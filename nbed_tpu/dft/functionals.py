"""Spin-resolved exchange-correlation energy densities (pure jnp).

Each functional maps ``(rho_a, rho_b, gaa, gab, gbb) -> energy / volume``
where ``g__`` are contracted density gradients (sigma variables). Potentials
come from JAX autodiff in :mod:`nbed_tpu.dft.xc`, so these closed forms are
the single source of truth.

Conventions match libxc/PySCF: 'b3lyp' uses the VWN-RPA correlation
parametrisation (as in PySCF >= 2.3, which the reference pins —
reference pyproject requires pyscf >= 2.3); 'b3lyp5' uses VWN5.
"""

import re

import jax.numpy as jnp
import numpy as np

__all__ = ["FUNCTIONALS", "resolve_functional"]

_TINY = 1e-12


def _safe(rho):
    return jnp.maximum(rho, _TINY)


# ----------------------------------------------------------------- exchange

def slater_x(ra, rb, gaa, gab, gbb):
    """Slater/Dirac LDA exchange, spin-scaled."""
    cx = (3.0 / 4.0) * (3.0 / np.pi) ** (1.0 / 3.0) * 2.0 ** (1.0 / 3.0)
    return -cx * (_safe(ra) ** (4.0 / 3.0) + _safe(rb) ** (4.0 / 3.0))


def b88_x(ra, rb, gaa, gab, gbb):
    """Becke 1988 exchange (full: LDA part + gradient correction)."""
    beta = 0.0042

    def per_spin(r, g):
        r = _safe(r)
        r43 = r ** (4.0 / 3.0)
        chi = jnp.sqrt(jnp.maximum(g, 0.0)) / r43
        lda = -(3.0 / 4.0) * (3.0 / np.pi) ** (1.0 / 3.0) * 2.0 ** (1.0 / 3.0) * r43
        corr = -beta * r43 * chi * chi / (1.0 + 6.0 * beta * chi * jnp.arcsinh(chi))
        return lda + corr

    return per_spin(ra, gaa) + per_spin(rb, gbb)


# -------------------------------------------------------------- correlation

# VWN parameter sets (A, x0, b, c) for paramagnetic / ferromagnetic /
# spin-stiffness fits. VWN5: the "recommended" fits; RPA: the fits libxc
# ships as LDA_C_VWN_RPA (used inside the canonical B3LYP).
_VWN5 = {
    "P": (0.0310907, -0.10498, 3.72744, 12.9352),
    "F": (0.01554535, -0.32500, 7.06042, 18.0578),
    "A": (-1.0 / (6.0 * np.pi**2), -0.00475840, 1.13107, 13.0045),
}
_VWN_RPA = {
    "P": (0.0310907, -0.409286, 13.0720, 42.7198),
    "F": (0.01554535, -0.743294, 20.1231, 101.578),
    "A": (-1.0 / (6.0 * np.pi**2), -0.228344, 1.06835, 11.4813),
}


def _vwn_eps(x, params):
    a, x0, b, c = params
    q = np.sqrt(4.0 * c - b * b)
    xx = x * x + b * x + c
    xx0 = x0 * x0 + b * x0 + c
    atn = jnp.arctan(q / (2.0 * x + b))
    return a * (
        jnp.log(x * x / xx)
        + (2.0 * b / q) * atn
        - (b * x0 / xx0)
        * (jnp.log((x - x0) ** 2 / xx) + (2.0 * (b + 2.0 * x0) / q) * atn)
    )


def _vwn_c(params):
    fpp0 = 8.0 / (9.0 * (2.0 ** (4.0 / 3.0) - 2.0))

    def fn(ra, rb, gaa, gab, gbb):
        rho = _safe(ra + rb)
        zeta = jnp.clip((ra - rb) / rho, -1.0 + 1e-15, 1.0 - 1e-15)
        rs = (3.0 / (4.0 * np.pi * rho)) ** (1.0 / 3.0)
        x = jnp.sqrt(rs)
        eps_p = _vwn_eps(x, params["P"])
        eps_f = _vwn_eps(x, params["F"])
        alpha = _vwn_eps(x, params["A"])
        f_zeta = ((1.0 + zeta) ** (4.0 / 3.0) + (1.0 - zeta) ** (4.0 / 3.0) - 2.0) / (
            2.0 ** (4.0 / 3.0) - 2.0
        )
        z4 = zeta**4
        eps = eps_p + alpha * (f_zeta / fpp0) * (1.0 - z4) + (eps_f - eps_p) * f_zeta * z4
        return rho * eps

    return fn


vwn5_c = _vwn_c(_VWN5)
vwn_rpa_c = _vwn_c(_VWN_RPA)


def lyp_c(ra, rb, gaa, gab, gbb):
    """Lee-Yang-Parr correlation (Miehlich et al., CPL 157, 200 (1989))."""
    a, b, c, d = 0.04918, 0.132, 0.2533, 0.349
    cf = 0.3 * (3.0 * np.pi**2) ** (2.0 / 3.0)
    ra = _safe(ra)
    rb = _safe(rb)
    rho = ra + rb
    rm13 = rho ** (-1.0 / 3.0)
    denom = 1.0 + d * rm13
    # omega = exp(-c*rho^-1/3) * rho^(-11/3) / denom, with the power folded
    # into the exponential: the bare rho**(-11/3) factor is huge at grid
    # tails while exp(-c*rho^-1/3) is tiny, and their product (and its
    # autodiff chain) is safer as one exponential.  Folded, the whole
    # factor underflows cleanly to zero and stays finite in any f64.
    omega = jnp.exp(-c * rm13 - (11.0 / 3.0) * jnp.log(rho)) / denom
    delta = c * rm13 + d * rm13 / denom
    g_tot = gaa + 2.0 * gab + gbb
    term1 = -4.0 * a / denom * ra * rb / rho
    inner = (
        2.0 ** (11.0 / 3.0) * cf * (ra ** (8.0 / 3.0) + rb ** (8.0 / 3.0))
        + (47.0 / 18.0 - 7.0 * delta / 18.0) * g_tot
        - (5.0 / 2.0 - delta / 18.0) * (gaa + gbb)
        - (delta - 11.0) / 9.0 * (ra * gaa + rb * gbb) / rho
    )
    term2 = -a * b * omega * (
        ra * rb * inner
        - (2.0 / 3.0) * rho**2 * g_tot
        + ((2.0 / 3.0) * rho**2 - ra**2) * gbb
        + ((2.0 / 3.0) * rho**2 - rb**2) * gaa
    )
    return term1 + term2


def _pw92_eps(rs, zeta):
    """Perdew-Wang 1992 LSDA correlation energy per particle."""

    def g(rs, a, a1, b1, b2, b3, b4):
        srs = jnp.sqrt(rs)
        den = 2.0 * a * (b1 * srs + b2 * rs + b3 * rs * srs + b4 * rs * rs)
        return -2.0 * a * (1.0 + a1 * rs) * jnp.log(1.0 + 1.0 / den)

    ec0 = g(rs, 0.031091, 0.21370, 7.5957, 3.5876, 1.6382, 0.49294)
    ec1 = g(rs, 0.015545, 0.20548, 14.1189, 6.1977, 3.3662, 0.62517)
    alc = -g(rs, 0.016887, 0.11125, 10.357, 3.6231, 0.88026, 0.49671)
    fz = ((1.0 + zeta) ** (4.0 / 3.0) + (1.0 - zeta) ** (4.0 / 3.0) - 2.0) / (
        2.0 ** (4.0 / 3.0) - 2.0
    )
    fpp0 = 8.0 / (9.0 * (2.0 ** (4.0 / 3.0) - 2.0))
    z4 = zeta**4
    return ec0 + alc * (fz / fpp0) * (1.0 - z4) + (ec1 - ec0) * fz * z4


def pw92_c(ra, rb, gaa, gab, gbb):
    rho = _safe(ra + rb)
    zeta = jnp.clip((ra - rb) / rho, -1.0 + 1e-15, 1.0 - 1e-15)
    rs = (3.0 / (4.0 * np.pi * rho)) ** (1.0 / 3.0)
    return rho * _pw92_eps(rs, zeta)


def pbe_x(ra, rb, gaa, gab, gbb):
    """PBE exchange (kappa=0.804), spin-scaled."""
    kappa, mu = 0.804, 0.2195149727645171

    def per_spin(r, g):
        r2 = 2.0 * _safe(r)  # spin scaling: Ex[ra,rb] = (Ex[2ra]+Ex[2rb])/2
        kf = (3.0 * np.pi**2 * r2) ** (1.0 / 3.0)
        # s2 split as (g/r2^2) * r2^(-2/3): the single-quotient form
        # g/(4 kf^2 r2^2) has an autodiff quotient-rule denominator
        # ~ r2^(16/3), which underflows at low density; each factor here
        # stays within range down to the _safe floor.
        u = jnp.maximum(g, 0.0) / (r2 * r2)
        s2 = u * r2 ** (-2.0 / 3.0) / (4.0 * (3.0 * np.pi**2) ** (2.0 / 3.0))
        fx = 1.0 + kappa - kappa / (1.0 + mu * s2 / kappa)
        lda = -(3.0 / (4.0 * np.pi)) * kf * r2
        return 0.5 * lda * fx

    return per_spin(ra, gaa) + per_spin(rb, gbb)


def _ityh_attenuation(a):
    """ITYH short-range attenuation factor F(a) of the exchange hole.

    Iikura-Tsuneda-Yanai-Hirao (JCP 115, 3540 (2001)): a GGA exchange
    energy density e_x = -1/2 rho^{4/3} K becomes, under the short-range
    erfc(omega*r)/r kernel, e_x * F(a) with a = omega*sqrt(K)/(6 sqrt(pi)
    rho^{1/3}) and

        F(a) = 1 - (8/3) a [sqrt(pi) erf(1/(2a)) + 2a (b - c)]
        b = exp(-1/(4a^2)) - 1,  c = 2a^2 b + 1/2.

    Limits: F(0) = 1 (pure short range sees the full functional),
    F(a->inf) ~ 1/(36 a^2) -> 0.  Three numerically distinct regimes:

    * a < 0.025: erf(1/(2a)) == 1 and exp(-1/(4a^2)) == 0 exactly in f64
      but their autodiff produces 0*inf = NaN -> use the exact saturated
      polynomial F = 1 - (8/3) a (sqrt(pi) - 3a + 4a^3).
    * a > 8: the closed form cancels catastrophically (terms of size a
      cancel to O(1/a^2); once exp(-1/(4a^2)) rounds to 1, b == 0 and the
      formula explodes as +(8/3)a^2 — density tails drive a to 1e6+) ->
      use the asymptotic series F = x^2/9 - x^4/60 + x^6/420, x = 1/(2a)
      (from the Taylor expansions of erf and exp; relative error < 1e-10
      at a = 8 and improving like a^-2).
    * otherwise: the closed form, with inputs clamped into the branch's
      valid range (double-where) so no NaN leaks through autodiff.
    """
    import jax.scipy.special as jsp

    a = jnp.maximum(a, 0.0)
    small = a < 0.025
    large = a > 8.0
    a_m = jnp.clip(a, 0.025, 8.0)
    b = jnp.exp(-1.0 / (4.0 * a_m * a_m)) - 1.0
    c = 2.0 * a_m * a_m * b + 0.5
    f_full = 1.0 - (8.0 / 3.0) * a_m * (
        np.sqrt(np.pi) * jsp.erf(1.0 / (2.0 * a_m)) + 2.0 * a_m * (b - c)
    )
    a_s = jnp.minimum(a, 0.025)
    f_sat = 1.0 - (8.0 / 3.0) * a_s * (np.sqrt(np.pi) - 3.0 * a_s + 4.0 * a_s**3)
    x2 = 1.0 / (4.0 * jnp.maximum(a, 8.0) ** 2)
    f_asym = x2 * (1.0 / 9.0 - x2 * (1.0 / 60.0 - x2 / 420.0))
    return jnp.where(small, f_sat, jnp.where(large, f_asym, f_full))


def ityh_sr_x(base_x, omega: float):
    """Short-range (erfc(omega*r)/r) version of a per-spin exchange
    functional via the ITYH exchange-hole attenuation (the construction
    behind libxc's GGA_X_ITYH used in CAM-B3LYP / LC-BLYP).

    ``base_x`` must be spin-scaled like the exchange functionals here:
    base_x(ra, rb, ...) = ex(ra, gaa) + ex(rb, gbb).
    """

    def per_spin(r, g):
        r = _safe(r)
        e_full = base_x(r, jnp.zeros_like(r), g, jnp.zeros_like(g),
                        jnp.zeros_like(g))
        # e_full = -1/2 r^{4/3} K  =>  K = -2 e_full r^{-4/3}
        k_fac = jnp.maximum(-2.0 * e_full * r ** (-4.0 / 3.0), _TINY)
        a = omega * jnp.sqrt(k_fac) / (6.0 * np.sqrt(np.pi) * r ** (1.0 / 3.0))
        return e_full * _ityh_attenuation(a)

    def fn(ra, rb, gaa, gab, gbb):
        return per_spin(ra, gaa) + per_spin(rb, gbb)

    return fn


def pbe_c(ra, rb, gaa, gab, gbb):
    """PBE correlation (Perdew-Burke-Ernzerhof 1996)."""
    gamma = (1.0 - np.log(2.0)) / np.pi**2
    beta = 0.06672455060314922
    rho = _safe(ra + rb)
    zeta = jnp.clip((ra - rb) / rho, -1.0 + 1e-15, 1.0 - 1e-15)
    rs = (3.0 / (4.0 * np.pi * rho)) ** (1.0 / 3.0)
    eps = _pw92_eps(rs, zeta)
    phi = 0.5 * ((1.0 + zeta) ** (2.0 / 3.0) + (1.0 - zeta) ** (2.0 / 3.0))
    kf = (3.0 * np.pi**2 * rho) ** (1.0 / 3.0)
    ks = jnp.sqrt(4.0 * kf / np.pi)
    gnorm2 = jnp.maximum(gaa + 2.0 * gab + gbb, 0.0)
    # split as (g/rho^2) / (2 phi ks)^2: the fused denominator
    # (2 phi ks rho)^2 ~ rho^(7/3) makes the autodiff quotient-rule
    # square ~ rho^(14/3), which underflows at low density
    t2 = gnorm2 / (rho * rho) / (2.0 * phi * ks) ** 2
    expo = jnp.exp(-eps / (gamma * phi**3))
    a_coef = (beta / gamma) / jnp.maximum(expo - 1.0, 1e-30)
    num = 1.0 + a_coef * t2
    den = 1.0 + a_coef * t2 + (a_coef * t2) ** 2
    h = gamma * phi**3 * jnp.log(1.0 + (beta / gamma) * t2 * num / den)
    return rho * (eps + h)


# ------------------------------------------------------------- meta-GGA (tau)

def _tpss_fx(r2, g2, t2):
    """TPSS exchange enhancement factor for an unpolarized density.

    Tao-Perdew-Staroverov-Scuseria (PRL 91, 146401 (2003)), Eqs. 5-10:
    F_x = 1 + kappa - kappa/(1 + x/kappa) with the inhomogeneity variable
    x(p, z, alpha) built from p = s^2, z = tau_W/tau and
    q_b = (9/20)(alpha-1)/sqrt(1 + b alpha(alpha-1)) + 2p/3.

    All intermediates are kept within range at low density: p and alpha
    are clamped at values far beyond where F_x has saturated, and the s^2
    quotient is split into range-safe factors like pbe_x.
    """
    kappa, b, c, e, mu = 0.804, 0.40, 1.59096, 1.537, 0.21951
    r2 = _safe(r2)
    g2 = jnp.maximum(g2, 0.0)
    # p = s^2, split to keep autodiff denominators in range (cf. pbe_x)
    u = g2 / (r2 * r2)
    p = u * r2 ** (-2.0 / 3.0) / (4.0 * (3.0 * np.pi**2) ** (2.0 / 3.0))
    p = jnp.clip(p, 0.0, 1.0e4)  # F_x(p>100) is saturated at 1+kappa
    tau_w = 0.125 * u * r2  # |grad rho|^2 / (8 rho)
    tau_unif = 0.3 * (3.0 * np.pi**2) ** (2.0 / 3.0) * r2 ** (5.0 / 3.0)
    t2 = jnp.maximum(t2, tau_w + _TINY * tau_unif)  # tau >= tau_W exactly
    z = jnp.clip(tau_w / t2, 0.0, 1.0)
    alpha = jnp.clip((t2 - tau_w) / tau_unif, 0.0, 1.0e6)
    q_b = (0.45 * (alpha - 1.0)
           / jnp.sqrt(1.0 + b * alpha * (alpha - 1.0))
           + 2.0 * p / 3.0)
    z2 = z * z
    zp2 = (0.6 * z) ** 2
    x = (
        (10.0 / 81.0 + c * z2 / (1.0 + z2) ** 2) * p
        + (146.0 / 2025.0) * q_b * q_b
        - (73.0 / 405.0) * q_b * jnp.sqrt(0.5 * zp2 + 0.5 * p * p)
        + (1.0 / kappa) * (10.0 / 81.0) ** 2 * p * p
        + 2.0 * np.sqrt(e) * (10.0 / 81.0) * zp2
        + e * mu * p**3
    ) / (1.0 + np.sqrt(e) * p) ** 2
    return 1.0 + kappa - kappa / (1.0 + x / kappa)


def tpss_x(ra, rb, gaa, gab, gbb, ta, tb):
    """TPSS meta-GGA exchange, spin-scaled: E_x[ra,rb] =
    (E_x[2 ra] + E_x[2 rb])/2 with per-spin (2 rho_s, 4 sigma_ss, 2 tau_s).
    """

    def per_spin(r, g, t):
        r2 = 2.0 * _safe(r)
        kf = (3.0 * np.pi**2 * r2) ** (1.0 / 3.0)
        lda = -(3.0 / (4.0 * np.pi)) * kf * r2
        return 0.5 * lda * _tpss_fx(r2, 4.0 * jnp.maximum(g, 0.0), 2.0 * t)

    return per_spin(ra, gaa, ta) + per_spin(rb, gbb, tb)


def _pbe_c_per_particle(ra, rb, gaa, gab, gbb):
    return pbe_c(ra, rb, gaa, gab, gbb) / _safe(ra + rb)


def tpss_c(ra, rb, gaa, gab, gbb, ta, tb):
    """TPSS meta-GGA correlation (PRL 91, 146401 (2003), Eqs. 11-14).

    eps_c = eps_revPKZB (1 + d eps_revPKZB z^3), d = 2.8,
    eps_revPKZB = eps_PBE (1 + C(zeta,xi) z^2)
                  - (1 + C(zeta,xi)) z^2 sum_s (rho_s/rho) eps_tilde_s,
    eps_tilde_s = max[eps_PBE(rho_s, 0, sigma_ss, 0, 0), eps_PBE(full)],
    z = tau_W/tau (total), C(zeta,0) = 0.53 + 0.87 zeta^2 + 0.50 zeta^4
    + 2.26 zeta^6 damped by (1 + xi^2 ((1+zeta)^{-4/3}+(1-zeta)^{-4/3})/2)^-4
    with xi = |grad zeta| / (2 (3 pi^2 rho)^{1/3}).

    One-electron limit (rb = 0, tau = tau_W): eps_revPKZB -> eps_PBE (1 -
    z^2) -> 0, so the correlation is exactly self-interaction free — the
    constraint tests/test_xc.py checks numerically.
    """
    d = 2.8
    ra = _safe(ra)
    rb = _safe(rb)
    rho = ra + rb
    g_tot = jnp.maximum(gaa + 2.0 * gab + gbb, 0.0)
    tau = jnp.maximum(ta + tb, _TINY)
    tau_w = 0.125 * g_tot / rho
    z = jnp.clip(tau_w / jnp.maximum(tau, tau_w), 0.0, 1.0)
    z2 = z * z

    zeta = jnp.clip((ra - rb) / rho, -1.0 + 1e-15, 1.0 - 1e-15)
    # |grad zeta|^2 = 4 (rb^2 gaa - 2 ra rb gab + ra^2 gbb) / rho^4, split
    # into range-safe factors (za, zb <= 1; g/rho^2 bounded at the mask
    # floor); xi^2 = |grad zeta|^2 / (4 (3 pi^2)^{2/3} rho^{2/3}).
    za, zb = ra / rho, rb / rho
    gz2 = 4.0 * jnp.maximum(
        zb * zb * (gaa / (rho * rho))
        - 2.0 * za * zb * (gab / (rho * rho))
        + za * za * (gbb / (rho * rho)),
        0.0,
    )
    xi2 = gz2 * rho ** (-2.0 / 3.0) / (4.0 * (3.0 * np.pi**2) ** (2.0 / 3.0))
    c0 = 0.53 + zeta**2 * (0.87 + zeta**2 * (0.50 + 2.26 * zeta**2))
    damp_arg = xi2 * 0.5 * ((1.0 + zeta) ** (-4.0 / 3.0)
                            + (1.0 - zeta) ** (-4.0 / 3.0))
    # (1 + u)^-4 via exp(-4 log1p(u)): u reaches ~1e24 at grid tails and
    # the direct 4th power (and its autodiff chain) leaves the range; the
    # exponential underflows cleanly to zero instead.
    c_zx = c0 * jnp.exp(-4.0 * jnp.log1p(damp_arg))

    eps_full = _pbe_c_per_particle(ra, rb, gaa, gab, gbb)
    zero = jnp.zeros_like(ra)
    eps_a = jnp.maximum(_pbe_c_per_particle(ra, zero, gaa, zero, zero),
                        eps_full)
    eps_b = jnp.maximum(_pbe_c_per_particle(rb, zero, gbb, zero, zero),
                        eps_full)
    eps_rev = (eps_full * (1.0 + c_zx * z2)
               - (1.0 + c_zx) * z2 * (za * eps_a + zb * eps_b))
    eps = eps_rev * (1.0 + d * eps_rev * z2 * z)
    return rho * eps


tpss_x.needs_tau = True
tpss_c.needs_tau = True


# ------------------------------------------------------------------- SCAN

def _scan_interp(alpha, c1, c2, d):
    """SCAN's alpha-interpolation f(alpha): exp(-c1 a/(1-a)) below a=1,
    -d exp(c2/(1-a)) above; continuous (both branches -> 0 at a=1).
    Double-where clamps keep the inactive branch's autodiff finite."""
    a_lt = jnp.minimum(alpha, 1.0 - 1e-9)
    a_gt = jnp.maximum(alpha, 1.0 + 1e-9)
    f_lt = jnp.exp(-c1 * a_lt / (1.0 - a_lt))
    f_gt = -d * jnp.exp(c2 / (1.0 - a_gt))
    return jnp.where(alpha < 1.0, f_lt, f_gt)


def _scan_fx(r2, g2, t2):
    """SCAN exchange enhancement for an unpolarized density
    (Sun, Ruzsinszky & Perdew, PRL 115, 036402 (2015), Eqs. 1-2 and the
    supplemental parametrisation)."""
    k1, c1x, c2x, dx = 0.065, 0.667, 0.8, 1.24
    mu_ak = 10.0 / 81.0
    b2 = np.sqrt(5913.0 / 405000.0)
    b1 = (511.0 / 13500.0) / (2.0 * b2)
    b3 = 0.5
    b4 = mu_ak**2 / k1 - 1606.0 / 18225.0 - b1**2
    a1 = 4.9479
    h0x = 1.174

    r2 = _safe(r2)
    g2 = jnp.maximum(g2, 0.0)
    u = g2 / (r2 * r2)  # range-split s^2 (cf. pbe_x)
    p = u * r2 ** (-2.0 / 3.0) / (4.0 * (3.0 * np.pi**2) ** (2.0 / 3.0))
    p = jnp.clip(p, 0.0, 1.0e4)
    tau_w = 0.125 * u * r2
    tau_unif = 0.3 * (3.0 * np.pi**2) ** (2.0 / 3.0) * r2 ** (5.0 / 3.0)
    t2 = jnp.maximum(t2, tau_w)
    # guard only exact zero: r2 is _safe-floored so tau_unif >= ~3e-16;
    # an absolute density-scale floor here would swamp tau_unif at low
    # density and push alpha (hence F_x) off the UEG limit
    alpha = jnp.clip((t2 - tau_w) / jnp.maximum(tau_unif, 1e-30), 0.0, 1e6)

    one_ma = 1.0 - alpha
    x = (mu_ak * p
         * (1.0 + (b4 * p / mu_ak) * jnp.exp(-jnp.abs(b4) * p / mu_ak))
         + (b1 * p + b2 * one_ma * jnp.exp(-b3 * one_ma * one_ma)) ** 2)
    h1x = 1.0 + k1 - k1 / (1.0 + x / k1)
    gx = 1.0 - jnp.exp(-a1 / jnp.sqrt(jnp.sqrt(jnp.maximum(p, _TINY ** 2))))
    fx_a = _scan_interp(alpha, c1x, c2x, dx)
    return (h1x + fx_a * (h0x - h1x)) * gx


def scan_x(ra, rb, gaa, gab, gbb, ta, tb):
    """SCAN meta-GGA exchange (PRL 115, 036402 (2015)), spin-scaled like
    :func:`tpss_x`: E_x[ra,rb] = (E_x[2 ra] + E_x[2 rb])/2."""

    def per_spin(r, g, t):
        r2 = 2.0 * _safe(r)
        kf = (3.0 * np.pi**2 * r2) ** (1.0 / 3.0)
        lda = -(3.0 / (4.0 * np.pi)) * kf * r2
        return 0.5 * lda * _scan_fx(r2, 4.0 * jnp.maximum(g, 0.0), 2.0 * t)

    return per_spin(ra, gaa, ta) + per_spin(rb, gbb, tb)


def scan_c(ra, rb, gaa, gab, gbb, ta, tb):
    """SCAN meta-GGA correlation (PRL 115, 036402 (2015), supplemental):
    eps_c = eps_c1 + f_c(alpha) (eps_c0 - eps_c1) with the single-orbital
    limit eps_c0 and a revised-PBE eps_c1 (rs-dependent beta, w1-resummed
    H1)."""
    b1c, b2c, b3c = 0.0285764, 0.0889, 0.125541
    c1c, c2c, dc = 0.64, 1.5, 0.7
    chi_inf = 0.128026
    gamma = 0.031091

    # floor the TOTAL density only: flooring each spin separately acts as
    # a spurious opposite-spin density (tau_W < tau, zeta < 1) that breaks
    # the exact one-electron limit by ~1e-9 integrated
    rho = _safe(ra + rb)
    zeta = jnp.clip((ra - rb) / rho, -1.0 + 1e-15, 1.0 - 1e-15)
    rs = (3.0 / (4.0 * np.pi * rho)) ** (1.0 / 3.0)
    gnorm2 = jnp.maximum(gaa + 2.0 * gab + gbb, 0.0)
    u = gnorm2 / (rho * rho)  # range-split |grad n|^2 / n^2
    s2 = u * rho ** (-2.0 / 3.0) / (4.0 * (3.0 * np.pi**2) ** (2.0 / 3.0))
    s2 = jnp.clip(s2, 0.0, 1.0e6)

    # alpha with the spin factor d_s(zeta)
    tau = jnp.maximum(ta + tb, 0.0)
    tau_w = 0.125 * u * rho
    tau_unif = 0.3 * (3.0 * np.pi**2) ** (2.0 / 3.0) * rho ** (5.0 / 3.0)
    ds_z = 0.5 * ((1.0 + zeta) ** (5.0 / 3.0) + (1.0 - zeta) ** (5.0 / 3.0))
    # 1e-30 floor: guards exact zero only (rho is _safe-floored, so
    # tau_unif*ds_z >= ~1e-16; a density-scale floor would dominate it at
    # low density and bias alpha, see _scan_fx)
    alpha = jnp.clip(
        (jnp.maximum(tau, tau_w) - tau_w)
        / jnp.maximum(tau_unif * ds_z, 1e-30),
        0.0, 1e6,
    )

    # eps_c1: revised PBE with rs-dependent beta and w1 resummation
    phi = 0.5 * ((1.0 + zeta) ** (2.0 / 3.0) + (1.0 - zeta) ** (2.0 / 3.0))
    ks = jnp.sqrt(4.0 * (3.0 / np.pi) ** (1.0 / 3.0) * rho ** (1.0 / 3.0))
    t2 = u / (2.0 * phi * ks) ** 2
    beta_rs = 0.066725 * (1.0 + 0.1 * rs) / (1.0 + 0.1778 * rs)
    eps_lsda = _pw92_eps(rs, zeta)
    gp3 = gamma * phi**3
    w1 = jnp.expm1(-eps_lsda / gp3)
    a_coef = beta_rs / (gamma * jnp.maximum(w1, 1e-30))
    g_at2 = (1.0 + 4.0 * a_coef * t2) ** (-0.25)
    h1 = gp3 * jnp.log1p(w1 * (1.0 - g_at2))
    eps_c1 = eps_lsda + h1

    # eps_c0: single-orbital / low-density limit
    eps_lda0 = -b1c / (1.0 + b2c * jnp.sqrt(rs) + b3c * rs)
    w0 = jnp.expm1(-eps_lda0 / b1c)
    g_inf = (1.0 + 4.0 * chi_inf * s2) ** (-0.25)
    h0 = b1c * jnp.log1p(w0 * (1.0 - g_inf))
    dx_z = 0.5 * ((1.0 + zeta) ** (4.0 / 3.0) + (1.0 - zeta) ** (4.0 / 3.0))
    gc_z = (1.0 - 2.3631 * (dx_z - 1.0)) * (1.0 - zeta**12)
    eps_c0 = (eps_lda0 + h0) * gc_z

    fc_a = _scan_interp(alpha, c1c, c2c, dc)
    return rho * (eps_c1 + fc_a * (eps_c0 - eps_c1))


scan_x.needs_tau = True
scan_c.needs_tau = True


# ------------------------------------------------- B97 family (wB97/wB97X)

def _b97_series(u, coefs):
    """Power-series inhomogeneity correction factor sum_i c_i u^i."""
    acc = jnp.zeros_like(u)
    up = jnp.ones_like(u)
    for c in coefs:
        acc = acc + c * up
        up = up * u
    return acc


def _b97_u(x2, gamma):
    """B97 variable u = gamma x^2 / (1 + gamma x^2) in [0, 1)."""
    gx2 = gamma * x2
    return gx2 / (1.0 + gx2)


def _b97_x2(r, g):
    """x_sigma^2 = sigma_ss / rho_s^{8/3}, range-split to keep autodiff
    denominators in range (cf. pbe_x)."""
    r = _safe(r)
    return (jnp.maximum(g, 0.0) / (r * r)) * r ** (-2.0 / 3.0)


def b97_sr_x(coefs, omega: float, gamma: float = 0.004):
    """Becke-97-style short-range exchange: per-spin SR-LDA exchange
    (exact erfc attenuation — for LDA the ITYH hole construction is the
    exact SR-LDA factor with a = omega/(2 k_F,sigma)) times the power
    series ICF.  omega=0 degenerates to full-range B97 exchange."""
    cx = (3.0 / 4.0) * (3.0 / np.pi) ** (1.0 / 3.0) * 2.0 ** (1.0 / 3.0)
    k_fac = 2.0 * cx  # e_LDA = -1/2 r^{4/3} K  =>  K = 2 cx

    def fn(ra, rb, gaa, gab, gbb):
        def per_spin(r, g):
            r = _safe(r)
            e_lda = -cx * r ** (4.0 / 3.0)
            if omega:
                a = (omega * np.sqrt(k_fac) / (6.0 * np.sqrt(np.pi))
                     * r ** (-1.0 / 3.0))
                e_lda = e_lda * _ityh_attenuation(a)
            return e_lda * _b97_series(_b97_u(_b97_x2(r, g), gamma), coefs)

        return per_spin(ra, gaa) + per_spin(rb, gbb)

    return fn


def b97_c(css, cos, g_ss: float = 0.2, g_os: float = 0.006):
    """Becke-97-style correlation: PW92 LSDA split into same-spin and
    opposite-spin pieces (Stoll partition: E_ss = E_c[rho_s, 0],
    E_os = E_c[ra, rb] - E_c[ra, 0] - E_c[0, rb]), each times its own
    power-series ICF."""

    def fn(ra, rb, gaa, gab, gbb):
        ra_, rb_ = _safe(ra), _safe(rb)

        def e_polarized(r):
            rs = (3.0 / (4.0 * np.pi * r)) ** (1.0 / 3.0)
            return r * _pw92_eps(rs, 1.0 - 1e-12)

        e_aa = e_polarized(ra_)
        e_bb = e_polarized(rb_)
        e_os = pw92_c(ra, rb, gaa, gab, gbb) - e_aa - e_bb
        x2a = _b97_x2(ra_, gaa)
        x2b = _b97_x2(rb_, gbb)
        return (e_aa * _b97_series(_b97_u(x2a, g_ss), css)
                + e_bb * _b97_series(_b97_u(x2b, g_ss), css)
                + e_os * _b97_series(_b97_u(0.5 * (x2a + x2b), g_os), cos))

    return fn


# wB97 / wB97X parameter sets (Chai & Head-Gordon, JCP 128, 084106
# (2008), Tables 1-2).  The UEG exact-exchange sum rule c_x,HF-SR +
# c_x0 = 1 holds exactly for both sets.  The -D/-V dispersion tails of
# the later variants are NOT included (no empirical dispersion model in
# this package).
_WB97X_CX = (0.842294, 0.726479, 1.04760, -5.70635, 13.2794)
_WB97X_CSS = (1.000000, -4.33879, 18.2308, -31.7430, 17.2901)
_WB97X_COS = (1.000000, -2.37368, 2.48687, -12.1768, 25.7759)
_WB97_CX = (1.000000, 1.13116, -2.74915, 12.0900, -5.71642)
_WB97_CSS = (1.000000, -2.55352, 11.8926, -26.9452, 17.0147)
_WB97_COS = (1.000000, 3.99051, -17.0066, 1.07292, 8.88211)


# ------------------------------------------------------------------ registry

# name -> (terms [(coef, fn)], hyb fraction of HF exchange) or
#         (terms, hyb, (beta, omega)) for range-separated hybrids, where
#         the exact exchange is hyb*K + beta*K_LR(omega) with K_LR built
#         from the long-range erf(omega*r12)/r12 ERIs.
FUNCTIONALS = {
    "hf": ([], 1.0),
    "lda": ([(1.0, slater_x), (1.0, vwn5_c)], 0.0),
    "svwn": ([(1.0, slater_x), (1.0, vwn5_c)], 0.0),
    "blyp": ([(1.0, b88_x), (1.0, lyp_c)], 0.0),
    # canonical B3LYP: 0.20 HF + 0.08 Slater + 0.72 B88(full) + 0.81 LYP
    # + 0.19 VWN; PySCF>=2.3 'b3lyp' = VWN-RPA, 'b3lyp5' = VWN5.
    "b3lyp": (
        [(0.08, slater_x), (0.72, b88_x), (0.81, lyp_c), (0.19, vwn_rpa_c)],
        0.20,
    ),
    "b3lyp5": (
        [(0.08, slater_x), (0.72, b88_x), (0.81, lyp_c), (0.19, vwn5_c)],
        0.20,
    ),
    "pbe": ([(1.0, pbe_x), (1.0, pbe_c)], 0.0),
    "pbe0": ([(0.75, pbe_x), (1.0, pbe_c)], 0.25),
    # meta-GGA (tau-dependent): TPSS and its 10%-exact-exchange hybrid.
    "tpss": ([(1.0, tpss_x), (1.0, tpss_c)], 0.0),
    "tpssh": ([(0.90, tpss_x), (1.0, tpss_c)], 0.10),
    # SCAN meta-GGA (PRL 115, 036402 (2015)) and its 25% hybrid.
    "scan": ([(1.0, scan_x), (1.0, scan_c)], 0.0),
    "scan0": ([(0.75, scan_x), (1.0, scan_c)], 0.25),
    # wB97X (Chai & Head-Gordon 2008): SR-B97 exchange + B97 correlation;
    # exact exchange = 0.157706 full-range + 0.842294 long-range(0.3)
    # (i.e. 100% at long range, 15.77% at short range).
    "wb97x": (
        [(1.0, b97_sr_x(_WB97X_CX, 0.3)), (1.0, b97_c(_WB97X_CSS, _WB97X_COS))],
        0.157706,
        (0.842294, 0.3),
    ),
    # wB97: 100% long-range exact exchange (omega=0.4), no SR fraction.
    "wb97": (
        [(1.0, b97_sr_x(_WB97_CX, 0.4)), (1.0, b97_c(_WB97_CSS, _WB97_COS))],
        0.0,
        (1.0, 0.4),
    ),
    "pw92": ([(1.0, slater_x), (1.0, pw92_c)], 0.0),
    # Double hybrids (Grimme-style): the SCF part below is an ordinary
    # global hybrid; the missing PT2 correlation (coefficient in DH_PT2)
    # is added on the converged KS orbitals/eigenvalues by
    # solvers.run_double_hybrid.  B2PLYP: JCP 124, 034108 (2006);
    # B2GP-PLYP: JPCA 112, 12868 (2008).
    "b2plyp": ([(0.47, b88_x), (0.73, lyp_c)], 0.53),
    "b2gpplyp": ([(0.35, b88_x), (0.64, lyp_c)], 0.65),
    # CAM-B3LYP (Yanai-Tew-Handy, CPL 393, 51 (2004)): exact exchange
    # 0.19 full-range + 0.46 long-range(omega=0.33); DFT exchange is the
    # complement 0.35 B88 + 0.46 SR-B88 (ITYH); correlation 0.19 VWN5 +
    # 0.81 LYP (libxc HYB_GGA_XC_CAM_B3LYP composition).
    "camb3lyp": (
        [
            (0.35, b88_x),
            (0.46, ityh_sr_x(b88_x, 0.33)),
            (0.19, vwn5_c),
            (0.81, lyp_c),
        ],
        0.19,
        (0.46, 0.33),
    ),
    # LC-BLYP (ITYH long-range correction applied to BLYP): 100% HF
    # exchange at long range, SR-B88 at short range, full LYP; the
    # original ITYH range parameter omega=0.33.
    "lcblyp": (
        [(1.0, ityh_sr_x(b88_x, 0.33)), (1.0, lyp_c)],
        0.0,
        (1.0, 0.33),
    ),
}


DH_PT2 = {"b2plyp": 0.27, "b2gpplyp": 0.36}


def pt2_coefficient(name) -> float:
    """PT2 weight of a double-hybrid functional, or 0.0 for everything
    else (the SCF machinery alone is then the complete functional)."""
    if name is None:
        return 0.0
    return DH_PT2.get(name.strip().lower().replace("-", ""), 0.0)


# ------------------------------------------------- composition parser

# primitive names usable in composition strings.  Exchange / correlation
# tables are separate because libxc-style "X_part,C_part" strings resolve
# bare names by side; names unique to one table ("b88", "lyp", "vwn5"...)
# also resolve without a comma, while side-ambiguous families (PBE, TPSS)
# need an explicit x/c suffix there ("pbex"/"pbec").
_X_PRIMITIVES = {
    "slater": slater_x, "lda": slater_x, "s": slater_x, "xalpha": slater_x,
    "b88": b88_x, "becke88": b88_x, "b": b88_x,
    "pbe": pbe_x,
    "tpss": tpss_x,
}
_C_PRIMITIVES = {
    "vwn": vwn5_c, "vwn5": vwn5_c,
    "vwnrpa": vwn_rpa_c, "vwn_rpa": vwn_rpa_c,
    "lyp": lyp_c,
    "pbe": pbe_c,
    "pw92": pw92_c, "pw": pw92_c,
    "tpss": tpss_c,
}

_TERM_RE = re.compile(
    r"(?P<sign>[+-]?)"
    r"(?:(?P<coef>\d*\.?\d+(?:e[+-]?\d+)?)\*?)?"
    r"(?P<name>[a-z][a-z0-9_]*)"
    r"(?:\((?P<args>[^)]*)\))?"
)


def parse_composition(spec: str):
    """Parse a libxc/PySCF-style linear-combination XC string.

    Grammar (case-insensitive, whitespace ignored):
        composition := side [',' side]     # with a comma: X side , C side
        side        := term (('+'|'-') term)*
        term        := [coef '*'] name ['(' omega ')']

    Component names:
      * ``HF``/``EXX`` — exact exchange (adds to the hybrid fraction);
        ``LR_HF(omega)`` / ``SR_HF(omega)`` — long-/short-range exact
        exchange (erf/erfc split at ``omega``).
      * ``SR_<X>(omega)`` — ITYH short-range version of a DFT exchange
        primitive, e.g. ``SR_B88(0.33)`` (the CAM-B3LYP construction).
      * exchange primitives: SLATER/LDA, B88, PBE, TPSS;
        correlation primitives: VWN5, VWN_RPA, LYP, PBE, PW92, TPSS.
        Without a comma, PBE/TPSS need a ``x``/``c`` suffix (``pbex``).
      * without a comma, a registered compound name (``b3lyp``, ``pbe0``,
        ``camb3lyp``...) expands in place with its coefficient applied.

    Examples (all equivalent to registry entries):
        ``"0.2*HF + 0.08*SLATER + 0.72*B88 + 0.81*LYP + 0.19*VWN_RPA"``
        ``"0.25*HF + 0.75*PBE, PBE"``
        ``"0.19*HF + 0.46*LR_HF(0.33) + 0.35*B88 + 0.46*SR_B88(0.33)
           + 0.19*VWN5 + 0.81*LYP"``  (CAM-B3LYP)

    Returns ``(terms, hyb, rsh)`` in the :func:`resolve_functional`
    contract. Raises ``ValueError`` with a pointed message on malformed
    input (unknown component, ambiguous side, mixed omegas).
    """
    flat = "".join(spec.split()).lower()
    if not flat:
        raise ValueError("empty XC composition string")
    sides = flat.split(",")
    if len(sides) > 2:
        raise ValueError(
            f"XC composition {spec!r} has {len(sides) - 1} commas; at most "
            "one ('X_part,C_part') is allowed."
        )

    terms, hyb, beta = [], 0.0, 0.0
    omegas = set()

    def need_omega(name, args):
        if not args:
            raise ValueError(
                f"range-separated component '{name}' needs an omega "
                f"argument, e.g. '{name}(0.33)'"
            )
        w = float(args)
        omegas.add(w)
        return w

    def resolve_name(name, args, side):
        """Apply one component with unit coefficient -> list of
        (coef, fn) terms plus (d_hyb, d_beta)."""
        if name in ("hf", "exx"):
            return [], 1.0, 0.0
        if name in ("lr_hf", "lrhf"):
            need_omega(name, args)
            return [], 0.0, 1.0
        if name in ("sr_hf", "srhf"):
            need_omega(name, args)
            return [], 1.0, -1.0
        if name.startswith("sr_") and side != "c":
            base = _X_PRIMITIVES.get(name[3:])
            if base is not None:
                w = need_omega(name, args)
                return [(1.0, ityh_sr_x(base, w))], 0.0, 0.0
        if side == "x":
            fn = _X_PRIMITIVES.get(name) or _X_PRIMITIVES.get(
                name.removesuffix("x").removesuffix("_"))
            if fn is None:
                raise ValueError(
                    f"unknown exchange component '{name}'; have "
                    f"{sorted(set(_X_PRIMITIVES))} (+ HF/LR_HF/SR_HF/SR_<X>)"
                )
            return [(1.0, fn)], 0.0, 0.0
        if side == "c":
            fn = _C_PRIMITIVES.get(name) or _C_PRIMITIVES.get(
                name.removesuffix("c").removesuffix("_"))
            if fn is None:
                raise ValueError(
                    f"unknown correlation component '{name}'; have "
                    f"{sorted(set(_C_PRIMITIVES))}"
                )
            return [(1.0, fn)], 0.0, 0.0
        # comma-less: compound registry first, then side-unique primitives
        key = name.replace("_", "")
        if key in FUNCTIONALS:
            sub_terms, sub_hyb, sub_rsh = resolve_functional(key)
            d_beta = 0.0
            if sub_rsh is not None:
                d_beta = sub_rsh[0]
                omegas.add(sub_rsh[1])
            return list(sub_terms), sub_hyb, d_beta
        in_x = name in _X_PRIMITIVES
        in_c = name in _C_PRIMITIVES
        if in_x and in_c:
            raise ValueError(
                f"component '{name}' is both an exchange and a correlation "
                f"primitive; disambiguate with '{name}x'/'{name}c' or use "
                "the 'X_part,C_part' comma form."
            )
        if in_x:
            return [(1.0, _X_PRIMITIVES[name])], 0.0, 0.0
        if in_c:
            return [(1.0, _C_PRIMITIVES[name])], 0.0, 0.0
        if name.endswith("x") and name[:-1] in _X_PRIMITIVES:
            return [(1.0, _X_PRIMITIVES[name[:-1]])], 0.0, 0.0
        if name.endswith("c") and name[:-1] in _C_PRIMITIVES:
            return [(1.0, _C_PRIMITIVES[name[:-1]])], 0.0, 0.0
        raise ValueError(
            f"unknown XC component '{name}'; have compounds "
            f"{sorted(FUNCTIONALS)}, exchange {sorted(set(_X_PRIMITIVES))}, "
            f"correlation {sorted(set(_C_PRIMITIVES))}"
        )

    for part, side in zip(sides, ("x", "c") if len(sides) == 2 else (None,)):
        if not part:
            continue  # empty side, e.g. "b88," (exchange only)
        pos = 0
        for m in _TERM_RE.finditer(part):
            if m.start() != pos:
                raise ValueError(
                    f"could not parse XC composition {spec!r} at "
                    f"'{part[pos:]}'"
                )
            pos = m.end()
            coef = float(m.group("coef") or 1.0)
            if m.group("sign") == "-":
                coef = -coef
            sub, d_hyb, d_beta = resolve_name(
                m.group("name"), m.group("args"), side)
            terms.extend((coef * c, f) for c, f in sub)
            hyb += coef * d_hyb
            beta += coef * d_beta
        if pos != len(part):
            raise ValueError(
                f"could not parse XC composition {spec!r} at '{part[pos:]}'"
            )

    if len(omegas) > 1:
        raise ValueError(
            f"XC composition {spec!r} mixes range-separation omegas "
            f"{sorted(omegas)}; a single omega is required (the exchange "
            "kernel is folded as hyb*K + beta*K_LR(omega))."
        )
    rsh = (beta, omegas.pop()) if beta and omegas else None
    return terms, hyb, rsh


def resolve_functional(name: str):
    """Return (terms, hyb, rsh) for a functional name (case-insensitive).

    ``rsh`` is ``None`` for global hybrids / pure functionals, or
    ``(beta, omega)`` for range-separated hybrids: exact exchange enters
    the Fock matrix as ``hyb*K + beta*K_LR(omega)``.

    Unregistered names are tried as libxc-style composition strings
    (:func:`parse_composition`) — the reference forwards arbitrary
    functional specs to PySCF/libxc (reference driver.py:163-169); this
    covers the linear-combination subset of that surface natively.
    """
    key = name.strip().lower().replace("-", "")
    try:
        entry = FUNCTIONALS[key]
    except KeyError:
        try:
            return parse_composition(name)
        except ValueError as exc:
            # families we recognise but do not ship primitives for: give a
            # targeted, actionable error instead of a bare parse failure
            # (reference surface: free-form xc strings forwarded to libxc,
            # reference driver.py:163-169)
            _FAMILY_HINTS = {
                ("m05", "m06", "m08", "m11", "mn12", "mn15"):
                    "the Minnesota meta-GGAs need VS98-type kinetic-energy"
                    "-density power series not shipped here; the closest "
                    "supported meta-GGA hybrids are 'scan0', 'tpssh' and "
                    "the range-separated 'wb97x'",
                ("b97d", "b97"):
                    "the B97 power-series GGA family is shipped only in "
                    "its range-separated wB97/wB97X forms; for a "
                    "dispersion-oriented GGA try 'blyp' or 'pbe'",
                ("revtpss", "rtpss"):
                    "only the original TPSS is shipped ('tpss', 'tpssh'); "
                    "revTPSS's revised C(zeta,xi) is not",
                ("hse", "hse06", "hse03"):
                    "screened (SR-only) exact exchange is not supported; "
                    "supported range separation is LR-corrected "
                    "('camb3lyp', 'wb97x', 'lcblyp')",
            }
            hint = next((h for fam, h in _FAMILY_HINTS.items()
                         if any(key.startswith(f) for f in fam)), None)
            hint_txt = f" Note: {hint}." if hint else ""
            raise KeyError(
                f"XC functional '{name}' is not a registered name and did "
                f"not parse as a composition string ({exc}).{hint_txt} "
                f"Registered names: {sorted(FUNCTIONALS)}. Composition "
                "strings combine exchange primitives "
                f"{sorted(_X_PRIMITIVES)} and correlation primitives "
                f"{sorted(_C_PRIMITIVES)} with HF/EXX, LR_HF(omega), "
                "SR_HF(omega) and SR_<X>(omega) terms, e.g. "
                "'0.2*HF + 0.08*SLATER + 0.72*B88, 0.81*LYP + 0.19*VWN_RPA'."
            ) from exc
    if len(entry) == 2:
        return entry[0], entry[1], None
    return entry
