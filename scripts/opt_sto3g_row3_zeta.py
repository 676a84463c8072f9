"""Derive STO-3G Slater zetas for third-shell atoms by the generating rule.

The distributed second-row STO-3G tables factor exactly as
``exp[k] = f[k] * zeta**2`` over universal fit vectors (recovered in
scripts/gen_sto3g_row2.py); the element data is therefore fully
determined by three zetas (1s, 2sp, 3sp).  Na and Mg are absent from the
shipped tables because their zetas could not be sourced offline.  This
script derives zetas variationally: minimise the atomic ground-TERM
restricted-HF energy *in the contracted minimal basis itself* over
(z1, z2, z3), with an inner direct orbital minimisation
(jax autodiff + BFGS, same approach as scripts/gen_ccpvdz_contractions.py
generalised to a third shell).

Validation mode first recovers the pinned zetas of Al/Si/S from the
published grid; if the atomic optimum does not reproduce the distributed
valence zetas (which may be Pople's *molecular* standard scale factors),
the deviation is printed so the provenance of any emitted Na/Mg row is
explicit.

RESULT (2026-08-18, this is why Na/Mg stay BSE-JSON-only): the Al
recovery FAILS —
``Al recovery: E=-263.63  zetas=[12.41, 3.41, 12.28]  (pinned 12.56,
4.36, 1.70, max|dz|=10.6)``.  Unconstrained total-energy optimization
collapses the 3sp zeta into the core region (a second core-like s
function buys ~20 Ha of 1s flexibility in a minimal basis), so the
distributed STO-3G zetas are NOT the unconstrained atomic optimum — the
valence scale factors come from molecular calibration that cannot be
reproduced offline.  Unlike the cc-pVDZ fluorine case (where the
construction rule IS atomic-HF-optimal and the O recovery succeeded,
scripts/opt_ccpvdz_exponents.py), a variationally derived Na/Mg row
would be a different basis wearing the STO-3G name.  Use a BSE JSON
file for Na/Mg.

Usage:
    python scripts/opt_sto3g_row3_zeta.py validate     # Al, Si, S recovery
    python scripts/opt_sto3g_row3_zeta.py Na Mg        # derive (see above)
"""

import sys

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np
from scipy.optimize import minimize

sys.path.insert(0, ".")
from nbed_tpu.chem import build_molecule  # noqa: E402
from nbed_tpu.chem.basis import _REGISTRY  # noqa: E402
from nbed_tpu.chem.basis.data_sto3g import (  # noqa: E402
    _FIT_1S, _FIT_2P, _FIT_2S, _S_COEF, _SP3_P_COEF, _SP3_S_COEF,
    _SP_P_COEF, _SP_S_COEF, _ZETA)

# fit vectors (zeta=1 exponents) recovered by gen_sto3g_row2.py from the
# distributed tables themselves; shared-exponent sp shells
_F_1S = tuple(a for a, _ in _FIT_1S)
_F_2SP = tuple(a for a, _ in _FIT_2S)
# 3sp universal fit: published row-2 exponents / zeta^2 (identical across
# elements to ~1e-10; Al row / 1.70^2)
_F_3SP = (0.4828576101, 0.1347150283, 0.05272656259)

# ground-term open-shell data: (n_open, l_open, (a_J0, a_J1, a_K1))
# for p^n terms; s^1 handled separately
_GROUND = {
    "Na": (1, 0, None),             # 3s^1, 2S
    "Mg": (0, None, None),          # closed shell
    "Al": (1, 1, (0.0, 0.0, 0.0)),  # 3p^1, 2P (single p electron)
    "Si": (2, 1, (0.0, 1.0, -1.0)),  # 3p^2, 3P
    "P": (3, 1, (0.0, 3.0, -3.0)),   # 3p^3, 4S
    "S": (4, 1, (1.0, 5.0, -3.0)),   # 3p^4, 3P
    "Cl": (5, 1, (2.0, 8.0, -4.0)),  # 3p^5, 2P
}


def shells_for(zetas, n_open, l_open):
    z1, z2, z3 = zetas
    shells = [
        (0, [(a * z1 * z1, c) for (a, _), c in zip(_FIT_1S, _S_COEF)]),
        (0, [(a * z2 * z2, c) for a, c in zip(_F_2SP, _SP_S_COEF)]),
        (1, [(a * z2 * z2, c) for a, c in zip(_F_2SP, _SP_P_COEF)]),
        (0, [(a * z3 * z3, c) for a, c in zip(_F_3SP, _SP3_S_COEF)]),
    ]
    # 3p function present whenever the element has one in STO-3G (always
    # for the sp shell); include it even for Na/Mg (unoccupied, it cannot
    # lower the atomic HF energy and so does not affect the zeta optimum)
    shells.append((1, [(a * z3 * z3, c)
                       for a, c in zip(_F_3SP, _SP3_P_COEF)]))
    return shells


def atom_tensors(sym, zetas, n_open, l_open):
    _REGISTRY["_row3_tmp"] = {sym: shells_for(zetas, n_open, l_open)}
    mol = build_molecule(f"1\n\n{sym} 0.0 0.0 0.0", "_row3_tmp")
    from nbed_tpu.integrals import (eri_tensor, kinetic, nuclear_attraction,
                                    overlap)
    h = np.asarray(kinetic(mol) + nuclear_attraction(mol))
    s = np.asarray(overlap(mol))
    eri = np.asarray(eri_tensor(mol))
    return h, s, eri


# AO layout for the contracted atom: [1s, 2s, 3s, 2p(xyz), 3p(xyz)]
NS, NP = 3, 2
S_IDX = np.array([0, 1, 2])
P_IDX = {0: np.array([3, 6]), 1: np.array([4, 7]), 2: np.array([5, 8])}


def make_energy_fn(sym):
    """(h, s, eri, params) -> ground-term RHF energy, jitted once.

    Orbitals: n_s_cl closed s + (0/1) open s over the 3 s AOs, one closed
    2p radial + optional open 3p radial over the 2 p AOs per component.
    All m components of a p shell share the radial vector; open-shell
    repulsion enters through term-restricted Slater-Condon invariants.
    """
    n_open, l_open, term = _GROUND[sym]
    open_s = 1 if (n_open and l_open == 0) else 0
    open_p = n_open if (n_open and l_open == 1) else 0
    n_s_cl = 2 + (0 if open_s else 1)  # Na: 1s,2s closed + open 3s
    n_p_rad = 1 + (1 if open_p else 0)

    def energy(op):
        h, s, eri = op["h"], op["s"], op["eri"]
        params = op["p"]
        nao = 9
        n_s_tot = n_s_cl + open_s
        a = params[: 3 * n_s_tot].reshape(3, n_s_tot)
        pr = params[3 * n_s_tot:].reshape(2, n_p_rad)

        s_ss = s[jnp.ix_(S_IDX, S_IDX)]
        px_idx = P_IDX[0]
        s_pp = s[jnp.ix_(px_idx, px_idx)]

        # symmetric orthonormalisation of all s orbitals together
        m = a.T @ s_ss @ a
        w, v = jnp.linalg.eigh(m)
        phi_s = a @ (v * (w ** -0.5)) @ v.T          # (3, n_s_tot)
        mp = pr.T @ s_pp @ pr
        wp, vp = jnp.linalg.eigh(mp)
        phi_p = pr @ (vp * (wp ** -0.5)) @ vp.T      # (2, n_p_rad)

        def s_vec(c):
            return jnp.zeros(nao).at[S_IDX].set(c)

        def p_vec(c, comp):
            return jnp.zeros(nao).at[P_IDX[comp]].set(c)

        def coulomb(u, v2, w2, x2):
            return jnp.einsum("p,q,r,x,pqrx->", u, v2, w2, x2, eri)

        closed = [s_vec(phi_s[:, i]) for i in range(n_s_cl)]
        # closed 2p: all three components, doubly occupied
        p_closed = [p_vec(phi_p[:, 0], c) for c in range(3)]
        closed = closed + p_closed

        e = 0.0
        for f in closed:
            e += 2.0 * (f @ h @ f)
        for fa in closed:
            for fb in closed:
                e += 2.0 * coulomb(fa, fa, fb, fb) - coulomb(fa, fb, fa, fb)

        if open_s:
            fo = s_vec(phi_s[:, n_s_cl])
            e += fo @ h @ fo
            for f in closed:
                e += 2.0 * coulomb(f, f, fo, fo) - coulomb(f, fo, f, fo)
        if open_p:
            ox = p_vec(phi_p[:, 1], 0)
            oy = p_vec(phi_p[:, 1], 1)
            e += open_p * (ox @ h @ ox)
            for f in closed:
                e += open_p * (2.0 * coulomb(f, f, ox, ox)
                               - coulomb(f, ox, f, ox))
            a0, a1, a2 = term
            j0 = coulomb(ox, ox, ox, ox)
            j1 = coulomb(ox, ox, oy, oy)
            k1 = coulomb(ox, oy, ox, oy)
            e += a0 * j0 + a1 * j1 + a2 * k1
        return e

    val_grad = jax.jit(jax.value_and_grad(energy, argnums=0),
                       static_argnums=())
    n_s_tot = n_s_cl + open_s
    n_par = 3 * n_s_tot + 2 * n_p_rad

    def inner(h, s, eri, x0=None):
        op = {"h": jnp.asarray(h), "s": jnp.asarray(s),
              "eri": jnp.asarray(eri)}
        if x0 is None:
            rng = np.random.default_rng(0)
            x0 = np.concatenate([np.eye(3, n_s_tot).reshape(-1),
                                 np.eye(2, n_p_rad).reshape(-1)])
            x0 = x0 + 0.01 * rng.standard_normal(x0.shape)
        assert len(x0) == n_par

        def f(p):
            opp = dict(op)
            opp["p"] = jnp.asarray(p)
            v, g = val_grad(opp)
            return float(v), np.asarray(g["p"], dtype=np.float64)

        res = minimize(f, np.asarray(x0), jac=True, method="BFGS",
                       options={"maxiter": 4000, "gtol": 1e-10})
        return float(res.fun), res.x

    return inner


def optimize_zetas(sym, z_init, fix=None, label=""):
    n_open, l_open, _ = _GROUND[sym]
    inner = make_energy_fn(sym)
    state = {"x0": None, "n": 0}

    def outer(logz):
        z = np.exp(logz)
        if fix is not None:
            z = np.array([fix[0] or z[0], fix[1] or z[1], fix[2] or z[2]])
        h, s, eri = atom_tensors(sym, z, n_open, l_open)
        e, x = inner(h, s, eri, state["x0"])
        state["x0"] = x
        state["n"] += 1
        return e

    res = minimize(outer, np.log(np.asarray(z_init, dtype=np.float64)),
                   method="Nelder-Mead",
                   options={"maxiter": 250, "xatol": 1e-5, "fatol": 1e-10,
                            "adaptive": True})
    z = np.exp(res.x)
    print(f"{label or sym}: E={res.fun:.6f}  zetas="
          f"{np.round(z, 4).tolist()}  n_outer={state['n']}", flush=True)
    return z, res.fun


def main():
    args = sys.argv[1:] or ["validate"]
    if args == ["validate"]:
        pinned = {"Al": (12.56, 4.36, 1.70), "Si": (13.53, 4.83, 1.75),
                  "S": (15.47, 5.79, 2.05)}
        for sym, zp in pinned.items():
            z, _ = optimize_zetas(sym, np.asarray(zp) * 1.05,
                                  label=f"{sym} recovery")
            dev = np.abs(z - np.asarray(zp))
            print(f"   pinned {zp}  recovered {np.round(z, 4).tolist()}  "
                  f"max|dz| = {dev.max():.4f}", flush=True)
        return
    seeds = {"Na": (10.63, 3.48, 1.60), "Mg": (11.60, 3.92, 1.65)}
    for sym in args:
        z, e = optimize_zetas(sym, seeds.get(sym, (12.0, 4.0, 1.7)))
        print(f"   -> zeta ({sym}): 1s {z[0]:.4f}  2sp {z[1]:.4f}  "
              f"3sp {z[2]:.4f}   E = {e:.6f}", flush=True)


if __name__ == "__main__":
    main()
