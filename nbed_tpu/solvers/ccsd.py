"""Spin-orbital CCSD (Stanton-Gauss-Watts-Bartlett intermediates).

One implementation covers RHF/UHF/embedded references: the spin-orbital
formulation with per-spin MO integrals handles distinct alpha/beta orbitals
and spin-resolved embedded core Hamiltonians naturally (the case the
reference patches around, driver.py:1087-1097).

Device-resident iteration structure: the whole amplitude solve is ONE
jitted ``lax.while_loop`` with an on-device Pulay-DIIS ring buffer (no
per-cycle host round trips).  The default sweep is f64.  The opt-in
``"mixed"`` precision mode runs the sweep in f32 first (``HIGHEST``
precision matmuls, true-f32 accuracy) and polishes the last ~1e-6 with a
short f64 sweep seeded from the f32 amplitudes — the same fixed-point
argument as the incremental mixed-precision SCF (docs/DESIGN notes): the
converged amplitudes are a fixed point of the f64 update regardless of
how the seed was produced.

Replaces: PySCF ``cc.CCSD`` (reference driver.py:1105-1135).
"""

import logging
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

logger = logging.getLogger(__name__)

__all__ = ["run_ccsd"]


def _antisymmetrized(so_h2):
    """<pq||rs> from the builder's a+a+aa coefficient tensor.

    Builder convention: coeff[p,q,r,s] = 0.5 * <pq|sr>  =>
    <pq|rs> = 2 * coeff[p,q,s,r].
    """
    v = 2.0 * np.transpose(so_h2, (0, 1, 3, 2))  # <pq|rs>
    return v - v.transpose(0, 1, 3, 2)  # <pq||rs>


@partial(jax.jit, static_argnums=(5,))
def _ccsd_step(t1, t2, fock, w, denoms, slices):
    no, nv = slices
    d1, d2 = denoms
    f = fock
    o = slice(0, no)
    v = slice(no, no + nv)

    tau_t = t2 + 0.5 * (
        jnp.einsum("ia,jb->ijab", t1, t1) - jnp.einsum("ib,ja->ijab", t1, t1)
    )
    tau = t2 + (
        jnp.einsum("ia,jb->ijab", t1, t1) - jnp.einsum("ib,ja->ijab", t1, t1)
    )

    fae = f[v, v] - jnp.diag(jnp.diag(f[v, v]))
    fae = fae - 0.5 * jnp.einsum("me,ma->ae", f[o, v], t1)
    fae = fae + jnp.einsum("mf,mafe->ae", t1, w[o, v, v, v])
    fae = fae - 0.5 * jnp.einsum("mnaf,mnef->ae", tau_t, w[o, o, v, v])

    fmi = f[o, o] - jnp.diag(jnp.diag(f[o, o]))
    fmi = fmi + 0.5 * jnp.einsum("ie,me->mi", t1, f[o, v])
    fmi = fmi + jnp.einsum("ne,mnie->mi", t1, w[o, o, o, v])
    fmi = fmi + 0.5 * jnp.einsum("inef,mnef->mi", tau_t, w[o, o, v, v])

    fme = f[o, v] + jnp.einsum("nf,mnef->me", t1, w[o, o, v, v])

    wmnij = w[o, o, o, o]
    wmnij = wmnij + jnp.einsum("je,mnie->mnij", t1, w[o, o, o, v])
    wmnij = wmnij - jnp.einsum("ie,mnje->mnij", t1, w[o, o, o, v])
    wmnij = wmnij + 0.25 * jnp.einsum("ijef,mnef->mnij", tau, w[o, o, v, v])

    wabef = w[v, v, v, v]
    wabef = wabef - jnp.einsum("mb,amef->abef", t1, w[v, o, v, v])
    wabef = wabef + jnp.einsum("ma,bmef->abef", t1, w[v, o, v, v])
    wabef = wabef + 0.25 * jnp.einsum("mnab,mnef->abef", tau, w[o, o, v, v])

    wmbej = w[o, v, v, o]
    wmbej = wmbej + jnp.einsum("jf,mbef->mbej", t1, w[o, v, v, v])
    wmbej = wmbej - jnp.einsum("nb,mnej->mbej", t1, w[o, o, v, o])
    wmbej = wmbej - jnp.einsum(
        "jnfb,mnef->mbej", 0.5 * t2 + jnp.einsum("jf,nb->jnfb", t1, t1),
        w[o, o, v, v],
    )

    # T1 equations
    rhs1 = f[o, v]
    rhs1 = rhs1 + jnp.einsum("ie,ae->ia", t1, fae)
    rhs1 = rhs1 - jnp.einsum("ma,mi->ia", t1, fmi)
    rhs1 = rhs1 + jnp.einsum("imae,me->ia", t2, fme)
    rhs1 = rhs1 - jnp.einsum("nf,naif->ia", t1, w[o, v, o, v])
    rhs1 = rhs1 - 0.5 * jnp.einsum("imef,maef->ia", t2, w[o, v, v, v])
    rhs1 = rhs1 - 0.5 * jnp.einsum("mnae,nmei->ia", t2, w[o, o, v, o])

    # T2 equations
    rhs2 = w[o, o, v, v]
    tmp_fae = fae - 0.5 * jnp.einsum("mb,me->be", t1, fme)
    term = jnp.einsum("ijae,be->ijab", t2, tmp_fae)
    rhs2 = rhs2 + term - jnp.einsum("ijbe,ae->ijab", t2, tmp_fae)
    tmp_fmi = fmi + 0.5 * jnp.einsum("je,me->mj", t1, fme)
    term = jnp.einsum("imab,mj->ijab", t2, tmp_fmi)
    rhs2 = rhs2 - term + jnp.einsum("jmab,mi->ijab", t2, tmp_fmi)
    rhs2 = rhs2 + 0.5 * jnp.einsum("mnab,mnij->ijab", tau, wmnij)
    rhs2 = rhs2 + 0.5 * jnp.einsum("ijef,abef->ijab", tau, wabef)
    perm = jnp.einsum("imae,mbej->ijab", t2, wmbej)
    perm = perm - jnp.einsum("ie,ma,mbej->ijab", t1, t1, w[o, v, v, o])
    perm = (
        perm
        - jnp.transpose(perm, (1, 0, 2, 3))
        - jnp.transpose(perm, (0, 1, 3, 2))
        + jnp.transpose(perm, (1, 0, 3, 2))
    )
    rhs2 = rhs2 + perm
    tmp = jnp.einsum("ie,abej->ijab", t1, w[v, v, v, o])
    rhs2 = rhs2 + tmp - jnp.transpose(tmp, (1, 0, 2, 3))
    tmp = jnp.einsum("ma,mbij->ijab", t1, w[o, v, o, o])
    rhs2 = rhs2 - tmp + jnp.transpose(tmp, (0, 1, 3, 2))

    t1_new = rhs1 / d1
    t2_new = rhs2 / d2

    e_corr = (
        jnp.einsum("ia,ia->", f[o, v], t1_new)
        + 0.25 * jnp.einsum("ijab,ijab->", w[o, o, v, v], t2_new)
        + 0.5 * jnp.einsum("ijab,ia,jb->", w[o, o, v, v], t1_new, t1_new)
    )
    return t1_new, t2_new, e_corr


@lru_cache(maxsize=8)
def _make_sweep(no: int, nv: int, diis_dim: int):
    """Jitted full-solve: while_loop of amplitude updates + on-device DIIS.

    The DIIS ring buffers (amplitude vector + residual vector, ``diis_dim``
    slots each) live on device; the B-matrix solve is a (m+1)x(m+1) lstsq
    with fill-masking, the same structure as the SCF engine's in-loop DIIS
    (nbed_tpu/scf/hf.py).
    """
    m = diis_dim
    n1 = no * nv
    namp = n1 + no * no * nv * nv

    def unpack(vec):
        return (vec[:n1].reshape(no, nv),
                vec[n1:].reshape(no, no, nv, nv))

    @partial(jax.jit, static_argnames=())
    def sweep(fock, w, d1, d2, t1, t2, conv_tol, r_tol, max_cycle):
        dtype = w.dtype
        carry = dict(
            t1=t1.astype(dtype),
            t2=t2.astype(dtype),
            e_corr=jnp.asarray(0.0, dtype),
            e_prev=jnp.asarray(jnp.inf, dtype),
            rmax=jnp.asarray(jnp.inf, dtype),
            cycle=jnp.asarray(0, jnp.int32),
            conv=jnp.asarray(False),
            hist_t=jnp.zeros((m, namp), dtype),
            hist_r=jnp.zeros((m, namp), dtype),
            nfill=jnp.asarray(0, jnp.int32),
        )

        def cond(c):
            return jnp.logical_and(c["cycle"] < max_cycle,
                                   jnp.logical_not(c["conv"]))

        def body(c):
            t1n, t2n, e = _ccsd_step(
                c["t1"], c["t2"], fock, w, (d1, d2), (no, nv)
            )
            r = jnp.concatenate([
                (t1n - c["t1"]).ravel(), (t2n - c["t2"]).ravel()
            ])
            t_vec = jnp.concatenate([t1n.ravel(), t2n.ravel()])
            slot = c["cycle"] % m
            hist_t = c["hist_t"].at[slot].set(t_vec)
            hist_r = c["hist_r"].at[slot].set(r)
            nfill = jnp.minimum(c["nfill"] + 1, m)

            # Unconditional extrapolation + jnp.where select.  The
            # pseudo-inverse of the symmetric DIIS system is built from
            # eigh (as in the SCF loop, scf/hf.py) with a relative cut on
            # near-null directions.  The masked B matrix is
            # identity-padded so the always-computed solve is well-defined
            # for any fill level.
            b = hist_r @ hist_r.T
            filled = (jnp.arange(m) < nfill).astype(dtype)
            b = (b * (filled[:, None] * filled[None, :])
                 + jnp.diag(1.0 - filled))
            big = jnp.zeros((m + 1, m + 1), dtype)
            big = big.at[:m, :m].set(b)
            big = big.at[:m, m].set(filled)
            big = big.at[m, :m].set(filled)
            rhs = jnp.zeros(m + 1, dtype).at[m].set(1.0)
            ew, ev = jnp.linalg.eigh(big)
            cut = jnp.max(jnp.abs(ew)) * max(1e-12, (m + 1) * float(jnp.finfo(dtype).eps))
            inv_ew = jnp.where(jnp.abs(ew) > cut, 1.0 / ew, 0.0)
            coef = (ev * inv_ew[None, :]) @ (ev.T @ rhs)
            coef = coef[:m] * filled
            t_vec = jnp.where(nfill >= 2, coef @ hist_t, t_vec)
            t1x, t2x = unpack(t_vec)
            rmax = jnp.max(jnp.abs(r))
            conv = jnp.logical_and(jnp.abs(e - c["e_prev"]) < conv_tol,
                                   rmax < r_tol)
            return dict(t1=t1x, t2=t2x, e_corr=e, e_prev=e, rmax=rmax,
                        cycle=c["cycle"] + 1, conv=conv,
                        hist_t=hist_t, hist_r=hist_r, nfill=nfill)

        out = jax.lax.while_loop(cond, body, carry)
        return (out["t1"], out["t2"], out["e_corr"], out["rmax"],
                out["cycle"], out["conv"])

    return sweep


@lru_cache(maxsize=8)
def _make_triples_energy(no: int, nv: int, chunk: int = 128):
    """Jitted spin-orbital (T) energy: lax.map over vmapped (i,j,k) chunks.

    E(T) = (1/36) sum_{ijkabc} Rc * (Rc + Rd) / D with
    D Rc = P(i/jk) P(a/bc) [ sum_e t2[jk,ae] <ei||bc>
                             - sum_m t2[im,bc] <ma||jk> ]
    D Rd = P(i/jk) P(a/bc) [ t1[ia] <jk||bc> ]
    (canonical-reference CCSD(T)).  The (nv,nv,nv) work blocks are built
    per occupied triple — full t3 storage is O(no^3 nv^3) and never
    materialized — with ``chunk`` triples vmapped per lax.map step so the
    contractions stay GEMM-shaped.
    """
    o = slice(0, no)
    v = slice(no, no + nv)

    def make(fock, w, t1, t2):
        eps = jnp.diag(fock)
        eps_o, eps_v = eps[:no], eps[no:]
        w_vovv = w[v, o, v, v]
        w_ovoo = w[o, v, o, o]
        w_oovv = w[o, o, v, v]
        d_abc = (eps_v[:, None, None] + eps_v[None, :, None]
                 + eps_v[None, None, :])

        def p_abc(x):
            return x - jnp.transpose(x, (1, 0, 2)) - jnp.transpose(x, (2, 1, 0))

        def conn(i, j, k):
            x = jnp.einsum("ae,ebc->abc", t2[j, k], w_vovv[:, i])
            x = x - jnp.einsum("mbc,ma->abc", t2[i], w_ovoo[:, :, j, k])
            return p_abc(x)

        def disc(i, j, k):
            return p_abc(t1[i][:, None, None] * w_oovv[j, k][None, :, :])

        def one_triple(idx):
            i = idx // (no * no)
            j = (idx // no) % no
            k = idx % no
            rc = conn(i, j, k) - conn(j, i, k) - conn(k, j, i)
            rd = disc(i, j, k) - disc(j, i, k) - disc(k, j, i)
            d = eps_o[i] + eps_o[j] + eps_o[k] - d_abc
            return jnp.sum(rc * (rc + rd) / d)

        n_tr = no * no * no
        n_chunks = -(-n_tr // chunk)
        idx = jnp.arange(n_chunks * chunk) % n_tr  # pad with repeats
        valid = (jnp.arange(n_chunks * chunk) < n_tr).astype(w.dtype)

        def body(args):
            ii, vv = args
            return jnp.sum(jax.vmap(one_triple)(ii) * vv)

        parts = jax.lax.map(
            body, (idx.reshape(n_chunks, chunk),
                   valid.reshape(n_chunks, chunk))
        )
        return jnp.sum(parts) / 36.0

    return jax.jit(make)


def run_ccsd(so_h1, so_h2, occ_mask, conv_tol: float = 1e-8,
             max_cycle: int = 100, precision: str = "auto",
             diis_dim: int = 6, triples: bool = False):
    """CCSD correlation energy from spin-orbital integrals.

    Args:
        so_h1: (M, M) spin-orbital one-body integrals (incl. any embedding
            potential).
        so_h2: (M, M, M, M) a+a+aa coefficient tensor (builder's 0.5*h2).
        occ_mask: boolean (M,) — True for occupied spin orbitals.
        precision: ``"f64"`` (one f64 sweep), ``"f32"`` (one f32 sweep,
            ~1e-5-grade), ``"mixed"`` (f32 sweep then f64 polish), or
            ``"auto"`` (the f64 sweep).
        diis_dim: on-device DIIS ring-buffer length.
        triples: also compute the perturbative (T) correction from the
            converged amplitudes (beyond the reference, which delegates
            plain CCSD to PySCF — reference driver.py:1105-1135).

    Returns:
        (e_corr, e_hf_elec) — correlation energy and the reference
        (mean-field) electronic energy implied by the integrals; with
        ``triples=True``: (e_corr, e_t, e_hf_elec).
    """
    occ = np.where(occ_mask)[0]
    vir = np.where(~np.asarray(occ_mask))[0]
    order = np.concatenate([occ, vir])
    h1 = np.asarray(so_h1)[np.ix_(order, order)]
    w = _antisymmetrized(np.asarray(so_h2))[np.ix_(order, order, order, order)]
    no, nv = len(occ), len(vir)

    o = slice(0, no)
    fock = h1 + np.einsum("piqi->pq", w[:, o, :, o])
    e_ref = np.einsum("ii->", h1[o, o]) + 0.5 * np.einsum("ijij->", w[o, o, o, o])

    eps = np.diag(fock)
    d1 = eps[o, None] - eps[None, no:]
    d2 = (
        eps[o, None, None, None] + eps[None, o, None, None]
        - eps[None, None, no:, None] - eps[None, None, None, no:]
    )
    t1 = jnp.asarray(fock[o, no:] / d1)
    t2 = jnp.asarray(w[o, o, no:, no:] / d2)

    sweep = _make_sweep(no, nv, diis_dim)
    ops64 = tuple(jnp.asarray(a) for a in (fock, w, d1, d2))
    if precision == "auto":
        precision = "f64"

    if precision in ("f32", "mixed"):
        ops32 = tuple(a.astype(jnp.float32) for a in ops64)
        # true-f32 matmuls: TF32 or bf16 passes are too coarse for the
        # amplitude fixed points.
        with jax.default_matmul_precision("highest"):
            t1_, t2_, e32, rmax, n_it, conv = sweep(
                *ops32, t1, t2,
                jnp.float32(max(conv_tol, 1e-6)), jnp.float32(1e-5),
                jnp.int32(max_cycle),
            )
        t1, t2 = t1_, t2_
        logger.debug("CCSD f32 sweep: %s cycles, e=%s, rmax=%s",
                     int(n_it), float(e32), float(rmax))
        if precision == "f32":
            if not bool(conv):
                logger.warning("CCSD (f32) did NOT converge in %d cycles.",
                               max_cycle)
            if triples:
                e_t = _make_triples_energy(no, nv)(
                    *ops64[:2], t1.astype(jnp.float64),
                    t2.astype(jnp.float64))
                return float(e32), float(e_t), float(e_ref)
            return float(e32), float(e_ref)

    t1_, t2_, e_corr, rmax, n_it, conv = sweep(
        *ops64, t1, t2, jnp.float64(conv_tol), jnp.float64(1e-6),
        jnp.int32(max_cycle),
    )
    if bool(conv):
        logger.debug("CCSD converged in %d f64 cycles (%s).",
                     int(n_it), precision)
    else:
        logger.warning("CCSD did NOT converge in %d cycles.", max_cycle)
    if triples:
        e_t = _make_triples_energy(no, nv)(*ops64[:2], t1_, t2_)
        logger.debug("(T) correction: %s", float(e_t))
        return float(e_corr), float(e_t), float(e_ref)
    return float(e_corr), float(e_ref)
