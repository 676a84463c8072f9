"""Spin-orbital MP2 (beyond the reference's CCSD/FCI solver menu).

E(2) = 1/4 sum_{ijab} |<ij||ab>|^2 / (e_i + e_j - e_a - e_b) — one
GEMM-shaped contraction over the same antisymmetrized spin-orbital
integrals the CCSD solver consumes, and exactly the CCSD initial-guess
doubles energy. Useful as a cheap correlation screen before paying for
CCSD(T) on an embedded space.
"""

import jax
import jax.numpy as jnp
import numpy as np

from .ccsd import _antisymmetrized

__all__ = ["run_mp2", "run_pt2", "run_double_hybrid"]


@jax.jit
def _mp2_energy(w_oovv, d2):
    t2 = w_oovv / d2
    return 0.25 * jnp.sum(w_oovv * t2)


def run_mp2(so_h1, so_h2, occ_mask):
    """MP2 correlation energy from spin-orbital integrals.

    Args mirror :func:`nbed_tpu.solvers.run_ccsd`; returns
    (e_corr_mp2, e_hf_elec).
    """
    occ = np.where(occ_mask)[0]
    vir = np.where(~np.asarray(occ_mask))[0]
    order = np.concatenate([occ, vir])
    h1 = np.asarray(so_h1)[np.ix_(order, order)]
    w = _antisymmetrized(np.asarray(so_h2))[np.ix_(order, order, order, order)]
    no = len(occ)

    o = slice(0, no)
    fock = h1 + np.einsum("piqi->pq", w[:, o, :, o])
    e_ref = np.einsum("ii->", h1[o, o]) + 0.5 * np.einsum("ijij->", w[o, o, o, o])

    eps = np.diag(fock)
    d2 = (
        eps[o, None, None, None] + eps[None, o, None, None]
        - eps[None, None, no:, None] - eps[None, None, None, no:]
    )
    e2 = _mp2_energy(jnp.asarray(w[o, o, no:, no:]), jnp.asarray(d2))
    return float(e2), float(e_ref)


def run_pt2(so_h2, eps_so, occ_mask):
    """PT2 correlation energy with *given* spin-orbital energies.

    :func:`run_mp2` rebuilds a canonical Fock from the integrals (correct
    for HF orbitals); double hybrids instead evaluate the same E(2)
    expression with the converged KS eigenvalues in the denominators
    (Grimme, JCP 124, 034108 (2006)).
    """
    occ = np.where(occ_mask)[0]
    vir = np.where(~np.asarray(occ_mask))[0]
    order = np.concatenate([occ, vir])
    w = _antisymmetrized(np.asarray(so_h2))[np.ix_(order, order, order, order)]
    eps = np.asarray(eps_so)[order]
    no = len(occ)
    o = slice(0, no)
    d2 = (
        eps[o, None, None, None] + eps[None, o, None, None]
        - eps[None, None, no:, None] - eps[None, None, None, no:]
    )
    return float(_mp2_energy(jnp.asarray(w[o, o, no:, no:]), jnp.asarray(d2)))


def run_double_hybrid(sol):
    """Total double-hybrid energy for a converged KS solution.

    ``sol`` must come from ``SCFEngine(mol, xc=<double hybrid>)`` (e.g.
    ``"b2plyp"``): the engine has already produced the hybrid-GGA SCF
    part; this adds ``c_PT2 * E(2)`` evaluated with the KS orbitals and
    eigenvalues.  Returns ``(e_tot, e_pt2)`` where ``e_tot = sol.e_tot +
    c_PT2 * e_pt2``.
    """
    from ..dft.functionals import pt2_coefficient
    from ..ham import HamiltonianBuilder

    c2 = pt2_coefficient(getattr(sol.engine, "xc", None))
    if c2 == 0.0:
        raise ValueError(
            f"'{sol.engine.xc}' is not a double-hybrid functional."
        )
    _, _, h2 = HamiltonianBuilder(sol, 0).build()
    eps = np.atleast_2d(np.asarray(sol.mo_energy))
    if eps.shape[0] == 1:  # restricted-collapsed solution
        eps = np.repeat(eps, 2, axis=0)
    k = eps.shape[-1]
    eps_so = np.empty(2 * k)
    eps_so[0::2] = eps[0]
    eps_so[1::2] = eps[1]
    occ = np.atleast_2d(np.asarray(sol.mo_occ))
    if occ.shape[0] == 1:
        occ = np.repeat(occ / 2.0, 2, axis=0)
    occ_mask = np.zeros(2 * k, dtype=bool)
    occ_mask[0::2] = occ[0] > 0
    occ_mask[1::2] = occ[1] > 0
    e_pt2 = run_pt2(h2, eps_so, occ_mask)
    return sol.e_tot + c2 * e_pt2, e_pt2
