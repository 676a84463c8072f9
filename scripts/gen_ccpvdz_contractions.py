"""Re-derive cc-pVDZ contraction coefficients from the construction recipe.

Dunning's cc-pVDZ general contractions are the atomic Hartree-Fock orbitals
of the ground-state atom expanded in the uncontracted primitive set
(J. Chem. Phys. 90, 1007 (1989), Sec. II): the two contracted s functions
are the 1s and 2s HF orbitals over the 9 s primitives, the contracted p
function is the 2p HF orbital over the 4 p primitives.

This script reproduces that construction with a symmetry- and
equivalence-restricted HF of the atomic ground TERM: one shared radial 2p
function for all three m components, and the term-specific open-shell
repulsion written exactly in the radial invariants (J0, J1, K1) via
Slater-Condon:

    C (p2, 3P):          J1 -  K1
    N (p3, 4S):         3J1 - 3K1
    O (p4, 3P):    J0 + 5J1 - 3K1
    F (p5, 2P):   2J0 + 8J1 - 4K1   (p5 has a single term -> exact)

The total energy is minimized directly over orthonormal orbital vectors
(jax autodiff + BFGS), then 1s/2s are canonicalized by diagonalizing the
effective Fock in the occupied s space.  Polarization d functions cannot
mix into s/p atomic orbitals by symmetry, so the uncontracted 9s4p problem
is complete.

Validation mode (default, `python ... C N O`) prints the max deviation
from the shipped published tables; `python ... F` emits a ready-to-paste
table entry.
"""

import sys

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np
from scipy.optimize import minimize

sys.path.insert(0, ".")
from nbed_tpu.chem import build_molecule  # noqa: E402
from nbed_tpu.chem.basis.data_ccpvdz import CCPVDZ  # noqa: E402
from nbed_tpu.integrals import (  # noqa: E402
    eri_tensor,
    kinetic,
    nuclear_attraction,
    overlap,
)

# term-specific open-shell repulsion coefficients (J0, J1, K1) and the
# open-shell electron count for 1s2 2s2 2p^n ground terms
OPEN_SHELL = {
    "C": (2, (0.0, 1.0, -1.0)),
    "N": (3, (0.0, 3.0, -3.0)),
    "O": (4, (1.0, 5.0, -3.0)),
    "F": (5, (2.0, 8.0, -4.0)),
}


def primitive_sets(sym):
    s_exps, p_exps = [], []
    for l, prims in CCPVDZ[sym]:
        for e, _ in prims:
            tgt = s_exps if l == 0 else (p_exps if l == 1 else None)
            if tgt is not None and e not in tgt:
                tgt.append(e)
    return sorted(s_exps, reverse=True), sorted(p_exps, reverse=True)


def build_uncontracted(sym):
    s_exps, p_exps = primitive_sets(sym)
    shells = [(0, [(e, 1.0)]) for e in s_exps] + [(1, [(e, 1.0)])
                                                  for e in p_exps]
    from nbed_tpu.chem.basis import _REGISTRY

    _REGISTRY["_uncontracted_tmp"] = {sym: shells}
    mol = build_molecule(f"1\n\n{sym} 0.0 0.0 0.0", "_uncontracted_tmp")
    return mol, s_exps, p_exps


def term_restricted_hf(sym):
    """Equivalence-restricted ground-term HF; returns orbital vectors over
    unit-normalised primitives: (s_exps, p_exps, c_1s, c_2s, c_2p, e_tot)."""
    n_p, (a0, a1, a2) = OPEN_SHELL[sym]
    mol, s_exps, p_exps = build_uncontracted(sym)
    ns, npp = len(s_exps), len(p_exps)
    h = jnp.asarray(kinetic(mol) + nuclear_attraction(mol))
    s = jnp.asarray(overlap(mol))
    eri = jnp.asarray(eri_tensor(mol))
    nao = mol.nao
    assert nao == ns + 3 * npp

    # full-AO index maps: s AOs first, then p shells x 3 cartesian components
    def s_vec(c):  # (ns,) -> (nao,)
        return jnp.concatenate([c, jnp.zeros(3 * npp)])

    def p_vec(c, comp):  # radial (npp,) -> (nao,) on cartesian component comp
        block = jnp.zeros((npp, 3)).at[:, comp].set(c).reshape(-1)
        return jnp.concatenate([jnp.zeros(ns), block])

    s_ss = s[:ns, :ns]
    # radial p metric from one cartesian component
    idx = ns + 3 * jnp.arange(npp)
    s_pp = s[jnp.ix_(idx, idx)]

    def coulomb(u, v, w, x):
        return jnp.einsum("p,q,r,x,pqrx->", u, v, w, x, eri)

    def energy(params):
        a = params[: 2 * ns].reshape(ns, 2)
        pi = params[2 * ns:]
        # symmetric orthonormalisation of the closed s pair
        m = a.T @ s_ss @ a
        w, v = jnp.linalg.eigh(m)
        phi = a @ (v * (w ** -0.5)) @ v.T
        pi = pi / jnp.sqrt(pi @ s_pp @ pi)
        f1, f2 = s_vec(phi[:, 0]), s_vec(phi[:, 1])
        px, py = p_vec(pi, 0), p_vec(pi, 1)
        e = 0.0
        for f in (f1, f2):
            e += 2.0 * (f @ h @ f)
        e += n_p * (px @ h @ px)
        # closed-closed
        for fa in (f1, f2):
            for fb in (f1, f2):
                e += 2.0 * coulomb(fa, fa, fb, fb) - coulomb(fa, fb, fa, fb)
        # closed-open (m-independent by symmetry)
        for f in (f1, f2):
            e += n_p * (2.0 * coulomb(f, f, px, px) - coulomb(f, px, f, px))
        # open-open in radial invariants
        j0 = coulomb(px, px, px, px)
        j1 = coulomb(px, px, py, py)
        k1 = coulomb(px, py, px, py)
        e += a0 * j0 + a1 * j1 + a2 * k1
        return e

    val_grad = jax.jit(jax.value_and_grad(energy))

    # hcore guess in the s block + most-diffuse-leaning p guess
    w, v = np.linalg.eigh(np.asarray(s_ss))
    x = v @ np.diag(w ** -0.5) @ v.T
    hs = np.asarray(h)[:ns, :ns]
    _, c0 = np.linalg.eigh(x.T @ hs @ x)
    a0_guess = x @ c0[:, :2]
    pi0 = np.ones(npp) / np.sqrt(npp)
    x0 = np.concatenate([a0_guess.reshape(-1), pi0])

    res = minimize(
        lambda p: tuple(np.asarray(t, dtype=np.float64)
                        for t in val_grad(jnp.asarray(p))),
        x0, jac=True, method="BFGS",
        options={"maxiter": 2000, "gtol": 1e-11},
    )
    e_tot = float(res.fun)

    # recover orthonormal vectors and canonicalize 1s/2s within their span
    a = res.x[: 2 * ns].reshape(ns, 2)
    pi = res.x[2 * ns:]
    m = a.T @ np.asarray(s_ss) @ a
    w, v = np.linalg.eigh(m)
    phi = a @ (v * (w ** -0.5)) @ v.T
    pi = pi / np.sqrt(pi @ np.asarray(s_pp) @ pi)

    # effective Fock (total-density GC Fock is enough to fix the invariant
    # 2x2 rotation; its occupied-space eigenvectors are the canonical 1s/2s)
    dm = 2.0 * (phi @ phi.T)
    dmf = np.zeros((nao, nao))
    dmf[:ns, :ns] = dm
    for comp in range(3):
        pv = np.zeros(nao)
        pv[ns + 3 * np.arange(npp) + comp] = pi
        dmf += (n_p / 3.0) * np.outer(pv, pv)
    j = np.einsum("pqrs,rs->pq", np.asarray(eri), dmf)
    k = np.einsum("prqs,rs->pq", np.asarray(eri), dmf)
    f_ao = np.asarray(h) + j - 0.5 * k
    f_occ = phi.T @ f_ao[:ns, :ns] @ phi
    _, rot = np.linalg.eigh(f_occ)
    phi = phi @ rot
    return s_exps, p_exps, phi[:, 0], phi[:, 1], pi, e_tot


def _signfix(vec):
    return vec if vec[np.argmax(np.abs(vec))] >= 0 else -vec


def published(sym):
    srows = [pr for l, pr in CCPVDZ[sym] if l == 0 and len(pr) > 1]
    prow = [pr for l, pr in CCPVDZ[sym] if l == 1 and len(pr) > 1]
    if not srows:
        return None
    return (np.array([c for _, c in srows[0]]),
            np.array([c for _, c in srows[1]]),
            np.array([c for _, c in prow[0]]))


def main():
    syms = sys.argv[1:] or ["C", "N", "O"]
    for sym in syms:
        s_exps, p_exps, c1s, c2s, c2p, e = term_restricted_hf(sym)
        c1s, c2s, c2p = _signfix(c1s), _signfix(c2s), _signfix(c2p)
        print(f"== {sym}  (restricted ground-term HF e_tot = {e:.6f}) ==")
        pub = published(sym)
        if pub is not None:
            p1, p2, pp = pub
            print(f"   max|d 1s| = {np.abs(c1s - p1).max():.2e}  "
                  f"max|d 2s| = {np.abs(c2s - p2).max():.2e}  "
                  f"max|d 2p| = {np.abs(c2p - pp).max():.2e}")
        print("   s exps:   ", s_exps)
        print("   1s coeffs:", np.round(c1s, 6).tolist())
        print("   2s coeffs:", np.round(c2s, 6).tolist())
        print("   p exps:   ", p_exps)
        print("   2p coeffs:", np.round(c2p, 6).tolist())


if __name__ == "__main__":
    main()
