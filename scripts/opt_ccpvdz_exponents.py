"""Optimize cc-pVDZ primitive exponents by the construction rule.

Dunning's (9s4p) primitive sets are variationally optimized for the atomic
ground-state HF energy (J. Chem. Phys. 90, 1007 (1989), Sec. II.A).  This
script reproduces that optimization: outer BFGS over log-exponents, inner
direct minimization of the equivalence-restricted ground-TERM HF energy
(same energy functional as scripts/gen_ccpvdz_contractions.py, one jitted
program reused across exponent sets).  Used to audit/correct the shipped
fluorine table where published values could not be sourced verbatim in
this offline image.

Usage: python scripts/opt_ccpvdz_exponents.py F [--validate-O]
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
from nbed_tpu.chem.basis.data_ccpvdz import CCPVDZ  # noqa: E402
from nbed_tpu.integrals import (  # noqa: E402
    eri_tensor,
    kinetic,
    nuclear_attraction,
    overlap,
)

OPEN_SHELL = {
    "C": (2, (0.0, 1.0, -1.0)),
    "N": (3, (0.0, 3.0, -3.0)),
    "O": (4, (1.0, 5.0, -3.0)),
    "F": (5, (2.0, 8.0, -4.0)),
}

NS, NP = 9, 4


def atom_tensors(sym, s_exps, p_exps):
    shells = [(0, [(float(e), 1.0)]) for e in s_exps]
    shells += [(1, [(float(e), 1.0)]) for e in p_exps]
    _REGISTRY["_opt_tmp"] = {sym: shells}
    mol = build_molecule(f"1\n\n{sym} 0.0 0.0 0.0", "_opt_tmp")
    h = np.asarray(kinetic(mol) + nuclear_attraction(mol))
    s = np.asarray(overlap(mol))
    eri = np.asarray(eri_tensor(mol))
    return h, s, eri


def make_energy_fn(sym):
    """One jitted (h, s, eri, params) -> E program, shared by all exponent
    sets (shapes are fixed at 9s4p)."""
    n_p, (a0c, a1c, a2c) = OPEN_SHELL[sym]
    nao = NS + 3 * NP

    def s_vec(c):
        return jnp.concatenate([c, jnp.zeros(3 * NP)])

    def p_vec(c, comp):
        block = jnp.zeros((NP, 3)).at[:, comp].set(c).reshape(-1)
        return jnp.concatenate([jnp.zeros(NS), block])

    def energy(params, h, s, eri):
        s_ss = s[:NS, :NS]
        idx = NS + 3 * jnp.arange(NP)
        s_pp = s[jnp.ix_(idx, idx)]
        a = params[: 2 * NS].reshape(NS, 2)
        pi = params[2 * NS:]
        m = a.T @ s_ss @ a
        w, v = jnp.linalg.eigh(m)
        phi = a @ (v * (w ** -0.5)) @ v.T
        pi = pi / jnp.sqrt(pi @ s_pp @ pi)
        f1, f2 = s_vec(phi[:, 0]), s_vec(phi[:, 1])
        px, py = p_vec(pi, 0), p_vec(pi, 1)

        def coul(u, v_, w_, x_):
            return jnp.einsum("p,q,r,x,pqrx->", u, v_, w_, x_, eri)

        e = 2.0 * (f1 @ h @ f1) + 2.0 * (f2 @ h @ f2) + n_p * (px @ h @ px)
        for fa in (f1, f2):
            for fb in (f1, f2):
                e += 2.0 * coul(fa, fa, fb, fb) - coul(fa, fb, fa, fb)
        for f in (f1, f2):
            e += n_p * (2.0 * coul(f, f, px, px) - coul(f, px, f, px))
        j0 = coul(px, px, px, px)
        j1 = coul(px, px, py, py)
        k1 = coul(px, py, px, py)
        return e + a0c * j0 + a1c * j1 + a2c * k1

    return jax.jit(jax.value_and_grad(energy)), nao


def inner_hf(sym, s_exps, p_exps, vg, x0=None):
    h, s, eri = atom_tensors(sym, s_exps, p_exps)
    if x0 is None:
        w0, v0 = np.linalg.eigh(s[:NS, :NS])
        x = v0 @ np.diag(w0 ** -0.5) @ v0.T
        _, c0 = np.linalg.eigh(x.T @ h[:NS, :NS] @ x)
        x0 = np.concatenate([(x @ c0[:, :2]).reshape(-1),
                             np.array([0.04, 0.23, 0.51, 0.46])])
    hj, sj, erij = jnp.asarray(h), jnp.asarray(s), jnp.asarray(eri)
    res = minimize(
        lambda p: tuple(np.asarray(t, dtype=np.float64)
                        for t in vg(jnp.asarray(p), hj, sj, erij)),
        x0, jac=True, method="BFGS",
        options={"maxiter": 4000, "gtol": 1e-11},
    )
    return float(res.fun), res.x


def optimize_exponents(sym, s0, p0, fix_p=False, maxiter=200):
    vg, _ = make_energy_fn(sym)
    state = {"x0": None, "best": np.inf}

    def outer(logz):
        s_exps = np.exp(logz[:NS])
        p_exps = p0 if fix_p else np.exp(logz[NS:])
        e, xin = inner_hf(sym, s_exps, p_exps, vg, state["x0"])
        state["x0"] = xin  # warm-start the next inner solve
        if e < state["best"]:
            state["best"] = e
        return e

    z0 = np.log(np.concatenate([s0] if fix_p else [s0, p0]))
    res = minimize(outer, z0, method="Nelder-Mead",
                   options={"maxiter": maxiter, "xatol": 1e-5,
                            "fatol": 1e-9, "adaptive": True})
    s_exps = np.exp(res.x[:NS])
    p_exps = p0 if fix_p else np.exp(res.x[NS:])
    return s_exps, p_exps, res.fun


def published_exps(sym):
    s_exps, p_exps = [], []
    for l, prims in CCPVDZ[sym]:
        for e, _ in prims:
            tgt = s_exps if l == 0 else (p_exps if l == 1 else None)
            if tgt is not None and e not in tgt:
                tgt.append(e)
    return (np.array(sorted(s_exps, reverse=True)),
            np.array(sorted(p_exps, reverse=True)))


def main():
    sym = sys.argv[1] if len(sys.argv) > 1 else "F"
    if "--validate-O" in sys.argv:
        # start O from scaled-N exponents; should recover the O energy
        sN, pN = published_exps("N")
        sO, pO = published_exps("O")
        vg, _ = make_energy_fn("O")
        e_pub, _ = inner_hf("O", sO, pO, vg)
        s_opt, p_opt, e_opt = optimize_exponents("O", sN * 1.3, pN * 1.3)
        print(f"O published-exponent E = {e_pub:.6f}")
        print(f"O optimized-from-N  E = {e_opt:.6f}  (dE = "
              f"{1000 * (e_opt - e_pub):+.3f} mHa)")
        print("  s_opt:", np.round(s_opt, 4).tolist())
        print("  s_pub:", sO.tolist())
        print("  p_opt:", np.round(p_opt, 4).tolist())
        print("  p_pub:", pO.tolist())
        return

    s_mem, p_mem = published_exps(sym)
    vg, _ = make_energy_fn(sym)
    e_mem, _ = inner_hf(sym, s_mem, p_mem, vg)
    print(f"{sym} shipped-exponent E = {e_mem:.6f}")
    s_opt, p_opt, e_opt = optimize_exponents(sym, s_mem, p_mem)
    print(f"{sym} optimized        E = {e_opt:.6f}  (dE = "
          f"{1000 * (e_opt - e_mem):+.3f} mHa)")
    print("  s_opt:", np.round(s_opt, 4).tolist())
    print("  p_opt:", np.round(p_opt, 4).tolist())


if __name__ == "__main__":
    main()
