"""Two-electron repulsion integrals (chemist notation (ab|cd)).

Shell quartets are canonicalised (a>=b, c>=d, pair(ab)>=pair(cd)), rotated to
an l-sorted representative of their 8-fold permutation orbit, and grouped by
angular class ``(la, lb, lc, ld)`` only.  Contractions are *flattened*: every
primitive quartet becomes one row of a flat work list, a single vectorised
McMurchie-Davidson kernel is ``vmap``-ped over fixed-size chunks of that
list, and rows are scatter-added into per-quartet cartesian blocks.  This
keeps the number of traced/compiled XLA programs at the number of angular
classes (<= 21 for an spd basis) instead of the (l, contraction-bucket)
product of the previous design — together with the vectorised Hermite R
build (:func:`..integrals.md.hermite_r`) this is what makes d-function bases
trace in seconds, unblocking vmapped-conformer and sharded workflows on
cc-pVDZ-class sets (reference relies on libcint for all of this,
SURVEY.md §2.3 row 3).

Blocks are finally rotated to spherical AOs with the per-shell
(norm-folding) cart2sph matrices and scattered to all 8 symmetric positions
with precomputed indices.  The output tensor feeds the J/K GEMMs.
"""

from functools import lru_cache
from itertools import product

import jax
import jax.numpy as jnp
import numpy as np

from ..chem.molecule import Molecule
from .core import _comp_powers, _e_tables, _sel
from .md import hermite_r_cross

__all__ = ["eri_tensor"]


def _e3(la, lb, a, b, ab_vec):
    pa = _comp_powers(la)
    pb = _comp_powers(lb)
    ex, ey, ez = _e_tables(la, lb, a, b, ab_vec)
    return jnp.einsum(
        "abt,abu,abv->abtuv",
        _sel(ex, pa[0], pb[0]),
        _sel(ey, pa[1], pb[1]),
        _sel(ez, pa[2], pb[2]),
    )


def _eri_prim(la, lb, lc, ld, omega=None):
    """Primitive cartesian ERI block (nca, ncb, ncc, ncd) for one quartet.

    ``omega`` selects the long-range erf(omega*r12)/r12 kernel (range-
    separated hybrids); None is the full-range Coulomb kernel."""
    lab, lcd = la + lb, lc + ld

    def f(ra, rb, rc, rd, a, b, c, d):
        p = a + b
        q = c + d
        big_p = (a * ra + b * rb) / p
        big_q = (c * rc + d * rd) / q
        alpha = p * q / (p + q)
        e_ab = _e3(la, lb, a, b, ra - rb)  # (nca, ncb, T,T,T)
        e_cd = _e3(lc, ld, c, d, rc - rd)
        r4 = hermite_r_cross(lab, lcd, alpha, big_p - big_q, omega=omega)
        pref = 2.0 * np.pi**2.5 / (p * q * jnp.sqrt(p + q))
        return pref * jnp.einsum("abtuv,tuvxyz,cdxyz->abcd", e_ab, r4, e_cd)

    return f


def _l_sorted(q, shells):
    """Rotate a quartet to the l-sorted representative of its 8-orbit:
    l_a >= l_b, l_c >= l_d, (l_a, l_b) >= (l_c, l_d)."""
    a, b, c, d = q
    if shells[a].l < shells[b].l:
        a, b = b, a
    if shells[c].l < shells[d].l:
        c, d = d, c
    if (shells[a].l, shells[b].l) < (shells[c].l, shells[d].l):
        a, b, c, d = c, d, a, b
    return (a, b, c, d)


class _AngularClass:
    """Static arrays for one (la, lb, lc, ld) class.

    ``prim_*`` arrays are the flattened primitive work list (one row per
    primitive quartet, rows grouped by quartet so scatter-add targets are
    contiguous); ``c2s_*`` are the per-quartet spherical rotations;
    ``indices`` are the 8 symmetric scatter images of the spherical block.
    """

    def __init__(self, ls, quartets, shells):
        self.ls = ls
        sh = [[shells[i] for i in q] for q in quartets]
        m = len(quartets)
        self.m = m
        self.atoms = np.array([[s.atom for s in q] for q in sh])  # (M, 4)
        self.c2s = [np.array([q[k].cart2sph for q in sh]) for k in range(4)]

        exps, coefs, qid, atom_rows = [], [], [], []
        for mi, q in enumerate(sh):
            prim_sets = [list(zip(s.exps, s.coeffs)) for s in q]
            for combo in product(*prim_sets):
                exps.append([p[0] for p in combo])
                coefs.append(np.prod([p[1] for p in combo]))
                qid.append(mi)
                atom_rows.append(self.atoms[mi])
        self.prim_exps = np.array(exps)  # (P, 4)
        self.prim_coef = np.array(coefs)  # (P,)
        self.prim_qid = np.array(qid, dtype=np.int32)  # (P,)
        self.prim_atoms = np.array(atom_rows, dtype=np.int32)  # (P, 4)
        self.n_prim = len(qid)

        ns = [2 * shells[quartets[0][k]].l + 1 for k in range(4)]
        self.ncart = [
            (shells[quartets[0][k]].l + 1) * (shells[quartets[0][k]].l + 2) // 2
            for k in range(4)
        ]
        offs = [np.array([q[k].ao_offset for q in sh]) for k in range(4)]
        grids = np.meshgrid(*[np.arange(n) for n in ns], indexing="ij")
        coords = [
            offs[k][:, None, None, None, None] + grids[k][None] for k in range(4)
        ]  # each (M, na, nb, nc, nd)
        perms = [
            (0, 1, 2, 3), (1, 0, 2, 3), (0, 1, 3, 2), (1, 0, 3, 2),
            (2, 3, 0, 1), (3, 2, 0, 1), (2, 3, 1, 0), (3, 2, 1, 0),
        ]
        self.indices = [
            tuple(coords[perm.index(k)].reshape(-1) for k in range(4))
            for perm in perms
        ]


def _canonical_quartets(nsh):
    """Canonical (a, b, c, d) with a>=b, c>=d, pair(ab)>=pair(cd)."""
    pairs = [(i, j) for i in range(nsh) for j in range(i + 1)]
    out = []
    for pi in range(len(pairs)):
        for qi in range(pi + 1):
            a, b = pairs[pi]
            c, d = pairs[qi]
            out.append((a, b, c, d))
    return out


@lru_cache(maxsize=32)
def _angular_classes(mol: Molecule):
    shells = mol.shells
    groups = {}
    for q in _canonical_quartets(len(shells)):
        q = _l_sorted(q, shells)
        ls = tuple(shells[i].l for i in q)
        groups.setdefault(ls, []).append(q)
    return [
        _AngularClass(ls, quartets, shells)
        for ls, quartets in sorted(groups.items())
    ]


@lru_cache(maxsize=None)
def _class_chunk_fn(ls, omega=None):
    """Process one fixed-size chunk of the primitive work list: compute the
    cartesian block of every row and scatter-add into the per-quartet
    accumulator.  One compiled program per angular class (jit re-specialises
    on the accumulator/chunk shapes)."""
    prim = _eri_prim(*ls, omega=omega)

    @jax.jit
    def step(acc, coords, exps, coef, qid, atoms):
        def one(e4, cf, at):
            ra, rb, rc, rd = (coords[at[0]], coords[at[1]],
                              coords[at[2]], coords[at[3]])
            return cf * prim(ra, rb, rc, rd, e4[0], e4[1], e4[2], e4[3])

        blocks = jax.vmap(one)(exps, coef, atoms)  # (chunk, nca..ncd)
        return acc.at[qid].add(blocks)

    return step


def eri_tensor(mol: Molecule, coords=None, chunk_elems: int = 2**22,
               omega=None):
    """Full AO ERI tensor (nao, nao, nao, nao), chemist notation (ij|kl).

    Pure function of ``coords`` (differentiable / vmappable over
    conformers); 8-fold permutation symmetry is used to compute only
    canonical quartets.  ``chunk_elems`` bounds the per-chunk intermediate
    (chunk_rows * cartesian-block elements).  ``omega`` selects the
    long-range erf(omega*r12)/r12 kernel used by range-separated hybrids.
    """
    c = jnp.asarray(mol.coords) if coords is None else coords
    nao = mol.nao
    out = jnp.zeros((nao, nao, nao, nao))
    omega = None if omega is None else float(omega)
    for cls in _angular_classes(mol):
        block = int(np.prod(cls.ncart))
        chunk = max(16, min(cls.n_prim, chunk_elems // block))
        step = _class_chunk_fn(cls.ls, omega)
        acc = jnp.zeros((cls.m, *cls.ncart))
        p = cls.n_prim
        pad = (-p) % chunk
        # pad rows carry coefficient 0 and benign exponents: they add 0
        exps = np.pad(cls.prim_exps, ((0, pad), (0, 0)), constant_values=1.0)
        coef = np.pad(cls.prim_coef, (0, pad))
        qid = np.pad(cls.prim_qid, (0, pad))
        atoms = np.pad(cls.prim_atoms, ((0, pad), (0, 0)))
        for s in range(0, p + pad, chunk):
            sl = slice(s, s + chunk)
            acc = step(acc, c, jnp.asarray(exps[sl]), jnp.asarray(coef[sl]),
                       jnp.asarray(qid[sl]), jnp.asarray(atoms[sl]))
        sph = jnp.einsum(
            "mabcd,map,mbq,mcr,mds->mpqrs", acc,
            jnp.asarray(cls.c2s[0]), jnp.asarray(cls.c2s[1]),
            jnp.asarray(cls.c2s[2]), jnp.asarray(cls.c2s[3]),
        )
        vals = sph.reshape(-1)
        for (ia, ib, ic, id_) in cls.indices:
            # .set with duplicate indices is safe: duplicates carry equal values
            out = out.at[jnp.asarray(ia), jnp.asarray(ib),
                         jnp.asarray(ic), jnp.asarray(id_)].set(vals)
    return out
