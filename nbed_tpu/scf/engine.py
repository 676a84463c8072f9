"""SCF engine: caches per-molecule operator tensors, runs the jitted SCF.

This is the structural replacement for PySCF StreamObjects in the reference:
where the reference configures a mutable ``scf.UHF``/``dft.UKS`` object and
monkey-patches ``get_hcore`` (reference driver.py:527-529, 595-597), here an
:class:`SCFEngine` owns immutable operator tensors (S, hcore, ERI
supermatrices, grid AO tables) and ``kernel`` is a pure call: embedding
potentials, electron-count overrides and Huzinaga projectors are explicit
arguments. :class:`SCFSolution` is the light result container the embedding
driver manipulates (environment deletion, virtual localization).
"""

import logging
from dataclasses import dataclass
from functools import cached_property, lru_cache
from typing import NamedTuple, Optional

import jax.numpy as jnp
import numpy as np

from ..chem.molecule import Molecule
from ..dft.functionals import resolve_functional
from ..dft.xc import make_xc_fn, make_xc_fn_streaming
from ..grids import build_grid, eval_aos
from ..integrals import (
    eri_tensor,
    kinetic,
    nuclear_attraction,
    overlap,
    point_charge_attraction,
)
from .hf import lowdin_x, make_rdm1, run_scf

logger = logging.getLogger(__name__)

__all__ = ["SCFEngine", "SCFSolution", "VeffResult"]


class VeffResult(NamedTuple):
    """get_veff output with energy components (pyscf-veff-like)."""

    matrix: jnp.ndarray  # (2, n, n)
    ecoul: jnp.ndarray
    exc: jnp.ndarray  # functional exc incl. -0.5*hyb*tr(D K) HF part


def _spinify(dm):
    dm = jnp.asarray(dm)
    if dm.ndim == 2:
        return jnp.stack([dm, dm]) * 0.5
    return dm


def df_b_factor(mol, coords, beta: float = 1.8, omega: float = 0.0) -> np.ndarray:
    """Metric-folded DF factor B[a,b,P] with (ab|cd) ~ sum_P B_abP B_cdP.

    Built from native 3-centre/2-centre integrals over an automatic
    even-tempered auxiliary basis; the metric inverse square root is
    eigenvalue-clipped for robustness.  Host-side (numpy) so callers can
    choose device placement/sharding of the result (the multi-chip path
    shards the aux axis, nbed_tpu/parallel/sharding.py).

    ``omega > 0`` fits in the long-range erf(omega*r12)/r12 metric (both
    the 3-centre integrals and the 2-centre metric are attenuated), the
    factorisation used for the long-range exchange of range-separated
    hybrids (same-metric fit, as PySCF's ``with_df`` does under RSH).
    """
    from .. import native
    from ..chem.basis.auxiliary import make_auxiliary_molecule

    aux = make_auxiliary_molecule(mol, beta=beta)
    b3 = native.eri_3c(mol, aux, coords, omega=omega)
    m2 = native.eri_2c(aux, coords, omega=omega)
    w, v = np.linalg.eigh(m2)
    # canonical orthogonalisation: *discard* near-null metric directions
    # (clip-inverting them amplifies integral noise by 1/sqrt(w) and
    # destroys large overcomplete auto-aux sets)
    keep = w > 1e-10 * w.max()
    m_isqrt = v[:, keep] / np.sqrt(w[keep])[None, :]  # (naux, nkeep)
    logger.debug("DF aux: %d functions, %d kept after metric pruning",
                 len(w), int(keep.sum()))
    return np.einsum("abP,PQ->abQ", b3, m_isqrt, optimize=True)


# max elements of the (nao, nao, chunk) DF-exchange intermediate at the
# DEFAULT 4000 MB memory budget (config.max_ram_memory default; engines
# scale it linearly via max_memory_mb): 2e7 f64 elements -> ~160 MB.
_DF_K_CHUNK_ELEMS = int(2e7)


def _df_k_spin(b, d, chunk_elems: int = _DF_K_CHUNK_ELEMS):
    """DF exchange K[i,j] = B_ikP d_kl B_jlP as two plain GEMM chains.

    Valid for any symmetric ``d`` (incl. the non-PSD delta densities of
    the incremental path).  Deliberately NOT the textbook eigen-/
    Cholesky-decomposed-density route: with the full-rank densities this
    engine feeds it, that route costs the same naux*nao^3 contractions
    PLUS an eigh inside the jitted SCF loop, so two plain GEMM chains are
    the cheaper choice.

    When the (nao, nao, naux) intermediate would exceed
    ``_DF_K_CHUNK_ELEMS`` the auxiliary axis is processed in fixed-size
    blocks under ``lax.fori_loop`` (K = sum_P B_P D B_P^T is exact under
    any partition of P), bounding device memory at large nao.
    """
    import jax

    nao, naux = b.shape[0], b.shape[-1]
    if nao * nao * naux <= chunk_elems:
        t = jnp.einsum("ikP,kl->ilP", b, d)
        k = jnp.einsum("ilP,jlP->ij", t, b)
        return 0.5 * (k + k.T)
    chunk = max(256, chunk_elems // (nao * nao))
    n_blk = -(-naux // chunk)
    pad = n_blk * chunk - naux
    b_p = jnp.pad(b, ((0, 0), (0, 0), (0, pad))) if pad else b

    def body(i, acc):
        b_c = jax.lax.dynamic_slice_in_dim(b_p, i * chunk, chunk, axis=2)
        t = jnp.einsum("ikP,kl->ilP", b_c, d)
        return acc + jnp.einsum("ilP,jlP->ij", t, b_c)

    k = jax.lax.fori_loop(0, n_blk, body,
                          jnp.zeros((nao, nao), dtype=b.dtype))
    return 0.5 * (k + k.T)


# Shared jitted programs across SCFEngine instances.  Keyed by the
# STRUCTURAL spec (atoms + basis + method + fast-path flags) — deliberately
# NOT by geometry: every coordinate-dependent quantity enters the trace as a
# jit argument, so a fresh engine (new driver, conformer step, warm bench
# run) reuses the compiled program instead of paying a full re-trace
# (tens of seconds per engine for a large molecule).  Bounded:
# each program closes over the engine that built it, pinning that engine's
# device operands (ERI supermatrices can be GBs) — insertion-order eviction
# keeps a many-structure process from accumulating them.
_JIT_PROGRAM_CACHE: dict = {}
_JIT_PROGRAM_CACHE_MAX = 24


# Hund's-rule unpaired-electron counts for neutral atoms (SAD guess)
_ATOM_SPIN = {1: 1, 2: 0, 3: 1, 4: 0, 5: 1, 6: 2, 7: 3, 8: 2, 9: 1, 10: 0,
              11: 1, 12: 0, 13: 1, 14: 2, 15: 3, 16: 2, 17: 1, 18: 0}


@lru_cache(maxsize=64)
def _atomic_density(symbol: str, basis: str):
    """Spin-summed UHF density of the neutral atom (per-spin average), for
    the superposition-of-atomic-densities initial guess.

    Pinned to the host CPU backend when one is available: these are
    microscopic SCFs (a few basis functions each) run eagerly, so on an
    accelerator their per-op dispatch would outweigh the arithmetic.
    """
    import contextlib

    import jax

    from ..chem import build_molecule
    from ..chem.periodic import SYMBOL_TO_Z

    ctx = contextlib.nullcontext()
    if jax.default_backend() != "cpu":
        try:
            ctx = jax.default_device(jax.devices("cpu")[0])
        except RuntimeError:
            pass
    with ctx:
        mol = build_molecule(f"1\n\n{symbol} 0.0 0.0 0.0", basis)
        z = SYMBOL_TO_Z[symbol.capitalize()]
        spin = _ATOM_SPIN.get(z, z % 2)
        na = (z + spin) // 2
        eng = SCFEngine(mol, conv_tol=1e-8, max_cycle=100,
                        init_guess="hcore", jit_kernel="off")
        res = eng.kernel(nelec=(na, z - na))
        dm = res.make_rdm1()
    return 0.5 * np.asarray(dm[0] + dm[1])


@dataclass(eq=False)
class SCFEngine:
    """Operator context for one molecule + method.

    Args:
        mol: molecule (static structure).
        xc: functional name, or None for Hartree-Fock.
        restricted: report style only — the solver is always spin-resolved
          (the reference driver is likewise always unrestricted,
          reference driver.py:69-78).
    """

    mol: Molecule
    xc: Optional[str] = None
    restricted: bool = False
    rohf: bool = False  # restricted open shell (ROHF/ROKS): both spins
    # share spatial orbitals via Roothaan's effective Fock; reference
    # parity target is the PySCF scf.ROHF surface (SURVEY §2.3)
    conv_tol: float = 1e-6
    dm_conv_tol: float = 1e-6
    max_cycle: int = 50
    grid_size: tuple = (96, 22)  # (n_radial, n_theta) for scheme="product"
    grid_scheme: str = "reference"  # "reference" (PySCF-parity) | "product"
    grid_level: int = 3  # per-element density level for scheme="reference"
    coords: Optional[np.ndarray] = None  # override geometry (bohr)
    integrals_backend: str = "auto"  # "auto" | "native" | "jax"
    warmup_f32: bool = False  # f32 pre-SCF seeding the f64 solve (opt-in)
    density_fitting: bool = False  # DF J/K: O(nao^2 naux) memory, GEMM builds
    df_beta: float = 1.8  # even-tempered auxiliary-basis ratio
    incremental_jk: bool = False  # f32 incremental Fock builds in the
    # f64 SCF (J/K of the density *change* in f32, periodic f64 rebase)
    rebase_every: int = 8  # full-f64 J/K rebuild period for incremental SCF
    init_guess: str = "sad"  # "sad" (superposition of atomic densities,
    # essential beyond ~50 AOs) | "hcore" (the reference Huzinaga-loop guess)
    jit_kernel: str = "auto"  # fuse the whole kernel() — f32 warm-up,
    # prologue, SCF loop, final Fock — into ONE compiled program with all
    # big operands passed as jit arguments: "auto" (on any accelerator,
    # where each eager op is a separate device dispatch; eager on the
    # CPU), "on", "off"
    max_memory_mb: float = 4000.0  # memory budget (MB) scaling the chunked
    # intermediates: the DF-exchange aux-axis chunk and the XC table/
    # streaming switchover are calibrated for 4000 MB (the reference's
    # config.max_ram_memory default, passed to PySCF max_memory, reference
    # driver.py:114) and scale linearly with this knob

    def __post_init__(self):
        if self.coords is None:
            self.coords = np.asarray(self.mol.coords)

    # ---------------------------------------------------------- operators
    @cached_property
    def _use_native(self) -> bool:
        """Native C++ host engine for static-geometry integral tensors;
        the JAX path serves vmapped/differentiated workflows."""
        import os

        backend = os.environ.get("NBED_TPU_INTEGRALS", self.integrals_backend)
        if backend == "jax":
            return False
        from .. import native

        ok = native.available()
        if backend == "native" and not ok:
            raise RuntimeError("Native integral engine requested but unavailable.")
        return ok

    @cached_property
    def _native_1e(self):
        from .. import native

        return native.one_electron(self.mol, self.coords)

    @cached_property
    def s(self):
        if self._use_native:
            return jnp.asarray(self._native_1e[0])
        return overlap(self.mol, jnp.asarray(self.coords))

    @cached_property
    def x(self):
        return lowdin_x(self.s)

    @cached_property
    def hcore(self):
        if self._use_native:
            _, t, v = self._native_1e
            return jnp.asarray(t + v)  # V already includes MM charges
        c = jnp.asarray(self.coords)
        h = kinetic(self.mol, c) + nuclear_attraction(self.mol, c)
        if self.mol.mm_coords is not None:
            h = h + point_charge_attraction(
                self.mol,
                self.mol.mm_coords,
                self.mol.mm_charges,
                self.mol.mm_radii,
                coords=c,
            )
        return h

    @cached_property
    def eri(self):
        if self._use_native:
            from .. import native

            return jnp.asarray(native.eri(self.mol, self.coords))
        return eri_tensor(self.mol, jnp.asarray(self.coords))

    @cached_property
    def eri_lr(self):
        """Long-range erf(omega*r12)/r12 AO ERIs (range-separated hybrids)."""
        _, omega = self._rsh
        if self._use_native:
            from .. import native

            return jnp.asarray(native.eri(self.mol, self.coords, omega=omega))
        return eri_tensor(self.mol, jnp.asarray(self.coords), omega=omega)

    @cached_property
    def eri_j(self):
        n = self.mol.nao
        return self.eri.reshape(n * n, n * n)

    @cached_property
    def eri_k(self):
        """Exchange supermatrix (ik|jl).

        For range-separated hybrids this is the *weighted* exchange kernel
        hyb*K + beta*K_LR(omega) and the engine reports ``hyb == 1`` — every
        consumer pairs ``-hyb*K(D)`` with this supermatrix, so folding the
        range separation here covers the SCF loop, the f32/incremental
        paths and ``get_veff`` uniformly.
        """
        n = self.mol.nao
        k = jnp.transpose(self.eri, (0, 2, 1, 3)).reshape(n * n, n * n)
        if self._rsh is None:
            return k
        beta, _ = self._rsh
        k_lr = jnp.transpose(self.eri_lr, (0, 2, 1, 3)).reshape(n * n, n * n)
        return self._xc_meta[1] * k + beta * k_lr

    @property
    def _df_chunk_elems(self) -> int:
        """Aux-chunk element bound for the DF-exchange intermediate,
        scaled from the 4000-MB calibration by :attr:`max_memory_mb`."""
        return max(int(_DF_K_CHUNK_ELEMS * self.max_memory_mb / 4000.0),
                   1_000_000)

    # above this many AO-table elements (ao + 3 gradient tables = x4; 1e8
    # elements ~ 3.2 GB f64, the 4000-MB calibration point) the XC closure
    # streams AO evaluation per grid chunk instead.  The table path is the
    # default: it evaluates the AOs once per SCF, and pfoa/level-3 (4.8e7
    # elements, 384k points) stays under the limit.  The streaming path
    # exists only to bound memory; it runs under lax.fori_loop with carried
    # accumulators, the same structure as the aux-chunked DF-K.
    @property
    def _XC_TABLE_LIMIT(self) -> float:
        return 1e8 * self.max_memory_mb / 4000.0

    @cached_property
    def _grid(self):
        def make(c):
            return build_grid(self.mol, c,
                              n_rad=self.grid_size[0],
                              n_theta=self.grid_size[1],
                              scheme=self.grid_scheme,
                              level=self.grid_level)

        if self._use_jit_kernel:
            # one dispatch instead of hundreds of eager grid-construction ops
            import jax

            return self._shared_jit("grid", lambda: jax.jit(make))(
                jnp.asarray(self.coords)
            )
        return make(jnp.asarray(self.coords))

    def _xc_pack(self, dtype):
        """(static tag, array operands) for rebuilding the XC closure.

        Split from the closure construction so the jitted kernel path can
        pass the (large) AO tables as jit ARGUMENTS — a closure-captured
        device array lowers to an HLO constant embedded in the program."""
        if self.xc is None or not self._xc_meta[0]:
            return "none", {}
        points, weights = self._grid
        if points.shape[0] * self.mol.nao > self._XC_TABLE_LIMIT:
            return "streaming", {
                "points": points, "weights": weights,
                "coords": jnp.asarray(self.coords),
            }
        ao, ao_grad = self._ao_tables
        return "table", {
            "ao": ao.astype(dtype), "grad": ao_grad.astype(dtype),
            "w": weights.astype(dtype),
        }

    @cached_property
    def _ao_tables(self):
        points, _ = self._grid
        if self._use_jit_kernel:
            import jax

            fn = self._shared_jit("aos", lambda: jax.jit(
                lambda p, c: eval_aos(self.mol, p, c)
            ))
            return fn(points, jnp.asarray(self.coords))
        return eval_aos(self.mol, points, jnp.asarray(self.coords))

    def _xc_from(self, tag, arrs, dtype):
        """Rebuild the XC closure from packed operands (jit-traceable)."""
        if tag == "none":
            return None
        if tag == "table":
            return make_xc_fn(arrs["ao"], arrs["grad"], arrs["w"], self.xc)
        return make_xc_fn_streaming(
            self.mol, arrs["coords"], arrs["points"], arrs["weights"],
            self.xc, dtype=dtype,
        )

    def _build_xc(self, dtype):
        tag, arrs = self._xc_pack(dtype)
        return self._xc_from(tag, arrs, dtype)

    @cached_property
    def _xc_meta(self):
        """(terms, hyb, rsh) of the functional; HF when xc is None."""
        if self.xc is None:
            return [], 1.0, None
        return resolve_functional(self.xc)

    @property
    def _rsh(self):
        """(beta, omega) of a range-separated hybrid, else None."""
        return self._xc_meta[2]

    @cached_property
    def _xc(self):
        """(xc_fn or None, hyb).

        For range-separated hybrids the reported hyb is 1.0: the
        (hyb, beta, omega) exchange weights are folded into :attr:`eri_k`
        (and the DF K build), so ``-hyb*K`` stays the universal contraction.
        """
        terms, hyb, rsh = self._xc_meta
        if rsh is not None:
            hyb = 1.0
        if not terms:
            return None, hyb
        return self._build_xc(jnp.float64), hyb

    @property
    def hyb(self):
        return self._xc[1]

    @property
    def xc_fn(self):
        return self._xc[0]

    @cached_property
    def _f32_ops(self):
        """f32 casts of the SCF operators for the mixed-precision warm-up
        (opt-in ``warmup_f32``): coarse Fock builds in f32, the final
        iterations refined in f64."""
        f32 = jnp.float32
        ops = {
            "hcore": self.hcore.astype(f32),
            "s": self.s.astype(f32),
            "eri_j": self.eri_j.astype(f32),
            "eri_k": self.eri_k.astype(f32),
        }
        xc_fn, hyb = self._xc
        ops["xc_fn"] = None if xc_fn is None else self._build_xc(f32)
        ops["hyb"] = hyb
        return ops

    @cached_property
    def _jk_fast_fn(self):
        """f32 J/K closure for incremental Fock builds, or None.

        The f64 SCF contracts only density *changes* through this path (see
        :func:`run_scf`), so its f32 error decays with ``|dD|``.
        """
        if not self.incremental_jk:
            return None
        if self.density_fitting:
            b32 = self._df_b.astype(jnp.float32)
            b32_lr = (None if self._rsh is None
                      else self._df_b_lr.astype(jnp.float32))

            def jk(dm32):
                d_tot = dm32[0] + dm32[1]
                rho = jnp.einsum("abP,ab->P", b32, d_tot)
                j = jnp.einsum("abP,P->ab", b32, rho)
                ce = self._df_chunk_elems
                k = jnp.stack([_df_k_spin(b32, dm32[0], ce),
                               _df_k_spin(b32, dm32[1], ce)])
                if b32_lr is not None:
                    k_lr = jnp.stack([_df_k_spin(b32_lr, dm32[0], ce),
                                      _df_k_spin(b32_lr, dm32[1], ce)])
                    k = self._xc_meta[1] * k + self._rsh[0] * k_lr
                return j, k

            return jk
        ops = self._f32_ops
        gj, gk = ops["eri_j"], ops["eri_k"]
        n = self.mol.nao

        def jk(dm32):
            j = (gj @ (dm32[0] + dm32[1]).reshape(-1)).reshape(n, n)
            k = (gk @ dm32.reshape(2, n * n).T).T.reshape(2, n, n)
            return j, k

        return jk

    @cached_property
    def _xc_fast_fn(self):
        """f32 XC closure for coarse SCF iterations (None when the
        incremental path is off or the method has no XC)."""
        if self._jk_fast_fn is None or self._xc[0] is None:
            return None
        if self.density_fitting:
            # _f32_ops would materialise the exact O(N^4) ERI supermatrices
            return self._build_xc(jnp.float32)
        return self._f32_ops["xc_fn"]

    @cached_property
    def _df_b(self):
        """Metric-folded DF factor B[a,b,P] with (ab|cd) ~ sum_P B_abP B_cdP."""
        return jnp.asarray(df_b_factor(self.mol, self.coords, self.df_beta))

    @cached_property
    def _df_b_lr(self):
        """DF factor in the long-range erf(omega*r12)/r12 metric (RSH K)."""
        _, omega = self._rsh
        return jnp.asarray(
            df_b_factor(self.mol, self.coords, self.df_beta, omega=omega)
        )

    def _df_jk_from(self, b, b_lr, dm):
        """DF J/K from explicit factors (jit-traceable; see :meth:`_df_jk`)."""
        d_tot = dm[0] + dm[1]
        rho = jnp.einsum("abP,ab->P", b, d_tot)
        j = jnp.einsum("abP,P->ab", b, rho)
        ce = self._df_chunk_elems
        k = jnp.stack([_df_k_spin(b, dm[0], ce), _df_k_spin(b, dm[1], ce)])
        if b_lr is not None:
            k_lr = jnp.stack([_df_k_spin(b_lr, dm[0], ce),
                              _df_k_spin(b_lr, dm[1], ce)])
            k = self._xc_meta[1] * k + self._rsh[0] * k_lr
        return j, k

    def _df_jk(self, dm):
        """DF J/K: Coulomb via the fitted density, exchange via a signed
        eigen-decomposed density (valid for any symmetric density, incl.
        the non-PSD delta densities of the incremental path).  For
        range-separated hybrids K is the folded hyb*K + beta*K_LR."""
        b_lr = self._df_b_lr if self._rsh is not None else None
        return self._df_jk_from(self._df_b, b_lr, dm)

    def _sad_guess(self):
        """Superposition-of-atomic-densities guess: block-diagonal assembly
        of cached per-element neutral-atom UHF densities."""
        from ..chem.periodic import Z_TO_SYMBOL

        n = self.mol.nao
        dm = np.zeros((n, n))
        sl = self.mol.aoslice_by_atom()
        for ia, z in enumerate(self.mol.atom_charges):
            blk = _atomic_density(Z_TO_SYMBOL[int(z)], self.mol.basis)
            p0, p1 = int(sl[ia, 2]), int(sl[ia, 3])
            dm[p0:p1, p0:p1] = blk
        return np.stack([dm, dm])

    # -------------------------------------------------- fused jitted kernel
    @cached_property
    def _use_jit_kernel(self) -> bool:
        """Fused programs on any accelerator; eager on the CPU, where a
        dispatch costs nothing and the eager path skips the compile."""
        import jax

        mode = self.jit_kernel
        return mode == "on" or (mode == "auto"
                                and jax.default_backend() != "cpu")

    @cached_property
    def _jit_spec(self) -> tuple:
        """Structural cache key for shared jitted programs (geometry enters
        as jit arguments, so conformers of one molecule share a program)."""
        mol = self.mol
        return (
            tuple(int(z) for z in np.asarray(mol.atom_charges)),
            mol.basis, mol.charge, mol.spin,
            self.mol.mm_coords is not None,
            self.xc, self.rohf, self.density_fitting, float(self.df_beta),
            self.incremental_jk, int(self.rebase_every),
            self.grid_scheme, tuple(self.grid_size), int(self.grid_level),
            # chunk sizes shape the traced program
            self._df_chunk_elems, float(self._XC_TABLE_LIMIT),
        )

    def _shared_jit(self, kind: str, build):
        key = (kind, self._jit_spec)
        fn = _JIT_PROGRAM_CACHE.get(key)
        if fn is None:
            while len(_JIT_PROGRAM_CACHE) >= _JIT_PROGRAM_CACHE_MAX:
                _JIT_PROGRAM_CACHE.pop(next(iter(_JIT_PROGRAM_CACHE)))
            fn = build()
        else:
            # LRU, not FIFO: promote on hit so a hot engine interleaved
            # with many cold ones keeps its program (a full retrace
            # otherwise)
            del _JIT_PROGRAM_CACHE[key]
        _JIT_PROGRAM_CACHE[key] = fn
        return fn

    @property
    def _hyb_eff(self) -> float:
        """HF-exchange weight as consumed by run_scf (1.0 under RSH, where
        the range weights are folded into :attr:`eri_k` / the DF K)."""
        _, hyb, rsh = self._xc_meta
        return 1.0 if rsh is not None else hyb

    @cached_property
    def _kernel_operands(self):
        """Big device operands for the fused kernel, passed as jit ARGUMENTS
        (a closure-captured device array lowers to an HLO constant embedded
        in the program)."""
        arrs = {"hcore": self.hcore, "s": self.s}
        if self.density_fitting:
            arrs["df_b"] = self._df_b
            if self._rsh is not None:
                arrs["df_b_lr"] = self._df_b_lr
        else:
            arrs["eri_j"] = self.eri_j
            arrs["eri_k"] = self.eri_k
        tag, xc_arrs = self._xc_pack(jnp.float64)
        for key, val in xc_arrs.items():
            arrs["xc_" + key] = val
        return arrs

    def _rebuild_fns(self, arrs):
        """(jk_fn, jk_fast, xc_fn, xc_fast, eri_j, eri_k) from jit-arg
        operands — closures capture tracers, never concrete big arrays."""
        f32 = jnp.float32
        tag, _ = self._xc_pack(jnp.float64)
        xc_arrs = {k[3:]: v for k, v in arrs.items() if k.startswith("xc_")}
        xc_fn = self._xc_from(tag, xc_arrs, jnp.float64)
        if self.density_fitting:
            b, b_lr = arrs["df_b"], arrs.get("df_b_lr")
            eri_j = eri_k = None

            def jk_fn(dm):
                return self._df_jk_from(b, b_lr, dm)
        else:
            eri_j, eri_k = arrs["eri_j"], arrs["eri_k"]
            jk_fn = None

        jk_fast = None
        xc_fast = None
        if self.incremental_jk:
            if self.density_fitting:
                b32 = arrs["df_b"].astype(f32)
                b32_lr = (arrs["df_b_lr"].astype(f32)
                          if "df_b_lr" in arrs else None)

                def jk_fast(dm32):
                    return self._df_jk_from(b32, b32_lr, dm32)
            else:
                gj32, gk32 = eri_j.astype(f32), eri_k.astype(f32)
                n = self.mol.nao

                def jk_fast(dm32):
                    j = (gj32 @ (dm32[0] + dm32[1]).reshape(-1))
                    k = (gk32 @ dm32.reshape(2, n * n).T).T
                    return j.reshape(n, n), k.reshape(2, n, n)
            if xc_fn is not None:
                xc32 = {k: v.astype(f32) for k, v in xc_arrs.items()} \
                    if tag == "table" else xc_arrs
                xc_fast = self._xc_from(tag, xc32, f32)
        return jk_fn, jk_fast, xc_fn, xc_fast, eri_j, eri_k

    @cached_property
    def _jitted_kernel(self):
        """One compiled program per call signature: f32 warm-up + SCF loop +
        polish + final Fock, one dispatch instead of hundreds of eager
        ops."""
        import jax

        def body(arrs, v_emb, dm0, dm_env_occ, dm_env_virt, *,
                 nelec, conv_tol, dm_conv_tol, max_cycle, level_shift,
                 warmup):
            f32 = jnp.float32
            hcore, s = arrs["hcore"], arrs["s"]
            jk_fn, jk_fast, xc_fn, xc_fast, eri_j, eri_k = \
                self._rebuild_fns(arrs)
            hyb = self._hyb_eff
            if warmup:
                # f32 pre-SCF seeding the f64 solve (same role as the
                # eager-path _f32_ops warm-up)
                if self.density_fitting:
                    b32 = arrs["df_b"].astype(f32)
                    b32_lr = (arrs["df_b_lr"].astype(f32)
                              if "df_b_lr" in arrs else None)

                    def wjk(dm32):
                        return self._df_jk_from(b32, b32_lr, dm32)

                    weri_j = weri_k = None
                else:
                    wjk = None
                    weri_j = arrs["eri_j"].astype(f32)
                    weri_k = arrs["eri_k"].astype(f32)
                tag, _ = self._xc_pack(jnp.float64)
                xc_arrs = {k[3:]: v for k, v in arrs.items()
                           if k.startswith("xc_")}
                if xc_fn is not None:
                    xc32 = {k: v.astype(f32) for k, v in xc_arrs.items()} \
                        if tag == "table" else xc_arrs
                    wxc = self._xc_from(tag, xc32, f32)
                else:
                    wxc = None
                warm = run_scf(
                    hcore=hcore.astype(f32), s=s.astype(f32),
                    eri_j=weri_j, eri_k=weri_k, jk_fn=wjk,
                    dm0=None if dm0 is None else dm0.astype(f32),
                    nelec=nelec,
                    v_emb=None if v_emb is None else v_emb.astype(f32),
                    xc_fn=wxc, hyb=hyb,
                    dm_env_occ=(None if dm_env_occ is None
                                else dm_env_occ.astype(f32)),
                    dm_env_virt=(None if dm_env_virt is None
                                 else dm_env_virt.astype(f32)),
                    conv_tol=1e-4, dm_conv_tol=1e-3, max_cycle=max_cycle,
                    rohf=self.rohf,
                )
                dm0 = warm.dm.astype(jnp.float64)
            return run_scf(
                hcore=hcore, s=s, eri_j=eri_j, eri_k=eri_k, jk_fn=jk_fn,
                jk_fn_fast=jk_fast, xc_fn_fast=xc_fast,
                rebase_every=self.rebase_every,
                nelec=nelec, v_emb=v_emb, xc_fn=xc_fn, hyb=hyb,
                dm_env_occ=dm_env_occ, dm_env_virt=dm_env_virt, dm0=dm0,
                conv_tol=conv_tol, dm_conv_tol=dm_conv_tol,
                max_cycle=max_cycle, level_shift=level_shift,
                rohf=self.rohf,
            )

        # max_cycle is a TRACED operand, not static: the while_loop bound
        # is data-dependent-safe in XLA, and keeping it dynamic means one
        # compiled program serves every cycle count.
        return self._shared_jit("kernel", lambda: jax.jit(
            body, static_argnames=(
                "nelec", "conv_tol", "dm_conv_tol",
                "level_shift", "warmup",
            )))

    # ------------------------------------------------------------ methods
    def energy_nuc(self):
        return float(self.mol.energy_nuc(jnp.asarray(self.coords)))

    @cached_property
    def _jitted_veff(self):
        """One-dispatch veff for the driver's subsystem-DFT stage."""
        import jax

        def body(arrs, dm):
            jk_fn, _, xc_fn, _, eri_j, eri_k = self._rebuild_fns(arrs)
            if jk_fn is not None:
                j, k = jk_fn(dm)
            else:
                n = self.mol.nao
                j = (eri_j @ (dm[0] + dm[1]).reshape(-1)).reshape(n, n)
                k = (eri_k @ dm.reshape(2, n * n).T).T.reshape(2, n, n)
            return self._veff_math(dm, j, k, xc_fn, self._hyb_eff)

        return self._shared_jit("veff", lambda: jax.jit(body))

    def get_jk(self, dm):
        dm = _spinify(dm)
        if self.density_fitting:
            return self._df_jk(dm)
        n = self.mol.nao
        j = (self.eri_j @ (dm[0] + dm[1]).reshape(-1)).reshape(n, n)
        k = (self.eri_k @ dm.reshape(2, n * n).T).T.reshape(2, n, n)
        return j, k

    @staticmethod
    def _veff_math(dm, j, k, xc_fn, hyb) -> VeffResult:
        if xc_fn is not None:
            exc, vxc = xc_fn(dm)
        else:
            exc, vxc = jnp.asarray(0.0), jnp.zeros_like(dm)
        v = j[None] + vxc - hyb * k
        ecoul = 0.5 * jnp.einsum("ij,ji->", j, dm[0] + dm[1])
        exc = exc - 0.5 * hyb * jnp.einsum("sij,sji->", k, dm)
        return VeffResult(matrix=v, ecoul=ecoul, exc=exc)

    def get_veff(self, dm) -> VeffResult:
        """J + Vxc - hyb*K with pyscf-compatible energy components
        (used by subsystem DFT, reference driver.py:344-345,391)."""
        dm = _spinify(dm)
        if self._use_jit_kernel:
            return self._jitted_veff(self._kernel_operands, dm)
        j, k = self.get_jk(dm)
        xc_fn, hyb = self._xc
        return self._veff_math(dm, j, k, xc_fn, hyb)

    @cached_property
    def _jitted_subsys(self):
        import jax

        def body(arrs, dm_act, dm_env):
            jk_fn, _, xc_fn, _, eri_j, eri_k = self._rebuild_fns(arrs)
            hyb = self._hyb_eff
            n = self.mol.nao
            h = arrs["hcore"]

            def jk(dm):
                if jk_fn is not None:
                    return jk_fn(dm)
                j = (eri_j @ (dm[0] + dm[1]).reshape(-1)).reshape(n, n)
                k = (eri_k @ dm.reshape(2, n * n).T).T.reshape(2, n, n)
                return j, k

            def comp(dm):
                j, k = jk(dm)
                v = self._veff_math(dm, j, k, xc_fn, hyb)
                e = jnp.einsum("ij,ji->", h, dm[0] + dm[1]) + v.ecoul + v.exc
                return e, v, j

            e_act, v_act, j_act = comp(dm_act)
            e_env, v_env, j_env = comp(dm_env)
            _, v_tot, _ = comp(dm_act + dm_env)
            j_cross = 0.5 * (
                jnp.einsum("ij,ij", dm_act[0] + dm_act[1], j_env)
                + jnp.einsum("ij,ij", dm_env[0] + dm_env[1], j_act)
            )
            xc_cross = v_tot.exc - v_act.exc - v_env.exc
            return (e_act, e_env, j_cross + xc_cross,
                    v_tot.matrix - v_act.matrix)

        return self._shared_jit("subsys", lambda: jax.jit(body))

    def subsystem_decomposition(self, dm_act, dm_env):
        """(e_act, e_env, two_e_cross, embedding_potential) in ONE compiled
        program — the driver's subsystem-DFT stage (reference
        driver.py:315-431 + the veff difference at driver.py:845-851) fused
        so an accelerator pays one dispatch instead of seven."""
        dm_act, dm_env = _spinify(dm_act), _spinify(dm_env)
        if self._use_jit_kernel:
            e_act, e_env, cross, v_emb = self._jitted_subsys(
                self._kernel_operands, dm_act, dm_env
            )
            return float(e_act), float(e_env), float(cross), np.asarray(v_emb)
        v_act = self.get_veff(dm_act)
        v_env = self.get_veff(dm_env)
        v_tot = self.get_veff(dm_act + dm_env)
        j_act = self.get_j(dm_act)
        j_env = self.get_j(dm_env)
        h = np.asarray(self.hcore)
        e_act = float(np.einsum("ij,ji->", h, np.asarray(dm_act[0] + dm_act[1]))
                      + v_act.ecoul + v_act.exc)
        e_env = float(np.einsum("ij,ji->", h, np.asarray(dm_env[0] + dm_env[1]))
                      + v_env.ecoul + v_env.exc)
        j_cross = 0.5 * float(
            np.einsum("ij,ij", np.asarray(dm_act[0] + dm_act[1]),
                      np.asarray(j_env))
            + np.einsum("ij,ij", np.asarray(dm_env[0] + dm_env[1]),
                        np.asarray(j_act))
        )
        xc_cross = float(v_tot.exc) - float(v_act.exc) - float(v_env.exc)
        v_emb = np.asarray(v_tot.matrix) - np.asarray(v_act.matrix)
        return e_act, e_env, j_cross + xc_cross, v_emb

    def get_j(self, dm):
        return self.get_jk(dm)[0]

    def kernel(
        self,
        nelec=None,
        v_emb=None,
        dm_env_occ=None,
        dm_env_virt=None,
        dm0=None,
        conv_tol=None,
        dm_conv_tol=None,
        max_cycle=None,
        level_shift=0.0,
    ) -> "SCFSolution":
        """Run SCF; all embedding terms are explicit arguments."""
        nelec = self.mol.nelec if nelec is None else nelec
        xc_fn, hyb = self._xc
        if self.density_fitting:
            self._df_b  # noqa: B018 — materialise outside any jax trace
            if self._rsh is not None:
                self._df_b_lr  # noqa: B018
        from_guess = False
        if (dm0 is None and self.init_guess == "sad"
                and tuple(nelec) == tuple(self.mol.nelec) and v_emb is None):
            # full-molecule SCF: seed from atomic densities (embedded-SCF
            # calls keep the reference's modified-hcore guess)
            dm0 = self._sad_guess()
            from_guess = True
        if self._use_jit_kernel:
            common = dict(
                nelec=tuple(int(x) for x in nelec),
                conv_tol=float(self.conv_tol if conv_tol is None
                               else conv_tol),
                dm_conv_tol=float(self.dm_conv_tol if dm_conv_tol is None
                                  else dm_conv_tol),
                level_shift=float(level_shift),
            )
            args = (
                None if v_emb is None else jnp.asarray(v_emb),
                None if dm_env_occ is None else _spinify(dm_env_occ),
                None if dm_env_virt is None else _spinify(dm_env_virt),
            )
            warmup = bool(self.warmup_f32 and (dm0 is None or from_guess))
            res = self._jitted_kernel(
                self._kernel_operands, args[0],
                None if dm0 is None else _spinify(dm0), args[1], args[2],
                max_cycle=int(self.max_cycle if max_cycle is None
                              else max_cycle),
                warmup=warmup, **common)
            return self._package(res, nelec, v_emb, dm_env_occ)
        if self.warmup_f32 and (dm0 is None or from_guess):
            f32 = jnp.float32
            ops = self._f32_ops
            warm = run_scf(
                hcore=ops["hcore"], s=ops["s"],
                eri_j=ops["eri_j"], eri_k=ops["eri_k"],
                dm0=None if dm0 is None else _spinify(dm0).astype(f32),
                nelec=nelec,
                v_emb=None if v_emb is None else jnp.asarray(v_emb, f32),
                xc_fn=ops["xc_fn"], hyb=ops["hyb"],
                dm_env_occ=(None if dm_env_occ is None
                            else _spinify(dm_env_occ).astype(f32)),
                dm_env_virt=(None if dm_env_virt is None
                             else _spinify(dm_env_virt).astype(f32)),
                conv_tol=1e-4, dm_conv_tol=1e-3,
                max_cycle=self.max_cycle if max_cycle is None else max_cycle,
                rohf=self.rohf,
            )
            dm0 = warm.dm.astype(jnp.float64)
        res = run_scf(
            hcore=self.hcore,
            s=self.s,
            eri_j=None if self.density_fitting else self.eri_j,
            eri_k=None if self.density_fitting else self.eri_k,
            jk_fn=self._df_jk if self.density_fitting else None,
            jk_fn_fast=self._jk_fast_fn,
            xc_fn_fast=self._xc_fast_fn,
            rebase_every=self.rebase_every,
            nelec=nelec,
            v_emb=None if v_emb is None else jnp.asarray(v_emb),
            xc_fn=xc_fn,
            hyb=hyb,
            dm_env_occ=None if dm_env_occ is None else _spinify(dm_env_occ),
            dm_env_virt=None if dm_env_virt is None else _spinify(dm_env_virt),
            dm0=None if dm0 is None else _spinify(dm0),
            conv_tol=self.conv_tol if conv_tol is None else conv_tol,
            dm_conv_tol=self.dm_conv_tol if dm_conv_tol is None else dm_conv_tol,
            max_cycle=self.max_cycle if max_cycle is None else max_cycle,
            level_shift=level_shift,
            rohf=self.rohf,
        )
        return self._package(res, nelec, v_emb, dm_env_occ)

    def _package(self, res, nelec, v_emb, dm_env_occ) -> "SCFSolution":
        """SCFResult (device arrays) -> SCFSolution (host result object)."""
        e_tot = float(res.e_elec) + self.energy_nuc()
        if not bool(res.converged):
            logger.warning("SCF has NOT converged (%s cycles).", int(res.n_iter))
        if self.restricted:
            if nelec[0] != nelec[1]:
                raise ValueError("Restricted reporting requires n_alpha == n_beta.")
            return SCFSolution(
                engine=self,
                nelec=tuple(int(x) for x in nelec),
                mo_coeff=np.asarray(res.mo_coeff[0]),
                mo_energy=np.asarray(res.mo_energy[0]),
                mo_occ=2.0 * np.asarray(res.mo_occ[0]),
                e_tot=e_tot,
                converged=bool(res.converged),
                v_emb=None if v_emb is None else np.asarray(v_emb),
                huzinaga_op=(
                    np.asarray(res.huzinaga_op[0]) if dm_env_occ is not None else None
                ),
                n_iter=int(res.n_iter),
            )
        return SCFSolution(
            engine=self,
            nelec=tuple(int(x) for x in nelec),
            mo_coeff=np.asarray(res.mo_coeff),
            mo_energy=np.asarray(res.mo_energy),
            mo_occ=np.asarray(res.mo_occ),
            e_tot=e_tot,
            converged=bool(res.converged),
            v_emb=None if v_emb is None else np.asarray(v_emb),
            huzinaga_op=np.asarray(res.huzinaga_op) if dm_env_occ is not None else None,
            n_iter=int(res.n_iter),
        )


@dataclass(eq=False)
class SCFSolution:
    """Mutable result container (the driver edits MO sets in-place when
    deleting environment orbitals / localizing virtuals, mirroring the
    reference's writes to PySCF objects, driver.py:593-630)."""

    engine: SCFEngine
    nelec: tuple
    mo_coeff: np.ndarray  # (2, n, k)
    mo_energy: np.ndarray  # (2, k)
    mo_occ: np.ndarray  # (2, k) in electrons per spin orbital (0/1)
    e_tot: float
    converged: bool
    v_emb: Optional[np.ndarray] = None  # (2, n, n)
    huzinaga_op: Optional[np.ndarray] = None
    n_iter: Optional[int] = None  # SCF cycles taken

    @property
    def mol(self) -> Molecule:
        return self.engine.mol

    def copy(self) -> "SCFSolution":
        return SCFSolution(
            engine=self.engine,
            nelec=self.nelec,
            mo_coeff=np.array(self.mo_coeff),
            mo_energy=np.array(self.mo_energy),
            mo_occ=np.array(self.mo_occ),
            e_tot=self.e_tot,
            converged=self.converged,
            v_emb=None if self.v_emb is None else np.array(self.v_emb),
            huzinaga_op=(
                None if self.huzinaga_op is None else np.array(self.huzinaga_op)
            ),
            n_iter=self.n_iter,
        )

    # -------------------------------------------------- pyscf-like surface
    def get_hcore(self):
        """Core Hamiltonian including the embedding potential — the explicit
        analogue of the reference's patched ``get_hcore`` (driver.py:527)."""
        h = np.asarray(self.engine.hcore)
        if self.v_emb is None:
            return h
        return h[None] + np.asarray(self.v_emb)

    @property
    def restricted(self) -> bool:
        return np.asarray(self.mo_coeff).ndim == 2

    def make_rdm1(self):
        c = np.asarray(self.mo_coeff)
        if self.restricted:
            return np.einsum("pi,i,qi->pq", c, np.asarray(self.mo_occ), c)
        return np.asarray(
            make_rdm1(jnp.asarray(self.mo_coeff), jnp.asarray(self.mo_occ))
        )

    def get_fock(self):
        """Fock matrix (incl. v_emb and Huzinaga term) at the current
        density; (n, n) for restricted solutions, else (2, n, n)."""
        dm = self.make_rdm1()
        veff = self.engine.get_veff(dm)
        h = self.get_hcore()
        if h.ndim == 2:
            h = h[None]
        f = h + np.asarray(veff.matrix)
        if self.huzinaga_op is not None:
            huz = self.huzinaga_op
            f = f + (huz[None] if huz.ndim == 2 else huz)
        if self.restricted:
            return f[0]
        return f

    def energy_nuc(self):
        return self.engine.energy_nuc()

    def energy_elec(self, dm=None):
        """(e_elec, e_coul) at the given (default: current) density, with
        v_emb folded into the one-body term — matching the reference's
        patched ``energy_elec`` (scf/embedded_hcore_funcs.py:11-46)."""
        dm = self.make_rdm1() if dm is None else np.asarray(_spinify(dm))
        veff = self.engine.get_veff(dm)
        h = self.get_hcore()
        if h.ndim == 2:
            h = h[None]
        e1 = np.einsum("sij,sji->", h, dm)
        xc_fn, hyb = self.engine._xc
        if xc_fn is None:
            j, k = self.engine.get_jk(dm)
            e_coul = 0.5 * (
                np.einsum("ij,ji->", np.asarray(j), dm[0] + dm[1])
                - np.einsum("sij,sji->", np.asarray(k), dm)
            )
            return float(e1 + e_coul), float(e_coul)
        # pyscf KS energy_elec returns e2 = ecoul + exc as second element
        e2 = veff.ecoul + veff.exc
        return float(e1 + e2), float(e2)

    def spin_square(self):
        """(<S^2>, 2S+1) of the (broken-symmetry) determinant — the UHF
        spin-contamination diagnostic (beyond the reference, which never
        surfaces it although its driver is always unrestricted):
        <S^2> = S_z(S_z+1) + N_beta - sum_ij |<phi_i^a|S|phi_j^b>|^2
        over occupied orbitals."""
        c = np.asarray(self.mo_coeff)
        occ = np.asarray(self.mo_occ)
        if c.ndim == 2:  # restricted-collapsed: a pure singlet/high-spin CSF
            ca = cb = c[:, occ > 0.5]
        else:
            ca = c[0][:, occ[0] > 0.5]
            cb = c[1][:, occ[1] > 0.5]
        s = np.asarray(self.engine.s)
        ovlp = ca.T @ s @ cb
        na, nb = ovlp.shape
        sz = 0.5 * (na - nb)
        s2 = sz * (sz + 1.0) + nb - float(np.sum(ovlp * ovlp))
        return float(s2), 2.0 * np.sqrt(s2 + 0.25)
