"""The WHOLE mu-embedding pipeline as one jittable function of geometry.

Beyond both the reference and this package's host-orchestrated driver:
``make_mu_embed_energy`` compiles global KS -> SPADE partition ->
subsystem-DFT energy decomposition -> mu-shift embedded HF -> embedded
total-energy assembly into a SINGLE pure XLA program ``coords ->
e_emb_rhf``, so the full WF-in-DFT energy can be

``vmap``-ed over conformer fleets (reaction paths, scans) with the
batch axis sharded over the mesh — the batched form of the
reference's ACE reaction-path workflow (its per-geometry Python
pipeline, reference ace.py:54-85, becomes one batched device program).

The one data-dependent decision in the driver's pipeline — SPADE's
largest-singular-value-gap choice of the active-space size (reference
occupied/spade.py:113-121) — is not traceable (it changes array
shapes), so the active-MO count is a STATIC argument here, exactly like
the reference's own ``n_mo_overwrite`` path that ACE feeds
(reference ace.py -> spade.py:98-123). Run the host driver (or
:class:`nbed_tpu.localizers.ACELocalizer`) once to fix ``n_act_mos``,
then scan geometries with this program.

Energy assembly follows the driver (driver.py `_mu_embed`/`post_embed`,
reference driver.py:500-538, 981-998):

    e_rhf = e_tot(embedded HF with v_emb) + e_env + two_e_cross
            - sum_s Tr(v_emb_s D_act_s)

with v_emb = mu * S D_env S + (veff[D_tot] - veff[D_act]).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from ..chem.molecule import Molecule
from ..integrals import eri_tensor, kinetic, nuclear_attraction, overlap
from ..scf.hf import run_scf

__all__ = ["make_mu_embed_energy", "batched_embedding_energies"]


@partial(jax.custom_jvp, nondiff_argnums=(1,))
def _topk_projector(m, k: int):
    """Projector onto the top-k eigenspace of symmetric ``m``.

    The SPADE split only needs the active *subspace*, not individual
    singular vectors — and the subspace projector stays differentiable
    under internal degeneracies (water: the O 1s core and the
    out-of-plane lone pair both lie entirely on O, so two singular
    values are exactly 1 and the plain SVD/eigh jvp divides by a zero
    gap -> NaN in every forward-mode geometry derivative). The custom
    tangent keeps only the cross-gap response

        dP = sum_{i in act, a in env} (v_i v_a^T + h.c.)
             (v_i^T dM v_a) / (lam_i - lam_a),

    which is the exact derivative of the projector and only requires
    the SPADE gap itself (lam_k > lam_{k+1}) to be open.
    """
    _, v = jnp.linalg.eigh(m)
    vk = v[:, m.shape[-1] - k:]
    return vk @ vk.T


@_topk_projector.defjvp
def _topk_projector_jvp(k, primals, tangents):
    (m,), (dm,) = primals, tangents
    n = m.shape[-1]
    w, v = jnp.linalg.eigh(m)
    vk, vr = v[:, n - k:], v[:, : n - k]
    p = vk @ vk.T
    denom = w[n - k:][None, :] - w[: n - k][:, None]  # (n-k, k), gap-only
    g = (vr.T @ dm @ vk) / denom
    dp_half = vr @ g @ vk.T
    return p, dp_half + dp_half.T


def make_mu_embed_energy(mol: Molecule, n_active_atoms: int, n_act_mos,
                         xc: str = "b3lyp", mu_level_shift: float = 1e6,
                         conv_tol: float = 1e-9, dm_conv_tol: float = 1e-7,
                         max_cycle: int = 100, grid_level: int = 3,
                         projector: str = "mu", grad_cycles: int = 0):
    """Build the jittable ``energy(coords) -> dict`` embedding program.

    Args:
        mol: molecule (atom/basis structure; geometry comes per call).
        n_active_atoms: leading atoms forming the active fragment.
        n_act_mos: STATIC active-MO count — an int, or a per-spin
            ``(n_alpha, n_beta)`` tuple (open shell). Fix it with one
            host-driver/ACE run, as the reference fixes n_mo_overwrite.
        xc: environment functional — pure, global-hybrid, or
            range-separated hybrid (the LR ERI tensor is folded into the
            exchange supermatrix as ``hyb*K + beta*K_LR``, the engine's
            convention).
        mu_level_shift: the mu projector shift (reference config default).
        projector: "mu" (level-shift projector in v_emb) or "huzinaga"
            (the −(FDS + SDF) operator inside the jitted SCF loop; the
            converged operator is frozen into v_emb for the correction,
            as the driver does, reference driver.py:595-597).

    Returns a pure function of ``coords`` (natm, 3, bohr) returning
    ``{"e_emb_rhf", "e_global", "e_act", "e_env", "two_e_cross",
    "converged"}`` — jit/vmap-compatible.

    Differentiability: forward-mode geometry derivatives require the SPADE
    eigenvalue gap at the active/environment split (``lam_k > lam_{k+1}``)
    to be OPEN along the whole path — the custom projector jvp divides by
    that gap.  ``n_act_mos > n_act_aos`` (gap structurally zero) is
    rejected at build time; a gap that *closes along a reaction path* is a
    physical degeneracy the caller must resolve by choosing a different
    ``n_act_mos`` (as the reference's ACE fit does).
    """
    if projector not in ("mu", "huzinaga"):
        raise ValueError(f"unknown projector {projector!r}")
    from ..dft.functionals import resolve_functional
    from ..dft.xc import _chunk_math, _mask_thresh

    terms, hyb, rsh = resolve_functional(xc) if xc else ([], 1.0, None)
    one_chunk = _chunk_math(terms, _mask_thresh(jnp.float64)) if terms else None

    n = mol.nao
    n_act_aos = int(mol.aoslice_by_atom()[n_active_atoms - 1][-1])
    n_occ = tuple(int(x) for x in mol.nelec)  # per-spin occupied counts
    if np.ndim(n_act_mos) == 0:
        n_act = (int(n_act_mos), int(n_act_mos))
    else:
        n_act = (int(n_act_mos[0]), int(n_act_mos[1]))
    if any(n_act[s] > n_occ[s] for s in range(2)):
        raise ValueError(f"n_act_mos {n_act} exceeds occupied {n_occ}.")
    if any(n_act[s] > n_act_aos for s in range(2)):
        # rank(A^T A) <= n_act_aos for the (n_act_aos, n_occ) SPADE block:
        # more active MOs than active-AO rows makes the top-k eigenvalue
        # gap identically zero and every forward-mode geometry derivative
        # through _topk_projector_jvp divides by that zero gap (NaN).  The
        # SPADE gap being OPEN (lam_k > lam_{k+1}) is a standing
        # requirement of the jvp rule; this static check rejects the one
        # structurally guaranteed violation at build time.
        raise ValueError(
            f"n_act_mos {n_act} exceeds the active-AO count {n_act_aos}: "
            "the SPADE overlap block cannot have that many nonzero "
            "singular values (zero gap -> NaN geometry derivatives)."
        )

    def energy(coords):
        coords = jnp.asarray(coords)
        s = overlap(mol, coords)
        hcore = kinetic(mol, coords) + nuclear_attraction(mol, coords)
        eri = eri_tensor(mol, coords)
        eri_j = eri.reshape(n * n, n * n)
        eri_k = jnp.transpose(eri, (0, 2, 1, 3)).reshape(n * n, n * n)
        if rsh is not None:
            # fold the RSH exchange once: hyb*K + beta*K_LR, reported hyb=1
            # (the engine's convention, scf/engine.py `eri_k`); the
            # *embedded* HF below keeps the unfolded full-range eri_k.
            eri_lr = eri_tensor(mol, coords, omega=rsh[1])
            eri_k_xc = hyb * eri_k + rsh[0] * jnp.transpose(
                eri_lr, (0, 2, 1, 3)).reshape(n * n, n * n)
            hyb_xc = 1.0
        else:
            eri_k_xc, hyb_xc = eri_k, hyb
        e_nuc = mol.energy_nuc(coords)

        if one_chunk is not None:
            from ..grids import build_grid, eval_aos

            pts, w = build_grid(mol, coords, level=grid_level)
            ao, grad = eval_aos(mol, pts, coords)

            def xc_fn(dm):
                return one_chunk(ao, grad, w, dm)
        else:
            xc_fn = None

        # ---- global KS (the reference's _global_ks, driver.py:155-191)
        glob = run_scf(
            hcore=hcore, s=s, eri_j=eri_j, eri_k=eri_k_xc, xc_fn=xc_fn,
            hyb=hyb_xc, nelec=n_occ, conv_tol=conv_tol,
            dm_conv_tol=dm_conv_tol, max_cycle=max_cycle,
            grad_cycles=grad_cycles,
        )
        e_global = glob.e_elec + e_nuc

        # ---- SPADE with a static active count (spade.py:98-134 semantics)
        w_s, v_s = jnp.linalg.eigh(s)
        s_half = (v_s * jnp.sqrt(w_s)[None, :]) @ v_s.T

        def spade(c_spin, n_o, k):
            # top-k right-singular subspace of the active-AO rows == top-k
            # eigenspace of A^T A; the projector form keeps geometry
            # derivatives finite under intra-block sigma degeneracies
            # (see _topk_projector)
            occ_c = c_spin[:, :n_o]
            a = (s_half @ occ_c)[:n_act_aos, :]
            p = _topk_projector(a.T @ a, k)
            dm_a = occ_c @ p @ occ_c.T
            return dm_a, occ_c @ occ_c.T - dm_a

        parts = [spade(glob.mo_coeff[sp], n_occ[sp], n_act[sp])
                 for sp in range(2)]
        dm_act = jnp.stack([p[0] for p in parts])
        dm_env = jnp.stack([p[1] for p in parts])

        # ---- subsystem-DFT decomposition (driver.py:315-431 semantics)
        def veff_parts(dm):
            j = (eri_j @ (dm[0] + dm[1]).reshape(-1)).reshape(n, n)
            k = (eri_k_xc @ dm.reshape(2, -1).T).T.reshape(2, n, n)
            if xc_fn is not None:
                exc, vxc = xc_fn(dm)
            else:
                exc, vxc = jnp.asarray(0.0), jnp.zeros_like(dm)
            v = j[None] + vxc - hyb_xc * k
            ecoul = 0.5 * jnp.einsum("ij,ji->", j, dm[0] + dm[1])
            exc = exc - 0.5 * hyb_xc * jnp.einsum("sij,sji->", k, dm)
            e = jnp.einsum("ij,ji->", hcore, dm[0] + dm[1]) + ecoul + exc
            return e, v, exc, j

        e_act, v_act, exc_act, j_act = veff_parts(dm_act)
        e_env, v_env, exc_env, j_env = veff_parts(dm_env)
        _, v_tot, exc_tot, _ = veff_parts(dm_act + dm_env)
        j_cross = 0.5 * (
            jnp.einsum("sij,ij->", dm_act, j_env)
            + jnp.einsum("sij,ij->", dm_env, j_act)
        )
        two_e_cross = j_cross + (exc_tot - exc_act - exc_env)

        # ---- embedded HF (mu: driver.py:500-538; huz: driver.py:540-632)
        v_pot = v_tot - v_act
        if projector == "mu":
            p_env = jnp.einsum("ij,sjk,kl->sil", s, dm_env, s)
            v_emb = mu_level_shift * p_env + v_pot
            emb = run_scf(
                hcore=hcore, s=s, eri_j=eri_j, eri_k=eri_k, nelec=n_act,
                v_emb=v_emb, dm0=dm_act, conv_tol=conv_tol,
                dm_conv_tol=dm_conv_tol, max_cycle=max_cycle,
                grad_cycles=grad_cycles,
            )
            v_corr = v_emb
        else:
            emb = run_scf(
                hcore=hcore, s=s, eri_j=eri_j, eri_k=eri_k, nelec=n_act,
                v_emb=v_pot, dm_env_occ=dm_env, dm0=dm_act,
                conv_tol=conv_tol, dm_conv_tol=dm_conv_tol,
                max_cycle=max_cycle, grad_cycles=grad_cycles,
            )
            # freeze the converged Huzinaga operator into v_emb for the
            # correction, as the driver does (reference driver.py:595-597)
            v_corr = emb.huzinaga_op + v_pot
        corr = jnp.einsum("sij,sij->", v_corr, dm_act)
        e_emb_rhf = (emb.e_elec + e_nuc) + e_env + two_e_cross - corr

        return {
            "e_emb_rhf": e_emb_rhf,
            "e_global": e_global,
            "e_act": e_act,
            "e_env": e_env,
            "two_e_cross": two_e_cross,
            "converged": jnp.logical_and(glob.converged, emb.converged),
        }

    return energy


def batched_embedding_energies(mol: Molecule, coords_batch,
                               n_active_atoms: int, n_act_mos,
                               mesh=None, **kwargs):
    """Embedded energies for a conformer batch from ONE compiled program.

    ``coords_batch``: (B, natm, 3) bohr. With a mesh, the batch axis is
    sharded over the mesh 'batch' axis (pure data parallelism: every
    lane runs global-KS -> SPADE -> mu-embedded-HF on its geometry).
    Returns the dict of stacked outputs from :func:`make_mu_embed_energy`.
    """
    fn = make_mu_embed_energy(mol, n_active_atoms, n_act_mos, **kwargs)
    coords_batch = jnp.asarray(coords_batch)
    vfn = jax.vmap(fn)
    if mesh is not None:
        sharding = NamedSharding(mesh, P("batch"))
        coords_batch = jax.device_put(
            coords_batch, NamedSharding(mesh, P("batch", None, None))
        )
        vfn = jax.jit(vfn, out_shardings={
            k: sharding for k in ("e_emb_rhf", "e_global", "e_act", "e_env",
                                  "two_e_cross", "converged")
        })
    else:
        vfn = jax.jit(vfn)
    return vfn(coords_batch)
