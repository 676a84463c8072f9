"""Mesh construction, sharded SCF, and conformer-batched energies.

Design (cf. the scaling-book recipe): pick a mesh, annotate shardings on the
big operands, let XLA insert the collectives.

- ERI supermatrices ``(N^2, N^2)`` are sharded row-wise over the 'model'
  axis: each device holds a slab and computes its slice of J/K; the results
  are re-replicated by an all-gather over the interconnect.
- Conformer batches shard over the 'batch' axis; each device runs the whole
  SCF for its conformers (embarrassingly parallel, no cross-device traffic
  inside a step).
"""



import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..chem.molecule import Molecule
from ..integrals import (
    eri_tensor,
    kinetic,
    nuclear_attraction,
    overlap,
    point_charge_attraction,
)
from ..scf.hf import run_scf

__all__ = ["make_mesh", "sharded_scf", "sharded_df_scf", "make_sharded_df_scf",
           "sharded_df_ks", "make_sharded_df_ks",
           "batched_hf_energies", "pad_to_multiple"]


def make_mesh(n_devices: int | None = None, batch: int = 1) -> Mesh:
    """Mesh with ('batch', 'model') axes over the first n devices."""
    devs = jax.devices()
    n = len(devs) if n_devices is None else n_devices
    if n % batch != 0:
        raise ValueError(f"{n} devices not divisible by batch axis {batch}.")
    arr = np.array(devs[:n]).reshape(batch, n // batch)
    return Mesh(arr, axis_names=("batch", "model"))


def pad_to_multiple(x, multiple: int, axes=(0,)):
    """Zero-pad selected axes up to a multiple (sharding divisibility)."""
    pads = [(0, 0)] * x.ndim
    for ax in axes:
        rem = (-x.shape[ax]) % multiple
        pads[ax] = (0, rem)
    return jnp.pad(x, pads)


def _df_k_gemm(b, d):
    """Aux-sharded DF exchange: K_ij = B_ikP D_kl B_jlP as a pure GEMM
    chain (no in-loop eigh: at full rank the eigen route costs the same
    naux*nao^3 plus an eigh per cycle), matching the single-device
    engine's _df_k_spin, whose aux-axis chunking is NOT used here because
    slicing the sharded axis inside jit would force a gather; the sharding
    itself already bounds the per-device intermediate to
    nao^2 * naux / n_model. P stays sharded through both contractions;
    the reduction over P in the second is GSPMD's one all-reduce."""
    t = jnp.einsum("ikP,kl->ilP", b, d)
    return jnp.einsum("ilP,jlP->ij", t, b)


def make_sharded_scf(mol: Molecule, mesh: Mesh, coords=None, nelec=None,
                     **scf_kwargs):
    """Build the model-parallel SCF program: ``(jitted_fn, args)``.

    The ERI supermatrices are row-padded to a multiple of the 'model' axis
    and sharded row-wise; each device contracts its *padded* slab with the
    replicated density (the pad rows stay in the GEMM so XLA never reshards
    the big operand) and only the small per-row output vector is sliced back
    to ``n*n`` before the reshape. Exposed separately from :func:`sharded_scf`
    so tests can lower/compile the program and assert the partitioning
    (collectives in the HLO, per-device slab shapes) rather than just the
    numerics.
    """
    c = jnp.asarray(mol.coords) if coords is None else coords
    n = mol.nao
    n_model = mesh.shape["model"]
    eri = eri_tensor(mol, c)
    eri_j = pad_to_multiple(eri.reshape(n * n, n * n), n_model, axes=(0,))
    eri_k = pad_to_multiple(
        jnp.transpose(eri, (0, 2, 1, 3)).reshape(n * n, n * n), n_model, axes=(0,)
    )
    row_sharded = NamedSharding(mesh, P("model", None))
    replicated = NamedSharding(mesh, P())
    eri_j = jax.device_put(eri_j, row_sharded)
    eri_k = jax.device_put(eri_k, row_sharded)
    hcore = jax.device_put(kinetic(mol, c) + nuclear_attraction(mol, c), replicated)
    s = jax.device_put(overlap(mol, c), replicated)

    def padded_run(hcore, s, eri_j, eri_k):
        def jk_fn(dm):
            # GEMMs run over the full padded row space (row-sharded slabs x
            # replicated density); the pad rows are dropped from the *small*
            # output vectors only, after the contraction.
            d_tot = (dm[0] + dm[1]).reshape(-1)
            j = (eri_j @ d_tot)[: n * n].reshape(n, n)
            k = (eri_k @ dm.reshape(2, n * n).T).T[:, : n * n].reshape(2, n, n)
            return j, k

        return run_scf(hcore=hcore, s=s, jk_fn=jk_fn,
                       nelec=mol.nelec if nelec is None else nelec, **scf_kwargs)

    return jax.jit(padded_run), (hcore, s, eri_j, eri_k)


def sharded_scf(mol: Molecule, mesh: Mesh, coords=None, nelec=None, **scf_kwargs):
    """Run HF with the ERI supermatrices sharded over the mesh 'model' axis.

    The J/K builds become distributed GEMMs: each device contracts its slab
    of (ij|kl) / (ik|jl) with the (replicated) density and XLA all-gathers
    the result over the interconnect. Returns the (replicated) SCFResult.
    """
    fn, args = make_sharded_scf(mol, mesh, coords=coords, nelec=nelec,
                                **scf_kwargs)
    return fn(*args)


def make_sharded_df_scf(mol: Molecule, mesh: Mesh, coords=None, nelec=None,
                        df_beta: float = 1.8, **scf_kwargs):
    """Build the aux-sharded density-fitted SCF program: ``(jitted_fn, args)``.

    The O(nao^2 naux) DF factor B — the memory wall for large molecules,
    where the O(nao^4) supermatrix of :func:`make_sharded_scf` stops
    fitting one chip's HBM — is sharded over its *auxiliary* axis across
    the mesh 'model' axis.  Per SCF cycle each device contracts its aux
    slab with the (replicated) density:

    - J:  rho_P = B_abP D_ab stays aux-sharded (no traffic); the
      back-contraction J_ab = B_abP rho_P is a partial sum per device that
      GSPMD finishes with one all-reduce over 'model'.
    - K:  T_ioP = B_ikP C_ko is aux-sharded; K_ij = T_ioP T_joP again
      reduces over the sharded axis -> one all-reduce.

    The aux axis is zero-padded to a multiple of the 'model' axis size
    (zero aux functions contribute nothing to either sum).  Exposed
    separately so tests can assert the partitioning on the lowered HLO.
    """
    from ..scf.engine import df_b_factor

    c = np.asarray(mol.coords) if coords is None else np.asarray(coords)
    n = mol.nao
    n_model = mesh.shape["model"]
    b = df_b_factor(mol, c, beta=df_beta)  # (n, n, naux_kept)
    b = np.pad(b, [(0, 0), (0, 0), (0, (-b.shape[2]) % n_model)])
    aux_sharded = NamedSharding(mesh, P(None, None, "model"))
    replicated = NamedSharding(mesh, P())
    b = jax.device_put(jnp.asarray(b), aux_sharded)
    cj = jnp.asarray(c)
    hcore = jax.device_put(kinetic(mol, cj) + nuclear_attraction(mol, cj),
                           replicated)
    s = jax.device_put(overlap(mol, cj), replicated)

    def df_run(hcore, s, b):
        def jk_fn(dm):
            d_tot = dm[0] + dm[1]
            rho = jnp.einsum("abP,ab->P", b, d_tot)
            j = jnp.einsum("abP,P->ab", b, rho)

            return j, jnp.stack([_df_k_gemm(b, dm[0]),
                                 _df_k_gemm(b, dm[1])])

        return run_scf(hcore=hcore, s=s, jk_fn=jk_fn,
                       nelec=mol.nelec if nelec is None else nelec, **scf_kwargs)

    return jax.jit(df_run), (hcore, s, b)


def make_sharded_df_ks(mol: Molecule, mesh: Mesh, xc: str = "b3lyp",
                       coords=None, nelec=None, df_beta: float = 1.8,
                       grid_level: int = 3, **scf_kwargs):
    """Build the multi-chip UKS program: ``(jitted_fn, args)``.

    Composes the two big-operand shardings so a KS step scales past one
    chip's HBM on BOTH memory axes:

    - DF factor B ``(nao, nao, naux)`` sharded over its auxiliary axis
      (as in :func:`make_sharded_df_scf`) — J/K cost one all-reduce over
      the mesh 'model' axis per cycle.
    - XC quadrature sharded over GRID POINTS: the AO table ``(G, nao)``
      and gradient table ``(3, G, nao)`` are zero-padded to a multiple of
      the 'model' axis and sharded on G. Each device evaluates densities
      and the functional on its grid slab; the Vxc back-contractions
      ``einsum('g,gp,gq->pq')`` reduce over the sharded axis, which GSPMD
      finishes with one all-reduce. Zero-padding is exact: the
      padded weights are zero, so both the energy sum and every
      ``d(exc)/d(rho)`` potential weight vanish on pad rows.

    Range-separated hybrids (CAM-B3LYP / LC-BLYP) are wired with a second
    DF factor fitted in the long-range erf(omega*r12)/r12 metric, sharded
    over the same auxiliary axis; the exchange seen by the SCF is the
    folded ``hyb*K + beta*K_LR`` (the single-device engine's convention,
    scf/engine.py), at one extra all-reduce per cycle.
    """
    from ..dft.functionals import resolve_functional
    from ..dft.xc import _chunk_math, _mask_thresh
    from ..grids import build_grid, eval_aos
    from ..scf.engine import df_b_factor

    terms, hyb, rsh = resolve_functional(xc)

    c = np.asarray(mol.coords) if coords is None else np.asarray(coords)
    cj = jnp.asarray(c)
    n_model = mesh.shape["model"]
    aux_sharded = NamedSharding(mesh, P(None, None, "model"))
    replicated = NamedSharding(mesh, P())

    def _sharded_b(omega=0.0):
        bb = df_b_factor(mol, c, beta=df_beta, omega=omega)
        bb = np.pad(bb, [(0, 0), (0, 0), (0, (-bb.shape[2]) % n_model)])
        return jax.device_put(jnp.asarray(bb), aux_sharded)

    b = _sharded_b()
    b_lr = None if rsh is None else _sharded_b(omega=rsh[1])
    hcore = jax.device_put(kinetic(mol, cj) + nuclear_attraction(mol, cj),
                           replicated)
    s = jax.device_put(overlap(mol, cj), replicated)

    points, weights = build_grid(mol, cj, level=grid_level)
    ao, ao_grad = eval_aos(mol, points, cj)
    gpad = (-points.shape[0]) % n_model
    ao = jnp.pad(ao, [(0, gpad), (0, 0)])
    ao_grad = jnp.pad(ao_grad, [(0, 0), (0, gpad), (0, 0)])
    weights = jnp.pad(weights, [(0, gpad)])
    ao = jax.device_put(ao, NamedSharding(mesh, P("model", None)))
    ao_grad = jax.device_put(ao_grad, NamedSharding(mesh, P(None, "model", None)))
    weights = jax.device_put(weights, NamedSharding(mesh, P("model")))

    xc_chunk = _chunk_math(terms, _mask_thresh(ao.dtype))

    def _make_jk(b, b_lr):
        def jk_fn(dm):
            d_tot = dm[0] + dm[1]
            rho = jnp.einsum("abP,ab->P", b, d_tot)
            j = jnp.einsum("abP,P->ab", b, rho)
            k = jnp.stack([_df_k_gemm(b, dm[0]), _df_k_gemm(b, dm[1])])
            if b_lr is not None:
                # folded RSH exchange: hyb*K + beta*K_LR, reported as hyb=1
                k_lr = jnp.stack([_df_k_gemm(b_lr, dm[0]),
                                  _df_k_gemm(b_lr, dm[1])])
                k = hyb * k + rsh[0] * k_lr
            return j, k

        return jk_fn

    hyb_eff = 1.0 if rsh is not None else hyb

    if rsh is None:
        def ks_run(hcore, s, b, ao, ao_grad, weights):
            def xc_fn(dm):
                return xc_chunk(ao, ao_grad, weights, dm)

            return run_scf(hcore=hcore, s=s, jk_fn=_make_jk(b, None),
                           xc_fn=xc_fn, hyb=hyb_eff,
                           nelec=mol.nelec if nelec is None else nelec,
                           **scf_kwargs)

        return jax.jit(ks_run), (hcore, s, b, ao, ao_grad, weights)

    def ks_run_rsh(hcore, s, b, b_lr, ao, ao_grad, weights):
        def xc_fn(dm):
            return xc_chunk(ao, ao_grad, weights, dm)

        return run_scf(hcore=hcore, s=s, jk_fn=_make_jk(b, b_lr),
                       xc_fn=xc_fn, hyb=hyb_eff,
                       nelec=mol.nelec if nelec is None else nelec,
                       **scf_kwargs)

    return jax.jit(ks_run_rsh), (hcore, s, b, b_lr, ao, ao_grad, weights)


def sharded_df_ks(mol: Molecule, mesh: Mesh, xc: str = "b3lyp", coords=None,
                  nelec=None, df_beta: float = 1.8, grid_level: int = 3,
                  **scf_kwargs):
    """Multi-chip UKS: aux-sharded DF J/K + grid-point-sharded XC.

    See :func:`make_sharded_df_ks`; returns the (replicated) SCFResult."""
    fn, args = make_sharded_df_ks(mol, mesh, xc=xc, coords=coords,
                                  nelec=nelec, df_beta=df_beta,
                                  grid_level=grid_level, **scf_kwargs)
    return fn(*args)


def sharded_df_scf(mol: Molecule, mesh: Mesh, coords=None, nelec=None,
                   df_beta: float = 1.8, **scf_kwargs):
    """Density-fitted HF with the B factor sharded over the 'model' axis.

    The scalable multi-chip path: per-device memory is O(nao^2 naux / n_model)
    and each J/K build costs one all-reduce (see
    :func:`make_sharded_df_scf`).
    """
    fn, args = make_sharded_df_scf(mol, mesh, coords=coords, nelec=nelec,
                                   df_beta=df_beta, **scf_kwargs)
    return fn(*args)


def batched_hf_energies(mol: Molecule, coords_batch, mesh: Mesh | None = None,
                        conv_tol: float = 1e-8, max_cycle: int = 50):
    """HF total energies for a batch of conformers (one compiled program).

    ``coords_batch``: (B, natm, 3) in bohr. With a mesh, the batch axis is
    sharded over the mesh 'batch' axis (pure data parallelism). This is the
    batched answer to BASELINE config #5 (batched geometry scans).
    """
    coords_batch = jnp.asarray(coords_batch)
    n = mol.nao

    def one(coords):
        s = overlap(mol, coords)
        hcore = kinetic(mol, coords) + nuclear_attraction(mol, coords)
        if mol.mm_coords is not None:  # QM/MM point/smeared charges
            hcore = hcore + point_charge_attraction(
                mol, mol.mm_coords, mol.mm_charges, mol.mm_radii, coords=coords
            )
        eri = eri_tensor(mol, coords)
        res = run_scf(
            hcore=hcore, s=s,
            eri_j=eri.reshape(n * n, n * n),
            eri_k=jnp.transpose(eri, (0, 2, 1, 3)).reshape(n * n, n * n),
            nelec=mol.nelec, conv_tol=conv_tol, max_cycle=max_cycle,
        )
        return res.e_elec + mol.energy_nuc(coords), res.converged

    fn = jax.vmap(one)
    if mesh is not None:
        sharding = NamedSharding(mesh, P("batch"))
        coords_batch = jax.device_put(
            coords_batch, NamedSharding(mesh, P("batch", None, None))
        )
        fn = jax.jit(fn, out_shardings=(sharding, sharding))
    else:
        fn = jax.jit(fn)
    return fn(coords_batch)


def batched_hf_gradients(mol: Molecule, coords_batch, mesh: Mesh | None = None,
                         conv_tol: float = 1e-10, dm_conv_tol: float = 1e-8,
                         max_cycle: int = 100):
    """HF energies AND analytic nuclear gradients for a conformer batch.

    Returns ``(e (B,), grad (B, natm, 3), converged (B,))`` from ONE
    compiled program: each lane runs the jitted SCF while_loop and then the
    reverse-mode gradient of the stationary energy functional
    (:mod:`nbed_tpu.solvers.gradients`) — a batched force evaluation for
    optimization/dynamics workloads, data-parallel over the mesh 'batch'
    axis. No reference analogue (the reference has no gradients at all).
    """
    from ..solvers.gradients import hf_gradient

    coords_batch = jnp.asarray(coords_batch)

    def one(coords):
        e, grad, res = hf_gradient(
            mol, coords=coords, conv_tol=conv_tol,
            dm_conv_tol=dm_conv_tol, max_cycle=max_cycle,
        )
        return e, grad, res.converged

    fn = jax.vmap(one)
    if mesh is not None:
        s1 = NamedSharding(mesh, P("batch"))
        s3 = NamedSharding(mesh, P("batch", None, None))
        coords_batch = jax.device_put(coords_batch, s3)
        fn = jax.jit(fn, out_shardings=(s1, s3, s1))
    else:
        fn = jax.jit(fn)
    return fn(coords_batch)
