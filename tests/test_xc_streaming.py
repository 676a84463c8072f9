"""Streaming (per-chunk AO recomputation) XC equals the table-based path."""

import numpy as np

from nbed_tpu.scf.engine import SCFEngine

import pytest

pytestmark = pytest.mark.slow  # driver/compile-heavy; smoke tier = -m 'not slow'


@pytest.mark.parametrize("xc", ["b3lyp", "tpss"])
def test_multichunk_fori_loop_paths_exact(water_molecule, xc):
    """The chunked fori_loop accumulation (table and streaming variants)
    must reproduce the single-chunk result bit-for-bit-grade: the loop
    carries (exc, vxc) accumulators instead of stacking per-chunk
    outputs."""
    import jax.numpy as jnp

    from nbed_tpu.dft.xc import make_xc_fn, make_xc_fn_streaming
    from nbed_tpu.grids import build_grid, eval_aos

    mol = water_molecule
    coords = jnp.asarray(mol.coords)
    points, weights = build_grid(mol, coords, level=1)
    ao, grad = eval_aos(mol, points, coords)
    g = points.shape[0]

    rng = np.random.default_rng(7)
    c = rng.standard_normal((2, mol.nao, 4))
    dm = jnp.asarray(np.einsum("spi,sqi->spq", c, c) / mol.nao)

    exc0, v0 = make_xc_fn(ao, grad, weights, xc, chunk=g)(dm)
    exc1, v1 = make_xc_fn(ao, grad, weights, xc, chunk=g // 4 + 1)(dm)
    assert np.isclose(float(exc0), float(exc1), rtol=0, atol=1e-11)
    assert np.max(np.abs(np.asarray(v0) - np.asarray(v1))) < 1e-11

    exc2, v2 = make_xc_fn_streaming(
        mol, coords, points, weights, xc, chunk=g // 4 + 1
    )(dm)
    assert np.isclose(float(exc0), float(exc2), rtol=0, atol=1e-11)
    assert np.max(np.abs(np.asarray(v0) - np.asarray(v2))) < 1e-11


def test_streaming_xc_matches_tables(water_molecule, water_uks):
    # max_memory_mb=0 -> _XC_TABLE_LIMIT 0: force the streaming path
    eng = SCFEngine(water_molecule, xc="b3lyp", conv_tol=1e-9, max_cycle=100,
                    max_memory_mb=0.0)
    sol = eng.kernel()
    assert sol.converged
    assert np.isclose(sol.e_tot, water_uks.e_tot, atol=1e-10)
