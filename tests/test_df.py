"""Density-fitting tests: auto-auxiliary quality and DF-SCF accuracy."""

import numpy as np
import pytest

from nbed_tpu import native
from nbed_tpu.chem.basis.auxiliary import make_auxiliary_molecule
from nbed_tpu.scf.engine import SCFEngine

pytestmark = [
    pytest.mark.slow,  # compile-heavy; smoke tier = -m 'not slow'
    pytest.mark.skipif(not native.available(),
                       reason="native engine unavailable"),
]


def test_df_factor_reconstructs_eri(water_molecule):
    aux = make_auxiliary_molecule(water_molecule)
    b3 = native.eri_3c(water_molecule, aux)
    m2 = native.eri_2c(aux)
    assert np.allclose(m2, m2.T, atol=1e-12)
    w, v = np.linalg.eigh(m2)
    assert w.min() > -1e-10  # Coulomb metric is PSD
    w = np.maximum(w, 1e-10)
    bt = np.einsum("abP,PQ->abQ", b3, (v / np.sqrt(w)) @ v.T, optimize=True)
    eri_df = np.einsum("abP,cdP->abcd", bt, bt, optimize=True)
    err = np.abs(native.eri(water_molecule) - eri_df)
    assert err.max() < 5e-5
    assert np.sqrt((err**2).mean()) < 5e-6


def test_df_hf_energy(water_molecule, water_uhf):
    df = SCFEngine(water_molecule, conv_tol=1e-10, dm_conv_tol=1e-8,
                   max_cycle=100, density_fitting=True).kernel()
    assert df.converged
    # measured +8.4e-6 with the default auto-aux (beta=1.8, l_max_factor=3);
    # parity-grade bound (<=1e-5 Ha) per the round-2 review worklist
    assert abs(df.e_tot - water_uhf.e_tot) < 1e-5


def test_df_hamiltonian_builder(water_molecule, water_uhf):
    """DF-based AO->MO two-body assembly tracks the exact builder: the
    FCI ground state agrees to DF accuracy without any O(nao^4) tensor."""
    from nbed_tpu.ham import HamiltonianBuilder
    from nbed_tpu.solvers import run_fci

    df_sol = SCFEngine(water_molecule, conv_tol=1e-10, dm_conv_tol=1e-8,
                       max_cycle=100, density_fitting=True).kernel()
    const, h1, h2 = HamiltonianBuilder(df_sol, 0.0).build()
    vals, _ = run_fci(const, h1, h2, 14, (5, 5))
    e_df = float(vals[0]) + df_sol.energy_nuc()
    # exact-path FCI oracle (reference tests/test_driver.py:76)
    assert abs(e_df - (-75.00912605315143)) < 5e-4


def test_df_b3lyp_energy(water_molecule, water_uks):
    df = SCFEngine(water_molecule, xc="b3lyp", conv_tol=1e-9, max_cycle=100,
                   density_fitting=True).kernel()
    assert df.converged
    # measured 5.3e-6 with the default auto-aux; parity-grade bound
    assert abs(df.e_tot - water_uks.e_tot) < 1e-5


def test_df_k_chunked_matches_unblocked(water_molecule):
    """The aux-chunked DF exchange (lax.fori_loop over P blocks) is exact:
    K = sum_P B_P D B_P^T under any partition of P.  The chunked branch
    bounds device memory at large nao."""
    import jax.numpy as jnp

    import nbed_tpu.scf.engine as eng_mod
    from nbed_tpu.scf.engine import _df_k_spin

    eng = SCFEngine(water_molecule, density_fitting=True)
    b = jnp.asarray(eng._df_b)
    rng = np.random.default_rng(7)
    d = rng.standard_normal((b.shape[0], b.shape[0]))
    d = jnp.asarray(d + d.T)
    k_ref = np.asarray(_df_k_spin(b, d))
    old = eng_mod._DF_K_CHUNK_ELEMS
    try:
        # force several blocks with an awkward (non-dividing) chunk size
        eng_mod._DF_K_CHUNK_ELEMS = b.shape[0] ** 2 * 7
        k_chunked = np.asarray(_df_k_spin(b, d))
    finally:
        eng_mod._DF_K_CHUNK_ELEMS = old
    assert np.abs(k_chunked - k_ref).max() < 1e-10


def test_xc_pack_prefers_table_below_limit(water_molecule):
    """Table XC is used up to _XC_TABLE_LIMIT AO-table elements and only
    then streams (the streaming path exists only to bound memory)."""
    eng = SCFEngine(water_molecule, xc="b3lyp")
    assert eng._xc_pack(np.float64)[0] == "table"
    eng2 = SCFEngine(water_molecule, xc="b3lyp", max_memory_mb=0.0)
    assert eng2._xc_pack(np.float64)[0] == "streaming"
