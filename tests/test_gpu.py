"""Checks that need an NVIDIA GPU (marker ``gpu``; they skip on a host
with no card and fail where a card is present but JAX cannot reach it).

``chip_smoke.py`` drives the same paths end to end on the card; these are
the unit-sized versions, run with
``JAX_PLATFORMS=cpu,cuda python -m pytest tests -m gpu``.
"""

import numpy as np
import pytest

pytestmark = pytest.mark.gpu


def test_gpu_fused_scf_matches_uhf_oracle(gpu_device, water_molecule):
    """The fused one-program SCF on the card lands on the exact UHF oracle
    (f64 GEMMs on cuBLAS, eigh on cuSOLVER)."""
    import jax

    from nbed_tpu.scf.engine import SCFEngine

    with jax.default_device(gpu_device):
        sol = SCFEngine(water_molecule, conv_tol=1e-10, dm_conv_tol=1e-8,
                        max_cycle=100, jit_kernel="on").kernel()
    assert sol.converged
    assert np.isclose(sol.e_tot, -74.96099960129165, atol=5e-8)


def test_gpu_eigh_residual_is_f64_grade(gpu_device):
    """cuSOLVER's eigh replaces LAPACK on the card: its eigenvector residual
    must be f64-grade, or DIIS stalls on eigenvector noise."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    a = rng.standard_normal((64, 64))
    a = a + a.T
    with jax.default_device(gpu_device):
        w, v = jnp.linalg.eigh(jnp.asarray(a))
    w, v = np.asarray(w), np.asarray(v)
    assert np.abs(a @ v - v * w[None, :]).max() < 1e-11
    assert np.abs(v.T @ v - np.eye(64)).max() < 1e-12
