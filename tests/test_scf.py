"""SCF engine tests: reference-oracle energies + Huzinaga SCF behaviour.

Oracle values are the reference test suite's hard-coded PySCF numbers
(reference tests/test_driver.py:41-80, BASELINE.md). HF oracles are exact
(<1e-8); DFT oracles are grid-limited (~2e-7 with our default grid).
"""

import numpy as np
import pytest

from nbed_tpu.scf import huzinaga_scf

pytestmark = pytest.mark.slow  # driver/compile-heavy; smoke tier = -m 'not slow'


def test_uhf_oracle(water_uhf, water_uhf_engine):
    assert np.isclose(water_uhf.e_tot, -74.96099960129165, atol=5e-8)
    e_elec, e_coul = water_uhf.energy_elec()
    assert np.isclose(e_elec, -84.24671382296947, atol=5e-8)
    assert np.isclose(e_coul, 38.288174841671974, atol=5e-8)
    assert water_uhf.converged


def test_rhf_matches_uhf(water_rhf, water_uhf):
    assert np.isclose(water_rhf.e_tot, water_uhf.e_tot, atol=1e-9)
    assert np.asarray(water_rhf.mo_coeff).ndim == 2
    assert np.allclose(water_rhf.mo_occ, [2, 2, 2, 2, 2, 0, 0])


def test_uks_b3lyp_oracle(water_uks):
    # reference tests/test_driver.py:45-49 — grid-limited agreement
    assert np.isclose(water_uks.e_tot, -75.3091447400438, atol=5e-6)
    e_elec, e2 = water_uks.energy_elec()
    assert np.isclose(e_elec, -84.59485896172163, atol=5e-6)
    assert np.isclose(e2, 37.93302591280513, atol=5e-6)


def test_f32_warmup_matches_plain(water_molecule, water_uhf, water_uks):
    """Mixed-precision warm-up (f32 pre-SCF seeding the f64 solve) lands on
    the same fixed points."""
    from nbed_tpu.scf.engine import SCFEngine

    warm_hf = SCFEngine(water_molecule, conv_tol=1e-10, dm_conv_tol=1e-8,
                        max_cycle=100, warmup_f32=True).kernel()
    assert np.isclose(warm_hf.e_tot, water_uhf.e_tot, atol=1e-10)
    warm_ks = SCFEngine(water_molecule, xc="b3lyp", conv_tol=1e-9,
                        max_cycle=100, warmup_f32=True).kernel()
    assert np.isclose(warm_ks.e_tot, water_uks.e_tot, atol=1e-7)


def test_incremental_jk_matches_f64(water_molecule, water_uhf, water_uks):
    """Incremental mixed-precision SCF (f32 J/K of the density change +
    periodic f64 rebase) reproduces the all-f64 fixed points to 1e-8."""
    from nbed_tpu.scf.engine import SCFEngine

    inc_hf = SCFEngine(water_molecule, conv_tol=1e-10, dm_conv_tol=1e-8,
                       max_cycle=100, incremental_jk=True).kernel()
    assert np.isclose(inc_hf.e_tot, water_uhf.e_tot, atol=1e-8)
    inc_ks = SCFEngine(water_molecule, xc="b3lyp", conv_tol=1e-9,
                       max_cycle=100, incremental_jk=True).kernel()
    assert np.isclose(inc_ks.e_tot, water_uks.e_tot, atol=1e-7)


def test_incremental_jk_df_matches(water_molecule):
    """Incremental f32 path composes with density fitting (signed
    eigen-decomposition handles non-PSD delta densities in DF-K)."""
    from nbed_tpu.scf.engine import SCFEngine

    plain = SCFEngine(water_molecule, conv_tol=1e-10, dm_conv_tol=1e-8,
                      max_cycle=100, density_fitting=True).kernel()
    inc = SCFEngine(water_molecule, conv_tol=1e-10, dm_conv_tol=1e-8,
                    max_cycle=100, density_fitting=True,
                    incremental_jk=True).kernel()
    assert np.isclose(inc.e_tot, plain.e_tot, atol=1e-8)


def test_jit_kernel_matches_eager(water_molecule, water_uhf, water_uks):
    """The fused jitted kernel (one compiled program per call signature,
    big operands as jit arguments; the default on an accelerator) is
    bit-consistent with the eager path on every route:
    plain/DF x HF/KS, v_emb, and get_veff."""
    from nbed_tpu.scf.engine import SCFEngine

    jit_hf = SCFEngine(water_molecule, conv_tol=1e-10, dm_conv_tol=1e-8,
                       max_cycle=100, jit_kernel="on").kernel()
    assert np.isclose(jit_hf.e_tot, water_uhf.e_tot, atol=1e-12)
    jit_ks = SCFEngine(water_molecule, xc="b3lyp", conv_tol=1e-9,
                       max_cycle=100, jit_kernel="on").kernel()
    assert np.isclose(jit_ks.e_tot, water_uks.e_tot, atol=1e-12)
    jit_df = SCFEngine(water_molecule, conv_tol=1e-10, dm_conv_tol=1e-8,
                       max_cycle=100, density_fitting=True,
                       jit_kernel="on").kernel()
    eag_df = SCFEngine(water_molecule, conv_tol=1e-10, dm_conv_tol=1e-8,
                       max_cycle=100, density_fitting=True).kernel()
    assert np.isclose(jit_df.e_tot, eag_df.e_tot, atol=1e-12)

    rng = np.random.default_rng(3)
    v = rng.normal(size=(water_molecule.nao,) * 2) * 0.01
    v = v + v.T
    e_j = SCFEngine(water_molecule, conv_tol=1e-10, max_cycle=100,
                    jit_kernel="on").kernel(nelec=(3, 3), v_emb=v)
    e_e = SCFEngine(water_molecule, conv_tol=1e-10,
                    max_cycle=100).kernel(nelec=(3, 3), v_emb=v)
    assert np.isclose(e_j.e_tot, e_e.e_tot, atol=1e-11)

    dm = water_uks.make_rdm1()
    ks_j = SCFEngine(water_molecule, xc="b3lyp", jit_kernel="on")
    ks_e = SCFEngine(water_molecule, xc="b3lyp", jit_kernel="off")
    vj, ve = ks_j.get_veff(dm), ks_e.get_veff(dm)
    assert np.abs(np.asarray(vj.matrix) - np.asarray(ve.matrix)).max() < 1e-12
    assert np.isclose(float(vj.exc), float(ve.exc), atol=1e-12)


def test_incremental_polish_reaches_f64_fixed_point(water_molecule,
                                                    water_uhf):
    """The pure-f64 polish loop after the incremental mixed-precision SCF:
    even when the f32 increments are corrupted enough to trip the de/ddm
    test away from the true fixed point, the returned solution must sit
    on the all-f64 answer.
    Exercised here by a LOOSE mixed-loop tolerance with a tight final one:
    convergence is certified by the polish loop, not the noisy mixed loop."""
    from nbed_tpu.scf.engine import SCFEngine

    inc = SCFEngine(water_molecule, conv_tol=1e-10, dm_conv_tol=1e-8,
                    max_cycle=100, incremental_jk=True,
                    rebase_every=1000).kernel()  # never rebase in-loop
    assert inc.converged
    assert np.isclose(inc.e_tot, water_uhf.e_tot, atol=1e-9)


def test_xc_mask_handles_tiny_densities(water_molecule):
    """GGA terms must stay finite (value AND autodiff potentials) for
    densities straddling the mask threshold (the range-split forms keep
    every autodiff denominator in range)."""
    import jax
    import jax.numpy as jnp

    from nbed_tpu.dft import functionals as F

    rho = np.logspace(-13, -1, 25)
    ra = jnp.asarray(np.repeat(rho, 2))
    rb = jnp.asarray(np.concatenate([rho, np.full_like(rho, 1e-15)]))
    g = jnp.asarray(np.concatenate([(10 * rho) ** 2,
                                    np.full_like(rho, 1e-30)]))
    for fn in (F.slater_x, F.b88_x, F.lyp_c, F.vwn_rpa_c, F.pbe_x, F.pbe_c):
        val = np.asarray(fn(ra, rb, g, g, g))
        assert np.isfinite(val).all(), fn.__name__
        grads = jax.grad(lambda *a: jnp.sum(fn(*a)), argnums=(0, 1, 2))(
            ra, rb, g, g, g
        )
        for gr in grads:
            assert np.isfinite(np.asarray(gr)).all(), fn.__name__


def test_restricted_dm_is_total(water_rhf):
    dm = water_rhf.make_rdm1()
    assert dm.ndim == 2
    s = np.asarray(water_rhf.engine.s)
    assert np.isclose(np.trace(dm @ s), 10.0, atol=1e-8)


@pytest.fixture(scope="module")
def dft_potential(spinless_driver):
    return spinless_driver.embedding_potential


@pytest.fixture(scope="module")
def dm_environment(spinless_driver):
    return spinless_driver.localized_system.dm_enviro


# NOTE on oracles: the reference's standalone huzinaga_scf tests
# (tests/test_scf.py:19-134) assert MO energies produced by a historical
# fixture state that is not reproducible from the current fixture
# definitions.  Reproduction evidence: scripts/huzinaga_oracle_repro.py runs
# a line-faithful replica of the reference algorithm on the exact fixture
# inputs and converges to MO energies up to 0.48 Ha from the asserted
# oracle; the fixtures mix densities from one geometry with an SCF on
# another, for which the Huzinaga premise D S D = D fails by 1.4e-1.  The
# Huzinaga machinery IS oracle-validated end-to-end through the driver tests
# (embedded CCSD/FCI energies and the DFT-in-DFT identity,
# tests/test_driver.py); here we assert the defining algorithmic properties
# on *matched* inputs: potential, environment density and SCF all on the
# spinless_driver's molecule.


@pytest.fixture(scope="module")
def huz_inputs(spinless_driver):
    v_emb = np.asarray(spinless_driver.embedding_potential)
    dm_env = np.asarray(spinless_driver.localized_system.dm_enviro)
    return spinless_driver._mol, v_emb, dm_env


def _make_engine(mol, xc, restricted):
    from nbed_tpu.scf.engine import SCFEngine

    return SCFEngine(mol, xc=xc, restricted=restricted, conv_tol=1e-10,
                     dm_conv_tol=1e-8, max_cycle=200)


def _check_huzinaga_properties(engine, v_emb, dm_env, restricted):
    # embedded (active) electron count, as the driver uses
    # (reference driver.py:262-287): 4 active pairs for this fixture
    na = 4
    mo_coeff, mo_energy, dm, huz, conv = huzinaga_scf(
        engine, embedding_potential=v_emb, dm_environment_occupied=dm_env,
        nelec=(na, na),
    )
    assert conv
    s = np.asarray(engine.s)
    if restricted:
        assert mo_coeff.shape == (7, 7)
        assert mo_energy.shape == (7,)
        assert dm.shape == (7, 7)
        c_occ = [mo_coeff[:, :na]]
        dm_envs = [0.5 * dm_env]  # per-spin environment density
        # restricted density is the spin-summed one
        assert np.isclose(np.trace(dm @ s), 2.0 * na, atol=1e-8)
    else:
        assert mo_coeff.shape == (2, 7, 7)
        assert mo_energy.shape == (2, 7)
        assert dm.shape == (2, 7, 7)
        c_occ = [mo_coeff[0][:, :na], mo_coeff[1][:, :na]]
        dm_envs = [dm_env[0], dm_env[1]]
        assert np.isclose(np.trace((dm[0] + dm[1]) @ s), 2.0 * na, atol=1e-8)
    # the defining Huzinaga property: converged occupied orbitals have no
    # weight in the environment space, <occ| S D_env S |occ> ~ 0
    for c, d_env in zip(c_occ, dm_envs):
        leak = np.abs(c.T @ s @ d_env @ s @ c).max()
        assert leak < 1e-8, f"environment leakage {leak}"
    return mo_energy


def test_huzinaga_rhf(huz_inputs):
    mol, v_emb, dm_env = huz_inputs
    _check_huzinaga_properties(
        _make_engine(mol, None, True), v_emb[0],
        dm_env[0] + dm_env[1], restricted=True,
    )


def test_huzinaga_uhf(huz_inputs):
    mol, v_emb, dm_env = huz_inputs
    mo_e = _check_huzinaga_properties(
        _make_engine(mol, None, False), v_emb, dm_env, restricted=False
    )
    # closed-shell inputs: alpha and beta solutions coincide
    assert np.allclose(mo_e[0], mo_e[1], atol=1e-8)


def test_huzinaga_rks(huz_inputs):
    mol, v_emb, dm_env = huz_inputs
    _check_huzinaga_properties(
        _make_engine(mol, "b3lyp", True), v_emb[0],
        dm_env[0] + dm_env[1], restricted=True,
    )


def test_huzinaga_uks(huz_inputs):
    mol, v_emb, dm_env = huz_inputs
    _check_huzinaga_properties(
        _make_engine(mol, "b3lyp", False), v_emb, dm_env, restricted=False
    )


def test_huzinaga_restricted_matches_unrestricted(huz_inputs):
    """Restricted reporting is exactly the alpha==beta fixed point."""
    mol, v_emb, dm_env = huz_inputs
    r = huzinaga_scf(_make_engine(mol, None, True), v_emb[0],
                     dm_env[0] + dm_env[1], nelec=(4, 4))
    u = huzinaga_scf(_make_engine(mol, None, False),
                     np.stack([v_emb[0]] * 2), dm_env, nelec=(4, 4))
    assert np.allclose(r[1], u[1][0], atol=1e-8)  # mo energies
    assert np.allclose(r[2], u[2][0] + u[2][1], atol=1e-8)  # total density


def test_spin_square_diagnostics():
    """<S^2>: exact 0 for closed-shell water; ~0.75/~2.0 (+ small UHF
    contamination) for the methyl-radical doublet / methylene triplet."""
    from pathlib import Path

    import numpy as np

    from nbed_tpu.chem import build_molecule
    from nbed_tpu.scf.engine import SCFEngine

    water = open(Path(__file__).parent / "molecules" / "water.xyz").read()
    s2, mult = SCFEngine(build_molecule(water, "sto-3g"),
                         conv_tol=1e-10).kernel().spin_square()
    assert abs(s2) < 1e-8 and abs(mult - 1.0) < 1e-8

    ch3 = open(Path(__file__).parent / "molecules" /
               "methyl_radical.xyz").read()
    s2, mult = SCFEngine(build_molecule(ch3, "sto-3g", spin=1),
                         conv_tol=1e-10).kernel().spin_square()
    assert 0.75 <= s2 < 0.80  # doublet + small contamination
    assert abs(mult - 2.0) < 0.05

    ch2 = "3\n\nC 0.0 0.0 0.0\nH 0.991 0.0 -0.421\nH -0.991 0.0 -0.421\n"
    s2, mult = SCFEngine(build_molecule(ch2, "sto-3g", spin=2),
                         conv_tol=1e-10).kernel().spin_square()
    assert 2.0 <= s2 < 2.05
    assert abs(mult - 3.0) < 0.05
