"""Embedding-driver tests against the reference oracles
(reference tests/test_driver.py). HF-path oracles are exact; B3LYP-dependent
quantities are grid-limited (tolerances noted inline)."""

import numpy as np
import pytest
from nbed_tpu.config import ValidationError

from nbed_tpu.config import NbedConfig, ProjectorTypes
from nbed_tpu.driver import NbedDriver

pytestmark = pytest.mark.slow  # driver/compile-heavy; smoke tier = -m 'not slow'


def test_global_ks(mu_driver):
    result = mu_driver._global_ks
    # achieved -7.6e-8 with the reference-parity grid (docs/ACCURACY.md)
    assert np.isclose(result.e_tot, -75.3091447400438, atol=2e-7)
    # the e1/e2 split carries the oracle's own ~1.3e-5 convergence imprint
    # (scripts/oracle_noise.py), hence the looser bound here
    assert np.allclose(
        result.energy_elec(),
        (-84.59485896172163, 37.93302591280513),
        atol=2e-5,
    )


def test_global_hf(mu_driver):
    result = mu_driver._global_hf
    assert np.isclose(result.energy_nuc(), 9.285714221677825)
    assert np.isclose(result.e_tot, -74.96099960129165, atol=1e-6)
    assert np.allclose(
        result.energy_elec(),
        (-84.24671382296947, 38.288174841671974),
        atol=1e-6,
    )


def test_global_ccsd(mu_driver):
    e_tot, e_corr = mu_driver._global_ccsd
    assert np.isclose(e_tot, -75.0090124134578, atol=1e-6)
    assert np.isclose(e_corr, -0.04801281045273269, atol=1e-6)


def test_global_fci(mu_driver):
    assert np.isclose(mu_driver._global_fci, -75.00912605315143, atol=1e-6)


def test_restricted_dft_in_dft(mu_driver, huz_driver):
    mu_did = mu_driver._dft_in_dft(ProjectorTypes.MU)
    huz_did = huz_driver._dft_in_dft(ProjectorTypes.HUZ)
    # DFT-in-DFT must reproduce the global KS energy (exact identity)
    assert np.isclose(mu_did["e_dft_in_dft"], mu_driver._global_ks.e_tot,
                      atol=5e-6)
    assert np.isclose(huz_did["e_dft_in_dft"], huz_driver._global_ks.e_tot,
                      atol=1e-8)
    assert np.isclose(mu_did["e_dft_in_dft"], huz_did["e_dft_in_dft"], atol=5e-6)


@pytest.mark.parametrize("driver", ["mu_driver", "huz_driver"])
def test_embedded_ccsd(driver, request):
    driver = request.getfixturevalue(driver)
    result = getattr(driver, driver.config.projector.value)
    # reference tests/test_driver.py:107-108. With the reference-parity grid
    # the deviation is ~7e-6 — inside the oracle's own reproducibility
    # floor: a global KS stopped at the reference's convergence=1e-6
    # scatters this value by up to 2.2e-5 (measured,
    # scripts/oracle_floor.py + tests/test_oracle_floor.py), so 1e-5 is
    # the tightest evidence-backed tolerance against this oracle.
    assert np.isclose(result["e_ccsd"], -75.1285849238916, atol=1e-5)


@pytest.mark.parametrize("driver", ["mu_driver"])
def test_embedded_ccsd_t(driver, request):
    """Embedded CCSD(T)-in-DFT (beyond the reference): the (T) correction
    on the embedded active space is small and negative, and the total
    stays within the embedded-oracle neighborhood."""
    from nbed_tpu.driver import run_emb_ccsd

    driver = request.getfixturevalue(driver)
    result = getattr(driver, driver.config.projector.value)
    sol = result["scf"]
    e_ccsd, _ = run_emb_ccsd(sol, convergence=1e-8)
    e_ccsdt, corr_t = run_emb_ccsd(sol, convergence=1e-8, triples=True)
    e_t = e_ccsdt - e_ccsd
    assert e_t < 0
    assert abs(e_t) < 1e-3


@pytest.mark.parametrize("driver", ["mu_driver", "huz_driver"])
def test_embedded_fci(driver, request):
    driver = request.getfixturevalue(driver)
    result = getattr(driver, driver.config.projector.value)
    # reference tests/test_driver.py:127; tolerance rationale as in
    # test_embedded_ccsd (achieved ~6e-6 vs a measured 2.2e-5 oracle
    # floor, docs/ACCURACY.md round-4 section)
    assert np.isclose(result["e_fci"], -75.12858550813999, atol=1e-5)


def test_projector_results_match(mu_driver, huz_driver):
    assert mu_driver.mu is not None and mu_driver.huzinaga is None
    assert huz_driver.huzinaga is not None and huz_driver.mu is None
    assert mu_driver.mu.keys() == huz_driver.huzinaga.keys()


def test_projectors_scf_match(mu_driver, huz_driver):
    mu_scf = mu_driver.embedded_scf
    huz_scf = huz_driver.embedded_scf
    assert mu_scf.converged and huz_scf.converged
    assert np.asarray(mu_scf.mo_coeff).shape == np.asarray(huz_scf.mo_coeff).shape
    assert np.asarray(mu_scf.mo_occ).shape == np.asarray(huz_scf.mo_occ).shape
    assert np.isclose(mu_scf.e_tot, huz_scf.e_tot, atol=1e-5)


def test_second_quantised_output(mu_driver):
    const, h1, h2 = mu_driver.mu["second_quantised"]
    assert np.isclose(const, mu_driver.mu["classical_energy"])
    k = h1.shape[0]
    assert h1.shape == (k, k)
    assert h2.shape == (k, k, k, k)


def test_df_embedding_pipeline(nbed_config):
    """Density-fitted engines run the whole embedding pipeline; the
    classical energy stays within DF accuracy of the exact-ERI result."""
    cfg = nbed_config.model_copy(update={})
    cfg.projector = ProjectorTypes.MU
    cfg.density_fitting = True
    cfg.run_ccsd_emb = False
    cfg.run_fci_emb = False
    driver = NbedDriver(cfg)
    driver.embed()
    assert driver.embedded_scf.converged
    # exact-ERI pipeline gives ~-14.2291 for this config; DF introduces
    # ~1e-4-scale deviations
    assert np.isclose(driver.classical_energy, -14.2291, atol=5e-3)


def test_pao_huzinaga_end_to_end(nbed_config, huz_driver):
    """PAO virtual localization runs the full Huzinaga pipeline (the
    reference's own PAO+huz branch is dead behind its guard,
    reference driver.py:819-820 vs 878-888)."""
    from nbed_tpu.config import VirtualLocalizerTypes

    cfg = nbed_config.model_copy(update={})
    cfg.projector = ProjectorTypes.HUZ
    cfg.virtual_localization = VirtualLocalizerTypes.PROJECTED_AO
    cfg.run_ccsd_emb = False
    cfg.run_fci_emb = False
    driver = NbedDriver(cfg)
    driver.embed()
    assert driver.embedded_scf.converged
    # The PAO virtual projector restricts the embedded virtual space; the
    # embedded SCF energy stays within a fraction of a Hartree of the
    # unrestricted-virtual Huzinaga solution on the same config.
    plain = huz_driver.embedded_scf.e_tot
    assert abs(driver.embedded_scf.e_tot - plain) < 1.0
    assert np.isfinite(driver.classical_energy)


def test_pao_requires_huzinaga(nbed_config):
    from nbed_tpu.config import VirtualLocalizerTypes

    cfg = nbed_config.model_copy(update={})
    cfg.projector = ProjectorTypes.MU
    cfg.virtual_localization = VirtualLocalizerTypes.PROJECTED_AO
    with pytest.raises(NotImplementedError):
        NbedDriver(cfg).embed()


def test_huzinaga_seeded_with_mu(nbed_config):
    """init_huzinaga_rhf_with_mu runs the mu branch first and seeds the
    Huzinaga SCF from its density (reference driver.py:871-893)."""
    cfg = nbed_config.model_copy(update={})
    cfg.projector = ProjectorTypes.HUZ
    cfg.init_huzinaga_rhf_with_mu = True
    cfg.run_ccsd_emb = False
    cfg.run_fci_emb = False
    driver = NbedDriver(cfg)
    driver.embed()
    assert driver.mu is not None  # mu branch ran to provide the seed
    assert driver.huzinaga is not None
    assert np.isclose(
        driver.mu["scf"].e_tot, driver.huzinaga["scf"].e_tot, atol=1e-5
    )


def test_incorrect_geometry_path():
    with pytest.raises(ValidationError):
        NbedConfig(
            geometry="THIS/IS/NOT/AN/XYZ/FILE",
            n_active_atoms=1,
            basis="STO-3G",
            xc_functional="b3lyp5",
            projector="mu",
            localization="spade",
            convergence=1e-6,
            run_ccsd_emb=True,
            run_fci_emb=True,
        )


def test_driver_standard_xyz_string_input(spinless_driver):
    """Reference tests/test_driver.py:187-197."""
    assert np.isclose(
        spinless_driver.classical_energy, -3.5867934952241356, atol=3e-5
    )
    assert np.asarray(spinless_driver.embedded_scf.mo_coeff).shape == (2, 7, 6)
    assert np.all(
        spinless_driver.embedded_scf.mo_occ
        == np.array([[1, 1, 1, 1, 0, 0], [1, 1, 1, 1, 0, 0]])
    )


def test_open_shell_pipeline_end_to_end():
    """Spin-resolved embed() on the methyl radical (doublet, 5a/4b
    electrons, C active): per-spin SPADE partitions, unequal alpha/beta
    active counts, embedded FCI in the odd-electron sector, and the
    subsystem-DFT partition identity (the reference's unrestricted-driver
    fixtures, conftest.py:104-147, cover this regime)."""
    from pathlib import Path

    from nbed_tpu import nbed

    xyz = (Path(__file__).parent / "molecules" / "methyl_radical.xyz")
    driver = nbed(geometry=str(xyz), n_active_atoms=1, basis="STO-3G",
                  xc_functional="b3lyp", projector="mu",
                  localization="spade", spin=1, run_ccsd_emb=False,
                  run_fci_emb=True)
    gks = driver._global_ks
    assert gks.converged
    assert -38.5 < gks.e_tot < -37.5  # measured -37.9424 (B3LYP/STO-3G)
    assert driver.mu["scf"].converged
    na, nb = driver.mu["scf"].nelec
    assert na == nb + 1  # doublet propagated into the embedded system
    assert driver.mu["e_fci"] < driver.mu["scf"].e_tot
    total = (driver.e_act + driver.e_env + driver.two_e_cross
             + driver._ks_engine.energy_nuc())
    assert np.isclose(total, gks.e_tot, atol=1e-10)

    # the Huzinaga projector lands on the same embedded FCI energy
    # (measured: mu -37.56839186, huz -37.56838720)
    huz = nbed(geometry=str(xyz), n_active_atoms=1, basis="STO-3G",
               xc_functional="b3lyp", projector="huzinaga",
               localization="spade", spin=1, run_ccsd_emb=False,
               run_fci_emb=True)
    assert huz.huzinaga["scf"].converged
    assert abs(huz.huzinaga["e_fci"] - driver.mu["e_fci"]) < 1e-4


def test_ccpvdz_pipeline_end_to_end(water_xyz):
    """Full pipeline on a d-function basis (cc-pVDZ water): the global KS,
    the embedded SCF and CCSD all converge, and the subsystem-DFT
    partition identity holds exactly. B3LYP/cc-pVDZ water sits near
    -76.42 Ha; the identity is basis-independent."""
    from nbed_tpu import nbed

    driver = nbed(geometry=water_xyz, n_active_atoms=1, basis="cc-pVDZ",
                  xc_functional="b3lyp", projector="mu",
                  localization="spade", run_ccsd_emb=True,
                  run_fci_emb=False)
    gks = driver._global_ks
    assert gks.converged
    assert -76.5 < gks.e_tot < -76.3
    assert driver.mu["scf"].converged
    assert -76.5 < driver.mu["e_ccsd"] < -75.9  # measured -76.2277
    total = (driver.e_act + driver.e_env + driver.two_e_cross
             + driver._ks_engine.energy_nuc())
    assert np.isclose(total, gks.e_tot, atol=1e-10)


def test_subsystem_dft_partition(spinless_driver):
    """e_act + e_env + two_e_cross + e_nuc == global KS e_tot (exact
    identity, reference tests/test_driver.py:200-224)."""
    total = (
        spinless_driver.e_act
        + spinless_driver.e_env
        + spinless_driver.two_e_cross
        + spinless_driver._ks_engine.energy_nuc()
    )
    assert np.isclose(total, spinless_driver._global_ks.e_tot, atol=1e-10)


def test_open_shell_concentric_localization():
    """CL virtual truncation on an open-shell system (methyl radical):
    per-spin ragged virtual spaces flow through the padded C stacks, the
    truncated embedded FCI stays within the CL truncation error of the
    full-virtual result, and both projectors agree after truncation
    (round-2 worklist: only the doublet FCI path without CL was
    oracle-tested)."""
    from pathlib import Path

    from nbed_tpu import nbed

    xyz = str(Path(__file__).parent / "molecules" / "methyl_radical.xyz")
    common = dict(geometry=xyz, n_active_atoms=1, basis="STO-3G",
                  xc_functional="b3lyp", localization="spade", spin=1,
                  run_fci_emb=True)
    full = nbed(projector="mu", **common)
    cl = nbed(projector="mu", virtual_localization="cl", **common)

    scf_cl = cl.mu["scf"]
    assert scf_cl.converged
    # CL recorded its shell structure and truncated (or kept) the virtuals
    assert cl.mu.get("cl") is not None
    n_mo_full = np.asarray(full.mu["scf"].mo_coeff).shape[-1]
    n_mo_cl = np.asarray(scf_cl.mo_coeff).shape[-1]
    assert n_mo_cl <= n_mo_full
    # spin sectors keep their electron counts (doublet preserved)
    na, nb = scf_cl.nelec
    assert na == nb + 1
    # per-spin MO sets stay S-orthonormal after the padded-stack surgery
    s = np.asarray(scf_cl.engine.s)
    for sp in range(2):
        c = np.asarray(scf_cl.mo_coeff)[sp]
        g = c.T @ s @ c
        np.testing.assert_allclose(g, np.eye(g.shape[0]), atol=1e-8)
    # truncation changes the FCI energy only by the CL truncation error
    assert abs(cl.mu["e_fci"] - full.mu["e_fci"]) < 5e-3

    huz = nbed(projector="huzinaga", virtual_localization="cl", **common)
    assert huz.huzinaga["scf"].converged
    assert abs(huz.huzinaga["e_fci"] - cl.mu["e_fci"]) < 1e-3


TRIPLET_CH2 = """3

C   0.0000  0.0000  0.0000
H   0.9910  0.0000  -0.4210
H   -0.9910  0.0000  -0.4210
"""


def test_triplet_embedding_end_to_end():
    """Triplet methylene (spin=2): the open-shell machinery beyond
    doublets — unequal alpha/beta partitions two electrons apart,
    spin-resolved subsystem DFT, per-spin environment deletion, embedded
    FCI — and projector agreement. (CL on top of a ragged triplet space
    is covered by the doublet CL test; at this tiny system CL's shell
    SVD sits on a degenerate singular value and the kept-virtual count
    is not stable.)  (A homonuclear
    diatomic like O2 split down the middle is NOT a valid case: SPADE's
    singular values pair up degenerately on the shared bond and the
    partition is ill-posed.)"""
    from nbed_tpu import nbed

    xyz = TRIPLET_CH2
    common = dict(geometry=xyz, n_active_atoms=1, basis="STO-3G",
                  xc_functional="b3lyp", localization="spade", spin=2,
                  run_fci_emb=True)
    mu = nbed(projector="mu", **common)
    sol = mu.mu["scf"]
    assert sol.converged
    na, nb = sol.nelec
    assert na == nb + 2  # triplet sector preserved through embedding
    # per-spin MO sets S-orthonormal after env deletion + CL surgery
    s = np.asarray(sol.engine.s)
    for sp in range(2):
        c = np.asarray(sol.mo_coeff)[sp]
        g = c.T @ s @ c
        np.testing.assert_allclose(g, np.eye(g.shape[0]), atol=1e-8)
    # partition identity holds for the spin-polarized subsystem DFT
    total = (mu.e_act + mu.e_env + mu.two_e_cross
             + mu._ks_engine.energy_nuc())
    assert np.isclose(total, mu._global_ks.e_tot, atol=1e-10)

    # per-spin env deletion must keep the full per-channel spaces: with
    # equal env COUNTS but different env INDICES the union rule deleted
    # legitimate virtuals (fixed: driver.py _delete_environment)
    assert np.asarray(sol.mo_coeff).shape == (2, 7, 5)

    huz = nbed(projector="huzinaga", **common)
    assert huz.huzinaga["scf"].converged
    assert abs(huz.huzinaga["e_fci"] - mu.mu["e_fci"]) < 1e-5


def test_ragged_spin_environment_deletion():
    """Stress test: spin-asymmetric SPADE partitions with genuinely DIFFERENT
    per-spin environment counts (O2 triplet / 6-31G, 1 active atom: the env
    holds 4 alpha but only 2 beta orbitals).  The reference's union rule
    (reference driver.py:671-676) would over-delete both spins by the wrong
    ranking; here each spin deletes exactly its own environment and the
    narrower-env spin truncates its highest legit virtuals to keep the MO
    stack rectangular.  CL then exercises the ragged-truncation equalizer
    (kernel-column extension).  PROGRESS round-3 worklist item."""
    from pathlib import Path

    from nbed_tpu import nbed

    xyz = str(Path(__file__).parent / "molecules" / "o2.xyz")
    common = dict(geometry=xyz, n_active_atoms=1, basis="6-31G", spin=2,
                  xc_functional="b3lyp", localization="spade",
                  virtual_localization="cl", run_ccsd_emb=True)
    mu = nbed(projector="mu", **common)
    scf = mu.mu["scf"]
    assert scf.converged
    c = np.asarray(scf.mo_coeff)
    assert c.ndim == 3 and c.dtype == np.float64  # rectangular, not object
    # per-spin MO sets stay S-orthonormal through deletion + CL surgery
    s = np.asarray(scf.engine.s)
    for sp in range(2):
        g = c[sp].T @ s @ c[sp]
        np.testing.assert_allclose(g, np.eye(g.shape[0]), atol=1e-8)
    # electron counts preserved per spin
    occ = np.asarray(scf.mo_occ)
    na, nb = scf.nelec
    assert occ[0].sum() == na and occ[1].sum() == nb
    # the ragged CL equalizer recorded the extension shell on one spin
    sh_a, sh_b = mu.mu["cl"].shells
    assert sh_a[-1] == sh_b[-1] == c.shape[-1]

    huz = nbed(projector="huzinaga", **common)
    assert huz.huzinaga["scf"].converged
    # both projectors land on the same embedded CCSD energy (truncated
    # spaces differ slightly by ranking, so the bound is loose)
    assert abs(huz.huzinaga["e_ccsd"] - mu.mu["e_ccsd"]) < 5e-3


def test_delete_spin_environment_extra_virtuals():
    """Unit test of the rectangularizing extra-virtual truncation."""
    from nbed_tpu.driver import _delete_spin_environment

    rng = np.random.default_rng(7)
    n = 8
    mo_coeff = rng.normal(size=(n, n))
    mo_energy = np.arange(n, dtype=float)
    mo_occ = np.array([1.0, 1.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0])
    # MU path: 2 env (top) + 1 extra virtual (next-highest legit virtual)
    c, e, o = _delete_spin_environment(
        ProjectorTypes.MU, 2, mo_coeff, mo_energy, mo_occ, None,
        n_extra_virt=1,
    )
    assert c.shape == (n, 5)
    # kept: occupied 0,1,2 and the two lowest virtuals 3,4
    np.testing.assert_array_equal(e, [0.0, 1.0, 2.0, 3.0, 4.0])
    assert o.sum() == 3.0
    # never deletes occupied orbitals even when virtuals run out
    from nbed_tpu.exceptions import NbedDriverError

    with pytest.raises(NbedDriverError):
        _delete_spin_environment(
            ProjectorTypes.MU, 2, mo_coeff, mo_energy, mo_occ, None,
            n_extra_virt=4,
        )


def test_huzinaga_env_ranking_metrics(huz_driver):
    """Adjudicate the environment-MO ranking metric (round-5 VERDICT #6).

    The reference ranks env MOs with ``einsum("ij,ki->i", C^T, P@C)``
    (reference driver.py:749-753), which contracts j and k INDEPENDENTLY —
    a product of coefficient sums, not the overlap its comments describe.
    nbed_tpu uses the true overlap ``diag(C^T P_env C)`` ("ij,ji->i").
    This test pins that on the oracle system both metrics select the SAME
    environment set (so adopting the physical metric changes nothing
    pinned elsewhere), and that the true metric separates env from active
    MOs with a strict gap.
    """
    drv = huz_driver
    pre, _v_emb = drv._huzinaga_embed(
        drv._hf_engine, drv.embedding_potential, drv.localized_system, None
    )
    c_env = drv.localized_system.c_enviro
    mo = np.asarray(pre.mo_coeff)
    proj = np.asarray(drv._env_projector)
    if mo.ndim == 2:
        lanes = [(mo, proj, c_env.shape[-1])]
    else:
        lanes = [(mo[s], proj[s], c_env.shape[-1]) for s in (0, 1)]
    for c, p, n_env in lanes:
        pc = p @ c
        true_metric = np.einsum("ij,ji->i", c.T, pc)
        ref_metric = np.einsum("ij,ki->i", c.T, pc)
        sel_true = np.argsort(true_metric)[::-1][:n_env]
        sel_ref = np.argsort(ref_metric)[::-1][:n_env]
        assert set(sel_true.tolist()) == set(sel_ref.tolist()), (
            "reference product-of-sums metric and true overlap metric "
            f"disagree: {sel_ref} vs {sel_true}"
        )
        # strict separation: the weakest selected env MO must carry clearly
        # more env-projector weight than the strongest unselected MO
        ranked = np.sort(true_metric)[::-1]
        assert ranked[n_env - 1] > 2.0 * max(ranked[n_env], 0.0) + 1e-3
