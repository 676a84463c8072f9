"""Shared fixtures. Default to the CPU backend with a virtual 8-device mesh
(multi-chip sharding tests run on host devices) before any jax import.

Tests marked ``gpu`` take their device from the ``gpu_device`` fixture and
skip where JAX has no CUDA backend; run them on a card with
``JAX_PLATFORMS=cpu,cuda python -m pytest tests -m gpu`` (CPU stays the
default backend for everything else)."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
# --xla_cpu_max_isa=AVX2: at AVX512 XLA:CPU adds the LLVM tuning prefs
# +prefer-no-scatter/+prefer-no-gather to the compile target, and the AOT
# loader's host-feature probe never reports tuning prefs — so every
# persistent-cache reload warns "could lead to execution errors such as
# SIGILL" even for artifacts this very host compiled.  Capping to AVX2
# removes the tuning prefs and the noise.
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8 --xla_cpu_max_isa=AVX2"
)

from pathlib import Path  # noqa: E402

import pytest  # noqa: E402

from nbed_tpu.chem import build_molecule  # noqa: E402
from nbed_tpu.config import NbedConfig  # noqa: E402
from nbed_tpu.driver import NbedDriver  # noqa: E402
from nbed_tpu.scf.engine import SCFEngine  # noqa: E402

MOLECULES = Path(__file__).parent / "molecules"


@pytest.fixture(scope="session")
def gpu_device():
    """The first CUDA device: decided here, never at import.  Skips only on
    a host with no NVIDIA card; where a card is present and JAX cannot
    reach it, the test fails."""
    import shutil

    if shutil.which("nvidia-smi") is None:
        pytest.skip("no NVIDIA card on this host (no nvidia-smi)")
    import jax

    try:
        return jax.devices("cuda")[0]
    except RuntimeError as exc:
        pytest.fail(f"an NVIDIA card is present but JAX cannot reach it "
                    f"(JAX_PLATFORMS={os.environ.get('JAX_PLATFORMS')!r}; "
                    f"run with JAX_PLATFORMS=cpu,cuda): {exc}")


@pytest.fixture(scope="session")
def water_filepath() -> Path:
    return MOLECULES / "water.xyz"


@pytest.fixture(scope="session")
def water_xyz(water_filepath) -> str:
    return water_filepath.read_text()


@pytest.fixture(scope="session")
def water_molecule(water_xyz):
    return build_molecule(water_xyz, "sto-3g")


@pytest.fixture(scope="session")
def water_rhf_engine(water_molecule) -> SCFEngine:
    return SCFEngine(water_molecule, restricted=True, conv_tol=1e-10,
                     dm_conv_tol=1e-8, max_cycle=100)


@pytest.fixture(scope="session")
def water_uhf_engine(water_molecule) -> SCFEngine:
    return SCFEngine(water_molecule, conv_tol=1e-10, dm_conv_tol=1e-8,
                     max_cycle=100)


@pytest.fixture(scope="session")
def water_rhf(water_rhf_engine):
    return water_rhf_engine.kernel()


@pytest.fixture(scope="session")
def water_uhf(water_uhf_engine):
    return water_uhf_engine.kernel()


@pytest.fixture(scope="session")
def water_rks_engine(water_molecule) -> SCFEngine:
    return SCFEngine(water_molecule, xc="b3lyp", restricted=True,
                     conv_tol=1e-9, max_cycle=100)


@pytest.fixture(scope="session")
def water_uks_engine(water_molecule) -> SCFEngine:
    return SCFEngine(water_molecule, xc="b3lyp", conv_tol=1e-9, max_cycle=100)


@pytest.fixture(scope="session")
def water_rks(water_rks_engine):
    return water_rks_engine.kernel()


@pytest.fixture(scope="session")
def water_uks(water_uks_engine):
    return water_uks_engine.kernel()


@pytest.fixture(scope="session")
def nbed_args(water_filepath) -> dict:
    return {
        "geometry": str(water_filepath),
        "n_active_atoms": 1,
        "basis": "STO-3G",
        "xc_functional": "b3lyp",
        "projector": "mu",
        "localization": "spade",
        "convergence": 1e-06,
        "charge": 0,
        "spin": 0,
        "symmetry": False,
        "mu_level_shift": 1000000.0,
        "run_ccsd_emb": True,
        "run_fci_emb": True,
        "n_mo_overwrite": (None, None),
        "run_dft_in_dft": False,
        "max_ram_memory": 4000,
        "occupied_threshold": 0.95,
        "virtual_threshold": 0.95,
        "max_shells": 4,
        "init_huzinaga_rhf_with_mu": False,
        "max_hf_cycles": 50,
        "max_dft_cycles": 50,
        "mm_coords": None,
        "mm_charges": None,
        "mm_radii": None,
    }


@pytest.fixture(scope="session")
def nbed_config(nbed_args) -> NbedConfig:
    return NbedConfig(**nbed_args)


@pytest.fixture(scope="session")
def spinless_driver() -> NbedDriver:
    water_xyz_raw = (
        "3\n \nH\t0.2774\t0.8929\t0.2544\nO\t0\t0\t0\nH\t0.6068\t-0.2383\t-0.7169"
    )
    config = NbedConfig(
        geometry=water_xyz_raw,
        n_active_atoms=2,
        basis="STO-3G",
        xc_functional="b3lyp",
        projector="mu",
        localization="spade",
        convergence=1e-6,
        run_ccsd_emb=False,
        run_fci_emb=False,
    )
    driver = NbedDriver(config)
    driver.embed()
    return driver


@pytest.fixture(scope="session")
def mu_driver(nbed_config) -> NbedDriver:
    cfg = nbed_config.model_copy(update={})
    from nbed_tpu.config import ProjectorTypes

    cfg.projector = ProjectorTypes.MU
    driver = NbedDriver(cfg)
    driver.embed()
    return driver


@pytest.fixture(scope="session")
def huz_driver(nbed_config) -> NbedDriver:
    from nbed_tpu.config import ProjectorTypes

    cfg = nbed_config.model_copy(update={})
    cfg.projector = ProjectorTypes.HUZ
    driver = NbedDriver(cfg)
    driver.embed()
    return driver
