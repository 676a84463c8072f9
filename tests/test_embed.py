"""API façade tests (reference tests/test_embed.py)."""

import json

import pytest
from nbed_tpu.config import ValidationError

from nbed_tpu.driver import NbedDriver
from nbed_tpu.embed import nbed

pytestmark = pytest.mark.slow  # driver/compile-heavy; smoke tier = -m 'not slow'


@pytest.fixture(scope="module")
def fast_args(water_filepath):
    """Cheap config reused across façade tests."""
    return {
        "geometry": str(water_filepath),
        "n_active_atoms": 2,
        "basis": "STO-3G",
        "xc_functional": "b3lyp",
        "projector": "mu",
        "localization": "spade",
        "convergence": 1e-6,
        "run_ccsd_emb": False,
        "run_fci_emb": False,
    }


@pytest.fixture(scope="module")
def config_file(tmp_path_factory, fast_args):
    path = tmp_path_factory.mktemp("cfg") / "config.json"
    path.write_text(json.dumps(fast_args))
    return path


def test_args_input(fast_args):
    assert isinstance(nbed(**fast_args), NbedDriver)


def test_file_input(config_file):
    assert isinstance(nbed(str(config_file)), NbedDriver)


def test_config_overwrite(nbed_config):
    from nbed_tpu.config import overwrite_config_kwargs

    new = overwrite_config_kwargs(nbed_config, n_active_atoms=2)
    assert new.n_active_atoms == 2
    assert nbed_config.n_active_atoms == 1


def test_none_config_input_missing_geometry(nbed_args):
    args = dict(nbed_args)
    args.pop("geometry")
    with pytest.raises(ValidationError):
        nbed(config=None, **args)


def test_wrong_config_object(fast_args):
    driver = nbed(config=["a", "list"], **fast_args)
    assert isinstance(driver, NbedDriver)


def test_reference_config_file_parses():
    """The reference's JSON config schema is drop-in (same field names)."""
    from pathlib import Path

    from nbed_tpu.config import parse_config

    cfg = parse_config(str(Path(__file__).parent / "test_config.json"))
    assert cfg.n_active_atoms == 1
    assert cfg.basis == "STO-3G"
    assert cfg.run_dft_in_dft is True


def test_symmetry_true_rejected():
    """symmetry=True must error loudly, not silently no-op (the reference
    forwards it to gto.Mole; this backend has no point-group machinery)."""
    import pytest
    from nbed_tpu.config import ValidationError

    from nbed_tpu.config import NbedConfig

    with pytest.raises(ValidationError, match="symmetry"):
        NbedConfig(
            geometry="2\n\nH 0.0 0.0 0.0\nH 0.0 0.0 0.7\n",
            n_active_atoms=1, basis="sto-3g", xc_functional="b3lyp",
            symmetry=True,
        )


def test_max_ram_memory_scales_engine_knobs():
    """config.max_ram_memory is consumed: it scales the engine's chunked
    DF-exchange intermediate and the XC table/streaming switchover."""
    from nbed_tpu.chem import build_molecule
    from nbed_tpu.scf.engine import SCFEngine

    mol = build_molecule("2\n\nH 0.0 0.0 0.0\nH 0.0 0.0 0.7\n", "sto-3g")
    small = SCFEngine(mol, max_memory_mb=1000.0)
    default = SCFEngine(mol)
    assert small._df_chunk_elems * 4 == default._df_chunk_elems
    assert small._XC_TABLE_LIMIT * 4 == default._XC_TABLE_LIMIT
    # the knob reshapes traced programs, so it must key the program cache
    assert small._jit_spec != default._jit_spec
