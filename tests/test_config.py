"""NbedConfig validation: the reference schema, enforced without pydantic."""

import dataclasses

import pytest

from nbed_tpu.config import (
    NbedConfig,
    OccupiedLocalizerTypes,
    ProjectorTypes,
    ValidationError,
    VirtualLocalizerTypes,
    parse_config,
)

WATER = "3\n\nO 0.0000 0.000 0.115\nH 0.0000 0.754 -0.459\nH 0.0000 -0.754 -0.459\n"
BASE = dict(geometry=WATER, n_active_atoms=1, basis="STO-3G",
            xc_functional="b3lyp")


@pytest.mark.parametrize("update, match", [
    ({"not_a_field": 1}, "unknown"),
    ({"geometry": "THIS/IS/NOT/AN/XYZ/FILE"}, "geometry"),
    ({"geometry": "H 0 0 0\n"}, "geometry"),
    ({"projector": "neither"}, "projector"),
    ({"localization": "foo"}, "localization"),
    ({"virtual_localization": "bar"}, "virtual_localization"),
    ({"n_active_atoms": 0}, "n_active_atoms"),
    ({"charge": -1}, "charge"),
    ({"convergence": 0.0}, "convergence"),
    ({"max_shells": 0}, "max_shells"),
    ({"occupied_threshold": 0.0}, "occupied_threshold"),
    ({"virtual_threshold": 1.0}, "virtual_threshold"),
    ({"symmetry": True}, "symmetry"),
    ({"qubit_mapping": "xyz"}, "qubit_mapping"),
    ({"n_mo_overwrite": (1, -2)}, "n_mo_overwrite"),
    ({"savefile": "/no/such/file.json"}, "savefile"),
    ({"basis": 3}, "basis"),
])
def test_invalid_values_rejected(update, match):
    with pytest.raises(ValidationError, match=match):
        NbedConfig(**{**BASE, **update})


@pytest.mark.parametrize("missing", ["geometry", "n_active_atoms", "basis",
                                     "xc_functional"])
def test_required_fields(missing):
    args = dict(BASE)
    args.pop(missing)
    with pytest.raises(ValidationError, match=missing):
        NbedConfig(**args)


def test_validation_error_is_value_error():
    assert issubclass(ValidationError, ValueError)


def test_defaults_match_reference_schema():
    cfg = NbedConfig(**BASE)
    assert cfg.projector is ProjectorTypes.MU
    assert cfg.localization is OccupiedLocalizerTypes.SPADE
    assert cfg.virtual_localization is VirtualLocalizerTypes.CONCENTRIC
    assert (cfg.convergence, cfg.charge, cfg.spin, cfg.unit) == (
        1e-6, 0, 0, "angstrom")
    assert (cfg.max_ram_memory, cfg.max_hf_cycles, cfg.max_dft_cycles) == (
        4000, 50, 50)
    assert cfg.n_mo_overwrite == (None, None)
    assert cfg.density_fitting is None and cfg.qubit_mapping == "jw"


def test_values_coerced_like_json_input():
    cfg = NbedConfig(**{**BASE, "projector": "huzinaga",
                        "virtual_localization": "pao",
                        "n_mo_overwrite": [None, 3], "convergence": 1,
                        "run_ccsd_emb": "true", "max_shells": 2.0})
    assert cfg.projector is ProjectorTypes.HUZ
    assert cfg.virtual_localization is VirtualLocalizerTypes.PROJECTED_AO
    assert cfg.n_mo_overwrite == (None, 3)
    assert cfg.convergence == 1.0 and isinstance(cfg.convergence, float)
    assert cfg.run_ccsd_emb is True and cfg.max_shells == 2


def test_geometry_path_coerced_to_contents(tmp_path):
    path = tmp_path / "water.xyz"
    path.write_text(WATER)
    assert NbedConfig(**{**BASE, "geometry": str(path)}).geometry == WATER
    bad = tmp_path / "bad.xyz"
    bad.write_text("not an xyz file\n")
    with pytest.raises(ValidationError, match="geometry"):
        NbedConfig(**{**BASE, "geometry": str(bad)})


def test_model_dump_and_copy_round_trip():
    cfg = NbedConfig(**{**BASE, "projector": "both", "run_fci_emb": True})
    dumped = cfg.model_dump()
    assert set(dumped) == {f.name for f in dataclasses.fields(NbedConfig)}
    assert NbedConfig(**dumped) == cfg
    copy = cfg.model_copy(update={"n_active_atoms": 2})
    assert copy.n_active_atoms == 2 and cfg.n_active_atoms == 1
    assert copy.model_copy(update={}) == copy
    with pytest.raises(ValidationError, match="n_active_atoms"):
        cfg.model_copy(update={"n_active_atoms": -1})


def test_parse_config_kwargs_override(tmp_path):
    import json

    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({**BASE, "projector": "huzinaga"}))
    cfg = parse_config(str(path), n_active_atoms=2)
    assert cfg.projector is ProjectorTypes.HUZ and cfg.n_active_atoms == 2
