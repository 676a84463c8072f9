"""Configuration model, enums and parsing helpers.

Schema-compatible with the reference config (reference nbed/config.py:79-145)
so existing JSON config files are drop-in: same field names, defaults and
validation behaviour (unknown keys rejected, XYZ regex + file-path coercion,
enums from their values, positive/non-negative bounds).  A plain dataclass
with its own validation: the package needs nothing beyond JAX, numpy and
scipy.
"""

import dataclasses
import json
import logging
import os
import re
from enum import Enum
from functools import partial
from pathlib import Path
from typing import Any

logger = logging.getLogger(__name__)


class ValidationError(ValueError):
    """A configuration value is missing, unknown or out of range."""


class ProjectorTypes(Enum):
    """Implemented projection operators (reference config.py:25-30)."""

    MU = "mu"
    HUZ = "huzinaga"
    BOTH = "both"


class OccupiedLocalizerTypes(Enum):
    """Implemented occupied-orbital localizers (reference config.py:33-39)."""

    SPADE = "spade"
    BOYS = "boys"
    IBO = "ibo"
    PM = "pm"


class VirtualLocalizerTypes(Enum):
    """Implemented virtual-orbital localizers (reference config.py:42-47)."""

    CONCENTRIC = "cl"
    PROJECTED_AO = "pao"
    DISABLE = "disable"


_XYZ = re.compile("^\\d+\n\\s?\n(?:\\w(?:\\s+\\-?\\d\\.\\d+){3}\n?)*")
_QUBIT_MAPPINGS = ("jw", "bk", "parity")


def _check_xyz(name: str, text: str) -> str:
    if not _XYZ.match(text):
        raise ValidationError(
            f"{name}: string does not match the XYZ pattern {_XYZ.pattern!r}"
        )
    return text


def validate_xyz_file(maybe_xyz: Any) -> str:
    """Coerce a path to an XYZ file into its contents; pass raw strings through.

    Mirrors reference config.py:55-76 behaviour: an existing path is read and
    validated as XYZ text; a non-existent path string is returned unchanged so
    the geometry regex produces the validation error.
    """
    match maybe_xyz:
        case str() | Path():
            if os.path.exists(maybe_xyz):
                with open(maybe_xyz) as file:
                    content = file.read()
                return _check_xyz("geometry", content)
            return str(maybe_xyz)
        case _:
            return maybe_xyz


# ------------------------------------------------------------ field coercers
def _str(name, v):
    if not isinstance(v, str):
        raise ValidationError(f"{name}: expected a string, got {v!r}")
    return v


def _bool(name, v):
    if isinstance(v, bool):
        return v
    if isinstance(v, int) and v in (0, 1):
        return bool(v)
    if isinstance(v, str) and v.lower() in ("true", "false", "1", "0"):
        return v.lower() in ("true", "1")
    raise ValidationError(f"{name}: expected a boolean, got {v!r}")


def _int(name, v, lo):
    if isinstance(v, str):
        try:
            v = int(v)
        except ValueError:
            pass
    if isinstance(v, float) and v.is_integer():
        v = int(v)
    if isinstance(v, bool) or not isinstance(v, int):
        raise ValidationError(f"{name}: expected an integer, got {v!r}")
    if v < lo:
        raise ValidationError(f"{name}: must be >= {lo}, got {v}")
    return v


def _float(name, v, gt=None, lt=None):
    if isinstance(v, str):
        try:
            v = float(v)
        except ValueError:
            pass
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        raise ValidationError(f"{name}: expected a number, got {v!r}")
    v = float(v)
    if gt is not None and not v > gt:
        raise ValidationError(f"{name}: must be > {gt}, got {v}")
    if lt is not None and not v < lt:
        raise ValidationError(f"{name}: must be < {lt}, got {v}")
    return v


def _enum(cls):
    def coerce(name, v):
        if isinstance(v, cls):
            return v
        try:
            return cls(v)
        except ValueError:
            raise ValidationError(
                f"{name}: expected one of {[m.value for m in cls]}, got {v!r}"
            ) from None
    return coerce


def _optional(coerce):
    return lambda name, v: None if v is None else coerce(name, v)


def _list(name, v):
    if isinstance(v, (list, tuple)):
        return list(v)
    raise ValidationError(f"{name}: expected a list, got {v!r}")


def _geometry(name, v):
    return _check_xyz(name, _str(name, validate_xyz_file(v)))


def _file_path(name, v):
    if not isinstance(v, (str, Path)) or not Path(v).is_file():
        raise ValidationError(f"{name}: path {v!r} is not an existing file")
    return Path(v)


def _n_mo_overwrite(name, v):
    if not isinstance(v, (list, tuple)) or len(v) != 2:
        raise ValidationError(f"{name}: expected a pair, got {v!r}")
    return tuple(None if x is None else _NONNEG_INT(name, x) for x in v)


def _symmetry(name, v):
    if _bool(name, v):
        raise ValidationError(
            "symmetry=True is not supported: point-group symmetry is a "
            "PySCF Mole feature this backend does not use (dense kernels "
            "gain nothing from it). Remove the flag or set symmetry=false."
        )
    return False


def _qubit_mapping(name, v):
    if v not in _QUBIT_MAPPINGS:
        raise ValidationError(
            f"{name}: expected one of {list(_QUBIT_MAPPINGS)}, got {v!r}")
    return v


_POS_INT = partial(_int, lo=1)
_NONNEG_INT = partial(_int, lo=0)
_POS_FLOAT = partial(_float, gt=0.0)
_UNIT_INTERVAL = partial(_float, gt=0.0, lt=1.0)


def _field(coerce, default=dataclasses.MISSING):
    return dataclasses.field(default=default, metadata={"coerce": coerce})


@dataclasses.dataclass(init=False)
class NbedConfig:
    """Validated run configuration.

    Field-for-field compatible with the reference model
    (reference config.py:106-145). See that file's docstring for semantics.
    Construct with keyword arguments only; an unknown key, a missing
    required key or a value out of range raises :class:`ValidationError`.
    """

    geometry: str = _field(_geometry)
    n_active_atoms: int = _field(_POS_INT)
    basis: str = _field(_str)
    xc_functional: str = _field(_str)
    projector: ProjectorTypes = _field(_enum(ProjectorTypes), ProjectorTypes.MU)
    localization: OccupiedLocalizerTypes = _field(
        _enum(OccupiedLocalizerTypes), OccupiedLocalizerTypes.SPADE)
    convergence: float = _field(_POS_FLOAT, 1e-6)
    charge: int = _field(_NONNEG_INT, 0)
    spin: int = _field(_NONNEG_INT, 0)
    unit: str = _field(_str, "angstrom")
    # accepted for schema compatibility; only the default (False) is
    # supported.  The reference forwards this to gto.Mole (reference
    # driver.py:96-104); point-group symmetry adds no leverage to dense
    # kernels, so True is REJECTED rather than silently ignored.
    symmetry: bool = _field(_symmetry, False)

    savefile: Path | None = _field(_optional(_file_path), None)

    run_ccsd_emb: bool = _field(_bool, False)
    run_fci_emb: bool = _field(_bool, False)
    run_dft_in_dft: bool = _field(_bool, False)
    # extension beyond the reference (which exports the Hamiltonian to an
    # external SDK for this): solve the embedded Hamiltonian with the
    # built-in UCCSD VQE (solvers/vqe.py) and record e_vqe in the result
    run_vqe_emb: bool = _field(_bool, False)
    # extension beyond the reference: CIS/TDA excited states of the
    # embedded active region (solvers/cis.py) — the number of excitation
    # roots to record under result["cis"] (0 = off)
    run_cis_emb: int = _field(_NONNEG_INT, 0)
    # extension beyond the reference: full RPA/TDHF excited states of the
    # embedded active region (solvers/cis.run_rpa) — roots recorded under
    # result["rpa"] (0 = off)
    run_rpa_emb: int = _field(_NONNEG_INT, 0)

    mm_coords: list | None = _field(_optional(_list), None)
    mm_charges: list | None = _field(_optional(_list), None)
    mm_radii: list | None = _field(_optional(_list), None)

    mu_level_shift: float = _field(_POS_FLOAT, 1e6)
    init_huzinaga_rhf_with_mu: bool = _field(_bool, False)

    virtual_localization: VirtualLocalizerTypes = _field(
        _enum(VirtualLocalizerTypes), VirtualLocalizerTypes.CONCENTRIC)
    n_mo_overwrite: tuple = _field(_n_mo_overwrite, (None, None))
    occupied_threshold: float = _field(_UNIT_INTERVAL, 0.95)
    virtual_threshold: float = _field(_UNIT_INTERVAL, 0.95)
    max_shells: int = _field(_POS_INT, 4)
    norm_cutoff: float = _field(_POS_FLOAT, 0.05)
    overlap_cutoff: float = _field(_POS_FLOAT, 1e-5)

    force_unrestricted: bool = _field(_bool, False)

    # nbed_tpu extensions (absent from reference configs)
    # density_fitting: None = auto (DF above the driver's nao threshold)
    density_fitting: bool | None = _field(_optional(_bool), None)
    warmup_f32: bool = _field(_bool, False)
    # Z2-symmetry qubit tapering of the embedded Hamiltonian (ham/taper.py):
    # records the Pauli sum, its symmetries, sector and the tapered sum
    # under result["tapered"] — qubit counts below the raw register.
    taper_qubits: bool = _field(_bool, False)
    # fermion-to-qubit encoding used by taper_qubits / run_vqe_emb
    # (the "second_quantised" output itself is mapping-agnostic):
    # "jw" | "bk" | "parity"
    qubit_mapping: str = _field(_qubit_mapping, "jw")

    # consumed: scales the engine's chunked-intermediate memory knobs
    # (SCFEngine.max_memory_mb — DF-exchange chunk, XC table/stream switch)
    max_ram_memory: int = _field(_POS_INT, 4000)
    max_hf_cycles: int = _field(_POS_INT, 50)
    max_dft_cycles: int = _field(_POS_INT, 50)

    def __init__(self, **data):
        fields = {f.name: f for f in dataclasses.fields(self)}
        unknown = sorted(set(data) - set(fields))
        if unknown:
            raise ValidationError(f"unknown configuration keys: {unknown}")
        for name, f in fields.items():
            if name in data:
                value = data[name]
            elif f.default is not dataclasses.MISSING:
                value = f.default
            else:
                raise ValidationError(f"{name}: field required")
            setattr(self, name, f.metadata["coerce"](name, value))

    def model_dump(self) -> dict:
        """Field values as a dict (the pydantic-style accessor callers use)."""
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}

    def model_copy(self, update: dict | None = None) -> "NbedConfig":
        """A validated copy with ``update`` applied."""
        return NbedConfig(**{**self.model_dump(), **(update or {})})


def overwrite_config_kwargs(config: NbedConfig, **config_kwargs) -> NbedConfig:
    """Overwrite config values with keywords and revalidate (config.py:148-168)."""
    if not config_kwargs:
        return config
    config_dict = config.model_dump()
    config_dict.update(config_kwargs)
    return NbedConfig(**config_dict)


def parse_config(config: "NbedConfig | str | None" = None, **config_kwargs) -> NbedConfig:
    """Resolve the three accepted config inputs into a validated model.

    Accepts a validated model, a path to a JSON file, or bare keyword
    arguments; unknown objects fall back to keyword parsing
    (reference config.py:171-207).
    """
    match config:
        case NbedConfig():
            config = overwrite_config_kwargs(config, **config_kwargs)
        case str() | Path():
            with open(config) as f:
                data = json.load(f)
            config = overwrite_config_kwargs(NbedConfig(**data), **config_kwargs)
        case None:
            config = NbedConfig(**config_kwargs)
        case _:
            logger.warning("Unknown input to config argument will be ignored.")
            config = NbedConfig(**config_kwargs)
    return config
