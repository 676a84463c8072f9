"""Orbital localization: occupied (SPADE/PM/Boys/IBO), virtual (CL/PAO), ACE.

Self-contained replacements for the reference's localizer stack
(reference nbed/localizers/): SPADE and concentric localization are batched
S^1/2-matmul + SVD pipelines (dense device linear algebra); PM/Boys/IBO are Jacobi
2x2 rotation sweeps over our own dipole / Lowdin-population integrals
instead of PySCF ``lo``.
"""

from .ace import ACELocalizer
from .occupied import (
    BOYSLocalizer,
    IBOLocalizer,
    OccupiedLocalizer,
    PMLocalizer,
    SPADELocalizer,
    check_values,
)
from .system import LocalizedSystem
from .virtual import ConcentricLocalizer, PAOLocalizer

__all__ = [
    "LocalizedSystem",
    "OccupiedLocalizer",
    "SPADELocalizer",
    "PMLocalizer",
    "BOYSLocalizer",
    "IBOLocalizer",
    "ConcentricLocalizer",
    "PAOLocalizer",
    "ACELocalizer",
    "check_values",
]
