"""Gaussian integral engine: jit-compiled McMurchie–Davidson kernels.

Native replacement for the reference's delegated PySCF/libcint integral
surface (SURVEY.md §2.3 rows 2-3): overlap/kinetic/nuclear one-electron
matrices, point-charge (QM/MM) attraction, dipole moments, cross-basis
overlap, and the full two-electron repulsion tensor.

Design: shell pairs/quartets are grouped by *static* angular-momentum and
contraction-length classes on the host; within a class, a single vectorised
kernel (pure function of atomic coordinates) is ``vmap``-ped over the
pair/quartet list and assembled by precomputed static index scatter. The
heavy arithmetic is batched tensor algebra (einsums over Hermite E / R
tables), which XLA maps onto the device's vector/matrix units, and the whole
engine is differentiable and ``vmap``-able over conformer coordinates.
"""

from .core import (
    dipole_integrals,
    kinetic,
    nuclear_attraction,
    overlap,
    overlap_cross,
    point_charge_attraction,
)
from .eri import eri_tensor
from .transform import ao_to_mo_1e, ao_to_mo_eri

__all__ = [
    "overlap",
    "overlap_cross",
    "kinetic",
    "nuclear_attraction",
    "point_charge_attraction",
    "dipole_integrals",
    "eri_tensor",
    "ao_to_mo_1e",
    "ao_to_mo_eri",
]
