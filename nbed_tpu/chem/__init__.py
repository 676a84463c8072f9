"""Molecule, basis-set and AO-metadata layer (host-side, static shapes).

Replaces the reference's delegation to ``pyscf.gto`` (reference
driver.py:87-104, SURVEY.md §2.3 row 1) with a self-contained basis parser
and shell tables designed so that every downstream integral kernel is a pure
function of atomic coordinates with static shapes — the property that makes
``vmap`` over conformer batches and ``jit`` re-use work on the device.
"""

from .molecule import Molecule, build_molecule, parse_xyz
from .periodic import SYMBOL_TO_Z, Z_TO_SYMBOL

__all__ = ["Molecule", "build_molecule", "parse_xyz", "SYMBOL_TO_Z", "Z_TO_SYMBOL"]
