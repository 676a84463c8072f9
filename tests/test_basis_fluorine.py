"""Fluorine cc-pVDZ: structural and energetic validation.

The F table was re-derived from the cc-pVDZ construction rule (the p5
ground term is unique, so the equivalence-restricted HF energy expression
is exact): contraction coefficients from the atomic ground-term HF
orbitals over the primitives (scripts/gen_ccpvdz_contractions.py — the
same code reproduces every digit of the published C and O tables), and
the two valence s exponents variationally optimized by the same rule
(scripts/opt_ccpvdz_exponents.py).  These tests pin the result
operationally, playing the role of the reference's PySCF-bundled tables
(reference driver.py:96-102): AO normalisation, the F atom and HF
molecule landing in their known windows above the Hartree-Fock limits,
and the reference test set's fluorinated molecule (fluoroethane, used in
the PRA study) running at cc-pVDZ quality.
"""

import jax

jax.config.update("jax_enable_x64", True)

import numpy as np
import pytest

from nbed_tpu.chem import build_molecule
from nbed_tpu.integrals import overlap
from nbed_tpu.scf.engine import SCFEngine


def test_ao_normalisation():
    mol = build_molecule("1\n\nF 0.0 0.0 0.0", "cc-pvdz")
    assert mol.nao == 14  # 3s 2p 1d
    s = np.asarray(overlap(mol))
    np.testing.assert_allclose(np.diag(s), 1.0, atol=1e-10)
    assert np.linalg.eigvalsh(s).min() > 1e-3


def test_f_atom_uhf_window():
    """UHF/cc-pVDZ F atom: above the HF limit (-99.4093), within the
    DZ-quality window (C/N/O land 2-17 mHa high; F ~25-40 mHa)."""
    mol = build_molecule("1\n\nF 0.0 0.0 0.0", "cc-pvdz")
    eng = SCFEngine(mol, conv_tol=1e-9, dm_conv_tol=1e-7, max_cycle=200,
                    init_guess="hcore")
    e = float(eng.kernel(nelec=(5, 4)).e_tot)
    assert -99.4093 < e < -99.365


def test_hydrogen_fluoride_rhf_window():
    """HF molecule at r_e = 0.917 A: RHF/cc-pVDZ must sit above the HF
    limit (-100.0708) and within DZ distance of it."""
    xyz = "2\n\nF 0.0 0.0 0.0\nH 0.0 0.0 0.917"
    mol = build_molecule(xyz, "cc-pvdz")
    eng = SCFEngine(mol, conv_tol=1e-9, dm_conv_tol=1e-7, max_cycle=200)
    e = float(eng.kernel(nelec=mol.nelec).e_tot)
    assert -100.0708 < e < -100.00


@pytest.mark.slow
def test_fluoroethane_ccpvdz_scf():
    """The PRA study's fluorinated molecule at cc-pVDZ (67 AOs)."""
    from pathlib import Path

    xyz = (Path(__file__).parent / "molecules" / "fluoroethane.xyz").read_text()
    mol = build_molecule(xyz, "cc-pvdz")
    assert mol.nao == 67
    eng = SCFEngine(mol, conv_tol=1e-8, dm_conv_tol=1e-6, max_cycle=200)
    res = eng.kernel(nelec=mol.nelec)
    assert bool(res.converged)
    # above the HF limit of C2H5F (< -178.4 is impossible at DZ; the
    # molecule must bind relative to separated UHF atoms: 2C + 5H + F)
    e = float(res.e_tot)
    assert -178.3 < e < -177.9
