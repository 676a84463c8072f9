"""Hamiltonian builder tests: the diagonalise-and-compare-to-FCI oracle
(pattern of reference tests/test_builder.py:55-120) plus reduce_virtuals."""

import numpy as np
import pytest

from nbed_tpu.chem import build_molecule
from nbed_tpu.ham import (
    HamiltonianBuilder,
    bravyi_kitaev,
    jordan_wigner,
    pauli_ground_state,
    reduce_virtuals,
)
from nbed_tpu.scf.engine import SCFEngine
from nbed_tpu.solvers import run_fci

pytestmark = pytest.mark.slow  # driver/compile-heavy; smoke tier = -m 'not slow'


def test_restricted_groundstate(water_rhf):
    const, h1, h2 = HamiltonianBuilder(water_rhf, 0).build()
    assert h1.shape == (14, 14)  # 14 qubits, reference test_builder.py:65
    e_fci, _ = run_fci(const, h1, h2, 14, (5, 5))
    # independently JW-map and diagonalise the qubit Hamiltonian
    jw = jordan_wigner(const, h1, h2)
    gs = pauli_ground_state(jw, k=1)
    assert np.isclose(e_fci[0], gs[0], atol=1e-8)
    # electronic FCI oracle (reference test_driver.py:76 minus e_nuc)
    assert np.isclose(
        e_fci[0] + water_rhf.energy_nuc(), -75.00912605315143, atol=1e-7
    )


def test_unrestricted_groundstate(water_uhf):
    const, h1, h2 = HamiltonianBuilder(water_uhf, 0).build()
    assert h1.shape == (14, 14)
    e_fci, _ = run_fci(const, h1, h2, 14, (5, 5))
    assert np.isclose(
        e_fci[0] + water_uhf.energy_nuc(), -75.00912605315143, atol=1e-7
    )


def test_jw_term_count_converged(water_uhf):
    """The converged water/STO-3G Hamiltonian has exactly 1086 JW terms.

    A run-to-run-stable count is a sharp convergence diagnostic:
    limit-cycled or unconverged SCFs produce more terms, because near-zero
    integrals fail the EQ_TOLERANCE cut on unconverged orbitals."""
    const, h1, h2 = HamiltonianBuilder(water_uhf, 0).build()
    assert len(jordan_wigner(const, h1, h2).terms) == 1086


def test_charged_groundstate(water_xyz):
    """Unrestricted, charged open-shell (reference test_builder.py:87-120)."""
    mol = build_molecule(water_xyz, "sto-3g", charge=1, spin=1)
    sol = SCFEngine(mol, conv_tol=1e-10, dm_conv_tol=1e-8, max_cycle=100).kernel()
    const, h1, h2 = HamiltonianBuilder(sol).build()
    e_fci, _ = run_fci(const, h1, h2, 14, (5, 4))
    jw = jordan_wigner(const, h1, h2)
    gs = pauli_ground_state(jw, k=3)
    # the (5,4) sector ground state appears among the lowest qubit eigenvalues
    assert np.any(np.isclose(e_fci[0], gs, atol=1e-8))


def test_jw_bk_spectra_agree(water_uhf):
    """JW and BK must be isospectral (validated on a reduced problem)."""
    reduced = reduce_virtuals(water_uhf, 3)  # 8 qubits: cheap full spectra
    const, h1, h2 = HamiltonianBuilder(reduced, 0).build()
    jw = jordan_wigner(const, h1, h2)
    bk = bravyi_kitaev(const, h1, h2)
    assert np.allclose(
        pauli_ground_state(jw, k=4), pauli_ground_state(bk, k=4), atol=1e-8
    )


def test_parity_encoding(water_uhf):
    """Parity encoding: isospectral with JW, no X/Y ever touches the top
    qubit (total number parity lives there as a plain Z), the single-qubit
    Z_{n-1} symmetry is found and tapered, and the python/native term
    engines agree."""
    import os

    from nbed_tpu.ham import (
        find_z2_symmetries,
        parity_transform,
        taper_auto,
    )

    reduced = reduce_virtuals(water_uhf, 3)  # 8 qubits: cheap full spectra
    const, h1, h2 = HamiltonianBuilder(reduced, 0).build()
    jw = jordan_wigner(const, h1, h2)
    par = parity_transform(const, h1, h2)
    assert np.allclose(
        pauli_ground_state(jw, k=4), pauli_ground_state(par, k=4), atol=1e-8
    )
    top = 1 << (par.n_qubits - 1)
    assert all(not (x & top) for (x, _) in par.terms)
    syms = find_z2_symmetries(par)
    # Z_{n-1} (total number parity) is in the Z-type symmetry group span
    span = {0}
    for z in (s.z for s in syms if s.x == 0):
        span |= {z ^ v for v in span}
    assert top in span
    tp, _, _ = taper_auto(par)
    assert tp.n_qubits < par.n_qubits
    assert np.isclose(pauli_ground_state(tp)[0],
                      pauli_ground_state(par)[0], atol=1e-9)
    # python numpy pipeline (f64 fast path) == native C++ engine
    old = os.environ.get("NBED_TPU_QUBIT")
    try:
        os.environ["NBED_TPU_QUBIT"] = "python"
        py = parity_transform(const, h1, h2)
    finally:
        if old is None:
            os.environ.pop("NBED_TPU_QUBIT", None)
        else:
            os.environ["NBED_TPU_QUBIT"] = old
    assert set(py.terms) == set(par.terms)
    assert max(abs(py.terms[k] - par.terms[k]) for k in py.terms) < 1e-12


def test_reduce_virtuals(water_rhf, water_uhf):
    reduced_r = reduce_virtuals(water_rhf, 1)
    reduced_u = reduce_virtuals(water_uhf, 1)
    assert reduced_r.mo_coeff.shape[-1] == reduced_u.mo_coeff.shape[-1] == 6
    assert np.all(reduced_r.mo_occ == np.sum(reduced_u.mo_occ, axis=0))
    with pytest.raises(ValueError) as excinfo:
        reduce_virtuals(water_rhf, 7)
    assert "more than exist" in str(excinfo)
    assert np.all(water_rhf.mo_coeff == reduce_virtuals(water_rhf, 0).mo_coeff)


def test_measurement_groups(water_uhf):
    """QWC grouping: complete, valid (all pairs in a group qubit-wise
    commute), and far fewer groups than terms."""
    from nbed_tpu.ham import measurement_groups

    reduced = reduce_virtuals(water_uhf, 2)
    const, h1, h2 = HamiltonianBuilder(reduced, 0).build()
    jw = jordan_wigner(const, h1, h2)
    groups = measurement_groups(jw)
    # complete: every term appears exactly once with its coefficient
    flat = {k: c for g in groups for (k, c) in g}
    assert flat == jw.terms
    # valid: all pairs within a group are qubit-wise commuting
    for g in groups:
        for i, ((xa, za), _) in enumerate(g):
            for (xb, zb), _ in g[i + 1:]:
                common = (xa | za) & (xb | zb)
                assert (xa & common) == (xb & common)
                assert (za & common) == (zb & common)
    # useful: a real compression (water-scale JW typically ~5-10x)
    assert len(groups) < len(jw) / 3


def test_measurement_groups_trivial():
    from nbed_tpu.ham import PauliSum, measurement_groups

    # all-diagonal sum -> one group
    p = PauliSum(4)
    p.add(1.0, 0, 0b0011)
    p.add(0.5, 0, 0b0101)
    p.add(-0.25, 0, 0)
    assert len(measurement_groups(p)) == 1
    # X0 vs Z0 anticommute on qubit 0 -> two groups
    q = PauliSum(1)
    q.add(1.0, 1, 0)
    q.add(1.0, 0, 1)
    assert len(measurement_groups(q)) == 2
    assert measurement_groups(PauliSum(2)) == []
