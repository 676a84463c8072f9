"""Quadrature-grid tests.

The Lebedev tables are generated by solving the octahedral moment equations
(scripts/gen_lebedev.py) and verified there against all spherical harmonics;
these tests re-verify the SHIPPED tables independently (so a regeneration
mistake cannot slip through) and exercise the high grid levels that the new
350/434/590 rules unlock (the reference inherits these levels from PySCF's
dft.gen_grid, reference driver.py:163-169).
"""

import math

import numpy as np
import pytest

from nbed_tpu.grids.data_lebedev import LEBEDEV_PARAMS
from nbed_tpu.grids.lebedev import lebedev_grid


def _real_sph_harm(l, m, pts):
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    rxy = np.hypot(x, y)
    phi = np.arctan2(y, x)
    am = abs(m)
    pmm = np.ones_like(z)
    fact = 1.0
    for _ in range(am):
        pmm = -pmm * fact * rxy
        fact += 2.0
    if l == am:
        plm = pmm
    else:
        pmmp1 = z * (2 * am + 1) * pmm
        if l == am + 1:
            plm = pmmp1
        else:
            for ll in range(am + 2, l + 1):
                pll = (z * (2 * ll - 1) * pmmp1 - (ll + am - 1) * pmm) / (ll - am)
                pmm, pmmp1 = pmmp1, pll
            plm = pmmp1
    norm = math.sqrt((2 * l + 1) / (4 * math.pi)
                     * math.factorial(l - am) / math.factorial(l + am))
    if m > 0:
        return math.sqrt(2.0) * norm * plm * np.cos(am * phi)
    if m < 0:
        return math.sqrt(2.0) * norm * plm * np.sin(am * phi)
    return norm * plm


@pytest.mark.parametrize("n", sorted(LEBEDEV_PARAMS))
def test_lebedev_rule_exact(n):
    """Every shipped rule integrates all Y_lm up to its degree exactly."""
    degree = LEBEDEV_PARAMS[n][0]
    pts, wts = lebedev_grid(n)
    assert len(pts) == n
    np.testing.assert_allclose(np.linalg.norm(pts, axis=1), 1.0, atol=1e-13)
    np.testing.assert_allclose(wts.sum(), 1.0, atol=1e-12)
    worst = 0.0
    for l in range(degree + 1):
        for m in range(-l, l + 1):
            v = float(np.sum(wts * _real_sph_harm(l, m, pts)))
            tgt = 1.0 / math.sqrt(4.0 * math.pi) if (l, m) == (0, 0) else 0.0
            worst = max(worst, abs(v - tgt))
    assert worst < 5e-12, (n, degree, worst)


def test_high_rules_available():
    """Grid levels beyond 3 resolve to real rules now (350/434/590)."""
    for n in (350, 434, 590):
        assert n in LEBEDEV_PARAMS
    from nbed_tpu.grids.grid import _default_rad_ang

    # period-3 element (S, z=16) at levels 3/4: degree 35 -> 434, 41 -> 590
    assert _default_rad_ang(16, 3)[1] == 434
    assert _default_rad_ang(16, 4)[1] == 590


@pytest.mark.slow
def test_grid_level_density_integration():
    """The pruned molecular grid integrates the SCF density to nelec."""
    from nbed_tpu.chem import build_molecule
    from nbed_tpu.grids.grid import build_grid, eval_aos
    from nbed_tpu.scf.engine import SCFEngine

    mol = build_molecule("1\n\nS 0.0 0.0 0.0", "sto-3g")
    res = SCFEngine(mol, conv_tol=1e-9, init_guess="hcore").kernel(nelec=(9, 7))
    dm = np.asarray(res.make_rdm1()).sum(axis=0)
    for level, tol in ((3, 5e-7), (4, 5e-8)):
        points, weights = build_grid(mol, scheme="reference", level=level)
        aos = np.asarray(eval_aos(mol, points)[0])
        rho = np.einsum("gi,ij,gj->g", aos, dm, aos)
        n_elec = float(np.asarray(weights) @ rho)
        assert abs(n_elec - 16.0) < tol, (level, n_elec)
