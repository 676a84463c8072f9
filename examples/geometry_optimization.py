"""Geometry optimization on analytic autodiff gradients (beyond the
reference).

The reference framework has no nuclear gradients — geometries are inputs.
Here every integral (and the XC quadrature grid itself) is a differentiable
function of the coordinates, so analytic HF/KS gradients are one
``jax.grad`` over the stationary energy functional (solvers/gradients.py),
and geometry optimization is a host-side BFGS around it.

Usage: python examples/geometry_optimization.py [xyz_path] [basis]
Defaults: stretched water / STO-3G.
"""

import sys


import numpy as np  # noqa: E402

from nbed_tpu.chem import build_molecule  # noqa: E402
from nbed_tpu.solvers.gradients import hf_gradient, optimize_geometry  # noqa: E402

STRETCHED_WATER = """3

O   0.0000  0.000  0.100
H   0.0000  0.850  -0.500
H   0.0000  -0.850  -0.500
"""

BOHR = 0.52917721092


def main():
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    xyz = open(args[0]).read() if args else STRETCHED_WATER
    basis = args[1] if len(args) > 1 else "sto-3g"
    mol = build_molecule(xyz, basis)

    e0, g0, _ = hf_gradient(mol)
    print(f"start:     E = {float(e0):.10f} Ha   "
          f"|grad|max = {float(np.max(np.abs(np.asarray(g0)))):.2e} Ha/bohr")

    coords, e, n_steps, converged = optimize_geometry(mol, verbose=True)
    _, g, _ = hf_gradient(mol, coords=coords)
    print(f"optimized: E = {e:.10f} Ha   "
          f"|grad|max = {float(np.max(np.abs(np.asarray(g)))):.2e} Ha/bohr   "
          f"({n_steps} evaluations, converged={converged})")

    print("\noptimized geometry (angstrom):")
    for sym_z, xyz_bohr in zip(mol.atom_charges, np.asarray(coords)):
        print(f"  Z={int(sym_z):2d}  " + "  ".join(f"{v * BOHR:12.6f}"
                                                   for v in xyz_bohr))
    for i in range(1, mol.natm):
        r = np.linalg.norm(coords[i] - coords[0]) * BOHR
        print(f"  r(0-{i}) = {r:.4f} A")


if __name__ == "__main__":
    main()
