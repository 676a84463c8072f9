"""Batched QM/MM conformer scan (BASELINE.md config #5 pattern).

A batch of geometries of a QM molecule in an MM point-charge field is
evaluated as ONE compiled program: integrals, QM/MM core-Hamiltonian terms
and the full SCF are pure functions of coordinates, so the conformer axis
is a plain vmap — sharded over the mesh 'batch' axis when more than one
device is available.

Usage: python examples/qmmm_conformer_scan.py [n_conformers]
"""

import sys
import time

import jax


import numpy as np  # noqa: E402

from nbed_tpu.chem import build_molecule  # noqa: E402
from nbed_tpu.parallel import batched_hf_energies, make_mesh  # noqa: E402


def main():
    n_conf = int(sys.argv[1]) if len(sys.argv) > 1 and sys.argv[1].isdigit() else 8
    xyz = (
        "3\n\nO   0.0000  0.000  0.115\n"
        "H   0.0000  0.754  -0.459\nH   0.0000  -0.754  -0.459\n"
    )
    # water in the field of two MM point charges (a crude solvent dipole)
    mol = build_molecule(
        xyz, "sto-3g",
        mm_coords=[[0.0, 0.0, 4.0], [0.0, 0.0, 5.0]],
        mm_charges=[-0.8, 0.4],
        mm_radii=None,
    )
    rng = np.random.default_rng(0)
    base = np.asarray(mol.coords)
    coords = np.repeat(base[None], n_conf, axis=0)
    coords += 0.02 * rng.standard_normal(coords.shape)  # thermal jitter (bohr)

    n_dev = len(jax.devices())
    mesh = make_mesh(n_dev, batch=n_dev) if n_dev > 1 and n_conf % n_dev == 0 else None
    t0 = time.perf_counter()
    energies, conv = batched_hf_energies(mol, coords, mesh=mesh,
                                         conv_tol=1e-8, max_cycle=60)
    dt = time.perf_counter() - t0
    energies = np.asarray(energies)
    print(f"{n_conf} conformers on {n_dev} device(s): {dt:.2f} s "
          f"({dt / n_conf:.3f} s/conformer, one compile)")
    print("converged:", np.asarray(conv).all())
    print("E range: ", energies.min(), "..", energies.max())


if __name__ == "__main__":
    main()
