"""Compare fermion-to-qubit encodings on an embedded Hamiltonian.

Runs the water-in-water embedding pipeline once, then maps the reduced
second-quantised Hamiltonian with Jordan-Wigner, Bravyi-Kitaev and the
parity encoding, reporting for each: Pauli-term count, max string weight,
qubit-wise-commuting measurement-group count, Z2-tapered register size,
and the (identical) ground-state energy.

Run:  PYTHONPATH=. python examples/qubit_mappings.py
"""

import numpy as np


from nbed_tpu import nbed  # noqa: E402
from nbed_tpu.ham import (  # noqa: E402
    measurement_groups,
    pauli_ground_state,
    taper_auto,
)
from nbed_tpu.ham.qubit import MAPPINGS  # noqa: E402


def weight(x, z):
    return bin(x | z).count("1")


def main():
    driver = nbed(
        geometry="tests/molecules/water.xyz",
        n_active_atoms=1,
        basis="STO-3G",
        xc_functional="b3lyp",
        projector="mu",
        localization="spade",
        convergence=1e-8,
    )
    const, h1, h2 = driver.mu["second_quantised"]
    print(f"embedded Hamiltonian: {h1.shape[0]} spin orbitals\n")
    print(f"{'mapping':>8} {'terms':>6} {'max|P|':>6} {'QWC groups':>10} "
          f"{'tapered q':>9} {'E0 (Ha)':>16}")
    for name, fn in MAPPINGS.items():
        psum = fn(const, h1, h2)
        tapered, syms, _ = taper_auto(psum)
        e0 = pauli_ground_state(psum)[0]
        w = max(weight(x, z) for (x, z) in psum.terms)
        print(f"{name:>8} {len(psum):>6} {w:>6} "
              f"{len(measurement_groups(psum)):>10} "
              f"{tapered.n_qubits:>9} {e0:>16.10f}")


if __name__ == "__main__":
    main()
