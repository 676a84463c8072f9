"""Replicate the reference's qubit-reduction study (PRA 109, 022418).

Runs projection-based embedding (SPADE + concentric localization, mu and
Huzinaga) on small organics and prints full-system vs embedded qubit and
Jordan-Wigner Pauli-term counts — the problem-size-reduction table of
BASELINE.md (e.g. formamide 36 -> 26 qubits).

Usage: python examples/qubit_reduction.py [molecule.xyz ...]
"""

import sys
import time
from pathlib import Path


from nbed_tpu import nbed  # noqa: E402
from nbed_tpu.ham.resources import embedding_reduction  # noqa: E402

MOLECULES = Path(__file__).parent.parent / "tests" / "molecules"
DEFAULTS = ["formamide.xyz", "acetonitrile.xyz"]


def main():
    paths = [a for a in sys.argv[1:] if a.endswith(".xyz")] or [
        str(MOLECULES / n) for n in DEFAULTS
    ]
    print(f"{'molecule':<16} {'qubits full->mu/huz':<24} "
          f"{'JW terms full->mu/huz':<30} {'t (s)':>7}")
    for path in paths:
        t0 = time.perf_counter()
        driver = nbed(
            geometry=path,
            n_active_atoms=2,
            basis="STO-3G",
            xc_functional="b3lyp",
            projector="both",
            localization="spade",
            convergence=1e-6,
        )
        res = embedding_reduction(driver)
        dt = time.perf_counter() - t0
        name = Path(path).stem
        qub = (f"{res['full']['n_qubits']} -> "
               f"{res['mu']['n_qubits']}/{res['huzinaga']['n_qubits']}")
        terms = (f"{res['full']['n_terms']:,} -> "
                 f"{res['mu']['n_terms']:,}/{res['huzinaga']['n_terms']:,}")
        print(f"{name:<16} {qub:<24} {terms:<30} {dt:7.1f}")


if __name__ == "__main__":
    main()
