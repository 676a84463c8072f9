"""Replicate the PRA paper's embedding-error-reduction column.

The publication notebook's cell-29 table reports, per molecule, the error
of global DFT and of embedded CCSD against the full-system correlated
reference (STO-3G):

    epsilon_DFT = |E_DFT(global) - E_CCSD(full)|
    epsilon_huz = |E_CCSD-in-DFT(huz) - E_CCSD(full)|

Published (BASELINE.md): acetonitrile 0.484653 -> 0.168956 Ha,
formamide 0.619315 -> 0.233137 Ha. This script recomputes all three
energies with this framework on the notebook's exact geometries.

Run:  python scripts/epsilon_replication.py [molecule ...]
"""

import sys


from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from qubit_reduction import (  # noqa: E402
    ACETALDEHYDE,
    ACETONITRILE,
    ETHANAMINE,
    ETHANOL,
    FLUOROETHANE,
    FORMAMIDE,
    N_METHYLMETHANAMINE,
)

from nbed_tpu.config import NbedConfig  # noqa: E402
from nbed_tpu.driver import NbedDriver  # noqa: E402

# (name, geometry, n_active_atoms, published eps_DFT, published eps_huz)
CASES = [
    ("acetonitrile", ACETONITRILE, 2, 0.484653, 0.168956),
    ("formamide", FORMAMIDE, 3, 0.619315, 0.233137),
    ("acetaldehyde", ACETALDEHYDE, 3, 0.569153, 0.169035),
    ("ethanol", ETHANOL, 2, 0.609165, 0.324017),
    ("fluoroethane", FLUOROETHANE, 2, 0.636886, 0.170195),
    ("ethanamine", ETHANAMINE, 3, 0.572698, 0.340741),
    ("N-methylmethanamine", N_METHYLMETHANAMINE, 2, 0.573387, 0.341703),
]


def main():
    only = set(sys.argv[1:])
    for name, xyz, n_active, pub_dft, pub_huz in CASES:
        if only and name not in only:
            continue
        cfg = NbedConfig(
            geometry=xyz, n_active_atoms=n_active,
            basis="STO-3G", xc_functional="b3lyp5", projector="huzinaga",
            localization="spade", convergence=1e-6,
            run_ccsd_emb=True, run_fci_emb=False,
        )
        d = NbedDriver(cfg)
        d.embed()
        e_dft = d._global_ks.e_tot
        e_ccsd_full, _ = d._global_ccsd
        e_emb = d.huzinaga["e_ccsd"]
        eps_dft = abs(e_dft - e_ccsd_full)
        eps_huz = abs(e_emb - e_ccsd_full)
        print(f"{name}: eps_DFT={eps_dft:.6f} (published {pub_dft:.6f}); "
              f"eps_huz={eps_huz:.6f} (published {pub_huz:.6f})  "
              f"[E_DFT={e_dft:.6f} E_CCSD_full={e_ccsd_full:.6f} "
              f"E_emb_CCSD={e_emb:.6f}]", flush=True)


if __name__ == "__main__":
    main()
