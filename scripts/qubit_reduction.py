"""Replicate the reference's headline problem-size-reduction results.

The reference's publication notebook ("A Scalable Approach to Quantum
Simulation via Projection-based Embedding", PRA 109, 022418; BASELINE.md)
reports, for small organics at STO-3G with SPADE + concentric localization,
the qubit-count and JW Pauli-term-count reduction from embedding. This
script reproduces those rows with the notebook's exact inputs: its inline
geometries (notebook cell 5 — NOT the test-fixture xyz files, which use
different geometries/atom orderings), its active-atom counts (cell 4),
b3lyp5, and the huzinaga projector (cell 21 config).

Published values (notebook cell 29):

  molecule      qubits full -> embedded   terms full -> embedded (huz)
  acetonitrile       36 -> 28                136,075 -> 50,607
  formamide          36 -> 26                138,231 -> 37,008

Run:  python scripts/qubit_reduction.py
"""

import sys


from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from nbed_tpu.chem import build_molecule  # noqa: E402
from nbed_tpu.config import NbedConfig  # noqa: E402
from nbed_tpu.driver import NbedDriver  # noqa: E402
from nbed_tpu.ham.builder import HamiltonianBuilder  # noqa: E402
from nbed_tpu.ham.qubit import jordan_wigner  # noqa: E402
from nbed_tpu.scf.engine import SCFEngine  # noqa: E402

# geometries exactly as in the notebook (publication inputs)
ACETONITRILE = """6

N\t1.2608\t0\t0
C\t0.1006\t0\t0
C\t-1.3613\t0\t0
H\t-1.75\t-0.8301\t0.5974
H\t-1.7501\t-0.1022\t-1.0175
H\t-1.75\t0.9324\t0.4202
"""

FORMAMIDE = """6

O\t1.128\t0.2091\t0
C\t0.0598\t-0.3882\t0
H\t-0.0014\t-1.4883\t-0.0001
N\t-1.1878\t0.1791\t0
H\t-1.3085\t1.1864\t0.0001
H\t-2.0305\t-0.3861\t-0.0001
"""

ACETALDEHYDE = """7

O\t1.1443\t0.2412\t0
H\t0.1478\t-1.5252\t-0.0007
C\t0.113\t-0.4226\t0
C\t-1.2574\t0.1815\t0
H\t-1.7938\t-0.1493\t0.8924
H\t-1.1865\t1.2719\t0.0016
H\t-1.7928\t-0.1468\t-0.8938
"""

ETHANOL = """9

H\t-1.1291\t0.8364\t0.8099
O\t-1.1712\t0.2997\t0
C\t-0.0463\t-0.5665\t0
H\t-0.0958\t-1.212\t0.8819
H\t-0.0952\t-1.1938\t-0.8946
C\t1.2175\t0.2668\t0
H\t2.105\t-0.372\t-0.0177
H\t1.2426\t0.9307\t-0.8704
H\t1.2616\t0.9052\t0.8886
"""

FLUOROETHANE = """8

F\t1.1298\t0.3032\t0
C\t0.0745\t-0.5534\t0
C\t-1.2043\t0.2502\t0
H\t0.1472\t-1.1828\t-0.891
H\t0.1471\t-1.1828\t0.891
H\t-2.0791\t-0.4057\t-0.0001
H\t-1.2472\t0.8979\t0.881
H\t-1.2471\t0.898\t-0.8809
"""

ETHANAMINE = """10

H\t1.1926\t-0.9044\t0.8134
H\t1.1926\t-0.9044\t-0.8134
N\t1.2133\t-0.2902\t0
C\t0.0295\t0.5602\t0
H\t0.0512\t1.2078\t0.8824
H\t0.0511\t1.2078\t-0.8825
C\t-1.2428\t-0.27\t0
H\t-1.2991\t-0.9094\t-0.8874
H\t-1.2991\t-0.9093\t0.8875
H\t-2.1202\t0.3846\t0
"""

N_METHYLMETHANAMINE = """10

N\t0.0001\t-0.5504\t0
H\t0\t-1.1423\t0.8302
C\t-1.2001\t0.2752\t0
C\t1.2001\t0.2752\t0
H\t-1.2506\t0.9105\t0.8903
H\t-2.0853\t-0.3685\t-0.0051
H\t-1.2467\t0.906\t-0.8936
H\t2.0853\t-0.3682\t-0.005
H\t1.2506\t0.9106\t0.8903
H\t1.2467\t0.906\t-0.8937
"""

# (name, geometry, n_active_atoms, published full->emb qubits, terms)
CASES = [
    ("acetonitrile", ACETONITRILE, 2, (36, 28), (136_075, 50_607)),
    ("formamide", FORMAMIDE, 3, (36, 26), (138_231, 37_008)),
    ("acetaldehyde", ACETALDEHYDE, 3, (38, 30), (182_702, 71_218)),
    ("ethanol", ETHANOL, 2, (42, 26), (283_020, 41_044)),
    ("fluoroethane", FLUOROETHANE, 2, (40, 32), (217_385, 89_953)),
    ("ethanamine", ETHANAMINE, 3, (44, 28), (329_299, 49_707)),
    ("N-methylmethanamine", N_METHYLMETHANAMINE, 2, (44, 28),
     (338_967, 52_207)),
]


def main():
    only = set(sys.argv[1:])
    for name, xyz, n_active, pub_qubits, pub_terms in CASES:
        if only and name not in only:
            continue
        # full system (notebook: HamiltonianBuilder on the global HF)
        mol = build_molecule(xyz, "sto-3g")
        sol = SCFEngine(mol, conv_tol=1e-8, max_cycle=500).kernel()
        hb = HamiltonianBuilder(sol, 0.0)
        # count at OpenFermion's EQ_TOLERANCE (1e-8), as the notebook does
        full = jordan_wigner(*hb.build(), tol=1e-8)
        full_qubits = 2 * mol.nao
        full_terms = len(full.terms)

        # embedded (SPADE + huzinaga + concentric localization)
        cfg = NbedConfig(
            geometry=xyz, n_active_atoms=n_active,
            basis="STO-3G", xc_functional="b3lyp5", projector="huzinaga",
            localization="spade", convergence=1e-6,
            run_ccsd_emb=False, run_fci_emb=False,
        )
        d = NbedDriver(cfg)
        d.embed()
        e_const, e_h1, e_h2 = d.huzinaga["second_quantised"]
        emb_qubits = e_h1.shape[0]
        emb_jw = jordan_wigner(e_const, e_h1, e_h2, tol=1e-8)
        emb_terms = len(emb_jw.terms)
        # measurement cost (not in the paper's table — grouping was left
        # to external SDKs): qubit-wise-commuting groups per Hamiltonian
        from nbed_tpu.ham import measurement_groups

        full_groups = len(measurement_groups(full))
        emb_groups = len(measurement_groups(emb_jw))

        # Z2 tapering on top of embedding+CL (beyond the paper, which stops
        # at the raw JW register): alpha/beta parities + point-group Z2s
        from nbed_tpu.ham import taper_auto

        import numpy as np

        occ = np.asarray(d.huzinaga["scf"].mo_occ)
        hf_bits = 0
        for p in occ[0].nonzero()[0]:
            hf_bits |= 1 << (2 * int(p))
        for p in occ[1].nonzero()[0]:
            hf_bits |= 1 << (2 * int(p) + 1)
        tapered, syms, _ = taper_auto(emb_jw, hf_bits=hf_bits)

        print(f"{name}: qubits {full_qubits} -> {emb_qubits} "
              f"(published {pub_qubits[0]} -> {pub_qubits[1]}) "
              f"-> {tapered.n_qubits} tapered; "
              f"terms {full_terms:,} -> {emb_terms:,} "
              f"(published {pub_terms[0]:,} -> {pub_terms[1]:,}) "
              f"-> {len(tapered.terms):,} tapered; "
              f"QWC groups {full_groups:,} -> {emb_groups:,}",
              flush=True)


if __name__ == "__main__":
    main()
