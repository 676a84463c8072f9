"""Large-molecule validation: full embed() on PFOA (C8HF15O2, 26 atoms).

PFOA is the largest molecule in the reference's own test set
(reference tests/molecules/pfoa.xyz); at STO-3G it has 126 AOs — the scale
where the driver auto-enables density fitting (config.density_fitting=None
tri-state, nao >= 96) and the SCF engine's SAD initial guess and streaming
XC path matter. This script runs the full pipeline (global UKS -> SPADE ->
subsystem DFT -> mu-embedded SCF -> environment deletion -> concentric
localization -> qubit Hamiltonian) and reports stage timings + peak RSS,
demonstrating bounded-memory operation at pfoa scale.

Run:  python scripts/pfoa_pipeline.py
"""

import os
import resource
import sys
import time


from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from nbed_tpu import nbed  # noqa: E402

XYZ = Path(__file__).resolve().parent.parent / "tests" / "molecules" / "pfoa.xyz"


def main():
    projector = sys.argv[1] if len(sys.argv) > 1 else "mu"
    t0 = time.perf_counter()
    # active region: the first 4 atoms of the reference geometry (a CF3-end
    # fragment) — the choice is arbitrary for this scale/robustness check
    driver = nbed(
        geometry=str(XYZ),
        n_active_atoms=4,
        basis="STO-3G",
        xc_functional="b3lyp",
        projector=projector,
        localization="spade",
        convergence=1e-6,
        run_ccsd_emb=bool(os.environ.get("NBED_PFOA_CCSD")),
        run_fci_emb=False,
    )
    wall = time.perf_counter() - t0
    peak_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    res = driver.mu if projector == "mu" else driver.huzinaga
    const, h1, h2 = res["second_quantised"]
    print(f"pipeline wall: {wall:.1f} s, peak RSS: {peak_gb:.2f} GB")
    print(f"global KS e_tot: {driver._global_ks.e_tot:.8f} Ha "
          f"(converged={driver._global_ks.converged})")
    print(f"embedded SCF e_tot: {res['scf'].e_tot:.8f} Ha "
          f"(converged={res['scf'].converged})")
    print(f"classical energy: {res['classical_energy']:.8f} Ha")
    if res.get("e_ccsd") is not None:
        print(f"embedded CCSD: {res['e_ccsd']:.8f} Ha")
    print(f"qubit Hamiltonian: {h1.shape[0]} spin orbitals "
          f"(full system would be {2 * driver._global_ks.mol.nao})")
    for k, v in getattr(driver, "timings", {}).items():
        print(f"  stage {k}: {v:.2f} s")


if __name__ == "__main__":
    main()
