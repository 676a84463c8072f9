"""Excited states of an embedded active region: CIS vs VQE+QSE.

Runs the water-in-water embedding pipeline once (O-active, mu projector),
then computes the active region's excitation spectrum two ways:

- classically, with CIS/TDA and full RPA/TDHF on the embedded SCF
  reference (plus the static polarizability the RPA spectrum implies);
- "on the quantum computer": UCCSD-VQE ground state followed by quantum
  subspace expansion over the singles pool (QSE — what one would measure
  on hardware as Pauli expectation values).

With a singles-only pool the QSE excitations sit slightly above CIS:
the VQE ground state is correlation-lowered while the singles subspace
cannot relax the excited roots by the same amount (pool="sd" recovers
the balance and drops them below CIS).

Run:  PYTHONPATH=. python examples/excited_states.py
"""

import numpy as np


from nbed_tpu import nbed  # noqa: E402
from nbed_tpu.driver import run_emb_cis, run_emb_rpa  # noqa: E402
from nbed_tpu.solvers import run_qse  # noqa: E402
from nbed_tpu.solvers.cis import (  # noqa: E402
    oscillator_strengths, spin_labels)

N_ROOTS = 5


def main():
    driver = nbed(
        geometry="tests/molecules/water.xyz",
        n_active_atoms=1,
        basis="STO-3G",
        xc_functional="b3lyp",
        projector="mu",
        localization="spade",
        convergence=1e-8,
        run_vqe_emb=True,
    )
    res = driver.mu

    cis = run_emb_cis(res["scf"], nroots=N_ROOTS)
    f_osc, _ = oscillator_strengths(res["scf"], cis)
    labels = spin_labels(res["scf"], cis)
    rpa = run_emb_rpa(res["scf"])  # full spectrum for the polarizability

    occ = np.asarray(res["scf"].mo_occ)
    nelec = (int((occ[0] > 0).sum()), int((occ[1] > 0).sum()))
    qse = run_qse(*res["second_quantised"], nelec=nelec, pool="singles",
                  params=res["vqe"].params, nroots=N_ROOTS + 1)

    ha_to_ev = 27.211386245988
    print(f"embedded VQE ground state: {res['e_vqe']:.8f} Ha "
          f"(QSE root 0: {qse.energies[0]:.8f})\n")
    print(f"{'root':>4} {'CIS (eV)':>10} {'RPA (eV)':>10} {'f_osc':>9} "
          f"{'spin':>8} {'QSE (eV)':>10}")
    for r in range(N_ROOTS):
        print(f"{r + 1:>4} {cis.excitations[r] * ha_to_ev:>10.4f} "
              f"{rpa.excitations[r] * ha_to_ev:>10.4f} "
              f"{f_osc[r]:>9.5f} {labels[r][0]:>8} "
              f"{qse.excitations[r + 1] * ha_to_ev:>10.4f}")

    from nbed_tpu.solvers import polarizability
    alpha = polarizability(res["scf"], rpa)
    print(f"\nembedded-region static polarizability (a.u.): "
          f"iso {np.trace(alpha) / 3:.4f}, "
          f"diag {np.diag(alpha).round(4).tolist()}")


if __name__ == "__main__":
    main()
