"""Measure the reproducibility floor of the embedded-energy oracles.

VERDICT round 3 asked for embedded CCSD/FCI agreement with the reference
oracles at 1e-6 Ha (tests currently hold 1e-5, achieved ~6e-6).  The
ACCURACY.md analysis attributes the residual to the *oracles' own SCF
convergence imprint*: the reference computed them with PySCF stopped at
convergence=1e-6 (reference tests/conftest.py:79), and the embedded
pipeline consumes the global-KS density through strictly NON-variational
functionals (v_emb, e_env, the XC cross term), which inherit any density
residual FIRST order.

This script makes that claim quantitative.  It takes our tightly converged
(1e-10) global-KS solution, applies random occupied-virtual orbital
rotations scaled so the *energy* sits a chosen delta above the fixed point
(the variational second-order signature of an SCF stopped when the energy
step fell below delta), and re-runs the ENTIRE downstream pipeline
(SPADE -> subsystem DFT -> v_emb -> tight embedded SCF -> FCI) from each
perturbed density.  The spread of embedded-FCI energies at delta = 1e-6 IS
the floor: two independent, correct implementations whose global SCFs both
stop at 1e-6 can legitimately disagree on the embedded energy by this
much.

Run:  python scripts/oracle_floor.py [n_samples]
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


import numpy as np  # noqa: E402

from nbed_tpu.config import NbedConfig  # noqa: E402
from nbed_tpu.driver import NbedDriver  # noqa: E402

WATER = Path(__file__).resolve().parent.parent / "tests" / "molecules" / "water.xyz"


def make_config():
    return NbedConfig(
        geometry=str(WATER), n_active_atoms=1, basis="STO-3G",
        xc_functional="b3lyp", projector="mu", localization="spade",
        convergence=1e-10, run_ccsd_emb=False, run_fci_emb=True,
    )


def perturb(sol, rng, scale):
    """Random occupied-virtual rotation of each spin's orbitals, scaled to
    unit Frobenius norm times ``scale`` in the rotation angle."""
    out = sol.copy()
    c = np.array(out.mo_coeff)
    occ = np.asarray(out.mo_occ)
    for s in range(2):
        no = int(np.sum(occ[s] > 0.5))
        nv = c[s].shape[1] - no
        k = rng.standard_normal((no, nv))
        k *= scale / np.linalg.norm(k)
        block = np.zeros((c[s].shape[1], c[s].shape[1]))
        block[:no, no:] = k
        block[no:, :no] = -k.T
        # orthogonal rotation: exp(K) via eigendecomposition-free Pade-2
        from scipy.linalg import expm

        c[s] = c[s] @ expm(block)
    out.mo_coeff = c
    return out


def e_tot_of(sol):
    e_elec, _ = sol.energy_elec()
    return e_elec + sol.energy_nuc()


def run_downstream(config, perturbed_sol):
    drv = NbedDriver(config)
    drv.__dict__["_global_ks"] = perturbed_sol  # cached_property injection
    drv.embed()
    return drv.mu["e_fci"]


def main():
    n_samples = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    config = make_config()
    base = NbedDriver(config)
    base.embed()
    e_ref = base.mu["e_fci"]
    sol = base._global_ks
    e0 = e_tot_of(sol)
    print(f"tight global KS e_tot = {e0:.10f}; embedded FCI = {e_ref:.10f}",
          flush=True)

    rng = np.random.default_rng(42)
    for de_target in (1e-6, 1e-7):
        spreads = []
        for i in range(n_samples):
            # calibrate the rotation angle so e_tot sits ~de_target above
            # the fixed point (variational: de ~ angle^2)
            scale = 1e-3
            for _ in range(8):
                cand = perturb(sol, np.random.default_rng(1000 + i), scale)
                de = e_tot_of(cand) - e0
                if de <= 0:
                    scale *= 2.0
                    continue
                scale *= float(np.sqrt(de_target / de))
                if 0.5 * de_target < de < 2.0 * de_target:
                    break
            e_fci = run_downstream(config, cand)
            spreads.append(e_fci - e_ref)
            print(f"  de_KS={de: .2e}  ->  d(e_fci)={e_fci - e_ref: .3e}",
                  flush=True)
        arr = np.array(spreads)
        print(f"delta={de_target:.0e}: embedded-FCI spread "
              f"max|d|={np.abs(arr).max():.3e}, rms={np.sqrt((arr**2).mean()):.3e}",
          flush=True)


if __name__ == "__main__":
    main()
