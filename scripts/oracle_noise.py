"""Reproduce the accuracy floor of the reference oracles (VERDICT round 1, #2).

Claim: with the reference-parity quadrature grid (Treutler radial, Lebedev
angular, NWChem prune, Treutler-adjusted Becke), the remaining deviation of
the embedded energies from the reference oracles (~6e-6 Ha) is dominated by
the *oracles' own SCF convergence imprint*, not by any physics difference in
this package.  Evidence printed by this script:

1. UHF (no XC, no grid anywhere): our fully-converged (1e-12) solution gives
   e_tot within ~2e-9 of the oracle, but the e1/e2 *split* (e_coul) is off
   by ~2e-6.  Both sides solve the identical equations (integrals agree to
   ~1e-10; a 2e-6 integral error would shift e_tot first-order, which is
   excluded by the 2e-9 e_tot match).  The only remaining source is the
   oracle density sitting off its own fixed point: the reference runs PySCF
   at config convergence=1e-6 (reference tests/conftest.py:79,
   driver.py:114), which leaves a density residual whose *first-order*
   imprint on non-variational functionals (e1/e2 split, v_emb, e_env,
   classical_energy) is ~1e-6..1e-5 while the variational e_tot moves only
   second-order (~1e-9..1e-7).

2. UKS/B3LYP shows the same fingerprint, scaled up: e_tot dev ~ -8e-8,
   e1/e2 split dev ~ +1.3e-5.

3. Our own fixed point is convergence-stable: tightening our conv_tol from
   1e-7 to 1e-12 moves the split by <1e-7, i.e. the offsets above are not
   our convergence noise.

Consequence: embedded CCSD/FCI (which inherit the global-KS density through
e_env + XC-cross + v_emb first-order) cannot be matched beyond ~5e-6 against
these oracles without replicating PySCF's exact DIIS trajectory and stopping
point bit-for-bit.  Test tolerances are set accordingly (1e-5) with this
script as the justification; the total-energy oracles (global HF/KS/CCSD/FCI)
are matched to 1e-7..2e-9.

Run:  python scripts/oracle_noise.py
"""

import sys


from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from nbed_tpu.chem import build_molecule  # noqa: E402
from nbed_tpu.scf.engine import SCFEngine  # noqa: E402

ORACLES = {  # reference tests/test_driver.py:41-57
    "uhf": (-74.96099960129165, -84.24671382296947, 38.288174841671974),
    "uks": (-75.3091447400438, -84.59485896172163, 37.93302591280513),
}


def main():
    xyz = (Path(__file__).resolve().parent.parent
           / "tests" / "molecules" / "water.xyz").read_text()
    mol = build_molecule(xyz, "sto-3g")

    print("== 1/2. fully-converged fixed points vs reference oracles ==")
    for name, xc in (("uhf", None), ("uks", "b3lyp")):
        eng = SCFEngine(mol, xc=xc, conv_tol=1e-12, dm_conv_tol=1e-10,
                        max_cycle=200)
        sol = eng.kernel()
        e_elec, e2 = sol.energy_elec()
        et, ee, e2o = ORACLES[name]
        print(f"  {name}: e_tot dev={sol.e_tot - et:+.3e}  "
              f"e_elec dev={e_elec - ee:+.3e}  e1/e2-split dev={e2 - e2o:+.3e}")

    print("== 3. our fixed point is convergence-stable ==")
    devs = []
    for ct, dt in ((1e-7, 1e-3), (1e-12, 1e-10)):
        eng = SCFEngine(mol, xc="b3lyp", conv_tol=ct, dm_conv_tol=dt,
                        max_cycle=200)
        _, e2 = eng.kernel().energy_elec()
        devs.append(e2)
    print(f"  UKS e2(conv 1e-7) - e2(conv 1e-12) = {devs[0] - devs[1]:+.3e}")


if __name__ == "__main__":
    main()
