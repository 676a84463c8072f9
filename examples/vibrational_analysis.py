"""Harmonic frequencies of water at the HF/STO-3G minimum.

Pipeline: analytic-gradient BFGS optimization -> semi-numerical Hessian
(central differences of the analytic gradient; all 6N displaced
SCF+gradient evaluations run as ONE vmapped compiled program, optionally
sharded over a device-mesh batch axis) -> mass-weighted normal-mode
analysis with Eckart TR projection.

Run:  PYTHONPATH=. python examples/vibrational_analysis.py
"""

from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

from nbed_tpu.chem import build_molecule  # noqa: E402
from nbed_tpu.solvers import harmonic_frequencies  # noqa: E402
from nbed_tpu.solvers.gradients import optimize_geometry  # noqa: E402

xyz = Path(__file__).resolve().parent.parent / "tests" / "molecules" / "water.xyz"
mol = build_molecule(xyz.read_text(), "sto-3g")

coords, e_min, n_steps, ok = optimize_geometry(mol, gtol=1e-6, verbose=True)
print(f"optimized in {n_steps} gradient evaluations: E = {e_min:.10f} Ha")

freqs, modes, hess = harmonic_frequencies(mol, coords=coords)
print("harmonic frequencies (cm^-1):")
for f in freqs:
    tag = "TR" if abs(f) < 30 else ("imag" if f < 0 else "vib")
    print(f"  {f:10.1f}   [{tag}]")

vib = freqs[np.abs(freqs) >= 30]
print(f"\n{len(vib)} vibrational modes: {np.round(vib, 1).tolist()}")

from nbed_tpu.solvers import ir_intensities, thermochemistry  # noqa: E402
from nbed_tpu.solvers.thermo import HA_PER_K_TO_CAL_MOL_K  # noqa: E402

intens = ir_intensities(mol, modes, coords=coords)
print("IR intensities (km/mol):", np.round(intens[np.abs(freqs) >= 30], 1).tolist())

th = thermochemistry(mol, freqs, coords=coords, symmetry_number=2)
print(f"ZPE = {th['zpe']*627.5094740631:.2f} kcal/mol, "
      f"S(298) = {th['s_tot']*HA_PER_K_TO_CAL_MOL_K:.2f} cal/(mol K), "
      f"G - E_elec = {th['g_therm']*627.5094740631:.2f} kcal/mol")
