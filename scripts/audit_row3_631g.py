"""Audit the Na-Ar 6-31G tables variationally (no BSE/PySCF in image).

The published 6-31G sets (Francl et al., JCP 77, 3654 (1982)) are
energy-optimized in exactly the shipped contraction structure (6 core s /
6 shared-sp inner / 3+1 split valence sp).  Two discriminating checks per
element, using the general atomic ground-term HF solver
(scripts/atomic_hf.py):

1. Window: the contracted-basis ROHF term energy must sit between the
   numerical HF limit (Koga/Clementi-Roetti values, exact to the printed
   digits) and limit + 90 mHa (split-valence truncation error band).
   A transcription error in any large-coefficient entry shifts the energy
   out of this band.
2. Stationarity: scaling any one shell's exponents by +/-1.5% must RAISE
   the energy (the published exponents are variationally optimal; a wrong
   exponent row shows up as a downhill direction at the 0.1+ mHa scale).

Run:  python scripts/audit_row3_631g.py [symbols...]
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

from atomic_hf import solve_atom  # noqa: E402

# numerical Hartree-Fock limits for the atomic ground terms
# (Koga/Clementi-Roetti; row-1/2 values used to audit the round-5
# He/Li/Be/B/Ne additions the same way)
HF_LIMIT = {
    "He": -2.861680, "Li": -7.432727, "Be": -14.573023,
    "B": -24.529061, "Ne": -128.547098,
    "Na": -161.858911, "Mg": -199.614636, "Al": -241.876707,
    "Si": -288.854362, "P": -340.718780, "S": -397.504896,
    "Cl": -459.482072, "Ar": -526.817512,
}


def shells_for(sym):
    from nbed_tpu.chem.basis import get_element_shells

    return [(l, list(prims)) for l, prims in get_element_shells("6-31g", sym)]


def scale_group(shells, group_idx, factor):
    """Scale the exponents of one shell 'group' (shells sharing exponents:
    the core s alone; each sp pair together)."""
    groups = []
    i = 0
    while i < len(shells):
        if (i + 1 < len(shells) and shells[i][0] == 0 and shells[i + 1][0] == 1
                and [e for e, _ in shells[i][1]]
                == [e for e, _ in shells[i + 1][1]]):
            groups.append([i, i + 1])
            i += 2
        else:
            groups.append([i])
            i += 1
    out = [(l, list(prims)) for l, prims in shells]
    for si in groups[group_idx]:
        l, prims = out[si]
        out[si] = (l, [(e * factor, c) for e, c in prims])
    return out, len(groups)


# Pople's Li/Be/B valence exponents carry molecular scale factors by
# construction (a free atomic refit gains ~4.5 mHa with more diffuse
# outer sp) — stationarity is not an applicable check there, only the
# energy window (see data_631g.py Be/B comment).
SCALED_VALENCE = {"Li", "Be", "B"}


def audit(sym, verbose=True):
    from atomic_hf import make_energy_program

    shells = shells_for(sym)
    program = make_energy_program(sym, shells)  # shared across perturbations
    e0, info = solve_atom(sym, shells, program=program)
    lim = HF_LIMIT[sym]
    ok_window = lim - 1e-6 < e0 < lim + 0.090
    rows = [f"{sym}: E(6-31G) = {e0:.6f}  vs HF limit {lim:.6f} "
            f"(+{(e0 - lim) * 1e3:.2f} mHa)  window={'OK' if ok_window else 'FAIL'}"]
    ok_stat = True
    if sym in SCALED_VALENCE:
        rows.append("  (stationarity skipped: molecularly-scaled valence)")
        print("\n".join(rows), flush=True)
        return ok_window, e0
    _, n_groups = scale_group(shells, 0, 1.0)
    for g in range(n_groups):
        for f in (0.985, 1.015):
            pert, _ = scale_group(shells, g, f)
            e_p, _ = solve_atom(sym, pert, program=program)
            de = e_p - e0
            if de < -1e-4:
                ok_stat = False
                rows.append(f"  group {g} x{f}: E drops {de * 1e3:+.3f} mHa "
                            "-> NOT stationary")
            elif verbose:
                rows.append(f"  group {g} x{f}: dE = {de * 1e3:+.3f} mHa")
    print("\n".join(rows), flush=True)
    return ok_window and ok_stat, e0


def main():
    syms = sys.argv[1:] or list(HF_LIMIT)
    results = {}
    for sym in syms:
        ok, e0 = audit(sym)
        results[sym] = (ok, e0)
    print("\nSummary:")
    for sym, (ok, e0) in results.items():
        print(f"  {sym:3s} {'PASS' if ok else 'FAIL'}  {e0:.6f}")


if __name__ == "__main__":
    main()
