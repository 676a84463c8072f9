"""Variationally pin the Be/B/Ne 6-31G valence rows (round-5 audit).

The round-5 audit (scripts/audit_row3_631g.py He Li Be B Ne) accepted the
recalled He/Li tables but flagged Be and B as marginally non-stationary
(wrong outer-sp exponent digits) and Ne as badly wrong (+1.46 Ha).  Since
the 6-31G sets are DEFINED as atomic-ground-term-HF-energy-optimal in the
fixed 6/3/1 contraction structure (Hehre/Ditchfield/Pople; Francl et al.),
this script recovers the defining optimum directly: optimize the inner-sp
exponents + s(/p) contraction coefficients and the outer-sp exponent with
the 6-term core held fixed, then renormalize each contracted column to a
unit self-overlap (the published gauge).

For Li/Be the atom has no p occupation, so the p contraction coefficients
are NOT determined by the atomic energy — they are left at their recalled
values and documented as energetically inert for the audit.

Run:  python scripts/refit_631g_row2_valence.py [Be B Ne]
Prints data_631g.py-ready rows and the energy ladder.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np
from scipy.optimize import minimize

from atomic_hf import make_energy_program, solve_atom  # noqa: E402

# element -> (optimize p coefficients too?, start overrides or None)
HAS_P = {"Be": False, "B": True, "Ne": True}
# Ne start: O->F progression of the published tables (the recalled row was
# far off; see the audit log in PROGRESS.md R5)
START = {
    "Ne": dict(e2=[28.8, 6.59, 1.75], e3=0.58,
               cs=[-0.110, -0.148, 1.13], cp=[0.036, 0.35, 0.722]),
}


def contracted_norm(l, prims):
    """Self-overlap of a contraction over normalized primitives."""
    e = np.array([p[0] for p in prims])
    c = np.array([p[1] for p in prims])
    s = (2.0 * np.sqrt(np.outer(e, e)) / np.add.outer(e, e)) ** (l + 1.5)
    return float(c @ s @ c)


def refit(sym):
    from nbed_tpu.chem.basis import get_element_shells

    shells0 = [(l, list(p)) for l, p in get_element_shells("6-31g", sym)]
    # layout: [0]=core s, [1]/[2]=sp1 s/p, [3]/[4]=sp2 s/p (outer, free)
    st = START.get(sym)
    e2 = st["e2"] if st else [e for e, _ in shells0[1][1]]
    cs = st["cs"] if st else [c for _, c in shells0[1][1]]
    cp = st["cp"] if st else [c for _, c in shells0[2][1]]
    e3 = st["e3"] if st else shells0[3][1][0][0]
    opt_p = HAS_P[sym]

    x0 = np.concatenate([np.log(e2), [np.log(e3)], cs, cp if opt_p else []])
    program = make_energy_program(sym, shells0)
    warm = {"x": None}

    def build(params):
        ee2 = np.exp(params[:3])
        ee3 = float(np.exp(params[3]))
        ccs = params[4:7]
        ccp = params[7:10] if opt_p else cp
        out = [(l, list(p)) for l, p in shells0]
        out[1] = (0, list(zip(ee2, ccs)))
        out[2] = (1, list(zip(ee2, ccp)))
        out[3] = (0, [(ee3, 1.0)])
        out[4] = (1, [(ee3, 1.0)])
        return out

    def obj(params):
        try:
            e, info = solve_atom(sym, build(params), x0=warm["x"],
                                 gtol=1e-8, program=program,
                                 restarts=warm["x"] is None)
            warm["x"] = info["x"]
        except Exception as exc:  # noqa: BLE001
            print(f"eval failed: {exc!r}", flush=True)
            return 0.0
        return e

    e0 = obj(x0)
    print(f"{sym}: start E = {e0:.6f}", flush=True)
    res = minimize(obj, x0, method="Nelder-Mead",
                   options={"maxiter": 800, "xatol": 1e-4, "fatol": 1e-7})
    final = build(res.x)
    e1, _ = solve_atom(sym, final, gtol=1e-10, program=program)
    print(f"{sym}: refit E = {e1:.6f}  (gain {1e3 * (e0 - e1):.3f} mHa)")

    # renormalize to the published gauge (unit contracted self-overlap);
    # a uniform scale of a contraction column changes no physics
    ee2 = [float(v) for v in np.exp(res.x[:3])]
    ee3 = float(np.exp(res.x[3]))
    ccs = np.array(res.x[4:7])
    ccp = np.array(res.x[7:10]) if opt_p else np.array(cp)
    ccs = ccs / np.sqrt(contracted_norm(0, list(zip(ee2, ccs))))
    ccp = ccp / np.sqrt(contracted_norm(1, list(zip(ee2, ccp))))
    print(f'    *_sp([({ee2[0]:.7f}, {ccs[0]:.7f}, {ccp[0]:.7f}),')
    print(f'          ({ee2[1]:.7f}, {ccs[1]:.7f}, {ccp[1]:.7f}),')
    print(f'          ({ee2[2]:.7f}, {ccs[2]:.7f}, {ccp[2]:.7f})]),')
    print(f'    *_sp([({ee3:.7f}, 1.0, 1.0)]),')
    return e1


if __name__ == "__main__":
    for sym in (sys.argv[1:] or ["Be", "B", "Ne"]):
        refit(sym)
