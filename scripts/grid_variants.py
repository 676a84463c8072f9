"""Sweep grid-scheme variants against the reference classical_energy oracle.

classical_energy (2-active-atom water, mu, B3LYP) isolates the DFT-side
embedding terms (e_env + two_e_cross + correction): no correlation solver,
maximally grid-sensitive.  Oracle: reference tests/test_driver.py:191.
"""

import sys


from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

import nbed_tpu.grids.grid as gg  # noqa: E402
from nbed_tpu.config import NbedConfig  # noqa: E402
from nbed_tpu.driver import NbedDriver  # noqa: E402

ORACLE = -3.5867934952241356
XYZ = "3\n \nH\t0.2774\t0.8929\t0.2544\nO\t0\t0\t0\nH\t0.6068\t-0.2383\t-0.7169"


def run_once(tag):
    gg._grid_meta_reference.cache_clear()
    cfg = NbedConfig(
        geometry=XYZ, n_active_atoms=2, basis="STO-3G", xc_functional="b3lyp",
        projector="mu", localization="spade", convergence=1e-10,
        run_ccsd_emb=False, run_fci_emb=False,
    )
    d = NbedDriver(cfg)
    d.embed()
    print(f"{tag}: classical dev = {d.classical_energy - ORACLE:+.3e}", flush=True)


def main():
    orig_becke = gg._becke_weights
    orig_rad_ang = gg._default_rad_ang
    orig_prune = gg._nwchem_prune

    run_once("baseline (treutler adjust, H50/O75, prune[1,3,i-1,i,i])")

    # A: becke-original adjust instead of treutler sqrt adjust
    gg._becke_weights = lambda p, o, c, b, **kw: orig_becke(p, o, c, b, adjust="becke")
    run_once("A: becke-ratio adjust")
    gg._becke_weights = orig_becke

    # B: no radii adjustment at all
    def no_adjust(p, o, c, b, **kw):
        import jax.numpy as jnp
        return orig_becke(p, o, c, jnp.ones_like(b), adjust="treutler")
    gg._becke_weights = no_adjust
    run_once("B: no size adjust")
    gg._becke_weights = orig_becke

    # C: no pruning (all points at the full angular order)
    gg._nwchem_prune = lambda z, rads, n_ang: np.full(len(rads), n_ang, int)
    run_once("C: no prune (302 everywhere)")
    gg._nwchem_prune = orig_prune

    # D: prune innermost region at 38 instead of 50
    def prune_d(z, rads, n_ang):
        out = orig_prune(z, rads, n_ang)
        out = out.copy()
        out[out == 50] = 38
        return out
    gg._nwchem_prune = prune_d
    run_once("D: innermost 38")
    gg._nwchem_prune = orig_prune

    # E: H radial 75 (same as O)
    gg._default_rad_ang = lambda z, lv: (75, orig_rad_ang(z, lv)[1])
    run_once("E: H n_rad 75")
    gg._default_rad_ang = orig_rad_ang

    # F: denser radial for both (check radial-truncation sensitivity)
    gg._default_rad_ang = lambda z, lv: (orig_rad_ang(z, lv)[0] * 2,
                                         orig_rad_ang(z, lv)[1])
    run_once("F: 2x radial")
    gg._default_rad_ang = orig_rad_ang


if __name__ == "__main__":
    main()
