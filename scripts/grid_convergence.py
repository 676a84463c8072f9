"""Diagnose the embedded-energy grid gap (VERDICT weak #3).

Runs the full mu+huz pipeline at increasing quadrature densities and prints
deviations from the reference oracles (reference tests/test_driver.py:45,107-108,127).
If the dense-grid limit converges to within 1e-6 Ha of the oracles, the fix is
grid density/scheme quality; if it converges elsewhere, the remaining gap is the
reference grid's own quadrature error and exact scheme replication is required.
"""

import sys


from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import nbed_tpu.scf.engine as eng
from nbed_tpu.config import NbedConfig
from nbed_tpu.driver import NbedDriver

ORACLES = {
    "global_ks": -75.3091447400438,
    "e_ccsd": -75.1285849238916,
    "e_fci": -75.12858550813999,
}

_orig_init = eng.SCFEngine.__init__


def run(grid_size):
    def patched(self, *a, **kw):
        kw.setdefault("grid_size", grid_size)
        _orig_init(self, *a, **kw)

    eng.SCFEngine.__init__ = patched
    water = Path(__file__).parent.parent / "tests" / "molecules" / "water.xyz"
    cfg = NbedConfig(
        geometry=str(water),
        n_active_atoms=1,
        basis="STO-3G",
        xc_functional="b3lyp",
        projector="both",
        localization="spade",
        convergence=1e-10,
        run_ccsd_emb=True,
        run_fci_emb=True,
        max_hf_cycles=200,
        max_dft_cycles=200,
    )
    d = NbedDriver(cfg)
    d.embed()
    print(f"grid={grid_size}")
    print(f"  global_ks dev = {d._global_ks.e_tot - ORACLES['global_ks']:+.3e}")
    for name, res in (("mu", d.mu), ("huz", d.huzinaga)):
        print(
            f"  {name}: ccsd dev = {res['e_ccsd'] - ORACLES['e_ccsd']:+.3e}"
            f"  fci dev = {res['e_fci'] - ORACLES['e_fci']:+.3e}"
        )
    sys.stdout.flush()
    eng.SCFEngine.__init__ = _orig_init


if __name__ == "__main__":
    sizes = [(96, 22), (150, 30), (220, 42)]
    if len(sys.argv) > 1:
        sizes = [tuple(map(int, a.split(","))) for a in sys.argv[1:]]
    for gs in sizes:
        run(gs)
