"""Diagnose the SPADE occupied partition on pfoa (126 AOs, 200 electrons)."""

import sys


from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

from nbed_tpu.config import NbedConfig
from nbed_tpu.driver import NbedDriver

XYZ = Path(__file__).resolve().parent.parent / "tests" / "molecules" / "pfoa.xyz"

cfg = NbedConfig(
    geometry=str(XYZ), n_active_atoms=4, basis="STO-3G",
    xc_functional="b3lyp", projector="mu", localization="spade",
    convergence=1e-6, run_ccsd_emb=False, run_fci_emb=False,
)
d = NbedDriver(cfg)
d.n_mo_overwrite = cfg.n_mo_overwrite
gks = d._global_ks
print("mol.nelec:", d._mol.nelec, "nao:", d._mol.nao)
occ = np.asarray(gks.mo_occ)
print("mo_occ shape:", occ.shape, "sum per spin:", occ.sum(axis=-1))
print("mo_coeff shape:", np.asarray(gks.mo_coeff).shape)
ls = d._localize()
s = np.asarray(d._ks_engine.s)
for name in ("c_active", "c_enviro", "c_loc_occ"):
    c = getattr(ls, name)
    g = c[0].T @ s @ c[0]
    print(f"{name}: shape {c.shape} diag(C^T S C)[:6]={np.round(np.diag(g)[:6], 4)}"
          f" ncols={c.shape[-1]} tr={np.trace(g):.3f}")
print("active inds:", np.asarray(ls.active_mo_inds).shape)
print("enviro inds:", np.asarray(ls.enviro_mo_inds).shape)
