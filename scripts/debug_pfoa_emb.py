"""Diagnose the mu-embedded SCF divergence at pfoa scale.

Stage 1 (once, ~15 min): build the driver state up to the embedding
potential and save the embedded-SCF operands to /tmp/pfoa_emb.npz.
Stage 2 (fast, repeatable): manual SCF iterations with per-cycle energy /
|dDM| printing to see *how* it diverges (oscillation vs drift).

Run:  python scripts/debug_pfoa_emb.py [stage2]
"""

import sys
import time


from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

STATE = "/tmp/pfoa_emb.npz"
XYZ = Path(__file__).resolve().parent.parent / "tests" / "molecules" / "pfoa.xyz"


def stage1():
    from nbed_tpu.config import NbedConfig
    from nbed_tpu.driver import NbedDriver

    cfg = NbedConfig(
        geometry=str(XYZ), n_active_atoms=4, basis="STO-3G",
        xc_functional="b3lyp", projector="mu", localization="spade",
        convergence=1e-6, run_ccsd_emb=False, run_fci_emb=False,
    )
    d = NbedDriver(cfg)
    # replicate embed() up to the embedding potential (driver.py stages)
    d.n_mo_overwrite = cfg.n_mo_overwrite
    d.localized_system = d._localize()
    e_act, e_env, two_e_cross = d._subsystem_dft(d.localized_system)
    total_dm = d.localized_system.dm_active + d.localized_system.dm_enviro
    g_act_and_env = d._ks_engine.get_veff(total_dm).matrix
    g_act = d._ks_engine.get_veff(d.localized_system.dm_active).matrix
    embedding_pot = np.asarray(g_act_and_env - g_act)
    v_emb = cfg.mu_level_shift * d._env_projector + embedding_pot
    np.savez(
        STATE,
        v_emb=v_emb,
        dm_active=d.localized_system.dm_active,
        dm_enviro=d.localized_system.dm_enviro,
        env_projector=d._env_projector,
        embedding_pot=embedding_pot,
        nelec=np.asarray(d._active_nelec()),
    )
    print("saved", STATE)


def stage2():
    import jax.numpy as jnp

    from nbed_tpu.chem import build_molecule
    from nbed_tpu.scf.engine import SCFEngine

    z = np.load(STATE)
    mol = build_molecule(XYZ.read_text(), "sto-3g")
    eng = SCFEngine(mol, conv_tol=1e-6, max_cycle=1, density_fitting=True)
    nelec = tuple(int(x) for x in z["nelec"])
    print("nelec:", nelec, "nao:", mol.nao)
    print("v_emb scale:", np.abs(z["v_emb"]).max())
    dm = np.asarray(z["dm_active"])
    e_nuc = eng.energy_nuc()
    print("e_nuc:", e_nuc)
    s_np = np.asarray(eng.s)
    p_env = np.asarray(z["env_projector"])  # S D_env S per spin or summed
    if p_env.ndim == 3:
        p_env = p_env[0]
    # screening sanity: diagonal of the embedding potential on 1s-like AOs
    emb0 = z["embedding_pot"]
    emb0 = emb0[0] if emb0.ndim == 3 else emb0
    hc = np.asarray(eng.hcore)
    sl0 = mol.aoslice_by_atom()
    for ia in (0, 1, 2, 3, 4, 10, 25):
        p0 = int(sl0[ia][2])
        print(f"atom {ia}: <emb_pot>={emb0[p0, p0]:+.3f} "
              f"<muPenv>={z['v_emb'][0][p0, p0] - emb0[p0, p0]:+.3e} "
              f"<hcore>={hc[p0, p0]:+.3f}")
    for it in range(8):
        t0 = time.perf_counter()
        sol = eng.kernel(nelec=nelec, v_emb=jnp.asarray(z["v_emb"]),
                         dm0=jnp.asarray(dm), max_cycle=1)
        dm_new = sol.make_rdm1()
        ddm = np.abs(dm_new - dm).max()
        tr = float(np.trace((dm_new[0] + dm_new[1]) @ s_np))
        env_ov = float(np.einsum("ij,ji->", dm_new[0] + dm_new[1], p_env))
        eps = np.asarray(sol.mo_energy)[0]
        ds = (dm_new[0] + dm_new[1]) @ s_np
        sl = mol.aoslice_by_atom()
        pops = np.array([np.trace(ds[int(a[2]):int(a[3]), int(a[2]):int(a[3])])
                         for a in sl])
        print(f"it {it:2d}: e_tot={sol.e_tot:+.6f} ddm={ddm:.3e} "
              f"tr(DS)={tr:.4f} tr(D Penv)={env_ov:.3e} "
              f"eps[10:16]={np.round(eps[10:16], 3)} "
              f"{time.perf_counter()-t0:.1f}s")
        print(f"      mulliken={np.round(pops, 2)}")
        dm = dm_new


def stage3():
    """Level-shift sweep on the saved embedded-SCF operands."""
    import jax.numpy as jnp

    from nbed_tpu.chem import build_molecule
    from nbed_tpu.scf.engine import SCFEngine

    z = np.load(STATE)
    mol = build_molecule(XYZ.read_text(), "sto-3g")
    eng = SCFEngine(mol, conv_tol=1e-6, max_cycle=60, density_fitting=True)
    nelec = tuple(int(x) for x in z["nelec"])
    for shift in (float(a) for a in sys.argv[2:] or ["0.25", "1.0"]):
        t0 = time.perf_counter()
        sol = eng.kernel(nelec=nelec, v_emb=jnp.asarray(z["v_emb"]),
                         dm0=jnp.asarray(z["dm_active"]), level_shift=shift)
        print(f"shift={shift}: e_tot={sol.e_tot:+.8f} "
              f"converged={sol.converged} {time.perf_counter()-t0:.0f}s",
              flush=True)


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "stage2":
        stage2()
    elif len(sys.argv) > 1 and sys.argv[1] == "stage3":
        stage3()
    else:
        stage1()
