"""Bring-up check: drive the embedding pipeline end to end on one NVIDIA GPU.

Run from the repository root on a machine with a card:

    python chip_smoke.py            # one card: phases 1-4 below
    python chip_smoke.py --multi    # four cards: batched + sharded paths only

One card, in order, each phase printing one JSON line (energies, each
error beside its tolerance, cold and warm wall seconds, integral backend):

1. water / STO-3G / B3LYP / SPADE through ``nbed()`` with CCSD and FCI, for
   the ``mu`` and ``huzinaga`` projectors, against the reference oracles
   (``BASELINE.md``) and against the same f64 code run on XLA:CPU;
2. acetonitrile with the PRA 109, 022418 notebook inputs
   (``scripts/qubit_reduction.py``: b3lyp5, Huzinaga, SPADE, concentric
   localization) through ``nbed()``: a 28-qubit embedded Hamiltonian;
3. pfoa (126 AOs) global DF-UKS/B3LYP to convergence on the SCF engine
   that ``NbedDriver`` builds, with the compiled program's memory analysis
   and the device's peak memory;
4. water global UKS in the fused (one program) and eager SCF, which must
   agree.

The default path is f64 throughout and has no hand-written kernel: every
device operation is XLA's own (cuBLAS GEMMs, cuSOLVER eigh).  The script
stops at the first failed check with a non-zero exit; it never falls back
to the CPU.  The last line is ``{"ok": true, "device": {...}}``.

Tolerances:
- 1e-6 Ha on the global UKS oracle, 2e-5 Ha on the embedded CCSD/FCI
  oracles: the CPU itself sits ~7e-6 from the latter, because of the
  oracles' own SCF noise;
- 1e-7 Ha between the card and XLA:CPU running the same f64 code: sums are
  taken in another order on the card (and grid reductions may use
  atomics), so bits differ from run to run;
- 1e-6 Ha for acetonitrile and pfoa against their CPU values (the
  pipeline's own convergence threshold is 1e-6);
- 1e-8 Ha between the fused and eager SCF on the card (conv_tol 1e-10).
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
WATER_XYZ = ROOT / "tests" / "molecules" / "water.xyz"
PFOA_XYZ = ROOT / "tests" / "molecules" / "pfoa.xyz"

# reference oracles (BASELINE.md; reference tests/test_driver.py)
ORACLE = {"e_ks": -75.3091447400438, "e_ccsd": -75.1285849238916,
          "e_fci": -75.12858550813999}
ORACLE_TOL = {"e_ks": 1e-6, "e_ccsd": 2e-5, "e_fci": 2e-5}

# The same code on XLA:CPU (jax 0.9.0, x86-64 host), in Ha.
CPU_WATER = {
    "mu": {"e_ks": -75.3091448156704, "e_ccsd": -75.12859223125659,
           "e_fci": -75.1285920741048},
    "huzinaga": {"e_ks": -75.3091448156704, "e_ccsd": -75.1285914894647,
                 "e_fci": -75.12859133231258},
}
CPU_TOL = 1e-7
CPU_ACETONITRILE = {"e_ks": -130.98422067199584, "e_rhf": -130.51128805379804}
CPU_PFOA_E_KS = -1925.6431337202157  # global DF-UKS, 126 AOs
PIPELINE_TOL = 1e-6
ACETONITRILE_QUBITS = 28  # BASELINE.md:39 (36 for the full system)
FUSED_EAGER_TOL = 1e-8
# SCF cycles the same code takes on XLA:CPU, printed beside the card's: a
# different count points first at the eigensolver (cuSOLVER on the card,
# LAPACK on the CPU), whose residual phase 4 prints.
CPU_ITERS = {"water_global_ks": 7, "acetonitrile_global_ks": 10,
             "water_tight": 9}
EIGH_TOL = 1e-11  # max |A v - v w| on phase 4's matrix (|w| up to ~30)


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def check(errors: dict, name: str, value: float, ref: float, tol: float):
    """Record |value - ref| beside its tolerance."""
    err = abs(float(value) - float(ref))
    errors[name] = {"value": float(value), "ref": float(ref), "err": err,
                    "tol": tol, "ok": bool(err <= tol)}


def finish(record: dict) -> None:
    """Print the phase line, then stop at the first failed check."""
    emit(record)
    bad = [k for k, e in record.get("errors", {}).items() if not e["ok"]]
    if bad:
        sys.exit(f"chip_smoke: phase {record['phase']} failed: {bad}")


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def integrals_backend(engine) -> str:
    return "native" if engine._use_native else "jax"


def phase_water(projector: str) -> None:
    from nbed_tpu import nbed

    kwargs = dict(
        geometry=str(WATER_XYZ), n_active_atoms=1, basis="STO-3G",
        xc_functional="b3lyp", projector=projector, localization="spade",
        convergence=1e-6, run_ccsd_emb=True, run_fci_emb=True,
    )
    _, cold = timed(lambda: nbed(**kwargs))
    driver, warm = timed(lambda: nbed(**kwargs))
    res = driver.mu if projector == "mu" else driver.huzinaga
    energies = {"e_ks": driver._global_ks.e_tot, "e_ccsd": res["e_ccsd"],
                "e_fci": res["e_fci"]}
    errors = {}
    for key, val in energies.items():
        check(errors, f"{key}_vs_oracle", val, ORACLE[key], ORACLE_TOL[key])
        check(errors, f"{key}_vs_cpu", val, CPU_WATER[projector][key],
              CPU_TOL)
    finish({"phase": f"1-water-{projector}", "energies": energies,
            "errors": errors, "cold_s": cold, "warm_s": warm,
            "n_iter_global_ks": {"card": driver._global_ks.n_iter,
                                 "cpu": CPU_ITERS["water_global_ks"]},
            "stages_warm_s": driver.timings,
            "integrals": integrals_backend(driver._ks_engine)})


def phase_acetonitrile() -> None:
    from scripts.qubit_reduction import ACETONITRILE

    from nbed_tpu import nbed

    kwargs = dict(
        geometry=ACETONITRILE, n_active_atoms=2, basis="STO-3G",
        xc_functional="b3lyp5", projector="huzinaga", localization="spade",
        convergence=1e-6, run_ccsd_emb=False, run_fci_emb=False,
    )
    _, cold = timed(lambda: nbed(**kwargs))
    driver, warm = timed(lambda: nbed(**kwargs))
    _, h1, _ = driver.huzinaga["second_quantised"]
    qubits = int(h1.shape[0])
    energies = {"e_ks": driver._global_ks.e_tot,
                "e_rhf": driver.huzinaga["e_rhf"]}
    errors = {}
    check(errors, "qubits", qubits, ACETONITRILE_QUBITS, 0)
    for key, val in energies.items():
        check(errors, f"{key}_vs_cpu", val, CPU_ACETONITRILE[key],
              PIPELINE_TOL)
    finish({"phase": "2-acetonitrile", "qubits": qubits,
            "qubits_full": 2 * driver._mol.nao, "energies": energies,
            "errors": errors, "cold_s": cold, "warm_s": warm,
            "n_iter_global_ks": {"card": driver._global_ks.n_iter,
                                 "cpu": CPU_ITERS["acetonitrile_global_ks"]},
            "stages_warm_s": driver.timings,
            "integrals": integrals_backend(driver._ks_engine)})


def phase_pfoa() -> None:
    import jax
    import jax.numpy as jnp

    from nbed_tpu.config import NbedConfig
    from nbed_tpu.driver import NbedDriver

    config = NbedConfig(geometry=str(PFOA_XYZ), n_active_atoms=4,
                        basis="STO-3G", xc_functional="b3lyp",
                        convergence=1e-6)
    driver = NbedDriver(config)
    engine = driver._ks_engine  # the engine the pipeline's global KS uses
    (operands, dm0), setup = timed(
        lambda: (engine._kernel_operands, jnp.asarray(engine._sad_guess())))
    compiled, compile_s = timed(lambda: engine._jitted_kernel.lower(
        operands, None, dm0, None, None, max_cycle=engine.max_cycle,
        nelec=engine.mol.nelec, conv_tol=engine.conv_tol, dm_conv_tol=engine.dm_conv_tol,
        level_shift=0.0, warmup=False).compile())
    mem = compiled.memory_analysis()
    emit({"phase": "3-pfoa-memory", "nao": engine.mol.nao,
          "density_fitting": engine.density_fitting,
          "xc_path": engine._xc_pack(jnp.float64)[0],
          "setup_s": setup, "compile_s": compile_s,
          "memory_analysis": {k: getattr(mem, k) for k in dir(mem)
                              if k.endswith("_in_bytes")}})
    sol, cold = timed(engine.kernel)
    sol2, warm = timed(engine.kernel)
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    errors = {}
    check(errors, "converged", float(sol.converged and sol2.converged), 1.0,
          0)
    check(errors, "e_ks_vs_cpu", sol.e_tot, CPU_PFOA_E_KS, PIPELINE_TOL)
    finish({"phase": "3-pfoa-global-dfuks", "nao": engine.mol.nao,
            "energies": {"e_ks": sol.e_tot, "e_ks_warm": sol2.e_tot},
            "errors": errors, "cold_s": cold, "warm_s": warm,
            "n_iter": {"card": sol.n_iter, "cpu": "not pinned"},
            "peak_bytes_in_use": peak,
            "integrals": integrals_backend(engine)})


def phase_fused_vs_eager() -> None:
    import jax.numpy as jnp

    from nbed_tpu.chem import build_molecule
    from nbed_tpu.scf.engine import SCFEngine

    mol = build_molecule(WATER_XYZ.read_text(), "sto-3g")
    out, times, iters = {}, {}, {}
    for mode in ("on", "off"):
        def run():
            return SCFEngine(mol, xc="b3lyp", conv_tol=1e-10,
                             dm_conv_tol=1e-8, max_cycle=100,
                             jit_kernel=mode).kernel()
        run()  # compile / first dispatch
        sol, times[mode] = timed(run)
        out[mode], iters[mode] = sol.e_tot, sol.n_iter
    # the eigensolver every SCF cycle calls, at pfoa's width
    a = np.random.default_rng(5).standard_normal((126, 126))
    a = a + a.T
    w, v = (np.asarray(x) for x in jnp.linalg.eigh(jnp.asarray(a)))
    errors = {}
    check(errors, "fused_vs_eager", out["on"], out["off"], FUSED_EAGER_TOL)
    check(errors, "fused_vs_oracle", out["on"], ORACLE["e_ks"],
          ORACLE_TOL["e_ks"])
    check(errors, "eigh_residual", np.abs(a @ v - v * w).max(), 0.0,
          EIGH_TOL)
    finish({"phase": "4-fused-vs-eager",
            "energies": {"fused": out["on"], "eager": out["off"]},
            "errors": errors, "warm_s": {"fused": times["on"],
                                         "eager": times["off"]},
            "n_iter": {"fused": iters["on"], "eager": iters["off"],
                       "cpu": CPU_ITERS["water_tight"]},
            "integrals": "native"})


def phase_multi() -> None:
    """Four cards: batched HF over a (4, 1) batch mesh, DF-UKS and ERI-HF
    over a (1, 4) model mesh, each against the single-card engine."""
    import jax
    import jax.numpy as jnp

    from nbed_tpu.chem import build_molecule
    from nbed_tpu.parallel import (
        batched_hf_energies, make_mesh, make_sharded_df_ks,
        make_sharded_scf,
    )
    from nbed_tpu.scf.engine import SCFEngine

    if len(jax.devices()) != 4:
        sys.exit(f"chip_smoke --multi: needs 4 devices, found "
                 f"{len(jax.devices())}")
    mol = build_molecule(WATER_XYZ.read_text(), "sto-3g")
    tight = dict(conv_tol=1e-10, dm_conv_tol=1e-8, max_cycle=100)

    # batched: 8 perturbed conformers, batch axis over 4 cards
    rng = np.random.default_rng(11)
    base = np.asarray(mol.coords)
    coords = base[None] + 0.02 * rng.standard_normal((8, *base.shape))
    mesh = make_mesh(4, batch=4)
    (energies, conv), wall = timed(lambda: jax.block_until_ready(
        batched_hf_energies(mol, jnp.asarray(coords), mesh=mesh,
                            conv_tol=1e-10, max_cycle=100)))
    ref = [SCFEngine(mol, coords=c, init_guess="hcore", **tight).kernel().e_tot
           for c in coords]
    errors = {}
    for i, (e, r) in enumerate(zip(np.asarray(energies), ref)):
        check(errors, f"batched_{i}", e, r, 1e-8)
    check(errors, "batched_converged", float(np.all(np.asarray(conv))), 1.0,
          0)
    finish({"phase": "multi-batched-hf", "mesh": dict(mesh.shape),
            "devices": len(energies.sharding.device_set),
            "shard_shapes": [list(s.data.shape)
                             for s in energies.addressable_shards],
            "errors": errors, "cold_s": wall})

    # model-sharded DF-UKS and ERI-HF against the single-card engine
    mesh = make_mesh(4, batch=1)
    for name, build, ref_engine in (
        ("sharded_df_ks",
         lambda: make_sharded_df_ks(mol, mesh, xc="b3lyp", **tight),
         SCFEngine(mol, xc="b3lyp", density_fitting=True,
                   init_guess="hcore", **tight)),
        ("sharded_scf", lambda: make_sharded_scf(mol, mesh, **tight),
         SCFEngine(mol, init_guess="hcore", **tight)),
    ):
        fn, args = build()
        big = args[2]  # ERI supermatrix / DF factor, sharded on 'model'
        res, wall = timed(lambda: jax.block_until_ready(fn(*args)))
        e = float(res.e_elec + mol.energy_nuc())
        errors = {}
        check(errors, "vs_single_card", e, ref_engine.kernel().e_tot, 1e-7)
        check(errors, "operand_devices", len(big.sharding.device_set), 4, 0)
        finish({"phase": f"multi-{name}", "mesh": dict(mesh.shape),
                "operand_shape": list(big.shape),
                "shard_shapes": [list(s.data.shape)
                                 for s in big.addressable_shards],
                "energies": {"sharded": e}, "errors": errors,
                "cold_s": wall})
    phase_multi_pfoa(mesh)


def phase_multi_pfoa(mesh) -> None:
    """Aux-sharded DF-UKS at pfoa's 126 AOs, the size the model axis is
    for, against the single-card engine that ``NbedDriver`` builds (auto-DF,
    the driver's auxiliary basis, grid and convergence settings), both
    started from the same SAD guess."""
    import jax
    import jax.numpy as jnp

    from nbed_tpu.config import NbedConfig
    from nbed_tpu.driver import NbedDriver
    from nbed_tpu.parallel import make_sharded_df_ks

    driver = NbedDriver(NbedConfig(geometry=str(PFOA_XYZ), n_active_atoms=4,
                                   basis="STO-3G", xc_functional="b3lyp",
                                   convergence=1e-6))
    engine, mol = driver._ks_engine, driver._mol
    settings = dict(conv_tol=engine.conv_tol, dm_conv_tol=engine.dm_conv_tol,
                    max_cycle=engine.max_cycle)
    dm0 = jnp.asarray(engine._sad_guess())
    (fn, args), setup = timed(lambda: make_sharded_df_ks(
        mol, mesh, xc=engine.xc, df_beta=engine.df_beta,
        grid_level=engine.grid_level, dm0=dm0, **settings))
    res, cold = timed(lambda: jax.block_until_ready(fn(*args)))
    res, warm = timed(lambda: jax.block_until_ready(fn(*args)))
    e = float(res.e_elec + mol.energy_nuc())
    b, ao = args[2], args[3]
    # The DF factor is a pure host function of (molecule, coordinates,
    # beta): hand the engine the one already built (its zero pad columns
    # add nothing to J or K) instead of spending the host set-up twice.
    engine.__dict__["_df_b"] = jax.device_put(b, jax.devices()[0])
    ref = engine.kernel(dm0=dm0)
    errors = {}
    check(errors, "vs_single_card", e, ref.e_tot, 1e-7)
    check(errors, "vs_cpu", e, CPU_PFOA_E_KS, PIPELINE_TOL)
    check(errors, "converged", float(bool(res.converged) and ref.converged),
          1.0, 0)
    check(errors, "operand_devices", len(b.sharding.device_set), 4, 0)
    finish({"phase": "multi-sharded_df_ks-pfoa", "nao": mol.nao,
            "mesh": dict(mesh.shape),
            "df_factor_shape": list(b.shape),
            "df_factor_shard_shapes": [list(s.data.shape)
                                       for s in b.addressable_shards],
            "ao_table_shape": list(ao.shape),
            "ao_table_shard_shapes": [list(s.data.shape)
                                      for s in ao.addressable_shards],
            "energies": {"sharded": e, "single_card": ref.e_tot},
            "n_iter": {"sharded": int(res.n_iter), "single_card": ref.n_iter},
            "errors": errors, "setup_s": setup, "cold_s": cold,
            "warm_s": warm})


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--multi", action="store_true",
                        help="run only the four-card batched/sharded checks")
    args = parser.parse_args()

    import jax

    import nbed_tpu  # noqa: F401  (enables f64 before any array exists)

    if jax.default_backend() != "gpu":
        sys.exit(f"chip_smoke: JAX found no GPU (backend "
                 f"{jax.default_backend()!r}); nothing was run")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    dev = jax.devices()[0]
    emit({"phase": "device", "nvidia_smi": smi.splitlines(),
          "device_kind": dev.device_kind, "count": len(jax.devices()),
          "jax": jax.__version__})

    if args.multi:
        phase_multi()
    else:
        phase_water("mu")
        phase_water("huzinaga")
        phase_acetonitrile()
        phase_pfoa()
        phase_fused_vs_eager()
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
