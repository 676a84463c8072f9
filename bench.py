"""Benchmark: one process on one NVIDIA GPU, stages timed on the host clock.

Run from the repository root:  python bench.py

Every stage ends its timed region with ``block_until_ready`` (or a host
readback of the result), runs once cold (compile included) and once or
more warm, and reports seconds.  The run fails when JAX finds no GPU; it
never falls back to the CPU.  The last stdout line is one JSON object
stamped with the card's name and power limit (``nvidia-smi``) and the JAX
device kind and count; ``bench_details.json`` repeats it.

Stages:

- ``pipeline``: water / STO-3G / B3LYP, mu + SPADE, CCSD and FCI through
  ``nbed()`` (the reference-parity configuration), cold and warm, with the
  driver's stage timings from the warm run.
- ``pfoa``: global DF-UKS/B3LYP at 126 AOs on the SCF engine the driver
  builds, cold and warm, with SCF cycle count and peak device memory.
- ``jk``: one f64 J/K build from the ERI supermatrices at nao=95 (the
  largest exact-ERI size below the driver's DF threshold), XLA's GEMMs.
- ``ccsd``: the f64 CCSD amplitude sweep at 10 occupied / 48 virtual spin
  orbitals, a fixed 20 cycles (conv_tol 0).
- ``batch``: vmapped HF over 8 water conformers in one program.
- ``jw``: Jordan-Wigner term generation for a dense 28-spin-orbital
  Hamiltonian (host code).
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
WATER = ROOT / "tests" / "molecules" / "water.xyz"
PFOA = ROOT / "tests" / "molecules" / "pfoa.xyz"


def _timed(fn):
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, time.perf_counter() - t0


def bench_pipeline(out):
    from nbed_tpu import nbed

    kwargs = dict(geometry=str(WATER), n_active_atoms=1, basis="STO-3G",
                  xc_functional="b3lyp", projector="mu",
                  localization="spade", convergence=1e-6,
                  run_ccsd_emb=True, run_fci_emb=True)
    _, out["pipeline_cold_s"] = _timed(lambda: nbed(**kwargs))
    driver, out["pipeline_warm_s"] = _timed(lambda: nbed(**kwargs))
    out["pipeline_stages_warm_s"] = dict(driver.timings)
    out["pipeline_e_ccsd"] = driver.mu["e_ccsd"]


def bench_pfoa(out):
    import jax

    from nbed_tpu.config import NbedConfig
    from nbed_tpu.driver import NbedDriver

    cfg = NbedConfig(geometry=str(PFOA), n_active_atoms=4, basis="STO-3G",
                     xc_functional="b3lyp", convergence=1e-6)
    engine = NbedDriver(cfg)._ks_engine
    _, out["pfoa_cold_s"] = _timed(engine.kernel)
    sol, out["pfoa_warm_s"] = _timed(engine.kernel)
    out["pfoa_nao"] = engine.mol.nao
    out["pfoa_e_ks"] = sol.e_tot
    out["pfoa_converged"] = sol.converged
    out["pfoa_n_iter"] = sol.n_iter
    out["peak_bytes_in_use"] = jax.devices()[0].memory_stats().get(
        "peak_bytes_in_use")


def bench_jk(out):
    import jax
    import jax.numpy as jnp

    nao = 95
    m = nao * nao
    k1, k2, k3 = jax.random.split(jax.random.key(0), 3)
    gj = jax.random.normal(k1, (m, m), jnp.float64)
    gk = jax.random.normal(k2, (m, m), jnp.float64)
    dm = jax.random.normal(k3, (2, nao, nao), jnp.float64)

    @jax.jit
    def jk(gj, gk, dm):
        j = gj @ (dm[0] + dm[1]).reshape(-1)
        k = (gk @ dm.reshape(2, m).T).T
        return j, k

    _, out["jk_cold_s"] = _timed(lambda: jk(gj, gk, dm))
    reps = 20
    _, t = _timed(lambda: [jk(gj, gk, dm) for _ in range(reps)])
    out["jk_nao"] = nao
    out["jk_warm_s"] = t / reps
    out["jk_GBps"] = 2 * m * m * 8 / out["jk_warm_s"] / 1e9


def bench_ccsd(out):
    import jax.numpy as jnp

    from nbed_tpu.solvers.ccsd import _make_sweep

    no, nv = 10, 48
    n = no + nv
    rng = np.random.default_rng(3)
    w = rng.standard_normal((n, n, n, n)) * 1e-3
    w = w - w.transpose(0, 1, 3, 2)
    w = w + w.transpose(2, 3, 0, 1)
    fock = np.diag(np.concatenate([-np.arange(no)[::-1] - 1.0,
                                   np.arange(nv) + 0.5]))
    eps = np.diag(fock)
    d1 = eps[:no, None] - eps[None, no:]
    d2 = (eps[:no, None, None, None] + eps[None, :no, None, None]
          - eps[None, None, no:, None] - eps[None, None, None, no:])
    ops = tuple(jnp.asarray(a) for a in (fock, w, d1, d2))
    amps = (jnp.zeros((no, nv)), jnp.asarray(w[:no, :no, no:, no:] / d2))
    sweep = _make_sweep(no, nv, 6)
    cycles = 20

    def run():
        return sweep(*ops, *amps, jnp.float64(0.0), jnp.float64(0.0),
                     jnp.int32(cycles))

    _, out["ccsd_cold_s"] = _timed(run)
    _, t = _timed(run)
    out["ccsd_no_nv"] = [no, nv]
    out["ccsd_iter_s"] = t / cycles


def bench_batch(out):
    import jax.numpy as jnp

    from nbed_tpu.chem import build_molecule
    from nbed_tpu.parallel import batched_hf_energies

    mol = build_molecule(WATER.read_text(), "sto-3g")
    base = np.asarray(mol.coords)
    rng = np.random.default_rng(11)
    coords = jnp.asarray(base[None]
                         + 0.02 * rng.standard_normal((8, *base.shape)))
    _, out["batch_cold_s"] = _timed(
        lambda: batched_hf_energies(mol, coords, conv_tol=1e-8))
    (_, conv), out["batch_warm_s"] = _timed(
        lambda: batched_hf_energies(mol, coords, conv_tol=1e-8))
    out["batch_size"] = 8
    out["batch_converged"] = int(np.asarray(conv).sum())


def bench_jw(out):
    from nbed_tpu.ham.qubit import jordan_wigner

    nso = 28
    rng = np.random.default_rng(7)
    h1 = rng.standard_normal((nso, nso))
    h1 = h1 + h1.T
    h2 = rng.standard_normal((nso,) * 4) * 0.05
    jordan_wigner(0.0, h1[:4, :4], h2[:4, :4, :4, :4])  # warm caches
    t0 = time.perf_counter()
    psum = jordan_wigner(0.0, h1, h2)
    dt = time.perf_counter() - t0
    out["jw28_terms"] = len(psum.terms)
    out["jw28_terms_per_s"] = len(psum.terms) / dt


def main():
    import jax

    import nbed_tpu  # noqa: F401  (enables f64 before any array exists)

    if jax.default_backend() != "gpu":
        sys.exit(f"bench: JAX found no GPU (backend "
                 f"{jax.default_backend()!r}); nothing was run")
    dev = jax.devices()[0]
    out = {
        "card": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            check=True, capture_output=True, text=True).stdout.strip(),
        "platform": dev.platform, "device_kind": dev.device_kind,
        "device_count": len(jax.devices()), "jax": jax.__version__,
    }
    stages = {"pipeline": bench_pipeline, "pfoa": bench_pfoa,
              "jk": bench_jk, "ccsd": bench_ccsd, "batch": bench_batch,
              "jw": bench_jw}
    for name, stage in stages.items():
        t0 = time.perf_counter()
        stage(out)
        print(f"[bench] {name}: {time.perf_counter() - t0:.1f} s",
              file=sys.stderr, flush=True)
    with open(ROOT / "bench_details.json", "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
