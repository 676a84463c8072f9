"""Platform choices: import without pydantic, compile-cache placement,
accelerator-vs-CPU path selection, and chip_smoke's refusal to run on CPU."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent


def _run(code: str, **env_updates) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(JAX_PLATFORMS="cpu", **env_updates)
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


def test_import_without_pydantic():
    proc = _run(
        "import sys; sys.modules['pydantic'] = None\n"
        "import nbed_tpu\n"
        "from nbed_tpu.config import NbedConfig\n"
        "NbedConfig(geometry='2\\n\\nH 0.0 0.0 0.0\\nH 0.0 0.0 0.7\\n',"
        " n_active_atoms=1, basis='sto-3g', xc_functional='b3lyp')\n"
        "print('ok')")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_cache_dir_honours_env(tmp_path):
    proc = _run("import nbed_tpu, jax;"
                "print(jax.config.jax_compilation_cache_dir)",
                JAX_COMPILATION_CACHE_DIR=str(tmp_path))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == str(tmp_path)


def test_cache_dir_defaults_to_checkout():
    proc = _run("import nbed_tpu, jax;"
                "print(jax.config.jax_compilation_cache_dir)")
    assert proc.returncode == 0, proc.stderr
    # one host-fingerprint subdirectory, whatever the backend: JAX's own
    # cache key separates CPU and GPU artifacts inside it
    from nbed_tpu import _host_cpu_tag

    assert Path(proc.stdout.strip()) == ROOT / ".jax_cache" / _host_cpu_tag()


def test_chip_smoke_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "no GPU" in proc.stderr


@pytest.mark.parametrize("backend, fused", [("cpu", False), ("gpu", True),
                                            ("cuda", True)])
def test_jit_kernel_auto_follows_backend(monkeypatch, water_molecule,
                                         backend, fused):
    import jax

    from nbed_tpu.scf.engine import SCFEngine

    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert SCFEngine(water_molecule)._use_jit_kernel is fused
    assert SCFEngine(water_molecule, jit_kernel="on")._use_jit_kernel
    assert not SCFEngine(water_molecule, jit_kernel="off")._use_jit_kernel


def test_fast_paths_are_opt_in(water_molecule):
    from nbed_tpu.scf.engine import SCFEngine

    eng = SCFEngine(water_molecule)
    assert eng._jk_fast_fn is None and eng._xc_fast_fn is None
    assert SCFEngine(water_molecule, incremental_jk=True)._jk_fast_fn


def test_ccsd_auto_is_f64(monkeypatch):
    """'auto' precision resolves to the f64 sweep with no device probe."""
    import jax
    import numpy as np

    from nbed_tpu.solvers import run_ccsd

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    rng = np.random.default_rng(0)
    n = 8  # spin orbitals, 2 occupied
    h1 = np.diag(np.arange(n, dtype=float) - 1.0)
    h2 = rng.standard_normal((n,) * 4) * 0.01
    h2 = h2 + h2.transpose(1, 0, 3, 2)
    h2 = h2 + h2.transpose(3, 2, 1, 0)
    occ = np.arange(n) < 2
    e_auto, _ = run_ccsd(h1, h2, occ, conv_tol=1e-10)
    e_64, _ = run_ccsd(h1, h2, occ, conv_tol=1e-10, precision="f64")
    e_32, _ = run_ccsd(h1, h2, occ, conv_tol=1e-10, precision="f32")
    assert e_auto == e_64
    assert e_auto != e_32
