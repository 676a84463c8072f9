"""nbed_tpu: accelerator-native projection-based embedding framework.

A from-scratch JAX/XLA re-design of the capabilities of UCL-CCS/Nbed
(see SURVEY.md). Unlike the reference — which orchestrates PySCF's C
cores — every layer here is self-contained and runs on the accelerator
JAX finds (an NVIDIA GPU in production, XLA:CPU for tests):

- integrals: McMurchie–Davidson one-/two-electron Gaussian integrals as
  jit-compiled JAX kernels (batched over shell classes, GEMM-shaped
  contraction assembly) and a native C++ host engine.
- scf: a functional SCF engine (RHF/UHF/RKS/UKS) with DIIS, level shifting,
  embedding potentials and Huzinaga projectors threaded explicitly (no
  monkey-patched ``get_hcore`` — cf. reference driver.py:527-529).
- dft: exchange-correlation functionals (Slater, B88, VWN-RPA/VWN5, LYP,
  B3LYP composite) evaluated on a Becke-partitioned molecular grid.
- localizers: SPADE / PM / Boys / IBO occupied localization, concentric +
  PAO virtual localization, ACE-of-SPADE (reference nbed/localizers/).
- ham: AO→MO transforms and second-quantised spin-orbital Hamiltonians with
  Jordan-Wigner / Bravyi-Kitaev qubit mappings (reference ham_builder.py).
- solvers: exact-diagonalisation FCI and spin-orbital CCSD reference solvers.
- driver/embed: the projection-based-embedding pipeline with mu-shift and
  Huzinaga projectors (reference driver.py), exposed via ``nbed(config)``.
- properties: dipole moments and Mulliken/Löwdin population analysis on
  global or embedded SCF solutions (diagnostics beyond the reference).

Float64 is enabled globally: quantum chemistry needs ~1e-10 in intermediate
linear algebra to hit 1e-6 Ha end-to-end.
"""

import os as _os

import jax

jax.config.update("jax_enable_x64", True)

# Persistent compilation cache: the integral-class and fused-SCF programs
# are compile-heavy and reused identically across processes.  Where
# JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing here
# overrides it.  Otherwise the cache lives at a fixed path inside the
# checkout (a moving path never hits).  XLA:CPU artifacts go one level
# deeper, keyed by a host-CPU fingerprint: JAX's cache key does not capture
# the exact machine-feature set of CPU AOT artifacts, and reloading one
# compiled on another CPU model can crash in deserialize_executable.


def _host_cpu_tag() -> str:
    """Hash BOTH the feature flags and the model name: XLA:CPU AOT
    artifacts embed LLVM *tuning* attributes (e.g. +prefer-no-scatter)
    chosen per CPU model, so two hosts with identical flag lists can still
    produce feature-mismatched artifacts."""
    try:
        import hashlib

        parts = {}
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, val = line.partition(":")
                key = key.strip()
                if key in ("flags", "model name") and key not in parts:
                    parts[key] = (" ".join(sorted(val.split()))
                                  if key == "flags" else val.strip())
        if parts:
            blob = "|".join(f"{k}={parts[k]}" for k in sorted(parts))
            return hashlib.md5(blob.encode()).hexdigest()[:8]
    except OSError:
        pass
    return "nohost"


def _default_cache_dir() -> str:
    """``<checkout>/.jax_cache/<host>``: JAX's own cache key separates
    backends, so one host directory serves CPU and GPU artifacts alike."""
    return _os.path.join(
        _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
        ".jax_cache", _host_cpu_tag(),
    )


if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _cache_dir = _default_cache_dir()
    try:
        _os.makedirs(_cache_dir, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", _cache_dir)
    except OSError:  # read-only checkout: run without a persistent cache
        pass
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

from .config import NbedConfig  # noqa: E402
from .embed import nbed  # noqa: E402
from .utils import setup_logs  # noqa: E402

__all__ = ["nbed", "NbedConfig", "setup_logs"]

__version__ = "0.1.0"
