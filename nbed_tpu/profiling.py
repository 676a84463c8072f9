"""Per-stage wall-time metrics and JAX profiler hooks.

The reference has no tracing/profiling at all (SURVEY.md §5.1); wall-time is
the headline metric of this build, so the driver records stage timings into
``NbedDriver.timings`` and a ``device_trace`` context wraps
``jax.profiler.trace`` for device-level (XLA op) profiles.
"""

import contextlib
import logging
import time

logger = logging.getLogger(__name__)

__all__ = ["StageTimer", "device_trace"]


class StageTimer:
    """Accumulates named stage wall times.

    >>> timer = StageTimer()
    >>> with timer("scf"):
    ...     ...
    >>> timer.timings["scf"]
    """

    def __init__(self):
        self.timings: dict = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.timings[name] = self.timings.get(name, 0.0) + dt
            logger.debug("stage %s: %.3f s", name, dt)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """XLA device profiler trace (view with TensorBoard / xprof)."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
