"""Observability: per-stage timing and device profiling.

The reference's only instrumentation is one wall-clock print per run
(`multiprocessor_Inhomogeneous_method.py:778,1119`; SURVEY.md section 5).
Here: a stage timer usable as a context manager, a `jax.profiler` trace
wrapper for device timelines, and the placement of JAX's compile cache.
"""
from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Dict, Optional

log = logging.getLogger("eigensolver_tpu")


class StageTimer:
    """Accumulates wall time per named stage; `report()` returns a dict."""

    def __init__(self):
        self.stages: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.stages[name] = self.stages.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1
            log.debug("stage %s: %.3fs (total %.3fs x%d)", name, dt,
                      self.stages[name], self.counts[name])

    def report(self) -> Dict[str, float]:
        return dict(sorted(self.stages.items(), key=lambda kv: -kv[1]))


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None):
    """jax.profiler trace around a block (viewable in TensorBoard/Perfetto);
    no-op when log_dir is None."""
    if log_dir is None:
        yield
        return
    import jax
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def block_and_time(fn, *args, n: int = 1, **kwargs):
    """Run fn n times with block_until_ready; return (last_result, sec/iter)."""
    import jax
    out = fn(*args, **kwargs)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args, **kwargs)
        jax.block_until_ready(out)
    return out, (time.perf_counter() - t0) / max(n, 1)


def enable_compile_cache() -> str:
    """Place JAX's persistent compilation cache; return its directory.

    If `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself and nothing
    is set here. Otherwise the cache goes to `<checkout>/.jax_cache`, a path
    fixed by this package's location, never a temporary or per-process name
    that a later run could not find again."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
