"""Profiling & timing harness (SURVEY.md §5 tracing/profiling).

- ``time_fn``: block-until-ready wall timing with warmup (the measurement
  discipline behind bench.py).
- ``trace``: context manager around ``jax.profiler.trace`` producing a
  Perfetto-compatible trace directory.
- ``roofline``: the memory-bound ceiling of an iteration for a given
  device bandwidth (which the caller supplies), to sanity-check measured
  numbers (one ideal pass moves ~12 B per pixel-iteration: read phi,
  read u0, write phi, all f32).
"""

from __future__ import annotations

import contextlib
import time


def time_fn(fn, *args, warmup: int = 1, reps: int = 3, readback=None):
    """Best-of-reps wall time of a jitted fn (seconds).

    ``readback``: optional lambda taking the output and returning a scalar
    jax array to copy to the host after each call.
    ``warmup=0`` measures cold (includes first-compile time).
    """
    import jax

    out = None
    for _ in range(max(warmup, 0)):
        out = fn(*args)
        jax.block_until_ready(out)
        if readback is not None:
            float(readback(out))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args)
        jax.block_until_ready(out)
        if readback is not None:
            float(readback(out))
        best = min(best, time.perf_counter() - t0)
    return best, out


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/cv_trace"):
    """jax.profiler trace context (view in Perfetto / TensorBoard)."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def roofline(h: int, w: int, hbm_gbps: float,
             bytes_per_pixel_iter: float = 12.0) -> float:
    """Memory-bound ceiling in Mpixel-iters/s at ``hbm_gbps`` GB/s."""
    pixels_per_sec = hbm_gbps * 1e9 / bytes_per_pixel_iter
    return pixels_per_sec / 1e6
