"""Profiling helpers: jax.profiler traces and device timing.

The reference has no tracing (SURVEY.md §5); the rebuild needs it for the
BASELINE latency metrics.  ``device_time`` waits for the device with
``jax.block_until_ready``: JAX returns before the device finishes, so a
timing without it measures the enqueue.
"""

from __future__ import annotations

import contextlib
import time

import jax
import numpy as np

__all__ = ["trace", "device_time"]


@contextlib.contextmanager
def trace(log_dir: str):
    """Context manager around jax.profiler.trace (view with TensorBoard or
    read with ``jax.profiler.ProfileData``)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def device_time(fn, *args, reps: int = 16, warmup: int = 2) -> dict:
    """Wall-time ``fn(*args)`` to completion, ``reps`` times one by one.

    Returns {"mean_s", "p50_s", "p99_s", "total_s", "reps"}."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return {
        "mean_s": float(np.mean(times)),
        "p50_s": float(np.percentile(times, 50)),
        "p99_s": float(np.percentile(times, 99)),
        "total_s": float(np.sum(times)),
        "reps": reps,
    }
