"""Profiling and step-timing utilities.

The reference's only observability is a ProgressMeter line with it/s
(`src/optimize.jl:4-6,69`; SURVEY §5 lists tracing/profiling as absent).
Here: `jax.profiler` trace capture around any callable, and timers that end
every timed call in `jax.block_until_ready` and keep the compiling call out
of the timed window.
"""

from __future__ import annotations

import contextlib
import statistics
import time
from typing import Callable

import jax

__all__ = ["trace", "time_call", "time_scan_steps"]


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a `jax.profiler` trace (view with TensorBoard / xprof)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def time_call(fn: Callable, *args, reps: int = 5,
              warmup: bool = True) -> list[float]:
    """Wall seconds of ``reps`` calls of ``fn(*args)``, each ended by
    `jax.block_until_ready`, after one untimed call that compiles and
    warms up (``warmup=False`` skips it, for callers that take turns
    between variants already warmed up)."""
    if warmup:
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return times


def time_scan_steps(
    run_steps: Callable[[int], jax.Array],
    n: int = 2000,
    reps: int = 3,
) -> float:
    """Median per-step seconds of a device-side loop: ``run_steps(n)``
    executes n steps on the device."""
    return statistics.median(time_call(run_steps, n, reps=reps)) / n
