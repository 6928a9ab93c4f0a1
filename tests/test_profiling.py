"""Profiling utilities (utils/profiling.py): step timer sanity and trace
capture produce real artifacts on the CPU backend.
"""

import pathlib

import jax
import jax.numpy as jnp

from normalizingflows.jl_tpu.utils import profiling


def test_time_scan_steps_scales_with_work():
    def run_steps(n):
        def body(c, _):
            return c @ c / jnp.maximum(jnp.max(jnp.abs(c)), 1.0), None
        out, _ = jax.lax.scan(body, jnp.eye(64) * 0.5, None, length=n)
        return out

    run = jax.jit(run_steps, static_argnums=0)
    per_step = profiling.time_scan_steps(run, n=50, reps=2)
    assert per_step > 0
    # 4x the matrix work should cost measurably more per step
    def run_steps_big(n):
        def body(c, _):
            return c @ c / jnp.maximum(jnp.max(jnp.abs(c)), 1.0), None
        out, _ = jax.lax.scan(body, jnp.eye(256) * 0.5, None, length=n)
        return out

    per_step_big = profiling.time_scan_steps(
        jax.jit(run_steps_big, static_argnums=0), n=50, reps=2)
    assert per_step_big > per_step


def test_trace_writes_artifacts(tmp_path):
    d = tmp_path / "trace"
    with profiling.trace(str(d)):
        jnp.sum(jnp.ones((128, 128))).block_until_ready()
    files = list(pathlib.Path(d).rglob("*"))
    assert any(f.is_file() for f in files), "no trace artifacts written"


def test_time_call_times_each_rep_after_warmup():
    calls = []

    def fn(x):
        calls.append(x)
        return jnp.sum(x)

    times = profiling.time_call(fn, jnp.ones(4), reps=3)
    assert len(times) == 3 and all(t >= 0 for t in times)
    assert len(calls) == 4  # one untimed warm-up call, then the reps


def test_time_call_without_warmup_times_every_call():
    calls = []

    def fn(x):
        calls.append(x)
        return jnp.sum(x)

    times = profiling.time_call(fn, jnp.ones(4), reps=2, warmup=False)
    assert len(times) == 2 and len(calls) == 2
