"""The fused RQS kernel against the `ops/rqs.py` oracle, on one GPU.

    python benchmarks/nsf_kernel_ab.py [--reps 7]

End to end: the NSF ELBO train step (`roofline.train_run`: Adam,
presampled base draws, `n` steps in one jitted `lax.scan`) in two cells,
the wide NSF (d=64, [128,128]×10, K=10, batch 4096, bf16 conditioners,
selective remat) and the NSF demo (d=2, `nsf` defaults, batch 64), each
with the oracle backend and with the kernel backend. Kernel alone: forward,
and forward+VJP, at the wide cell's per-call width (131,072 elements, K=10,
raw bf16), the oracle against the kernel at each setting of `BLOCKS`
(elements per block, warps; the first is the kernel's own), as a chain of
dependent calls unrolled in one jitted program.

Variants are compiled and warmed up first, then timed in turns (A B, B A,
...) in one process; every timed call ends in `jax.block_until_ready`.
Prints one JSON line per measurement, each with the card's name and power
limit. Refuses to run without a GPU.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys

import jax
import jax.numpy as jnp

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "benchmarks")]

import normalizingflows as nf  # noqa: E402
from chip_smoke import card_line  # noqa: E402
from normalizingflows.jl_tpu.device import init_compile_cache  # noqa: E402
from normalizingflows.jl_tpu.ops import rqs, rqs_pallas  # noqa: E402
from normalizingflows.jl_tpu.utils.profiling import time_call  # noqa: E402
from roofline import train_run  # noqa: E402

CELLS = {
    "nsf_wide_bf16": dict(dim=64, hdims=(128, 128), K=10, nlayers=10,
                          batch=4096, compute_dtype=jnp.bfloat16, remat=True,
                          lr=1e-3, n=50),
    "nsf_demo": dict(dim=2, hdims=(32, 32), K=10, nlayers=10, batch=64,
                     compute_dtype=None, remat=False, lr=1e-4, n=1000),
}
BLOCKS = ((rqs_pallas.BLOCK, rqs_pallas.NUM_WARPS), (256, 4), (256, 8),
          (512, 8), (1024, 4))


def make_train(cell: dict, backend: str):
    """``(run, steps)``: ``cell["n"]`` train steps on the given spline
    backend, warmed up."""
    flow = jax.jit(lambda k: nf.nsf(
        k, cell["dim"], cell["hdims"], K=cell["K"], nlayers=cell["nlayers"],
        identity_init=True, compute_dtype=cell["compute_dtype"],
        remat=cell["remat"], backend=backend))(jax.random.key(0))
    run = train_run(flow, nf.Banana(cell["dim"], 1.0, 100.0), cell["batch"],
                    cell["n"], cell["lr"])
    key = jax.random.key(2)
    jax.block_until_ready(run(key))
    return lambda: run(key), cell["n"]


def make_spline_ops(blocks, n=131072, K=10, B=30.0, passes=50):
    """``passes`` dependent spline calls (fwd, or fwd+VJP) on param-major
    bf16 raw, jitted and warmed up: the oracle, and the kernel at each
    (block, warps) of ``blocks``. The chain is unrolled in Python, not a
    `lax.scan`: a GPU while loop syncs with the host every iteration,
    which would be timed instead of the calls."""
    kx, kr = jax.random.split(jax.random.key(0))
    x0 = jax.random.uniform(kx, (n,), jnp.float32, -B, B)
    raw_t = jax.random.normal(kr, (3 * K - 1, n)).astype(jnp.bfloat16)

    def kernel(x, r):
        return rqs_pallas.rqs_fused_t(x, r, B)

    def oracle(x, r):
        p = rqs.rqs_params_from_raw(r.T.astype(jnp.float32), B)
        return rqs.rqs_forward(x, *p)

    def chain(fn, grad):
        def step(x):
            if grad:
                g = jax.grad(lambda x, r: jnp.sum(fn(x, r)[1]), (0, 1))(
                    x, raw_t)
                return x + 1e-6 * g[0] + 1e-6 * g[1][0].astype(x.dtype)
            y, ld = fn(x, raw_t)
            return 0.5 * (x + y) + 1e-6 * ld

        def run(x):
            for _ in range(passes):
                x = step(x)
            return x

        f = jax.jit(run)
        jax.block_until_ready(f(x0))  # compiles at the current block
        return (lambda: f(x0)), passes

    ops = {}
    own = rqs_pallas.BLOCK, rqs_pallas.NUM_WARPS
    try:
        for grad in (False, True):
            kind = "fwd_vjp" if grad else "fwd"
            ops[f"rqs_{kind}_oracle"] = chain(oracle, grad)
            for block, warps in blocks:
                rqs_pallas.BLOCK, rqs_pallas.NUM_WARPS = block, warps
                ops[f"rqs_{kind}_kernel_{block}x{warps}"] = chain(kernel,
                                                                  grad)
    finally:
        rqs_pallas.BLOCK, rqs_pallas.NUM_WARPS = own
    return ops


def in_turns(calls: dict, reps: int) -> dict:
    """calls: name -> (fn, units), all warmed up. ``reps`` rounds, the
    order reversed every other round; returns name -> list of units/s."""
    names = list(calls)
    rates = {k: [] for k in names}
    for r in range(reps):
        for k in (names if r % 2 == 0 else names[::-1]):
            fn, units = calls[k]
            rates[k] += [units / t for t in time_call(fn, reps=1,
                                                      warmup=False)]
    return rates


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--reps", type=int, default=7)
    a = p.parse_args(argv)
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"nsf_kernel_ab: needs a GPU, JAX found {dev.platform}",
              file=sys.stderr)
        return 3
    init_compile_cache()
    card = card_line()
    def emit(name, unit, rs):
        row = {"measurement": name, "unit": unit,
               "median": statistics.median(rs), "min": min(rs),
               "max": max(rs), "reps": len(rs), "rates": rs,
               "card": card, "device_kind": dev.device_kind}
        print(json.dumps(row), flush=True)

    for cell_name, cell in CELLS.items():
        calls = {backend: make_train(cell, backend)
                 for backend in ("oracle", "pallas")}
        for v, rs in in_turns(calls, a.reps).items():
            emit(f"{cell_name}/{v}", "steps/s", rs)
    for k, rs in in_turns(make_spline_ops(BLOCKS), a.reps).items():
        emit(k, "calls/s", rs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
