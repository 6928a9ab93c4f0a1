"""Rates of the kernels and training steps against the card's peaks.

    python benchmarks/roofline.py [--quick]

Each measurement reports an analytic flop or byte count per element or per
step, the achieved rate (median and interquartile range of timed calls that
end in `jax.block_until_ready`, after an untimed compiling call), and its
share of the published peak for this card (`PEAKS`, keyed by the exact
`device_kind`; an unknown kind is an error):

  * RQS spline kernel — elementwise and arithmetic-light: its roof is
    device-memory bandwidth.
  * Wide RealNVP training step — matmul-dominated: its roof is the
    tensor-core (bf16) or plain f32 peak (MFU).

Prints one JSON line per measurement. Refuses to run without a GPU.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import optax

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import normalizingflows as nf  # noqa: E402
from normalizingflows.jl_tpu.ops import rqs_pallas  # noqa: E402
from normalizingflows.jl_tpu.utils.profiling import time_call  # noqa: E402
from normalizingflows.jl_tpu.utils.pytree import (  # noqa: E402
    apply_mask,
    trainable_mask,
)

# Published dense peaks per card (NVIDIA H100 SXM data sheet, no sparsity,
# at the full 700 W power limit). "f32" is the plain f32 rate outside the
# tensor cores: Precision.HIGHEST products are exact f32, not TF32.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16": 989e12, "f32": 67e12, "hbm": 3.35e12},
}


def peaks(kind: str | None = None) -> dict:
    kind = kind or jax.devices()[0].device_kind
    if kind not in PEAKS:
        raise KeyError(f"no published peaks for device kind {kind!r}; "
                       "add them to benchmarks/roofline.py PEAKS")
    return PEAKS[kind]


def rate_stats(times: list[float], units: float) -> dict:
    """Median and IQR of units/s over timed calls (rate = units/time, so
    the quartiles swap)."""
    rates = sorted(units / t for t in times)
    q = statistics.quantiles(rates, n=4) if len(rates) > 1 else rates * 3
    return {"median": statistics.median(rates), "iqr": [q[0], q[2]],
            "reps": len(rates)}


def _device() -> dict:
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


# ---------------------------------------------------------------- RQS kernel

def rqs_flops_bytes(K: int, raw_bytes: int = 2):
    """Per-element cost of the fused RQS forward: x in, 3K−1 raw params in
    (bf16 under the mixed-precision policy), y and log-det out; ≈6 ops per
    raw param (exp, sum, div, cumsum add, scale, clamp), K compares, ~30
    flop of rational-quadratic evaluation."""
    bytes_per = 4 * 3 + raw_bytes * (3 * K - 1)
    flops_per = 6 * (3 * K - 1) + K + 30
    return flops_per, bytes_per


def measure_rqs(n_elems: int = 1 << 22, K: int = 10, B: float = 30.0,
                passes: int = 20):
    """Achieved device-memory bandwidth of the fused RQS forward on
    param-major bf16 raw (what the bf16 conditioners feed it)."""
    kx, kr = jax.random.split(jax.random.key(0))
    x = jax.random.uniform(kx, (n_elems,), jnp.float32, -B, B)
    raw_t = jax.random.normal(kr, (3 * K - 1, n_elems)).astype(jnp.bfloat16)

    @jax.jit
    def run(x, raw_t):
        def body(x, _):
            y, ld = rqs_pallas.rqs_fused_t(x, raw_t, B)
            return 0.5 * (x + y) + 1e-6 * ld, None

        return jax.lax.scan(body, x, None, length=passes)[0]

    st = rate_stats(time_call(run, x, raw_t), passes * n_elems)
    flops_per, bytes_per = rqs_flops_bytes(K)
    gbps = st["median"] * bytes_per / 1e9
    return {
        "measurement": "rqs_fused_forward",
        "config": f"n={n_elems}, K={K}, raw bf16",
        "elems_per_s": st["median"], "elems_per_s_iqr": st["iqr"],
        "timing_reps": st["reps"],
        "bytes_per_elem": bytes_per, "flops_per_elem": flops_per,
        "achieved_GBps": gbps,
        "pct_of_hbm_peak": 100 * gbps * 1e9 / peaks()["hbm"],
        "device": _device(),
    }


# ----------------------------------------------------------- training steps

def realnvp_train_flops(dim, hdims, nlayers, batch):
    """Matmul flops of ONE ELBO training step (fwd + backward ≈ 3× fwd:
    grad-wrt-input and grad-wrt-weight matmuls each cost one forward)."""
    half = dim // 2
    dims = [half, *hdims, half]
    mlp = sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))  # flops/sample
    fwd = batch * mlp * 2 * 2 * nlayers  # 2 MLPs (s,t) × 2 couplings
    return 3 * fwd


def train_run(flow, target, batch, m, lr=1e-3, unroll=1):
    """jitted ``run(key) -> losses``: m Adam steps of the ELBO in one
    `lax.scan` (``unroll`` steps per loop iteration), with all steps' base
    draws sampled up front."""
    optimizer = optax.adam(lr)
    mask = trainable_mask(flow, frozen=lambda m: m is flow.base)
    opt_state = optimizer.init(flow)

    def step(carry, xs):
        f, st = carry
        loss, g = jax.value_and_grad(
            lambda f: -nf.elbo_from_samples(xs, f, target.log_prob))(f)
        u, st = optimizer.update(apply_mask(g, mask), st, f)
        return (optax.apply_updates(f, u), st), loss

    @jax.jit
    def run(key):
        xs = flow.base.sample(key, (m, batch))
        return jax.lax.scan(step, (flow, opt_state), xs, unroll=unroll)[1]

    return run


def measure_wide_train(dim=128, hdims=(256, 256), nlayers=10, batch=4096,
                       compute_dtype=None, n=30):
    """MFU of the wide-RealNVP training step (remat=True)."""
    flow = jax.jit(
        lambda k: nf.realnvp(k, dim, hdims, nlayers=nlayers,
                             compute_dtype=compute_dtype, remat=True)
    )(jax.random.key(0))
    run = train_run(flow, nf.Banana(dim, 1.0, 100.0), batch, n)
    st = rate_stats(time_call(run, jax.random.key(1)), n)
    dt = "bf16" if compute_dtype == jnp.bfloat16 else "f32"
    flops = realnvp_train_flops(dim, hdims, nlayers, batch)
    peak = peaks()[dt]
    return {
        "measurement": f"realnvp_wide_train_{dt}",
        "config": f"d={dim}, hdims={list(hdims)}, L={nlayers}, batch={batch}",
        "steps_per_s": st["median"], "steps_per_s_iqr": st["iqr"],
        "timing_reps": st["reps"],
        "matmul_flops_per_step": flops,
        "achieved_TFLOPs": st["median"] * flops / 1e12,
        "mfu_pct": 100 * st["median"] * flops / peak,
        "peak": f"{dt} {peak / 1e12:.0f} TFLOP/s",
        "device": _device(),
    }


def measure_nsf_wide_train(dim=64, hdims=(128, 128), K=10, nlayers=10,
                           batch=4096, compute_dtype=jnp.bfloat16, n=10):
    """NSF training step in the throughput regime: steps/s and spline
    elements/s (batch × dim × nlayers per forward). It mixes conditioner
    matmuls with the RQS kernel, so no single roof applies."""
    flow = jax.jit(
        lambda k: nf.nsf(k, dim, hdims, K=K, nlayers=nlayers,
                         identity_init=True, compute_dtype=compute_dtype,
                         remat=True)
    )(jax.random.key(0))
    run = train_run(flow, nf.Banana(dim, 1.0, 100.0), batch, n)
    st = rate_stats(time_call(run, jax.random.key(1)), n)
    elems = batch * dim * nlayers
    dt = "bf16" if compute_dtype == jnp.bfloat16 else "f32"
    return {
        "measurement": f"nsf_wide_train_{dt}",
        "config": f"d={dim}, hdims={list(hdims)}, K={K}, L={nlayers}, "
                  f"batch={batch}",
        "steps_per_s": st["median"], "steps_per_s_iqr": st["iqr"],
        "timing_reps": st["reps"],
        "spline_Melems_per_s": st["median"] * elems / 1e6,
        "device": _device(),
    }


def measure_sampling(dim=2, hdims=(16, 16), nlayers=3, batch=262144,
                     passes=8):
    """Samples/s of the RealNVP demo flow at a large batch."""
    flow = jax.jit(
        lambda k: nf.realnvp(k, dim, hdims, nlayers=nlayers)
    )(jax.random.key(0))

    @jax.jit
    def run(key):
        def body(c, k):
            s = flow.sample(k, (batch,))
            return c + s[0, 0] + s[-1, -1], None

        return jax.lax.scan(body, jnp.zeros(()),
                            jax.random.split(key, passes))[0]

    st = rate_stats(time_call(run, jax.random.key(1)), passes * batch)
    return {
        "measurement": "realnvp_sampling",
        "config": f"d={dim}, hdims={list(hdims)}, L={nlayers}, batch={batch}",
        "samples_per_s": st["median"], "samples_per_s_iqr": st["iqr"],
        "timing_reps": st["reps"], "device": _device(),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--quick", action="store_true")
    a = p.parse_args(argv)
    if jax.devices()[0].platform != "gpu":
        print("roofline: needs a GPU", file=sys.stderr)
        return 3
    from normalizingflows.jl_tpu.device import init_compile_cache

    init_compile_cache()
    peaks()  # an unknown card fails before any measurement
    batch = 1024 if a.quick else 4096
    rows = [
        measure_rqs(n_elems=1 << (18 if a.quick else 22)),
        measure_wide_train(batch=batch),
        measure_wide_train(batch=batch, compute_dtype=jnp.bfloat16),
        measure_nsf_wide_train(batch=batch),
        measure_sampling(batch=32768 if a.quick else 262144),
    ]
    for r in rows:
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
