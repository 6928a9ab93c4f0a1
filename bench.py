"""Benchmark: ELBO training steps/s and flow samples/s on one GPU.

    python bench.py

Headline workload = the reference's demo config (RealNVP on the hard
Banana(2, b=1, var=100): 3 layers, conditioner hdims [16,16], Adam(5e-4),
16 samples per step — `example/demo_RealNVP.jl:20-61` / BASELINE.md).
Secondary rows: the NSF demo config, the wide RealNVP step in f32 and bf16
with its MFU (`benchmarks/roofline.py`), and sampling at batch 262,144.

Each rate is the median and interquartile range of 5 timed calls that end
in `jax.block_until_ready`, after an untimed call that compiles.
``vs_baseline`` is the speedup over the same jitted program on the host
CPU (the reference is CPU-only Julia with no published numbers;
BASELINE.md). Prints ONE JSON line. Any failure, or a missing GPU, exits
non-zero.
"""

import json
import pathlib
import sys

import jax
import jax.numpy as jnp

import normalizingflows as nf
from normalizingflows.jl_tpu.device import init_compile_cache
from normalizingflows.jl_tpu.utils.profiling import time_call

sys.path.insert(0, str(pathlib.Path(__file__).parent / "benchmarks"))
import roofline  # noqa: E402

# Reference demo config (demo_RealNVP.jl:20-61)
DIM = 2
HDIMS = (16, 16)
NLAYERS = 3
BATCH = 16           # reference: 16 samples/iter
SAMPLE_BATCH = 262144
LR = 5e-4


def build():
    # jit-construct so init math runs on the device in one executable
    flow = jax.jit(
        lambda k: nf.realnvp(k, DIM, HDIMS, nlayers=NLAYERS)
    )(jax.random.key(0))
    return flow, nf.Banana(DIM, 1.0, 100.0)


def build_nsf():
    """NSF demo config (`demo_neural_spline_flow.jl:20-53`): defaults
    10 layers [32,32] K=10 B=30."""
    flow = jax.jit(
        lambda k: nf.nsf(k, DIM, identity_init=True)
    )(jax.random.key(0))
    return flow, nf.Banana(DIM, 1.0, 100.0)


def measure_steps_per_s(device, n=2000, builder=build, batch=BATCH):
    """(rate stats, final loss) of n-step chunks on ``device``."""
    with jax.default_device(device):
        flow, target = builder()
        # unroll=16 lets XLA fuse across the latency-bound demo steps
        run = roofline.train_run(flow, target, batch, n, LR, unroll=16)
        key = jax.random.key(1)
        st = roofline.rate_stats(time_call(run, key), n)
        return st, float(run(key)[-1])


def measure_samples_per_s(passes=8):
    flow, _ = build()

    @jax.jit
    def draw_many(key):
        # checksum forces materialization of every batch
        def body(c, k):
            s = flow.sample(k, (SAMPLE_BATCH,))
            return c + s[0, 0] + s[-1, -1], None

        return jax.lax.scan(body, jnp.zeros(()),
                            jax.random.split(key, passes))[0]

    return roofline.rate_stats(time_call(draw_many, jax.random.key(7)),
                               passes * SAMPLE_BATCH)


def main() -> int:
    accel = jax.devices()[0]
    if accel.platform != "gpu":
        print(f"bench: needs a GPU, JAX found {accel.platform}",
              file=sys.stderr)
        return 3
    init_compile_cache()
    head, final_loss = measure_steps_per_s(accel)
    nsf_st, _ = measure_steps_per_s(accel, n=1000, builder=build_nsf,
                                    batch=64)
    samples = measure_samples_per_s()
    r32 = roofline.measure_wide_train(n=10)
    r16 = roofline.measure_wide_train(n=10, compute_dtype=jnp.bfloat16)
    cpu_st, _ = measure_steps_per_s(jax.devices("cpu")[0], n=1000)
    print(json.dumps({
        "metric": "elbo_steps_per_s_realnvp_banana",
        "value": head["median"],
        "unit": "steps/s",
        "steps_per_s_iqr": head["iqr"],
        "vs_baseline": head["median"] / cpu_st["median"],
        "samples_per_s": samples["median"],
        "final_loss_2000_steps": final_loss,
        "batch_per_step": BATCH,
        "timing_reps": head["reps"],
        "nsf_steps_per_s": nsf_st["median"],
        "nsf_steps_per_s_iqr": nsf_st["iqr"],
        "wide_realnvp_f32_steps_per_s": r32["steps_per_s"],
        "wide_realnvp_bf16_steps_per_s": r16["steps_per_s"],
        "wide_realnvp_bf16_mfu_pct": r16["mfu_pct"],
        "device": {"platform": accel.platform, "kind": accel.device_kind,
                   "count": len(jax.devices())},
        "baseline_def": "same jitted program on the host CPU (reference "
                        "is CPU-only Julia with no published numbers; "
                        "see BASELINE.md)",
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
