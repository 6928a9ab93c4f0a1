"""Neural spline flow on the HARD banana target.

Parity workload for reference `example/demo_neural_spline_flow.jl:20-53`:
Banana(2, b=1, var=100), float32, NSF defaults (10 layers, [32,32], K=10,
B=30), 64 samples/iter, Adam(1e-4).

`--affine-wrap` trains the envelope variant instead (identity init +
warmup-cosine 5e-4): a trainable per-dim affine around the spline stack
that lifts the bare architecture's log(Z_box/2) = −2.600 ELBO ceiling —
measured −0.22 at 50k iters vs RealNVP's −0.565 on the same target
(`benchmarks/NSF_DIAGNOSE.md`).
"""

import argparse

import jax
import jax.numpy as jnp
import optax

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import normalizingflows as nf  # noqa: E402


def main(max_iters: int, seed: int = 123, affine_wrap: bool = False):
    dtype = jnp.float32
    key = jax.random.key(seed)

    target = nf.Banana(2, 1.0, 100.0)
    kf, kt = jax.random.split(key)
    flow = nf.nsf(kf, nf.DiagNormal.standard(2, dtype),
                  identity_init=affine_wrap, affine_wrap=affine_wrap)
    if affine_wrap:
        opt = optax.adam(optax.warmup_cosine_decay_schedule(
            0.0, 5e-4, warmup_steps=min(500, max_iters // 4 + 1),
            decay_steps=max_iters, end_value=1e-5))
    else:
        opt = optax.adam(1e-4)  # reference demo optimizer

    before = float(nf.elbo_batch(kt, flow, target.log_prob, 4096))
    res = nf.train_flow(
        kt, nf.elbo_batch, flow, target.log_prob, 64,
        max_iters=max_iters, optimizer=opt,
        show_progress=True, check_every=max(max_iters // 20, 1),
    )
    after = float(nf.elbo_batch(jax.random.key(7), res.flow,
                                target.log_prob, 4096))
    print(f"ELBO before: {before:.4f}  after {max_iters} iters: {after:.4f}")
    return res


if __name__ == "__main__":
    from normalizingflows.jl_tpu.device import init_compile_cache

    init_compile_cache()
    p = argparse.ArgumentParser()
    p.add_argument("--iters", type=int, default=200)
    p.add_argument("--affine-wrap", action="store_true")
    a = p.parse_args()
    main(a.iters, affine_wrap=a.affine_wrap)
