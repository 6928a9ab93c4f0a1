"""RealNVP on the HARD banana target.

Parity workload for reference `example/demo_RealNVP.jl:20-61`:
Banana(2, b=1, var=100), float32, 3 RealNVP layers with [16,16]
conditioners, 16 samples/iter, Adam(5e-4), batched ELBO (the reference
notes ≈50k iters for full convergence).
"""

import argparse

import jax
import jax.numpy as jnp
import optax

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import normalizingflows as nf  # noqa: E402


def main(max_iters: int, seed: int = 123, use_stl: bool = False):
    dtype = jnp.float32
    key = jax.random.key(seed)

    target = nf.Banana(2, 1.0, 100.0)
    kf, kt = jax.random.split(key)
    flow = nf.realnvp(kf, nf.DiagNormal.standard(2, dtype), (16, 16),
                      nlayers=3, dtype=dtype)

    objective = nf.elbo_stl if use_stl else nf.elbo_batch
    before = float(nf.elbo_batch(kt, flow, target.log_prob, 4096))
    res = nf.train_flow(
        kt, objective, flow, target.log_prob, 16,
        max_iters=max_iters, optimizer=optax.adam(5e-4),
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
    p.add_argument("--iters", type=int, default=500)
    p.add_argument("--stl", action="store_true")
    a = p.parse_args()
    main(a.iters, use_stl=a.stl)
