"""Planar flow on the (easy) banana target.

Parity workload for reference `example/demo_planar_flow.jl:16-48`:
Banana(2, b=1, var=10), float64, 10 planar layers, 32 samples/iter,
Adam(1e-2), batched ELBO, up to 10k iters (CI-style short run by default;
pass --iters 10000 for the full run).
"""

import argparse

import jax
import jax.numpy as jnp
import optax

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import normalizingflows as nf  # noqa: E402


def main(max_iters: int, seed: int = 123):
    jax.config.update("jax_enable_x64", True)
    dtype = jnp.float64
    key = jax.random.key(seed)

    target = nf.Banana(2, jnp.asarray(1.0, dtype), jnp.asarray(10.0, dtype))
    kf, kt = jax.random.split(key)
    flow = jax.jit(
        lambda k: nf.planarflow(k, nf.DiagNormal.standard(2, dtype),
                                nlayers=10, dtype=dtype)
    )(kf)

    before = float(nf.elbo_batch(kt, flow, target.log_prob, 1024))
    res = nf.train_flow(
        kt, nf.elbo_batch, flow, target.log_prob, 32,
        max_iters=max_iters, optimizer=optax.adam(1e-2),
        show_progress=True, check_every=max(max_iters // 20, 1),
    )
    after = float(nf.elbo_batch(jax.random.key(7), res.flow,
                                target.log_prob, 1024))
    print(f"ELBO before: {before:.4f}  after {max_iters} iters: {after:.4f}")
    return res


if __name__ == "__main__":
    from normalizingflows.jl_tpu.device import init_compile_cache

    init_compile_cache()
    p = argparse.ArgumentParser()
    p.add_argument("--iters", type=int, default=200)
    main(p.parse_args().iters)
