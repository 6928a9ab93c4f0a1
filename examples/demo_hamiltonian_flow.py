"""Hamiltonian (leapfrog) flow on Neal's funnel.

Parity workload for reference `example/demo_hamiltonian_flow.jl:105-171`:
Funnel(2, μ=−8, σ=5), float64 (the dynamics are chaotic — reference `:107`),
15 blocks × 3 leapfrog steps, ϵ₀=0.05, per-sample ELBO on the joint (x, ρ)
space, 16 samples/iter, Adam(3e-4), grad-norm convergence at 1e-3.
"""

import argparse

import jax
import jax.numpy as jnp
import optax

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import normalizingflows as nf  # noqa: E402
from normalizingflows.jl_tpu.models.hamiltonian import joint_logp


def main(max_iters: int, seed: int = 123):
    jax.config.update("jax_enable_x64", True)
    dtype = jnp.float64
    key = jax.random.key(seed)
    dim = 2

    target = nf.Funnel(dim, jnp.asarray(-8.0, dtype), jnp.asarray(5.0, dtype))
    flow = jax.jit(
        lambda _: nf.hamiltonian_flow(dim, target.score, n_blocks=15, L=3,
                                      eps0=0.05, dtype=dtype)
    )(0)  # jit-construct: one device program, not per-leaf transfers
    lp = joint_logp(target.log_prob, dim)

    before = float(nf.elbo_batch(key, flow, lp, 512))
    res = nf.train_flow(
        key, nf.elbo, flow, lp, 16,
        max_iters=max_iters, optimizer=optax.adam(3e-4),
        hasconverged=lambda i, s, f, st: s["gradient_norm"] < 1e-3,
        show_progress=True, check_every=max(max_iters // 20, 1),
    )
    after = float(nf.elbo_batch(jax.random.key(7), res.flow, lp, 512))
    print(f"joint ELBO before: {before:.4f}  after: {after:.4f}")
    return res


if __name__ == "__main__":
    from normalizingflows.jl_tpu.device import init_compile_cache

    init_compile_cache()
    p = argparse.ArgumentParser()
    p.add_argument("--iters", type=int, default=100)
    main(p.parse_args().iters)
