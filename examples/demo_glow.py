"""Glow-style flow on the Cross target.

No reference demo counterpart — the reference ships the Cross target
(`example/targets/cross.jl:30-38`) but never demos it. The cross's four
axis-aligned mixture arms need cross-dimension mixing that RealNVP's fixed
even/odd partition struggles with in 2-D; Glow's learned PLU mixing
(Kingma & Dhariwal 2018) between coupling blocks supplies it, plus
data-dependent ActNorm initialization from a base-sample batch.
"""

import argparse

import jax
import optax

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import normalizingflows as nf  # noqa: E402


def main(max_iters: int, seed: int = 123):
    key = jax.random.key(seed)
    target = nf.Cross()

    kf, ki, kt = jax.random.split(key, 3)
    flow = jax.jit(lambda k: nf.glow(k, 2, (32, 32), nlayers=6))(kf)
    # Glow data-dependent init: normalize each ActNorm over a base batch
    flow = nf.glow_init_actnorms(flow, flow.base.sample(ki, (1024,)))

    before = float(nf.elbo_batch(kt, flow, target.log_prob, 1024))
    res = nf.train_flow(
        kt, nf.elbo_batch, flow, target.log_prob, 64,
        max_iters=max_iters, optimizer=optax.adam(2e-3),
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
