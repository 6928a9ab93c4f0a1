"""MAF trained by maximum likelihood from a data file — the forward-KL
pipeline the reference leaves as a TODO
(`src/objectives/loglikelihood.jl:35-43`), end to end:

  target samples → raw float32 file → C++ prefetching `NativeLoader`
  (`native/dataloader.cc`, numpy fallback off-toolchain) → `train_flow_mle`
  scan chunks → masked-autoregressive flow (`models/autoregressive.py`,
  parallel log_prob direction — one MADE matmul pass per layer).

The flow family is beyond the reference's zoo (MAF — Papamakarios et al.
2017); the score to beat is the target's own negative entropy
E_p[log p], the maximum achievable held-out log-likelihood.
"""

import argparse
import pathlib
import sys
import tempfile

import jax
import jax.numpy as jnp
import optax

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import normalizingflows as nf  # noqa: E402
from normalizingflows.jl_tpu.utils.data import make_loader, to_raw_file  # noqa: E402


def main(max_iters: int, seed: int = 123):
    dtype = jnp.float32
    key = jax.random.key(seed)
    kd, kf, kh = jax.random.split(key, 3)

    target = nf.Banana(2, 1.0, 10.0)
    n_train, batch = 65536, 256
    data = target.sample(kd, (n_train,))
    path = pathlib.Path(tempfile.gettempdir()) / "maf_mle_banana.raw"
    to_raw_file(str(path), data)
    loader = make_loader(str(path), batch, n_rows=n_train, dim=2, seed=seed)

    flow = jax.jit(
        lambda k: nf.maf(k, nf.DiagNormal.standard(2, dtype), (32, 32),
                         nlayers=5, dtype=dtype)
    )(kf)

    heldout = target.sample(kh, (8192,))
    ll = jax.jit(lambda f: jnp.mean(f.log_prob(heldout)))
    optimum = float(jnp.mean(target.log_prob(heldout)))  # E_p[log p]
    before = float(ll(flow))

    res = nf.train_flow_mle(
        flow, loader, max_iters=max_iters, optimizer=optax.adam(1e-3),
        check_every=max(max_iters // 20, 1), show_progress=True,
    )
    after = float(ll(res.flow))
    loader.close()
    print(f"held-out mean log-lik  before: {before:.4f}  "
          f"after {max_iters} iters: {after:.4f}  "
          f"(target E_p[log p] = {optimum:.4f}, epochs = "
          f"{max_iters * batch / n_train:.1f})")
    return res


if __name__ == "__main__":
    from normalizingflows.jl_tpu.device import init_compile_cache

    init_compile_cache()
    p = argparse.ArgumentParser()
    p.add_argument("--iters", type=int, default=500)
    a = p.parse_args()
    main(a.iters)
