"""Batch-sharded objectives and sampling (shard_map + collectives).

Design (SURVEY §2c): parameters replicated, MC sample batch sharded over a
1-D 'batch' mesh. Each shard derives its own PRNG stream with
``jax.random.fold_in(key, shard_index)`` — the reference threads one
`AbstractRNG` through everything (`src/NormalizingFlows.jl:55`); here N-shard
runs are statistically (not bitwise) equivalent to 1-shard runs with N×
the samples. The per-shard partial means are combined with `lax.pmean`
(an all-reduce, over NVLink between GPUs); gradients of the shard_mapped
objective automatically produce the matching psum.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable

import jax
from jax.sharding import Mesh, PartitionSpec as P


from ..models.distributions import TransformedDistribution
from .mesh import BATCH_AXIS

__all__ = ["shard_objective", "sample_sharded", "per_shard_key"]


def per_shard_key(key: jax.Array, axis_name: str = BATCH_AXIS) -> jax.Array:
    """Fold the shard index into the key — independent per-shard streams."""
    return jax.random.fold_in(key, jax.lax.axis_index(axis_name))


def shard_objective(
    objective: Callable[..., jax.Array],
    mesh: Mesh,
    axis_name: str = BATCH_AXIS,
) -> Callable[..., jax.Array]:
    """Lift ``vo(key, flow, *args, n)`` into a batch-sharded estimator.

    The returned callable has the same signature; the trailing argument must
    be the MC sample count, which is split evenly across the mesh. Each
    device evaluates the objective on its own fold_in-derived key and
    n/ndev samples; `pmean` combines. `jax.grad` through it inserts the
    gradient psum. The result is a drop-in objective for `train_flow`.
    """
    ndev = mesh.shape[axis_name]

    def sharded(key, flow, *args):
        *rest, n = args
        if n % ndev != 0:
            raise ValueError(
                f"n_samples={n} must divide evenly over {ndev} devices"
            )
        local_n = n // ndev

        @partial(
            jax.shard_map,
            mesh=mesh,
            in_specs=(P(), P()),
            out_specs=P(),
            # the custom-VJP rules on the path (the mixed-precision Dense,
            # the RQS kernel) return per-shard cotangents for replicated
            # weights, which the varying-axes check rejects; the only
            # collectives are the explicit pmean and the gradient psum that
            # autodiff of shard_map inserts for replicated inputs
            check_vma=False,
        )
        def run(key, flow):
            k = per_shard_key(key, axis_name)
            local = objective(k, flow, *rest, local_n)
            return jax.lax.pmean(local, axis_name)

        return run(key, flow)

    return sharded


def sample_sharded(
    flow: TransformedDistribution,
    key: jax.Array,
    n: int,
    mesh: Mesh,
    axis_name: str = BATCH_AXIS,
) -> jax.Array:
    """Draw n flow samples with the batch axis sharded over the mesh.

    Replaces the reference CUDA extension's column-by-column hcat sampling
    loop (`ext/NormalizingFlowsCUDAExt.jl:65-74`) with one batched,
    device-parallel forward pass; this is the samples/s benchmark path.
    """
    ndev = mesh.shape[axis_name]
    if n % ndev != 0:
        raise ValueError(f"n={n} must divide evenly over {ndev} devices")
    local_n = n // ndev

    @partial(jax.shard_map, mesh=mesh, in_specs=(P(), P()),
             out_specs=P(axis_name, None), check_vma=False)  # as above
    def run(key, flow):
        k = per_shard_key(key, axis_name)
        return flow.sample(k, (local_n,))

    return run(key, flow)
