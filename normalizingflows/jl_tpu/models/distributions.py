"""Base distributions and the transformed-distribution wrapper.

JAX replacement for the Distributions.jl + Bijectors.jl pair the
reference builds on: a flow there is a `Bijectors.TransformedDistribution`
(base dist + bijector, recommended at reference `src/NormalizingFlows.jl:28`),
with `rand` = sample-base-then-forward and `logpdf` = inverse + logdet + base
logpdf. Here the same semantics live in :class:`TransformedDistribution`,
plus a fused ``sample_and_log_prob`` used by the ELBO fast path.

PRNG: explicit `jax.random` key threading replaces the reference's
`_device_specific_rand(rng, ...)` dispatch point
(`src/NormalizingFlows.jl:94-127` + `ext/NormalizingFlowsCUDAExt.jl`) — in
JAX the same code compiles for CPU and GPU, so no device dispatch layer is
needed; sharded sampling derives per-shard keys via `fold_in`
(see `parallel/`).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from ..utils.pytree import Module, module, static_field
from .bijector import Bijector

__all__ = [
    "Distribution",
    "DiagNormal",
    "StandardNormal",
    "TransformedDistribution",
    "transformed",
]

_LOG_2PI = math.log(2.0 * math.pi)


class Distribution(Module):
    """Minimal distribution protocol: `sample`, `log_prob`, `dim`."""

    def sample(self, key: jax.Array, sample_shape: tuple = ()) -> jax.Array:
        raise NotImplementedError

    def log_prob(self, x: jax.Array) -> jax.Array:
        raise NotImplementedError

    @property
    def event_dim(self) -> int:
        raise NotImplementedError


@module
class DiagNormal(Distribution):
    """Multivariate normal with diagonal covariance (MvNormal equivalent).

    ``scale`` is the standard deviation per dimension. Used as the flow base
    distribution q0 everywhere in the reference (e.g.
    `example/demo_RealNVP.jl:27`); by default the training loop freezes it,
    matching the reference's ``@leaf MvNormal`` convention
    (`test/interface.jl:21`)."""

    loc: jax.Array
    scale: jax.Array

    @staticmethod
    def standard(dim: int, dtype=jnp.float32) -> "DiagNormal":
        return DiagNormal(jnp.zeros((dim,), dtype), jnp.ones((dim,), dtype))

    @property
    def event_dim(self) -> int:
        return self.loc.shape[-1]

    def sample(self, key, sample_shape=()):
        shape = tuple(sample_shape) + self.loc.shape
        eps = jax.random.normal(key, shape, dtype=self.loc.dtype)
        return self.loc + self.scale * eps

    def log_prob(self, x):
        z = (x - self.loc) / self.scale
        return -0.5 * jnp.sum(jnp.square(z), axis=-1) - jnp.sum(
            jnp.log(self.scale)
        ) - 0.5 * self.event_dim * jnp.asarray(_LOG_2PI, dtype=x.dtype)


@module
class StandardNormal(Distribution):
    """N(0, I) with static dim — zero parameters (cannot be trained away)."""

    dim: int = static_field()
    dtype: object = static_field(default=jnp.float32)

    @property
    def event_dim(self) -> int:
        return self.dim

    def sample(self, key, sample_shape=()):
        return jax.random.normal(
            key, tuple(sample_shape) + (self.dim,), dtype=self.dtype
        )

    def log_prob(self, x):
        return -0.5 * jnp.sum(jnp.square(x), axis=-1) - 0.5 * self.dim * (
            jnp.asarray(_LOG_2PI, dtype=x.dtype)
        )


@module
class TransformedDistribution(Distribution):
    """Pushforward of ``base`` through ``bijector`` — "the flow".

    Semantics match Bijectors.jl's `TransformedDistribution` (consumed by the
    reference at `src/objectives/elbo.jl:94` and
    `src/objectives/loglikelihood.jl:23`):

      * ``sample``:   x ~ base;  y = T(x)                 (call stack §3.3)
      * ``log_prob``: x, ld = T⁻¹(y);  base.log_prob(x) + ld   (§3.4)
      * ``sample_and_log_prob``: fused forward path returning
        ``(y, log q(y))`` via log q(y) = base.log_prob(x) − logdet_fwd —
        one transform traversal instead of forward-then-inverse; this is
        the ELBO fast path (`src/objectives/elbo.jl:65-70` does the same
        with `with_logabsdet_jacobian`).
    """

    base: Distribution
    bijector: Bijector

    @property
    def event_dim(self) -> int:
        return self.base.event_dim

    def sample(self, key, sample_shape=()):
        x = self.base.sample(key, sample_shape)
        return self.bijector.forward(x)

    def sample_and_log_prob(self, key, sample_shape=()):
        x = self.base.sample(key, sample_shape)
        y, log_det = self.bijector.forward_and_log_det(x)
        return y, self.base.log_prob(x) - log_det

    def sample_with_base(self, key, sample_shape=()):
        """Return (x, y, logdet_fwd) — the raw ingredients of the ELBO
        estimator (reference `src/objectives/elbo.jl:4-7`)."""
        x = self.base.sample(key, sample_shape)
        y, log_det = self.bijector.forward_and_log_det(x)
        return x, y, log_det

    def log_prob(self, y):
        x, log_det = self.bijector.inverse_and_log_det(y)
        return self.base.log_prob(x) + log_det


def transformed(base: Distribution, bijector: Bijector) -> TransformedDistribution:
    """Bijectors.jl `transformed(q0, T)` equivalent."""
    return TransformedDistribution(base, bijector)
