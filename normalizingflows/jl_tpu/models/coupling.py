"""RealNVP affine-coupling flow.

Re-design of reference `src/flows/realnvp.jl`:
  * `AffineCoupling` (`realnvp.jl:33-110`): y_A = x_A ⊙ exp(s(x_B)) + t(x_B),
    log|det J| = Σ s(x_B); analytic inverse x_A = (y_A − t(y_B)) ⊙ exp(−s(y_B)).
    The log-scale net `s` ends in tanh BEFORE exponentiation for stability
    (`realnvp.jl:49-52`).
  * `RealNVP_layer` (`realnvp.jl:132-145`): two couplings with complementary
    even/odd alternating masks.
  * `realnvp` (`realnvp.jl:170-192`): stack of layers; defaults hdims=[32,32],
    nlayers=10 per Agrawal–Sheldon–Domke 2020 App. E.

All methods are natively batched over ``(..., dim)``; a single compiled
program serves the vector and matrix call sites that the reference implements
twice (`realnvp.jl:57-83`).
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp

from ..ops.masks import PartitionMask, interleave
from ..utils.pytree import module, static_field
from .bijector import Bijector, Chain
from .distributions import DiagNormal, Distribution, TransformedDistribution
from .flows import create_flow
from .nets import MLP, fnn

__all__ = ["AffineCoupling", "CouplingPairStack", "RealNVP_layer", "realnvp"]


@module
class AffineCoupling(Bijector):
    """Affine coupling layer (Dinh et al. 2017, RealNVP)."""

    __trainable__ = ("s", "t")  # mirrors `@functor AffineCoupling (s, t)`,
    # reference `src/flows/realnvp.jl:40`

    s: MLP  # log-scale conditioner (tanh-bounded output)
    t: MLP  # shift conditioner
    mask: PartitionMask = static_field()

    @staticmethod
    def make(
        key: jax.Array,
        dim: int,
        hdims: Sequence[int],
        mask_idx: Sequence[int],
        dtype=jnp.float32,
        compute_dtype=None,
    ) -> "AffineCoupling":
        """Constructor per reference `realnvp.jl:45-54`: conditioners map the
        complement (size dim−|A|) to the transformed set (size |A|); `s` gets
        a tanh output activation. ``compute_dtype`` sets the conditioner
        matmul precision policy (see `nets.Dense`)."""
        mask = PartitionMask.make(dim, mask_idx)
        c = mask.n_transformed
        ks, kt = jax.random.split(key)
        s = fnn(ks, dim - c, hdims, c, output_activation=jnp.tanh,
                dtype=dtype, compute_dtype=compute_dtype)
        t = fnn(kt, dim - c, hdims, c, dtype=dtype,
                compute_dtype=compute_dtype)
        return AffineCoupling(s, t, mask)

    def forward_and_log_det(self, x):
        x_a, x_b, x_c = self.mask.partition(x)
        log_s = self.s(x_b)
        y_a = x_a * jnp.exp(log_s) + self.t(x_b)
        log_det = jnp.sum(log_s, axis=-1)
        return self.mask.combine(y_a, x_b, x_c), log_det

    def inverse_and_log_det(self, y):
        y_a, y_b, y_c = self.mask.partition(y)
        log_s = self.s(y_b)
        x_a = (y_a - self.t(y_b)) * jnp.exp(-log_s)
        log_det = -jnp.sum(log_s, axis=-1)
        return self.mask.combine(x_a, y_b, y_c), log_det


def RealNVP_layer(
    key: jax.Array, dim: int, hdims: Sequence[int], dtype=jnp.float32,
    compute_dtype=None,
) -> list[AffineCoupling]:
    """One RealNVP block: two couplings with complementary alternating masks
    (reference `realnvp.jl:132-145`, masks `1:2:d` and `2:2:d`)."""
    k1, k2 = jax.random.split(key)
    c1 = AffineCoupling.make(k1, dim, hdims, range(0, dim, 2), dtype,
                             compute_dtype)
    c2 = AffineCoupling.make(k2, dim, hdims, range(1, dim, 2), dtype,
                             compute_dtype)
    return [c1, c2]


@module
class CouplingPairStack(Bijector):
    """N RealNVP blocks (complementary even/odd `AffineCoupling` pairs)
    executed as ONE split-carry ``lax.scan``.

    The generic `Repeated(Chain([c_even, c_odd]))` path re-partitions and
    re-combines the state inside every block, but block k+1's partition
    exactly undoes block k's combine — the lane shuffles telescope away.
    Here the state is split into ``(x_even, x_odd)`` once before the scan,
    carried split, and riffled back once after, so the per-block body is
    pure conditioner matmuls + fused elementwise (VERDICT r3 item 2: the
    wide train step spent >half its time outside matmuls; partition/combine
    traffic was part of that gap).

    Mathematically identical to the generic path (same MLPs, same order,
    same f32 accumulation) — pinned by ``tests/test_flows.py``.
    """

    stacked: dict  # {'s_even','t_even','s_odd','t_odd'}: MLPs, leading n axis
    n: int = static_field()
    dim: int = static_field()
    remat: bool = static_field(default=False)

    @staticmethod
    def from_pairs(pairs, remat: bool = False) -> "CouplingPairStack":
        """Build from `RealNVP_layer` output: a list of `[c_even, c_odd]`
        pairs whose masks must be the standard alternating `0::2` / `1::2`
        sets (reference `realnvp.jl:139-140`)."""
        dim = pairs[0][0].mask.dim
        even = tuple(range(0, dim, 2))
        odd = tuple(range(1, dim, 2))
        for c_e, c_o in pairs:
            if c_e.mask.idx_a != even or c_o.mask.idx_a != odd:
                raise ValueError(
                    "CouplingPairStack requires alternating even/odd masks; "
                    "use the generic Repeated path for custom masks")

        def stack(pick):
            return jax.tree_util.tree_map(
                lambda *leaves: jnp.stack(leaves), *[pick(p) for p in pairs]
            )

        stacked = {
            "s_even": stack(lambda p: p[0].s),
            "t_even": stack(lambda p: p[0].t),
            "s_odd": stack(lambda p: p[1].s),
            "t_odd": stack(lambda p: p[1].t),
        }
        return CouplingPairStack(stacked, len(pairs), dim, remat)

    def forward_and_log_det(self, x):
        xa, xb = x[..., 0::2], x[..., 1::2]

        def body(carry, mlps):
            xa, xb, ld = carry
            s = mlps["s_even"](xb)
            xa = xa * jnp.exp(s) + mlps["t_even"](xb)
            s2 = mlps["s_odd"](xa)
            xb = xb * jnp.exp(s2) + mlps["t_odd"](xa)
            ld = ld + jnp.sum(s, axis=-1) + jnp.sum(s2, axis=-1)
            return (xa, xb, ld), None

        if self.remat:
            body = jax.checkpoint(body)
        (xa, xb, ld), _ = jax.lax.scan(
            body, (xa, xb, x[..., 0] * 0), self.stacked, length=self.n
        )
        return interleave(xa, xb, self.dim), ld

    def inverse_and_log_det(self, y):
        ya, yb = y[..., 0::2], y[..., 1::2]

        def body(carry, mlps):
            ya, yb, ld = carry
            s2 = mlps["s_odd"](ya)
            yb = (yb - mlps["t_odd"](ya)) * jnp.exp(-s2)
            s = mlps["s_even"](yb)
            ya = (ya - mlps["t_even"](yb)) * jnp.exp(-s)
            ld = ld - jnp.sum(s, axis=-1) - jnp.sum(s2, axis=-1)
            return (ya, yb, ld), None

        if self.remat:
            body = jax.checkpoint(body)
        (ya, yb, ld), _ = jax.lax.scan(
            body, (ya, yb, y[..., 0] * 0), self.stacked, length=self.n,
            reverse=True,
        )
        return interleave(ya, yb, self.dim), ld


def realnvp(
    key: jax.Array,
    q0: Distribution | int,
    hdims: Sequence[int] = (32, 32),
    nlayers: int = 10,
    dtype=jnp.float32,
    scan: bool = True,
    compute_dtype=None,
    remat: bool = False,
) -> TransformedDistribution:
    """RealNVP flow (reference `realnvp.jl:170-192`); ``q0`` may be a base
    distribution or an int dim (→ standard DiagNormal base). Defaults
    hdims=[32,32], nlayers=10.

    ``scan=True`` (default) stacks the blocks into a `Repeated` scan so
    compile time is depth-independent; ``scan=False`` lays them out as a
    flat `Chain` (same math, per-layer call sites)."""
    if isinstance(q0, int):
        q0 = DiagNormal.standard(q0, dtype)
    dim = q0.event_dim
    pairs = [
        RealNVP_layer(k, dim, hdims, dtype, compute_dtype)
        for k in jax.random.split(key, nlayers)
    ]
    if scan:
        # split-carry scan: per-block partition/combine elided entirely;
        # remat=True recomputes block activations in the backward pass
        # (wide-flow HBM-residual trade; see bijector.Repeated.remat)
        return create_flow([CouplingPairStack.from_pairs(pairs, remat=remat)],
                           q0)
    return create_flow([Chain(p) for p in pairs], q0)
