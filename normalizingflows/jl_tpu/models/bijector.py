"""Bijector protocol and combinators.

JAX replacement for the Bijectors.jl substrate the reference delegates
to (`src/NormalizingFlows.jl:10-11`): `with_logabsdet_jacobian`, `Inverse`,
`∘` composition, and `Stacked`. Differences by design:

  * Arrays are **row-major batches** ``(..., dim)`` (the reference uses
    column-major ``d×n`` matrices, `src/flows/realnvp.jl:77-83`). All
    bijectors natively handle arbitrary leading batch dimensions so a single
    compiled program serves vector and batched call sites.
  * Composition order is EXPLICIT: ``Chain([f, g, h])`` applies ``f`` first.
    (The reference's ``reduce(∘, Ls)`` applies the LAST element first — a
    documented gotcha at `src/flows/utils.jl:10-12`; we fix the order.)
  * ``forward_and_log_det`` / ``inverse_and_log_det`` return
    ``(y, log_det)`` with ``log_det`` shaped like the batch ``(...,)`` —
    the fused transform+logdet path that `elbo_batch` exploits
    (`src/objectives/elbo.jl:65-70`).
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp

from ..utils.pytree import Module, module, static_field

__all__ = [
    "Bijector",
    "Identity",
    "Inverse",
    "Chain",
    "Shift",
    "Scale",
    "Stacked",
    "Repeated",
    "invert",
    "chain",
    "stack_bijectors",
]


def _zero_log_det(x: jax.Array) -> jax.Array:
    """Batch-shaped zero log-det DERIVED from x (``x[...,0] * 0``) rather
    than a fresh ``jnp.zeros``: under ``shard_map`` the result then carries
    x's varying manual axes, which `lax.scan` requires to be consistent
    across the carry (a fresh zeros is 'unvarying' and trips the vma
    check)."""
    return x[..., 0] * 0


class Bijector(Module):
    """Invertible transform with tractable log|det J|.

    Subclasses implement ``forward_and_log_det`` and ``inverse_and_log_det``
    on ``(..., dim)`` arrays, returning ``(out, log_det)`` where ``log_det``
    has the batch shape ``(...,)``. This is the protocol equivalent of
    Bijectors.jl's ``transform`` / ``with_logabsdet_jacobian`` pair
    (consumed at reference `src/objectives/elbo.jl:5,67`).
    """

    def forward_and_log_det(self, x: jax.Array) -> tuple[jax.Array, jax.Array]:
        raise NotImplementedError

    def inverse_and_log_det(self, y: jax.Array) -> tuple[jax.Array, jax.Array]:
        raise NotImplementedError

    def forward(self, x: jax.Array) -> jax.Array:
        return self.forward_and_log_det(x)[0]

    def inverse(self, y: jax.Array) -> jax.Array:
        return self.inverse_and_log_det(y)[0]

    def __call__(self, x: jax.Array) -> jax.Array:
        return self.forward(x)


@module
class Identity(Bijector):
    """y = x, log|det J| = 0."""

    def forward_and_log_det(self, x):
        return x, _zero_log_det(x)

    def inverse_and_log_det(self, y):
        return y, _zero_log_det(y)


@module
class Inverse(Bijector):
    """The inverse of another bijector (Bijectors.jl `Inverse` equivalent,
    used by the density path at reference `src/flows/realnvp.jl:86-110`)."""

    bijector: Bijector

    def forward_and_log_det(self, x):
        return self.bijector.inverse_and_log_det(x)

    def inverse_and_log_det(self, y):
        return self.bijector.forward_and_log_det(y)


def invert(b: Bijector) -> Bijector:
    """Invert a bijector, collapsing double inversion."""
    if isinstance(b, Inverse):
        return b.bijector
    return Inverse(b)


@module
class Chain(Bijector):
    """Composition; ``bijectors[0]`` is applied FIRST in the forward pass.

    Replaces the reference's ``create_flow = transformed(q0, reduce(∘, Ls))``
    (`src/flows/utils.jl:23-26`) with an explicit left-to-right order.
    """

    bijectors: tuple[Bijector, ...]

    def __init__(self, bijectors: Sequence[Bijector]):
        object.__setattr__(self, "bijectors", tuple(bijectors))

    def forward_and_log_det(self, x):
        log_det = _zero_log_det(x)
        for b in self.bijectors:
            x, ld = b.forward_and_log_det(x)
            log_det = log_det + ld
        return x, log_det

    def inverse_and_log_det(self, y):
        log_det = _zero_log_det(y)
        for b in reversed(self.bijectors):
            y, ld = b.inverse_and_log_det(y)
            log_det = log_det + ld
        return y, log_det

    def forward(self, x):
        for b in self.bijectors:
            x = b.forward(x)
        return x

    def inverse(self, y):
        for b in reversed(self.bijectors):
            y = b.inverse(y)
        return y


def chain(*bijectors: Bijector) -> Chain:
    return Chain(bijectors)


@module
class Repeated(Bijector):
    """N structurally-identical blocks applied via ``lax.scan``.

    The deep-flow composition primitive. A `Chain` of N blocks gives XLA N
    separate call sites — compile time (and, for Pallas layers, kernel
    compiles) grows linearly with depth. `Repeated` stacks the N
    blocks' parameters along a leading axis and scans one block body, so a
    flow of ANY depth compiles exactly one forward (and one backward)
    program per block type. This is also the fix for the reference's own
    scaling complaint — `Optimisers.destructure` compile blow-up with many
    layers (`src/NormalizingFlows.jl:65-66`).

    ``stacked`` must be a bijector whose array leaves carry a leading layer
    axis of size ``n`` (see :func:`stack_bijectors`); static fields must be
    identical across layers. Forward applies layer 0 first.
    """

    stacked: Bijector
    n: int = static_field()
    # rematerialize each block under autodiff: recompute the block's
    # activations in the backward pass instead of saving them to device
    # memory: on wide flows the scan's per-layer residuals are a large
    # share of backward traffic while the recompute flops are cheap (a
    # flops-for-bandwidth trade). Off by default: at demo sizes residuals
    # are tiny and remat only adds latency.
    remat: bool = static_field(default=False)

    def _scan(self, x, fn_name, reverse):
        def body(carry, layer):
            x, ld = carry
            y, ldi = getattr(layer, fn_name)(x)
            return (y, ld + ldi), None

        if self.remat:
            body = jax.checkpoint(body)
        init = (x, _zero_log_det(x))
        (y, ld), _ = jax.lax.scan(
            body, init, self.stacked, length=self.n, reverse=reverse
        )
        return y, ld

    def forward_and_log_det(self, x):
        return self._scan(x, "forward_and_log_det", reverse=False)

    def inverse_and_log_det(self, y):
        return self._scan(y, "inverse_and_log_det", reverse=True)


def stack_bijectors(blocks: Sequence[Bijector],
                    remat: bool = False) -> Repeated:
    """Stack structurally-identical bijectors into a `Repeated`.
    ``remat=True`` recomputes block activations in the backward pass
    (see `Repeated.remat`)."""
    blocks = list(blocks)
    stacked = jax.tree_util.tree_map(
        lambda *leaves: jnp.stack(leaves), *blocks
    )
    return Repeated(stacked, len(blocks), remat)


@module
class Shift(Bijector):
    """y = x + b (Bijectors.jl `Shift`; used in mean-field VI,
    reference `test/interface.jl:24` and `example/demo_hamiltonian_flow.jl:96`)."""

    b: jax.Array

    def forward_and_log_det(self, x):
        y = x + self.b
        return y, _zero_log_det(x)

    def inverse_and_log_det(self, y):
        x = y - self.b
        return x, _zero_log_det(y)


@module
class Scale(Bijector):
    """y = a ⊙ x with log|det J| = Σ log|a| (Bijectors.jl `Scale`).

    No positivity constraint on ``a`` — like the reference, the log-det uses
    log|a| so sign flips remain valid bijections (`test/interface.jl:24`
    trains raw scales to σ=2)."""

    a: jax.Array

    def _ld(self, shape, dtype):
        ld = jnp.sum(jnp.log(jnp.abs(self.a)))
        return jnp.broadcast_to(ld, shape).astype(dtype)

    def forward_and_log_det(self, x):
        return x * self.a, self._ld(x.shape[:-1], x.dtype)

    def inverse_and_log_det(self, y):
        return y / self.a, -self._ld(y.shape[:-1], y.dtype)


@module
class Stacked(Bijector):
    """Apply different bijectors to disjoint index sets of the last axis.

    Equivalent of Bijectors.jl `Stacked((b1, b2), [r1, r2])`, used by the
    Hamiltonian flow's momentum-normalization layer
    (`example/demo_hamiltonian_flow.jl:93-99`). Each range may be a
    ``(start, stop)`` TUPLE (contiguous span — XLA sees fixed slices, no
    gather; the legacy form used by the momentum layer) or any other
    static index sequence — a ``range``, list, or tuple of length ≠ 2 —
    taken literally as the index set (the reference's general form, e.g.
    ``Stacked(bs, [1:3:d, 2:3:d, 3:3:d])``), lowered to a fixed
    gather/scatter. To pass a literal TWO-element index set, use a list
    (``[0, 2]``) — a bare 2-tuple always means (start, stop). All indices
    are static aux data; the sets must be pairwise disjoint and together
    tile [0, dim) so the layer stays a bijection."""

    bijectors: tuple[Bijector, ...]
    ranges: tuple[tuple[int, ...], ...] = static_field()

    def __init__(self, bijectors: Sequence[Bijector],
                 ranges: Sequence):
        object.__setattr__(self, "bijectors", tuple(bijectors))
        # Normalized storage form: tagged tuples ('idx', i0, i1, ...) so
        # pytree unflatten (which re-invokes __init__ with the stored aux
        # data) is a no-op re-normalization — a bare user tuple can never
        # start with the 'idx' tag, so the forms are unambiguous.
        norm = []
        for r in ranges:
            if isinstance(r, tuple) and len(r) > 0 and r[0] == "idx":
                norm.append(r)  # already normalized (pytree round-trip)
            elif isinstance(r, tuple) and len(r) == 2:
                # legacy contiguous (start, stop) span
                norm.append(("idx", *range(int(r[0]), int(r[1]))))
            else:
                norm.append(("idx", *(int(i) for i in r)))
        object.__setattr__(self, "ranges", tuple(norm))
        if len(self.bijectors) != len(self.ranges):
            raise ValueError("bijectors and ranges must have equal length")
        flat = [i for r in self.ranges for i in r[1:]]
        if len(set(flat)) != len(flat) or set(flat) != set(range(len(flat))):
            raise ValueError(
                "Stacked index sets must be disjoint and tile [0, dim); "
                f"got {self.index_sets}")

    @property
    def index_sets(self) -> tuple[tuple[int, ...], ...]:
        """The resolved per-bijector index sets."""
        return tuple(r[1:] for r in self.ranges)

    @staticmethod
    def _is_contiguous(idx: tuple[int, ...]) -> bool:
        return idx == tuple(range(idx[0], idx[-1] + 1))

    def _take(self, x, idx):
        if self._is_contiguous(idx):
            return x[..., idx[0]:idx[-1] + 1]
        return x[..., jnp.asarray(idx, dtype=jnp.int32)]

    def _apply(self, x, fn_name):
        parts = []
        log_det = _zero_log_det(x)
        for b, idx in zip(self.bijectors, self.index_sets):
            part, ld = getattr(b, fn_name)(self._take(x, idx))
            parts.append((idx, part))
            log_det = log_det + ld
        if all(self._is_contiguous(idx) for idx, _ in parts) and tuple(
            i for idx, _ in parts for i in idx
        ) == tuple(range(x.shape[-1])):
            # contiguous in-order tiling: plain concat, no scatter
            return jnp.concatenate([p for _, p in parts], axis=-1), log_det
        out = jnp.zeros_like(x)
        for idx, p in parts:
            out = out.at[..., jnp.asarray(idx, dtype=jnp.int32)].set(p)
        return out, log_det

    def forward_and_log_det(self, x):
        return self._apply(x, "forward_and_log_det")

    def inverse_and_log_det(self, y):
        return self._apply(y, "inverse_and_log_det")
