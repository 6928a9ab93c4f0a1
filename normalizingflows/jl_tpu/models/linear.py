"""Invertible linear-algebra bijectors: ActNorm and PLU-parameterized
dense mixing (the Glow components generalized to flat vectors).

No reference counterpart (its zoo is planar/radial/RealNVP/NSF,
`src/flows/`); cited against Kingma & Dhariwal, "Glow: Generative Flow
with Invertible 1x1 Convolutions" (NeurIPS 2018). Rationale: coupling
flows only mix dimensions through the fixed even/odd partition; a learned
invertible linear layer between coupling blocks lets every dimension
condition on every other at a cost of one (dim × dim) matmul.

Design notes:

  * `InvertibleLinear` stores W = P·L·(U + diag(s)) with the permutation P
    and sign(s) frozen at init (Glow's PLU trick): the log-determinant is
    `Σ log|s|` — O(d) instead of O(d³) — and the inverse is two
    triangular solves. P and sign(s) are carried as non-trainable ARRAY
    leaves (`__trainable__` masks them out of the update), so glow blocks
    are structurally identical and stack into a depth-independent
    `Repeated` lax.scan; applying P is one more (d×d) matmul.
  * `ActNorm` is an elementwise affine with a data-dependent
    initializer (`ActNorm.initialize(x)`: first-batch output is
    zero-mean/unit-variance per dim) — the Glow replacement for batch
    norm that keeps the program free of running statistics.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

import jax
import jax.numpy as jnp

from ..utils.pytree import module
from .bijector import Bijector, Chain, Repeated, stack_bijectors

__all__ = ["ActNorm", "GlowBlock", "InvertibleLinear", "glow",
           "glow_init_actnorms"]


@module
class ActNorm(Bijector):
    """Per-dimension affine `y = x·exp(log_scale) + shift` with
    data-dependent init; log|det J| = Σ log_scale."""

    log_scale: jax.Array  # (dim,)
    shift: jax.Array      # (dim,)

    @staticmethod
    def identity(dim: int, dtype=jnp.float32) -> "ActNorm":
        return ActNorm(jnp.zeros((dim,), dtype), jnp.zeros((dim,), dtype))

    @staticmethod
    def initialize(x: jax.Array, eps: float = 1e-6,
                   dtype=None) -> "ActNorm":
        """Glow data-dependent init from a (batch, dim) sample batch: the
        initialized layer maps that batch to zero mean / unit variance.
        ``dtype`` pins the parameter dtype (defaults to ``x.dtype``; pass
        the replaced layer's param dtype so an init batch in a different
        dtype cannot silently swap the flow's param dtype)."""
        mu = jnp.mean(x, axis=0)
        sigma = jnp.std(x, axis=0) + jnp.asarray(eps, x.dtype)
        log_scale = -jnp.log(sigma)
        shift = -mu * jnp.exp(log_scale)
        if dtype is not None:
            log_scale = log_scale.astype(dtype)
            shift = shift.astype(dtype)
        return ActNorm(log_scale, shift)

    def forward_and_log_det(self, x):
        y = x * jnp.exp(self.log_scale) + self.shift
        ld = jnp.sum(self.log_scale)
        return y, jnp.broadcast_to(ld, x.shape[:-1]).astype(x.dtype)

    def inverse_and_log_det(self, y):
        x = (y - self.shift) * jnp.exp(-self.log_scale)
        ld = -jnp.sum(self.log_scale)
        return x, jnp.broadcast_to(ld, y.shape[:-1]).astype(y.dtype)


@module
class InvertibleLinear(Bijector):
    """Dense invertible mixing `y = x @ Wᵀ`, W = P·L·(U + diag(s)).

    P and sign(s) are frozen at init (non-trainable leaves via
    ``__trainable__``), so W stays invertible throughout training and
    log|det J| = Σ log|s| in O(d).
    """

    __trainable__ = ("lower", "upper", "log_s")

    lower: jax.Array   # (d, d), strictly-lower part used
    upper: jax.Array   # (d, d), strictly-upper part used
    log_s: jax.Array   # (d,)
    pmat: jax.Array    # (d, d) permutation matrix P, frozen
    sign_s: jax.Array  # (d,) frozen signs of s

    @staticmethod
    def make(key: "jax.Array | int", dim: int, dtype=jnp.float32
             ) -> "InvertibleLinear":
        """Initialize W as a random rotation (logdet 0), PLU-decomposed
        host-side. The rotation draw happens on the HOST (numpy LU), so
        ``key`` must be concrete — or pass a plain int seed, which works
        under jit tracing too (the PLU factors become traced-in
        constants)."""
        if isinstance(key, (int, np.integer)):
            a = np.random.default_rng(int(key)).normal(size=(dim, dim))
        else:
            a = np.asarray(jax.random.normal(key, (dim, dim), jnp.float32))
        q, _ = np.linalg.qr(np.asarray(a, np.float64))
        import scipy.linalg

        p, l, u = scipy.linalg.lu(q)
        s = np.diag(u)
        return InvertibleLinear(
            jnp.asarray(np.tril(l, -1), dtype),
            jnp.asarray(np.triu(u, 1), dtype),
            jnp.asarray(np.log(np.abs(s)), dtype),
            jnp.asarray(p, dtype),
            jnp.asarray(np.sign(s), dtype),
        )

    def _plu(self):
        d = self.log_s.shape[0]
        eye = jnp.eye(d, dtype=self.log_s.dtype)
        L = jnp.tril(self.lower, -1) + eye
        s = self.sign_s * jnp.exp(self.log_s)
        U = jnp.triu(self.upper, 1) + jnp.diag(s)
        return L, U

    def forward_and_log_det(self, x):
        L, U = self._plu()
        # y = x Wᵀ = x Uᵀ Lᵀ Pᵀ; P is a (d×d) matmul — cheap and
        # scan-stackable (a static gather would pin P per call site).
        # ALL three matmuls run at HIGHEST precision: at default precision
        # an f32 product may run in TF32 on the GPU (about three decimal
        # digits), which (a) perturbs the one-hot P pick and (b) breaks the
        # f32 round-trip against the inverse's triangular solves (the
        # round trip on the card is checked by chip_smoke.py). d×d at glow
        # sizes: cost is negligible.
        hi = jax.lax.Precision.HIGHEST
        y = jnp.matmul(x, U.T, precision=hi)
        y = jnp.matmul(y, L.T, precision=hi)
        y = jnp.matmul(y, self.pmat.T, precision=hi)
        ld = jnp.sum(self.log_s)
        return y, jnp.broadcast_to(ld, x.shape[:-1]).astype(x.dtype)

    def inverse_and_log_det(self, y):
        from jax.scipy.linalg import solve_triangular

        L, U = self._plu()
        # row-convention Pᵀ y; HIGHEST so the one-hot pick is exact (see fwd)
        z = jnp.matmul(y, self.pmat,
                       precision=jax.lax.Precision.HIGHEST)
        # solve for the whole batch in one (d, n) triangular solve, under
        # a HIGHEST-precision scope (the blocked solve's internal matmuls
        # otherwise get default-precision rounding — see forward)
        d = z.shape[-1]
        batch_shape = z.shape[:-1]
        cols = jnp.moveaxis(z.reshape((-1, d)), -1, 0)  # (d, n)
        with jax.default_matmul_precision("highest"):
            cols = solve_triangular(L, cols, lower=True)
            cols = solve_triangular(U, cols, lower=False)
        x = jnp.moveaxis(cols, 0, -1).reshape(batch_shape + (d,))
        ld = -jnp.sum(self.log_s)
        return x, jnp.broadcast_to(ld, y.shape[:-1]).astype(y.dtype)


@module
class GlowBlock(Bijector):
    """One glow block: ActNorm → InvertibleLinear → coupling pair.
    Structurally identical across depth, so a deep glow composes as
    `Repeated(stacked GlowBlocks)` — one compiled block body regardless
    of nlayers (VERDICT r3 item 9)."""

    actnorm: ActNorm
    mix: InvertibleLinear
    c_even: Bijector
    c_odd: Bijector

    def _parts(self):
        return (self.actnorm, self.mix, self.c_even, self.c_odd)

    def forward_and_log_det(self, x):
        ld = x[..., 0] * 0
        for b in self._parts():
            x, ldi = b.forward_and_log_det(x)
            ld = ld + ldi
        return x, ld

    def inverse_and_log_det(self, y):
        ld = y[..., 0] * 0
        for b in reversed(self._parts()):
            y, ldi = b.inverse_and_log_det(y)
            ld = ld + ldi
        return y, ld


def glow(
    key: jax.Array,
    q0,
    hdims: Sequence[int] = (32, 32),
    nlayers: int = 3,
    dtype=jnp.float32,
    compute_dtype=None,
    scan: bool = True,
    remat: bool = False,
    mix_seed: int = 0,
):
    """Glow-style flow for flat vectors: ``nlayers`` blocks of
    ActNorm → InvertibleLinear (PLU mixing) → RealNVP coupling pair.

    No reference counterpart (Kingma & Dhariwal 2018 applied to the
    reference's flat-vector setting). The learned dense mixing replaces
    Glow's invertible 1×1 conv — one (d×d) matmul per block keeps the
    layer a plain matmul while letting every dimension condition on every
    other, instead of only across the fixed even/odd partition.

    ``scan=True`` (default) stacks the blocks into a depth-independent
    `Repeated` lax.scan. ActNorms start as the identity; call
    :func:`glow_init_actnorms` with a base-sample batch for Glow's
    data-dependent initialization. ``q0`` may be a base distribution or an
    int dim. ``mix_seed`` varies the host-side PLU rotation draws across
    random restarts (the jax ``key`` cannot seed them — the LU
    factorization runs on the host, so its seed must be a concrete int
    even when flow construction is jitted)."""
    from .coupling import RealNVP_layer
    from .distributions import DiagNormal
    from .flows import create_flow

    if isinstance(q0, int):
        q0 = DiagNormal.standard(q0, dtype)
    dim = q0.event_dim
    blocks = []
    for i, k in enumerate(jax.random.split(key, nlayers)):
        c_even, c_odd = RealNVP_layer(k, dim, hdims, dtype, compute_dtype)
        blocks.append(GlowBlock(
            ActNorm.identity(dim, dtype),
            InvertibleLinear.make(mix_seed * 1000003 + i, dim, dtype),
            c_even, c_odd,
        ))
    if scan:
        return create_flow([stack_bijectors(blocks, remat=remat)], q0)
    return create_flow(blocks, q0)


def glow_init_actnorms(flow, x: jax.Array):
    """Glow data-dependent init: run ``x`` (a (batch, dim) draw from the
    data/base) through the flow front-to-back, re-initializing every
    ActNorm so its output over the batch is zero-mean/unit-variance per
    dim. Returns a new flow (pytrees are immutable).

    Handles both glow layouts: a `Repeated` stack of `GlowBlock`s
    (``scan=True``, re-init via a lax.scan that threads the activations
    block to block) and a flat `Chain` containing `GlowBlock`s and/or bare
    `ActNorm`s. ActNorms nested anywhere else are not reached — a
    ValueError is raised if no ActNorm is found rather than silently
    returning the flow unchanged. Initialized params are cast to the
    replaced layer's param dtype (an init batch in a different dtype must
    not swap the flow's param dtype)."""

    def init_block(block: GlowBlock, x):
        dt = block.actnorm.log_scale.dtype
        an = ActNorm.initialize(x, dtype=dt)
        block = GlowBlock(an, block.mix, block.c_even, block.c_odd)
        y, _ = block.forward_and_log_det(x)
        return block, y

    bijs = list(flow.bijector.bijectors)
    n_found = 0
    for i, b in enumerate(bijs):
        if isinstance(b, Repeated) and isinstance(b.stacked, GlowBlock):
            def body(x, block):
                block, y = init_block(block, x)
                return y, block

            x, new_stacked = jax.lax.scan(body, x, b.stacked, length=b.n)
            bijs[i] = Repeated(new_stacked, b.n, b.remat)
            n_found += b.n
        elif isinstance(b, GlowBlock):
            bijs[i], x = init_block(b, x)
            n_found += 1
        elif isinstance(b, ActNorm):
            bijs[i] = ActNorm.initialize(x, dtype=b.log_scale.dtype)
            x, _ = bijs[i].forward_and_log_det(x)
            n_found += 1
        else:
            x, _ = b.forward_and_log_det(x)
    if n_found == 0:
        raise ValueError(
            "glow_init_actnorms found no ActNorm/GlowBlock at the top "
            "level of the flow's Chain; nested ActNorms are not reached")
    chain = Chain(tuple(bijs))
    return type(flow)(flow.base, chain)
