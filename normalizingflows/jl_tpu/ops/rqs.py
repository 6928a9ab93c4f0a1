"""Rational-quadratic spline (RQS) transform — pure-jnp reference path.

JAX replacement for the MonotonicSplines.jl kernels the reference
delegates to (`src/flows/neuralspline.jl:65-140`): parameter normalization
(`rqs_params_from_nn`), forward (`rqs_forward`) and inverse (`rqs_inverse`)
evaluation of the monotone rational-quadratic spline of Durkan, Bekasov,
Murray & Papamakarios, "Neural Spline Flows" (NeurIPS 2019), eqs. (4)-(8).

This module is the numerics ORACLE: straight-line jnp that XLA fuses well
and that autodiff differentiates exactly (lifting the reference's
Zygote-only restriction for NSF, `src/flows/neuralspline.jl:207-212`).
The fused Pallas (Triton) kernel with a custom VJP in `rqs_pallas.py` is
pinned against it by tests and by `chip_smoke.py`.

Shapes: the spline is elementwise over an arbitrary batch of scalars with
per-element knot tables. ``x``: (...,); ``xs``/``ys``: (..., K+1) knot
coordinates; ``ds``: (..., K+1) derivatives at the knots. Outside the box
[-B, B] the transform is the identity with zero log-det (linear tails,
boundary derivatives pinned to 1).

The bin search is a broadcast compare-and-sum over the K+1 knot axis —
no `searchsorted`, no dynamic control flow: K vectorized compares (K≈10),
which beats any scalar binary search.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "rqs_params_from_raw",
    "rqs_forward",
    "rqs_inverse",
]

# Durkan et al. reference implementation constants (nflows defaults).
DEFAULT_MIN_BIN_WIDTH = 1e-3
DEFAULT_MIN_BIN_HEIGHT = 1e-3
DEFAULT_MIN_DERIVATIVE = 1e-3


def _exact_cumsum(a: jax.Array) -> jax.Array:
    """Running sum over the last (K-sized) axis with EXACT per-step adds.

    ``jnp.cumsum`` may lower to a triangular-ones matmul, which at default
    precision can round f32 operands (TF32 on the GPU) — enough knot drift
    to collapse the last bin against the pinned +B knot. K is tiny;
    ``associative_scan`` lowers to exact vector adds on every backend."""
    return jax.lax.associative_scan(jnp.add, a, axis=-1)


def rqs_params_from_raw(
    raw: jax.Array,
    B: float,
    min_bin_width: float = DEFAULT_MIN_BIN_WIDTH,
    min_bin_height: float = DEFAULT_MIN_BIN_HEIGHT,
    min_derivative: float = DEFAULT_MIN_DERIVATIVE,
):
    """Normalize raw conditioner outputs into monotone spline knot tables.

    ``raw``: (..., 3K−1) — K unnormalized widths, K heights, K−1 interior
    derivatives (the reference's layout via
    `MonotonicSplines.rqs_params_from_nn`, consumed at
    `src/flows/neuralspline.jl:65-71`). Returns ``(xs, ys, ds)`` each
    (..., K+1): softmax-normalized widths/heights scaled to [−B, B] and
    cumsum'd into knot grids; softplus interior derivatives; boundary
    derivatives fixed at 1 so the spline matches its linear tails C¹-smoothly.
    """
    K = (raw.shape[-1] + 1) // 3
    w_raw = raw[..., :K]
    h_raw = raw[..., K : 2 * K]
    d_raw = raw[..., 2 * K :]
    dtype = raw.dtype

    widths = jax.nn.softmax(w_raw, axis=-1)
    widths = min_bin_width + (1.0 - min_bin_width * K) * widths
    heights = jax.nn.softmax(h_raw, axis=-1)
    heights = min_bin_height + (1.0 - min_bin_height * K) * heights

    two_B = jnp.asarray(2.0 * B, dtype)
    xs = -B + two_B * _exact_cumsum(widths)
    xs = jnp.concatenate(
        [jnp.full_like(xs[..., :1], -B), xs], axis=-1
    )
    xs = xs.at[..., -1].set(jnp.asarray(B, dtype))
    ys = -B + two_B * _exact_cumsum(heights)
    ys = jnp.concatenate(
        [jnp.full_like(ys[..., :1], -B), ys], axis=-1
    )
    ys = ys.at[..., -1].set(jnp.asarray(B, dtype))

    interior = min_derivative + jax.nn.softplus(d_raw)
    one = jnp.ones_like(interior[..., :1])
    ds = jnp.concatenate([one, interior, one], axis=-1)
    return xs, ys, ds


def _select_bin(v: jax.Array, knots: jax.Array) -> jax.Array:
    """Index k of the bin containing v: largest k with knots[k] <= v,
    clipped to [0, K−1]. Broadcast compare + sum (vectorized)."""
    K = knots.shape[-1] - 1
    k = jnp.sum(
        (v[..., None] >= knots[..., :-1]).astype(jnp.int32), axis=-1
    ) - 1
    return jnp.clip(k, 0, K - 1)


def _gather(params: jax.Array, k: jax.Array) -> jax.Array:
    return jnp.take_along_axis(params, k[..., None], axis=-1)[..., 0]


def rqs_forward(
    x: jax.Array, xs: jax.Array, ys: jax.Array, ds: jax.Array
):
    """Elementwise forward RQS: returns (y, log_det_elementwise).

    Durkan et al. eq. (4) for the value and the log of eq. (5) for the
    derivative. Outside [−B, B]: identity, zero log-det (the behavior of
    `MonotonicSplines.rqs_forward` consumed at
    `src/flows/neuralspline.jl:106`).
    """
    B = xs[..., -1]
    inside = (x >= -B) & (x <= B)
    xc = jnp.clip(x, -B, B)

    k = _select_bin(xc, xs)
    x_k = _gather(xs, k)
    x_k1 = _gather(xs, k + 1)
    y_k = _gather(ys, k)
    y_k1 = _gather(ys, k + 1)
    d_k = _gather(ds, k)
    d_k1 = _gather(ds, k + 1)

    tiny = jnp.asarray(1e-6, x.dtype) * (xs[..., -1] - xs[..., 0])
    w = jnp.maximum(x_k1 - x_k, tiny)
    h = jnp.maximum(y_k1 - y_k, tiny)
    s = h / w
    xi = (xc - x_k) / w
    xi1m = 1.0 - xi
    xi_prod = xi * xi1m

    denom = s + (d_k1 + d_k - 2.0 * s) * xi_prod
    num = h * (s * jnp.square(xi) + d_k * xi_prod)
    y = y_k + num / denom

    # eq (5): dy/dx = s² (d_{k+1} ξ² + 2 s ξ(1−ξ) + d_k (1−ξ)²) / denom²
    deriv_num = jnp.square(s) * (
        d_k1 * jnp.square(xi) + 2.0 * s * xi_prod + d_k * jnp.square(xi1m)
    )
    log_det = jnp.log(deriv_num) - 2.0 * jnp.log(denom)

    y = jnp.where(inside, y, x)
    log_det = jnp.where(inside, log_det, jnp.zeros_like(log_det))
    return y, log_det


def rqs_inverse(
    y: jax.Array, xs: jax.Array, ys: jax.Array, ds: jax.Array
):
    """Elementwise inverse RQS: returns (x, log_det_elementwise) with
    log_det = −log|dy/dx| at the recovered x (Durkan et al. eqs. (6)-(8):
    closed-form quadratic solve per bin; the numerically stable root
    ``2c / (−b − √(b²−4ac))`` is used)."""
    B = ys[..., -1]
    inside = (y >= -B) & (y <= B)
    yc = jnp.clip(y, -B, B)

    k = _select_bin(yc, ys)
    x_k = _gather(xs, k)
    x_k1 = _gather(xs, k + 1)
    y_k = _gather(ys, k)
    y_k1 = _gather(ys, k + 1)
    d_k = _gather(ds, k)
    d_k1 = _gather(ds, k + 1)

    tiny = jnp.asarray(1e-6, y.dtype) * (ys[..., -1] - ys[..., 0])
    w = jnp.maximum(x_k1 - x_k, tiny)
    h = jnp.maximum(y_k1 - y_k, tiny)
    s = h / w
    dy = yc - y_k
    dsum = d_k1 + d_k - 2.0 * s

    a = h * (s - d_k) + dy * dsum
    b = h * d_k - dy * dsum
    c = -s * dy
    disc = jnp.square(b) - 4.0 * a * c
    # disc >= 0 by monotonicity; clamp against roundoff
    root = 2.0 * c / (-b - jnp.sqrt(jnp.maximum(disc, 0.0)))
    xi = jnp.clip(root, 0.0, 1.0)
    x = x_k + xi * w

    xi1m = 1.0 - xi
    xi_prod = xi * xi1m
    denom = s + dsum * xi_prod
    deriv_num = jnp.square(s) * (
        d_k1 * jnp.square(xi) + 2.0 * s * xi_prod + d_k * jnp.square(xi1m)
    )
    log_det = -(jnp.log(deriv_num) - 2.0 * jnp.log(denom))

    x = jnp.where(inside, x, y)
    log_det = jnp.where(inside, log_det, jnp.zeros_like(log_det))
    return x, log_det
