"""Fused rational-quadratic-spline kernel (Pallas, Triton route).

One `pallas_call` fuses, per element, what `ops/rqs.py` spreads over several
XLA passes:

    raw conditioner outputs (3K−1)
      → softmax/cumsum knot normalization        (rqs_params_from_raw)
      → bin search (compare over the K knots)
      → rational-quadratic forward/inverse + log-derivative

so the (N, K+1)×3 knot tables and the bin picks never touch device memory:
the kernel reads 3K−1 raw values and x, and writes y and the log-derivative.

Layout: param-major. ``raw_t`` is (3K−1, N). A block owns ``BLOCK``
consecutive elements and loads parameter row j as one (BLOCK,) vector, which
is coalesced across each warp. Every K-sized step (softmax max/sum, the exact
running cumsum, the bin pick, the backward's reverse cumsum) is unrolled in
Python over lists of (BLOCK,) vectors: the Triton lowering accepts only
power-of-two shapes, so no (K, BLOCK) or (3K−1, BLOCK) value is ever built.

The backward is a second kernel with a hand-derived reverse (closed form for
the forward direction, implicit differentiation of the quadratic root for the
inverse), exposed through `jax.custom_vjp`. Numerics are pinned against the
`ops/rqs.py` oracle (tests/test_rqs_kernel.py, interpret mode on the CPU;
`chip_smoke.py` compiled on the card).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from . import rqs as _oracle

__all__ = ["rqs_fused", "rqs_fused_t"]

# Elements per block and warps per block: one element per thread (the
# forward keeps ~60 K-sized vectors live, the backward about twice that).
# Swept on the H100 at 131,072 elements (PERF.md): 128×4 led the forward +
# backward pair; 1024 elements on 4 warps spills and is 5× slower.
BLOCK = 128
NUM_WARPS = 4


def _sum(rows):
    return functools.reduce(jnp.add, rows)


def _softmax(rows):
    m = functools.reduce(jnp.maximum, rows)
    e = [jnp.exp(r - m) for r in rows]
    s = _sum(e)
    return [ej / s for ej in e]


def _softplus(v):
    return jnp.maximum(v, 0.0) + jnp.log1p(jnp.exp(-jnp.abs(v)))


def _sigmoid(v):
    return 1.0 / (1.0 + jnp.exp(-v))


def _tables(raw, B: float, K: int, like):
    """Per-bin knot endpoints from the 3K−1 raw rows.

    Returns lists of K vectors (xs_lo, xs_hi, ys_lo, ys_hi, d_lo, d_hi) plus
    the softmax probabilities and the raw derivative rows the backward needs.
    The cumsum is an exact running sum (a matmul cumsum may round its
    operands and collapse the last bin onto the pinned +B knot)."""
    mbw = _oracle.DEFAULT_MIN_BIN_WIDTH
    mbh = _oracle.DEFAULT_MIN_BIN_HEIGHT
    mder = _oracle.DEFAULT_MIN_DERIVATIVE
    p_w = _softmax(raw[:K])
    p_h = _softmax(raw[K:2 * K])
    d_raw = raw[2 * K:]
    lo = jnp.full_like(like, -B)
    hi = jnp.full_like(like, B)

    def knots(p, min_bin):
        acc, out = None, []
        for pj in p[:-1]:
            bin_ = min_bin + (1.0 - min_bin * K) * pj
            acc = bin_ if acc is None else acc + bin_
            out.append(-B + 2.0 * B * acc)
        return [lo] + out, out + [hi]

    xs_lo, xs_hi = knots(p_w, mbw)
    ys_lo, ys_hi = knots(p_h, mbh)
    interior = [mder + _softplus(d) for d in d_raw]
    one = jnp.ones_like(like)
    return (xs_lo, xs_hi, ys_lo, ys_hi, [one] + interior, interior + [one],
            p_w, p_h, d_raw)


def _bins(v, grid_lo, K):
    """sel[j] = v >= lo_j for j = 1..K−1. Knots increase, so the bin is the
    last j with sel true (0 if none), as the oracle's compare-and-sum."""
    return [v >= grid_lo[j] for j in range(1, K)]


def _pick(sel, t):
    out = t[0]
    for j, s in enumerate(sel, start=1):
        out = jnp.where(s, t[j], out)
    return out


def _onehot(sel, K):
    """onehot[j] = (bin == j), from the monotone compare vector."""
    hot = []
    for j in range(K):
        below = sel[j - 1] if j > 0 else None
        above = sel[j] if j < K - 1 else None
        if below is None:
            hot.append(jnp.logical_not(above))
        elif above is None:
            hot.append(below)
        else:
            hot.append(below & jnp.logical_not(above))
    return hot


def _table_to_raw(g_lo, g_hi, p, min_bin, B, K):
    """Reverse of softmax → affine bins → cumsum → (lo, hi) knot views.
    Knot j+1 is read as hi of bin j and lo of bin j+1; the pinned ±B knots
    carry no gradient."""
    acc = jnp.zeros_like(p[0])
    g_bins = [acc]
    for j in range(K - 2, -1, -1):
        acc = acc + 2.0 * B * (g_hi[j] + g_lo[j + 1])
        g_bins.append(acc)
    g_soft = [(1.0 - min_bin * K) * g for g in g_bins[::-1]]
    dot = _sum([pj * gj for pj, gj in zip(p, g_soft)])
    return [pj * (gj - dot) for pj, gj in zip(p, g_soft)]


def _transform(x, raw, B: float, K: int, inverse: bool):
    """(y, ld) of one block: ``x`` a vector, ``raw`` a list of 3K−1 vectors.
    Same math as `ops/rqs.py`."""
    xs_lo, xs_hi, ys_lo, ys_hi, d_lo, d_hi, *_ = _tables(raw, B, K, x)
    inside = (x >= -B) & (x <= B)
    v = jnp.clip(x, -B, B)
    sel = _bins(v, ys_lo if inverse else xs_lo, K)
    x_k, x_k1 = _pick(sel, xs_lo), _pick(sel, xs_hi)
    y_k, y_k1 = _pick(sel, ys_lo), _pick(sel, ys_hi)
    d_k, d_k1 = _pick(sel, d_lo), _pick(sel, d_hi)

    # roundoff guard: normalization bounds w, h ≥ min_bin·2B; the clamp keeps
    # a degenerate bin away from log(0) and 0-division at the pinned knots
    tiny = 1e-6 * 2.0 * B
    w = jnp.maximum(x_k1 - x_k, tiny)
    h = jnp.maximum(y_k1 - y_k, tiny)
    s = h / w
    dsum = d_k1 + d_k - 2.0 * s
    if not inverse:
        xi = (v - x_k) / w
    else:
        dy = v - y_k
        a = h * (s - d_k) + dy * dsum
        b = h * d_k - dy * dsum
        c = -s * dy
        disc = jnp.maximum(b * b - 4.0 * a * c, 0.0)
        xi = jnp.clip(2.0 * c / (-b - jnp.sqrt(disc)), 0.0, 1.0)
    xi1m = 1.0 - xi
    xi_prod = xi * xi1m
    denom = s + dsum * xi_prod
    deriv_num = (s * s) * (d_k1 * xi * xi + 2.0 * s * xi_prod
                           + d_k * xi1m * xi1m)
    ld = jnp.log(deriv_num) - 2.0 * jnp.log(denom)
    if not inverse:
        out = y_k + h * (s * xi * xi + d_k * xi_prod) / denom
    else:
        out = x_k + xi * w
        ld = -ld
    return jnp.where(inside, out, x), jnp.where(inside, ld, 0.0)


def _backward(x, raw, g_out, gld, B: float, K: int, inverse: bool):
    """Hand-derived reverse of `_transform`: (gx, list of 3K−1 graw rows).

    Forward direction: the closed-form reverse of Durkan et al. eqs. 4–8
    through the softmax/cumsum/softplus normalization (the spline derivative
    P/D² is exp(ld)). Inverse direction: the inverse finds ξ* with
    Y(ξ*; θ) = v, so by the implicit function theorem ∂ξ*/∂θ =
    −(∂Y/∂θ)/(∂Y/∂ξ), ∂Y/∂ξ = w·P/D²; this differentiates the exact root,
    which agrees with autodiff of the closed-form root away from
    measure-zero clip and tie points."""
    (xs_lo, xs_hi, ys_lo, ys_hi, d_lo, d_hi,
     p_w, p_h, d_raw) = _tables(raw, B, K, x)
    inside = (x >= -B) & (x <= B)
    v = jnp.clip(x, -B, B)
    sel = _bins(v, ys_lo if inverse else xs_lo, K)
    x_k, x_k1 = _pick(sel, xs_lo), _pick(sel, xs_hi)
    y_k, y_k1 = _pick(sel, ys_lo), _pick(sel, ys_hi)
    d_k, d_k1 = _pick(sel, d_lo), _pick(sel, d_hi)

    tiny = 1e-6 * 2.0 * B
    w_span, h_span = x_k1 - x_k, y_k1 - y_k
    w = jnp.maximum(w_span, tiny)
    h = jnp.maximum(h_span, tiny)
    s = h / w
    dsum = d_k1 + d_k - 2.0 * s
    if not inverse:
        xi = (v - x_k) / w
    else:
        dy = v - y_k
        a = h * (s - d_k) + dy * dsum
        b = h * d_k - dy * dsum
        c = -s * dy
        disc = jnp.maximum(b * b - 4.0 * a * c, 0.0)
        xi = jnp.clip(2.0 * c / (-b - jnp.sqrt(disc)), 0.0, 1.0)
    xi1m = 1.0 - xi
    q = xi * xi1m
    D = s + dsum * q
    Ny = s * xi * xi + d_k * q
    R = d_k1 * xi * xi + 2.0 * s * q + d_k * xi1m * xi1m
    P = (s * s) * R
    # outside the box the map is the identity with zero log-det
    g_in = jnp.where(inside, g_out, 0.0)
    gld_in = jnp.where(inside, gld, 0.0)

    if not inverse:
        gD = g_in * (-h * Ny / (D * D)) + gld_in * (-2.0 / D)
        gP = gld_in / P
        gNy = g_in * h / D
        g_xi = (gD * dsum * (1.0 - 2.0 * xi)
                + gNy * (2.0 * s * xi + d_k * (1.0 - 2.0 * xi))
                + gP * (s * s) * (2.0 * d_k1 * xi + 2.0 * s * (1.0 - 2.0 * xi)
                                  - 2.0 * d_k * xi1m))
        g_s = (gD * (1.0 - 2.0 * q) + gNy * xi * xi
               + gP * (2.0 * s * R + 2.0 * (s * s) * q))
        g_dk = gD * q + gNy * q + gP * (s * s) * xi1m * xi1m
        g_dk1 = gD * q + gP * (s * s) * xi * xi
        # s = h/w, xi = (v − x_k)/w
        g_h = g_in * Ny / D + g_s / w
        g_w = -g_s * h / (w * w) - g_xi * xi / w
        g_v = g_xi / w
        g_xk_extra = -g_xi / w
        g_yk_extra = g_in
    else:
        # ld_out = −(log P − 2 log D): explicit partials at fixed ξ
        gP_e = -gld_in / P
        gD_e = 2.0 * gld_in / D
        g_s_e = gD_e * (1.0 - 2.0 * q) + gP_e * (2.0 * s * R
                                                 + 2.0 * (s * s) * q)
        g_dk_e = gD_e * q + gP_e * (s * s) * xi1m * xi1m
        g_dk1_e = gD_e * q + gP_e * (s * s) * xi * xi
        # total cotangent reaching ξ: out = x_k + ξw, plus ld's ξ-derivative
        Dp = dsum * (1.0 - 2.0 * xi)
        Pp = (s * s) * (2.0 * d_k1 * xi + 2.0 * s * (1.0 - 2.0 * xi)
                        - 2.0 * d_k * xi1m)
        g_xi_tot = g_in * w - gld_in * (Pp / P - 2.0 * Dp / D)
        dYdxi = w * P / (D * D)
        coef = -g_xi_tot / dYdxi
        # ∂Y/∂θ at fixed ξ for Y(ξ) = y_k + h·Ny/D
        g_s = g_s_e + coef * h * (xi * xi * D - Ny * (1.0 - 2.0 * q)) / (D * D)
        g_dk = g_dk_e + coef * h * q * (D - Ny) / (D * D)
        g_dk1 = g_dk1_e - coef * h * Ny * q / (D * D)
        g_h = coef * Ny / D + g_s / w
        g_w = g_in * xi - g_s * h / (w * w)
        g_v = g_xi_tot / dYdxi
        g_xk_extra = g_in
        g_yk_extra = coef

    # spans → knot endpoints, through the max() clamps
    g_w = jnp.where(w_span > tiny, g_w, 0.0)
    g_h = jnp.where(h_span > tiny, g_h, 0.0)
    g_xk, g_xk1 = g_xk_extra - g_w, g_w
    g_yk, g_yk1 = g_yk_extra - g_h, g_h

    hot = _onehot(sel, K)

    def scatter(g):
        return [jnp.where(hj, g, 0.0) for hj in hot]

    g_w_raw = _table_to_raw(scatter(g_xk), scatter(g_xk1), p_w,
                            _oracle.DEFAULT_MIN_BIN_WIDTH, B, K)
    g_h_raw = _table_to_raw(scatter(g_yk), scatter(g_yk1), p_h,
                            _oracle.DEFAULT_MIN_BIN_HEIGHT, B, K)
    # d_lo = [1, interior], d_hi = [interior, 1]
    g_d_lo, g_d_hi = scatter(g_dk), scatter(g_dk1)
    g_d_raw = [_sigmoid(d_raw[j]) * (g_d_lo[j + 1] + g_d_hi[j])
               for j in range(K - 1)]
    gx = jnp.where(inside, g_v, g_out)
    return gx, g_w_raw + g_h_raw + g_d_raw


def _block(n):
    idx = pl.program_id(0) * BLOCK + jnp.arange(BLOCK)
    return idx, idx < n


def _load_rows(ref, idx, mask, dtype):
    # raw may be stored narrower (bf16 under the mixed-precision policy);
    # all in-kernel math runs in x's dtype
    return [plgpu.load(ref.at[j, idx], mask=mask, other=0.0).astype(dtype)
            for j in range(ref.shape[0])]


def _fwd_kernel(x_ref, raw_ref, y_ref, ld_ref, *, n, B, K, inverse):
    idx, mask = _block(n)
    x = plgpu.load(x_ref.at[idx], mask=mask, other=0.0)
    y, ld = _transform(x, _load_rows(raw_ref, idx, mask, x.dtype), B, K,
                       inverse)
    plgpu.store(y_ref.at[idx], y, mask=mask)
    plgpu.store(ld_ref.at[idx], ld, mask=mask)


def _bwd_kernel(x_ref, raw_ref, gy_ref, gld_ref, gx_ref, graw_ref,
                *, n, B, K, inverse):
    idx, mask = _block(n)
    x = plgpu.load(x_ref.at[idx], mask=mask, other=0.0)
    gy = plgpu.load(gy_ref.at[idx], mask=mask, other=0.0)
    gld = plgpu.load(gld_ref.at[idx], mask=mask, other=0.0)
    gx, graw = _backward(x, _load_rows(raw_ref, idx, mask, x.dtype), gy, gld,
                         B, K, inverse)
    plgpu.store(gx_ref.at[idx], gx, mask=mask)
    for j, g in enumerate(graw):
        plgpu.store(graw_ref.at[j, idx], g.astype(graw_ref.dtype), mask=mask)


def _call(kernel, name, n, out_shape, interpret, *args):
    return pl.pallas_call(
        kernel,
        grid=(pl.cdiv(n, BLOCK),),
        out_shape=out_shape,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name=name,
    )(*args)


@functools.partial(jax.custom_vjp, nondiff_argnums=(2, 3, 4))
def rqs_fused_t(x_flat, raw_t, B, inverse=False, interpret=False):
    """Fused RQS on param-major inputs: ``x_flat`` (N,), ``raw_t``
    (3K−1, N). Returns (out (N,), elementwise log|dy/dx| (N,)).
    ``interpret=True`` runs the kernel in the Pallas interpreter (tests on
    the CPU)."""
    n = x_flat.shape[0]
    K = (raw_t.shape[0] + 1) // 3
    kern = functools.partial(_fwd_kernel, n=n, B=float(B), K=K,
                             inverse=bool(inverse))
    out = jax.ShapeDtypeStruct(x_flat.shape, x_flat.dtype)
    y, ld = _call(kern, "rqs_fwd", n, (out, out), interpret, x_flat, raw_t)
    return y, ld


def _rqs_fused_t_fwd(x_flat, raw_t, B, inverse, interpret):
    return rqs_fused_t(x_flat, raw_t, B, inverse, interpret), (x_flat, raw_t)


def _rqs_fused_t_bwd(B, inverse, interpret, res, g):
    x_flat, raw_t = res
    gy, gld = g
    n = x_flat.shape[0]
    K = (raw_t.shape[0] + 1) // 3
    kern = functools.partial(_bwd_kernel, n=n, B=float(B), K=K,
                             inverse=bool(inverse))
    args = (x_flat, raw_t, gy.astype(x_flat.dtype), gld.astype(x_flat.dtype))
    shapes = (jax.ShapeDtypeStruct(x_flat.shape, x_flat.dtype),
              jax.ShapeDtypeStruct(raw_t.shape, raw_t.dtype))
    gx, graw_t = _call(kern, "rqs_bwd", n, shapes, interpret, *args)
    return gx, graw_t


rqs_fused_t.defvjp(_rqs_fused_t_fwd, _rqs_fused_t_bwd)


def rqs_fused(x, raw, B, inverse=False, interpret=False):
    """Fused RQS of ``x`` (...,) by per-element raw parameters ``raw``
    (..., 3K−1): the fused equivalent of `rqs_params_from_raw` +
    `rqs_forward`/`rqs_inverse`. Returns (out, elementwise log|dy/dx|)."""
    raw_t = raw.reshape(-1, raw.shape[-1]).T
    y, ld = rqs_fused_t(x.reshape(-1), raw_t, float(B), bool(inverse),
                        bool(interpret))
    return y.reshape(x.shape), ld.reshape(x.shape)
