"""Fused RQS kernel (Pallas, Triton route) vs the pure-jnp oracle.

The kernel runs in interpret mode on the CPU; values AND gradients must
agree with `ops/rqs.py` to float32 tolerance. The same kernel body is what
compiles for the GPU: `test_kernels_lower_for_cuda` lowers it for CUDA from
this CPU-only process, which applies Triton's shape rules without a card,
and `chip_smoke.py` checks the compiled kernel on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from normalizingflows.jl_tpu.ops import rqs as oracle
from normalizingflows.jl_tpu.ops import rqs_pallas as kern

K = 10
B = 5.0
N = 300  # deliberately not a multiple of the kernel block size


def _setup(seed=0, dtype=jnp.float32, K=K, N=N):
    kx, kr = jax.random.split(jax.random.key(seed))
    # inputs spanning inside and outside the [−B, B] box
    x = jax.random.uniform(kx, (N,), dtype, minval=-1.5 * B, maxval=1.5 * B)
    raw = 0.5 * jax.random.normal(kr, (N, 3 * K - 1), dtype)
    return x, raw


def _oracle_fwd(x, raw):
    xs, ys, ds = oracle.rqs_params_from_raw(raw, B)
    return oracle.rqs_forward(x, xs, ys, ds)


def _oracle_inv(y, raw):
    xs, ys, ds = oracle.rqs_params_from_raw(raw, B)
    return oracle.rqs_inverse(y, xs, ys, ds)


def test_forward_matches_oracle():
    x, raw = _setup()
    y_o, ld_o = _oracle_fwd(x, raw)
    y_k, ld_k = kern.rqs_fused(x, raw, B, interpret=True)
    np.testing.assert_allclose(y_k, y_o, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ld_k, ld_o, rtol=1e-4, atol=1e-5)


def test_inverse_matches_oracle():
    x, raw = _setup(seed=1)
    y_o, ld_o = _oracle_inv(x, raw)
    y_k, ld_k = kern.rqs_fused(x, raw, B, inverse=True, interpret=True)
    np.testing.assert_allclose(y_k, y_o, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ld_k, ld_o, rtol=1e-4, atol=1e-5)


def test_kernel_roundtrip():
    x, raw = _setup(seed=2)
    y, ld_f = kern.rqs_fused(x, raw, B, interpret=True)
    x2, ld_i = kern.rqs_fused(y, raw, B, inverse=True, interpret=True)
    np.testing.assert_allclose(x2, x, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ld_f, -ld_i, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("inverse", [False, True])
def test_gradients_match_oracle(inverse):
    x, raw = _setup(seed=3)
    ofn = _oracle_inv if inverse else _oracle_fwd

    def loss_oracle(x, raw):
        y, ld = ofn(x, raw)
        return jnp.sum(jnp.sin(y)) + jnp.sum(ld * 0.5)

    def loss_kernel(x, raw):
        y, ld = kern.rqs_fused(x, raw, B, inverse=inverse, interpret=True)
        return jnp.sum(jnp.sin(y)) + jnp.sum(ld * 0.5)

    go_x, go_r = jax.grad(loss_oracle, argnums=(0, 1))(x, raw)
    gk_x, gk_r = jax.grad(loss_kernel, argnums=(0, 1))(x, raw)
    np.testing.assert_allclose(gk_x, go_x, rtol=2e-3, atol=1e-4)
    np.testing.assert_allclose(gk_r, go_r, rtol=2e-3, atol=1e-4)


@pytest.mark.parametrize("n_bins", [4, 8, 10])  # 3K−1 = 11, 23, 29
@pytest.mark.parametrize("raw_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["forward", "inverse", "vjp"])
def test_kernel_matches_oracle_grid(mode, raw_dtype, n_bins):
    """Every K whose 3K−1 parameter rows are not a power of two, raw in f32
    and in bf16 (the oracle gets the same bf16-rounded raw, upcast), and an
    element count that leaves a partial last block."""
    n = kern.BLOCK + 37
    x, raw = _setup(seed=n_bins, K=n_bins, N=n)
    raw = raw.astype(raw_dtype)
    raw_up = raw.astype(jnp.float32)
    inverse = mode == "inverse"
    ofn = _oracle_inv if inverse else _oracle_fwd
    if mode != "vjp":
        y_o, ld_o = ofn(x, raw_up)
        y_k, ld_k = kern.rqs_fused(x, raw, B, inverse=inverse,
                                   interpret=True)
        assert y_k.dtype == x.dtype and y_k.shape == (n,)
        np.testing.assert_allclose(y_k, y_o, rtol=1e-5, atol=2e-5)
        np.testing.assert_allclose(ld_k, ld_o, rtol=1e-4, atol=2e-5)
        return

    gy = jax.random.normal(jax.random.key(7), (n,))

    def loss(fn):
        return lambda x, r: (lambda y, ld: jnp.sum(y * gy) + jnp.sum(ld))(
            *fn(x, r))

    go_x, go_r = jax.grad(loss(_oracle_fwd), (0, 1))(x, raw_up)
    gk_x, gk_r = jax.grad(loss(lambda x, r: kern.rqs_fused(
        x, r, B, interpret=True)), (0, 1))(x, raw)
    assert gk_r.dtype == raw.dtype  # cotangent in raw's storage dtype
    np.testing.assert_allclose(gk_x, go_x, rtol=2e-3, atol=1e-4)
    tol = 1e-2 if raw_dtype == "bfloat16" else 1e-4  # bf16 cotangent store
    np.testing.assert_allclose(np.asarray(gk_r, np.float32), go_r,
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("raw_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("inverse", [False, True])
def test_kernels_lower_for_cuda(inverse, raw_dtype):
    """Forward and backward kernels lower through the Triton route for CUDA
    at the wide config's per-call width — Triton's power-of-two shape rule
    is enforced at this stage, so no card is needed to catch a violation."""
    n = 4096 * 32
    x = jnp.zeros((n,), jnp.float32)
    raw_t = jnp.zeros((3 * K - 1, n), raw_dtype)

    def fwd(x, r):
        return kern.rqs_fused_t(x, r, 30.0, inverse)

    def grad(x, r):
        return jax.grad(lambda x, r: jnp.sum(sum(fwd(x, r))), (0, 1))(x, r)

    for fn in (fwd, grad):
        text = jax.jit(fn).trace(x, raw_t).lower(
            lowering_platforms=("cuda",)).as_text()
        assert "triton" in text


def test_param_major_entry_matches():
    """`rqs_fused_t` (the param-major entry) agrees with the elem-major
    wrapper in value and gradient."""
    x, raw = _setup(seed=5)
    y_e, ld_e = kern.rqs_fused(x, raw, B, interpret=True)
    y_t, ld_t = kern.rqs_fused_t(x, raw.T, B, interpret=True)
    np.testing.assert_allclose(y_t, y_e, rtol=1e-6)
    np.testing.assert_allclose(ld_t, ld_e, rtol=1e-6)

    def loss_t(x, raw_t):
        y, ld = kern.rqs_fused_t(x, raw_t, B, interpret=True)
        return jnp.sum(jnp.sin(y)) + jnp.sum(ld * 0.5)

    def loss_e(x, raw):
        y, ld = kern.rqs_fused(x, raw, B, interpret=True)
        return jnp.sum(jnp.sin(y)) + jnp.sum(ld * 0.5)

    gt_x, gt_r = jax.grad(loss_t, argnums=(0, 1))(x, raw.T)
    ge_x, ge_r = jax.grad(loss_e, argnums=(0, 1))(x, raw)
    np.testing.assert_allclose(gt_x, ge_x, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(gt_r.T, ge_r, rtol=1e-6, atol=1e-7)


def test_multi_dim_batch_shape():
    x, raw = _setup(seed=4)
    x3 = x[:296].reshape(4, 74)
    raw3 = raw[:296].reshape(4, 74, 3 * K - 1)
    y, ld = kern.rqs_fused(x3, raw3, B, interpret=True)
    assert y.shape == (4, 74) and ld.shape == (4, 74)
    y_f, ld_f = kern.rqs_fused(x3.ravel(), raw3.reshape(-1, 3 * K - 1), B,
                               interpret=True)
    np.testing.assert_allclose(y.ravel(), y_f, rtol=1e-6)


def test_param_major_feed_matches_default(key, monkeypatch):
    """The param-major kernel feed of `SplinePairStack` (permuted last
    Dense + one (batch, (3K−1)·n_t) transpose) is the SAME function as the
    default feed of the flat `NeuralSplineCoupling` layout (raw reshaped
    and transposed per call) — forward, inverse, log-dets, and ELBO
    gradients, numerically identical up to f32 reassociation (the permuted
    matmul sums in another order)."""
    import normalizingflows as nf
    from normalizingflows.jl_tpu.models.spline import SplinePairStack
    from normalizingflows.jl_tpu.utils.pytree import global_norm

    x = jax.random.normal(jax.random.key(1), (64, 6))
    t = nf.Banana(6, 1.0, 10.0)
    # the flows call the kernel as compiled for a card; on the CPU it runs
    # in the Pallas interpreter
    call = kern._call
    monkeypatch.setattr(kern, "_call", lambda kernel, name, n, shapes, _, *a:
                        call(kernel, name, n, shapes, True, *a))
    outs = []
    for scan in (False, True):
        # f32 conditioners: with bf16 products the two layouts' rounding
        # of raw differs by bf16 ulps, which the knots amplify
        flow = nf.nsf(key, 6, (16, 16), K=8, B=5.0, nlayers=2,
                      backend="pallas", scan=scan)
        assert isinstance(flow.bijector.bijectors[0], SplinePairStack) == scan
        y, ld = flow.bijector.forward_and_log_det(x)
        xi, ldi = flow.bijector.inverse_and_log_det(y)
        g = jax.grad(lambda f: -nf.elbo_batch(
            jax.random.key(2), f, t.log_prob, 32))(flow)
        outs.append((np.asarray(y), np.asarray(ld), np.asarray(xi),
                     np.asarray(ldi), float(global_norm(g))))
    for a, b in zip(*outs):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("inverse", [False, True])
def test_analytic_backward_matches_vjp_tape(key, inverse):
    """The hand-derived backward kernel (closed form for the forward
    direction, implicit differentiation for the inverse) is the SAME
    derivative as autodiff's tape through the kernel's own forward math
    (`_transform`, plain jnp outside any kernel): f64 agreement at
    machine-epsilon scale across in-box and out-of-box elements. (EXACTLY at
    x = ±B the two give different — equally valid — subgradients: the tape
    routes through clip/maximum tie-breaking, the analytic form takes the
    interior limit. Measure-zero; excluded here. The inverse carries a
    slightly looser tolerance: the IFT differentiates the exact root while
    the tape differentiates the closed-form root FORMULA — identical in
    real arithmetic, a few ulps apart after the quadratic's f64 rounding on
    near-flat bins.)"""
    K, B, n = 10, 30.0, 4096
    kx, kr, kg, kl = jax.random.split(key, 4)
    x = jax.random.uniform(kx, (n,), jnp.float64, -1.2 * B, 1.2 * B)
    raw = jax.random.normal(kr, (3 * K - 1, n), jnp.float64)
    gy = jax.random.normal(kg, (n,), jnp.float64)
    gld = jax.random.normal(kl, (n,), jnp.float64)

    def loss(fn):
        return lambda x, raw: (lambda y, ld: jnp.sum(y * gy)
                               + jnp.sum(ld * gld))(*fn(x, raw))

    ga = jax.grad(loss(lambda x, r: kern.rqs_fused_t(
        x, r, B, inverse, True)), (0, 1))(x, raw)
    gv = jax.grad(loss(lambda x, r: kern._transform(
        x, list(r), B, K, inverse)), (0, 1))(x, raw)
    tol = 1e-10 if inverse else 1e-12
    for a, b in zip(ga, gv):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=tol, atol=tol)
