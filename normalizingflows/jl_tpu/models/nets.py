"""MLP conditioner networks.

Replaces the reference's Flux.jl usage (`src/flows/utils.jl:28-100`):
`mlp3` (3-layer Dense chain with leakyrelu, `:33-46`) and `fnn` (arbitrary
hidden dims, optional output activation, `:71-100`). Initialization matches
Flux defaults: Glorot-uniform weights, zero bias. Parameters are pytree
leaves; the dtype knob plays the role of Flux's `_paramtype` Float32/64 cast.

Weights are stored (in_dim, out_dim) and applied as ``x @ W + b`` on
``(..., in_dim)`` batches — batched matmuls that XLA hands to cuBLAS.
"""

from __future__ import annotations

import functools
from typing import Callable, Sequence

import jax
import jax.numpy as jnp

from .. import device
from ..utils.pytree import Module, module, static_field

__all__ = ["Dense", "MLP", "fnn", "mlp3", "leaky_relu"]


@functools.partial(jax.custom_vjp, nondiff_argnums=(2, 3))
def _mixed_matmul(x, W, cd, pet):
    """Matmul with operands cast to ``cd`` (bf16 policy) and accumulation
    dtype ``pet``. The custom VJP keeps BOTH backward matmuls in ``cd``
    too: without it, autodiff feeds the f32 cotangent into mixed-dtype
    dot-generals that XLA upcasts to full-f32 products. Standard
    mixed-precision semantics:
    bf16 operand/gradient matmuls, f32 accumulation, f32 master params."""
    return jnp.matmul(x.astype(cd), W.astype(cd),
                      preferred_element_type=pet)


def _mixed_matmul_fwd(x, W, cd, pet):
    return _mixed_matmul(x, W, cd, pet), (x, W)


def _mixed_matmul_bwd(cd, pet, res, g):
    x, W = res
    gc = g.astype(cd)
    gx = jnp.matmul(gc, W.astype(cd).T,
                    preferred_element_type=pet).astype(x.dtype)
    xf = x.reshape(-1, x.shape[-1]).astype(cd)
    gf = gc.reshape(-1, g.shape[-1])
    gW = jnp.matmul(xf.T, gf, preferred_element_type=pet).astype(W.dtype)
    return gx, gW


_mixed_matmul.defvjp(_mixed_matmul_fwd, _mixed_matmul_bwd)


def leaky_relu(x: jax.Array) -> jax.Array:
    """Flux's `leakyrelu` default (slope 0.01)."""
    return jax.nn.leaky_relu(x, negative_slope=0.01)


def _glorot_uniform(key, in_dim, out_dim, dtype):
    limit = jnp.sqrt(jnp.asarray(6.0 / (in_dim + out_dim), dtype=dtype))
    return jax.random.uniform(
        key, (in_dim, out_dim), dtype=dtype, minval=-limit, maxval=limit
    )


@module
class Dense(Module):
    """One affine layer with activation: act(x @ W + b).

    ``compute_dtype`` is the mixed-precision policy knob (SURVEY §7 hard
    part 3): params stay in their stored dtype (master f32), but the matmul
    operands are cast to ``compute_dtype`` (bf16 → tensor-core products)
    with f32 accumulation (`preferred_element_type`). Bias add, activation,
    and everything downstream (log-dets) remain f32.

    Autodiff caveats of the ``compute_dtype`` path (it routes through a
    `jax.custom_vjp`): (a) forward-mode AD — `jax.jvp` / `jax.jacfwd`
    through a mixed-precision Dense — raises TypeError (custom_vjp defines
    no JVP rule); use reverse mode, or ``compute_dtype=None``. (b) reverse-
    mode cotangents are themselves computed with ``compute_dtype`` operand
    matmuls (standard mixed-precision training semantics) — gradients are
    NOT bitwise equal to the full-precision path's.
    """

    W: jax.Array
    b: jax.Array
    activation: Callable | None = static_field(default=None)
    compute_dtype: object = static_field(default=None)

    @staticmethod
    def make(key, in_dim, out_dim, activation=None, dtype=jnp.float32,
             compute_dtype=None):
        W = _glorot_uniform(key, in_dim, out_dim, dtype)
        b = jnp.zeros((out_dim,), dtype=dtype)
        return Dense(W, b, activation, compute_dtype)

    def __call__(self, x: jax.Array) -> jax.Array:
        if self.compute_dtype is not None:
            # mixed precision: bf16 (or other) operands, f32 accumulate.
            # XLA:CPU has no mixed-dtype dot thunk (bf16×bf16→f32), so there
            # the product is taken in compute_dtype and upcast after — a
            # static trace-time branch, not a runtime one.
            pet = self.W.dtype if device.mixed_dot_supported() else None
            y = _mixed_matmul(
                x, self.W, self.compute_dtype, pet
            ).astype(self.W.dtype) + self.b
        else:
            # Full-precision matmul for f32/f64 params: DEFAULT precision
            # may run an f32 product in TF32 on the GPU (about three
            # decimal digits), which breaks the reference's exact-
            # arithmetic density semantics (log-dets feed exp()). HIGHEST is
            # exact f32; passing bf16 params opts into tensor-core bf16
            # arithmetic explicitly.
            prec = (
                jax.lax.Precision.HIGHEST
                if self.W.dtype in (jnp.float32, jnp.float64)
                else None
            )
            y = jnp.matmul(x, self.W, precision=prec) + self.b
        if self.activation is not None:
            y = self.activation(y)
        return y


@module
class MLP(Module):
    """Chain of Dense layers (Flux.Chain equivalent)."""

    layers: tuple[Dense, ...]

    def __call__(self, x: jax.Array) -> jax.Array:
        for layer in self.layers:
            x = layer(x)
        return x

    @property
    def in_dim(self) -> int:
        return self.layers[0].W.shape[0]

    @property
    def out_dim(self) -> int:
        return self.layers[-1].W.shape[1]


def fnn(
    key: jax.Array,
    input_dim: int,
    hidden_dims: Sequence[int],
    output_dim: int,
    inlayer_activation: Callable = leaky_relu,
    output_activation: Callable | None = None,
    dtype=jnp.float32,
    compute_dtype=None,
) -> MLP:
    """Fully-connected network, reference `fnn` (`src/flows/utils.jl:71-100`):
    hidden layers with ``inlayer_activation``, optional output activation
    (e.g. tanh for the RealNVP log-scale head, `src/flows/realnvp.jl:50`).
    ``compute_dtype=jnp.bfloat16`` enables the mixed-precision matmul policy
    (params stay ``dtype``; see `Dense`)."""
    dims = [input_dim, *hidden_dims, output_dim]
    keys = jax.random.split(key, len(dims) - 1)
    layers = []
    for i, (k, din, dout) in enumerate(zip(keys, dims[:-1], dims[1:])):
        last = i == len(dims) - 2
        act = output_activation if last else inlayer_activation
        layers.append(Dense.make(k, din, dout, act, dtype, compute_dtype))
    return MLP(tuple(layers))


def mlp3(
    key: jax.Array,
    input_dim: int,
    hidden_dim: int,
    output_dim: int,
    activation: Callable = leaky_relu,
    dtype=jnp.float32,
) -> MLP:
    """3-layer MLP, reference `mlp3` (`src/flows/utils.jl:33-46`):
    in→h (act), h→h (act), h→out (linear)."""
    return fnn(
        key, input_dim, [hidden_dim, hidden_dim], output_dim,
        inlayer_activation=activation, dtype=dtype,
    )
