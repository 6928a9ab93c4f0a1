"""Batched scalar root-finding for bijector inverses without closed form.

The reference's planar/radial inverses go through Bijectors.jl's adaptive
root-finder (exercised by `test/flow.jl:158-172, 224-238`). Adaptive
iteration counts are hostile to XLA (dynamic control flow), so here the
solve is a FIXED-iteration bisection bracket followed by Newton polish —
fully vectorized over the batch, jit/vmap/grad-safe.

Differentiation is IMPLICIT (`lax.custom_root`): the backward pass applies
the implicit-function theorem ∂x/∂θ = −(∂f/∂θ)/(∂f/∂x) at the root instead
of unrolling the 40+ solver iterations through reverse AD — no per-iteration
residuals are stored and the gradient is exact at the converged root.

`f` must be elementwise monotone increasing on the bracket [lo, hi] with
f(lo) <= 0 <= f(hi).
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

__all__ = ["solve_monotone"]


def solve_monotone(
    f: Callable[[jax.Array], jax.Array],
    lo: jax.Array,
    hi: jax.Array,
    bisect_iters: int = 40,
    newton_iters: int = 3,
) -> jax.Array:
    """Root of elementwise-increasing ``f`` on [lo, hi].

    40 bisection halvings shrink the bracket by 2⁻⁴⁰ ≈ 1e-12 relative,
    then a few Newton steps (derivative via forward-mode JVP) polish to
    machine precision — comfortably beating the reference tests' rtol 1e-4
    round-trip requirement in float32 and 1e-12 in float64.
    """
    lo = jnp.asarray(lo)
    hi = jnp.asarray(hi)

    def _solve(fn, x0):
        del x0  # the static bracket is a better start than custom_root's

        def bisect_body(_, carry):
            a, b = carry
            mid = 0.5 * (a + b)
            take_upper = fn(mid) < 0
            a = jnp.where(take_upper, mid, a)
            b = jnp.where(take_upper, b, mid)
            return a, b

        a, b = jax.lax.fori_loop(0, bisect_iters, bisect_body, (lo, hi))
        x = 0.5 * (a + b)

        def newton_body(_, x):
            fx, dfx = jax.jvp(fn, (x,), (jnp.ones_like(x),))
            step = fx / jnp.where(dfx > 0, dfx, jnp.ones_like(dfx))
            x_new = jnp.clip(x - step, a, b)
            return jnp.where(jnp.isfinite(x_new), x_new, x)

        return jax.lax.fori_loop(0, newton_iters, newton_body, x)

    def _tangent_solve(g, y):
        # g is the linearization of f at the root, elementwise scalar:
        # solve g(x) = y  ⇒  x = y / g(1)
        return y / g(jnp.ones_like(y))

    return jax.lax.custom_root(f, 0.5 * (lo + hi), _solve, _tangent_solve)
