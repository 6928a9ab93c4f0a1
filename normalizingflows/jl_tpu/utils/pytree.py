"""Pytree module system: frozen dataclasses registered as JAX pytrees.

This is the JAX replacement for the reference's Functors.jl machinery
(`@functor` registration, `Optimisers.destructure`, `@leaf` freezing — see
reference `src/NormalizingFlows.jl:67` and `test/interface.jl:21`). Instead of
flattening parameters to a single vector, modules ARE pytrees: `jax.grad`,
`optax`, and `jax.jit` consume them directly. Trainability is expressed with a
boolean mask pytree (`trainable_mask`), mirroring Optimisers.jl's
`trainable(model)` protocol and Functors' `@leaf` freezing.

Design notes:
  * Static fields (ints, tuples, callables, strings) go to pytree aux data so
    they become compile-time constants under `jit` — no dynamic shapes.
  * Data fields are jnp arrays (or sub-modules); they are traced.
  * Modules are immutable (frozen dataclasses); updates via `replace`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, TypeVar

import jax
import jax.numpy as jnp

T = TypeVar("T")

__all__ = [
    "Module",
    "module",
    "static_field",
    "field",
    "replace",
    "trainable_mask",
    "apply_mask",
    "tree_size",
    "global_norm",
    "destructure",
]


def static_field(**kwargs: Any) -> Any:
    """A dataclass field stored as pytree aux data (compile-time constant)."""
    metadata = dict(kwargs.pop("metadata", {}) or {})
    metadata["static"] = True
    return dataclasses.field(metadata=metadata, **kwargs)


def field(**kwargs: Any) -> Any:
    """A regular (traced, differentiable) dataclass field."""
    return dataclasses.field(**kwargs)


class Module:
    """Base class for all pytree modules.

    Subclasses are declared with the :func:`module` decorator. The optional
    class attribute ``__trainable__`` names the data fields that participate
    in gradient-based training (``None`` means all data fields are trainable),
    mirroring the reference's Optimisers.trainable protocol
    (e.g. ``@functor AffineCoupling (s, t)`` at reference
    `src/flows/realnvp.jl:40`).
    """

    __trainable__: tuple | None = None


def module(cls: type) -> type:
    """Class decorator: frozen dataclass + JAX pytree registration."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    data_fields = [
        f.name for f in dataclasses.fields(cls) if not f.metadata.get("static")
    ]
    meta_fields = [
        f.name for f in dataclasses.fields(cls) if f.metadata.get("static")
    ]
    jax.tree_util.register_dataclass(
        cls, data_fields=data_fields, meta_fields=meta_fields
    )
    cls.__data_fields__ = tuple(data_fields)
    cls.__meta_fields__ = tuple(meta_fields)
    return cls


replace = dataclasses.replace


def _mask_tree(obj: Any, on: bool) -> Any:
    """Build a pytree of booleans matching ``obj``'s structure.
    Recurses through plain containers (tuple/list/dict) so a Module nested
    inside e.g. `Chain.bijectors` still has its ``__trainable__``
    declaration honored."""
    if isinstance(obj, Module):
        tr = type(obj).__trainable__
        kwargs = {}
        for name in obj.__data_fields__:
            sub_on = on and (tr is None or name in tr)
            kwargs[name] = _mask_tree(getattr(obj, name), sub_on)
        for name in obj.__meta_fields__:
            kwargs[name] = getattr(obj, name)
        return type(obj)(**kwargs)
    if isinstance(obj, (tuple, list)) and not hasattr(obj, "_fields"):
        return type(obj)(_mask_tree(v, on) for v in obj)
    if hasattr(obj, "_fields"):  # namedtuple
        return type(obj)(*(_mask_tree(v, on) for v in obj))
    if isinstance(obj, dict):
        return {k: _mask_tree(v, on) for k, v in obj.items()}
    leaves_treedef = jax.tree_util.tree_structure(obj)
    if leaves_treedef.num_leaves == 0:
        return obj
    if jax.tree_util.treedef_is_leaf(leaves_treedef):
        return on
    return jax.tree_util.tree_map(lambda _: on, obj)


def trainable_mask(tree: Any, frozen: Callable[[Any], bool] | None = None) -> Any:
    """Boolean pytree: True where a leaf is trainable.

    ``frozen`` is an optional predicate on sub-modules; any module for which it
    returns True contributes an all-False subtree (the pytree equivalent of the
    reference's ``@leaf MvNormal`` freezing at `test/interface.jl:21`).
    """
    if frozen is None:
        # __trainable__ declarations (e.g. InvertibleLinear's frozen
        # permutation) must hold even with no frozen predicate
        def frozen(m):
            return False

    def rec(obj: Any, on: bool) -> Any:
        if frozen(obj):
            return _mask_tree(obj, False)
        if isinstance(obj, Module):
            tr = type(obj).__trainable__
            kwargs = {}
            for name in obj.__data_fields__:
                sub_on = on and (tr is None or name in tr)
                kwargs[name] = rec(getattr(obj, name), sub_on)
            for name in obj.__meta_fields__:
                kwargs[name] = getattr(obj, name)
            return type(obj)(**kwargs)
        if isinstance(obj, (tuple, list)) and not hasattr(obj, "_fields"):
            return type(obj)(rec(v, on) for v in obj)
        if hasattr(obj, "_fields"):  # namedtuple
            return type(obj)(*(rec(v, on) for v in obj))
        if isinstance(obj, dict):
            return {k: rec(v, on) for k, v in obj.items()}
        return _mask_tree(obj, on)

    return rec(tree, True)


def apply_mask(grads: Any, mask: Any) -> Any:
    """Zero out gradient leaves where the mask is False."""
    return jax.tree_util.tree_map(
        lambda g, m: g if m else jnp.zeros_like(g), grads, mask
    )


def tree_size(tree: Any) -> int:
    """Total number of scalar parameters in a pytree."""
    return sum(
        leaf.size for leaf in jax.tree_util.tree_leaves(tree)
        if hasattr(leaf, "size")
    )


def global_norm(tree: Any) -> jax.Array:
    """L2 norm over all leaves (the reference reports `norm(g)` per step,
    `src/optimize.jl:89`)."""
    leaves = [
        jnp.sum(jnp.square(leaf)) for leaf in jax.tree_util.tree_leaves(tree)
    ]
    if not leaves:
        return jnp.zeros(())
    return jnp.sqrt(sum(leaves))


def destructure(tree: T) -> tuple[jax.Array, Callable[[jax.Array], T]]:
    """Flatten a module/pytree to ``(theta, re)`` with ``re(theta)`` the
    reconstructor — API parity with `Optimisers.destructure`
    (reference `src/NormalizingFlows.jl:67`).

    The reference trains in this flattened form; here it exists for
    diagnostics and interop only (SURVEY §1: the idiomatic JAX optimization
    variable is the pytree itself — flattening every step would defeat
    XLA's per-leaf layout choices and recompile on any structure change).
    Static fields ride along in the closure, so ``re`` rebuilds the exact
    module type.
    """
    from jax.flatten_util import ravel_pytree

    theta, re = ravel_pytree(tree)
    return theta, re
