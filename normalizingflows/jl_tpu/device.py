"""Device capabilities and process set-up: the one place that asks what the
device can do.

Models call `use_rqs_kernel` and `mixed_dot_supported` at trace time instead
of testing the backend themselves, so the decision lives here and tests can
monkeypatch `platform`.
"""

from __future__ import annotations

import os
import pathlib

import jax

__all__ = ["platform", "use_rqs_kernel", "mixed_dot_supported",
           "init_compile_cache", "DEFAULT_CACHE_DIR"]

# <repo>/.jax_cache (listed in .gitignore): a fixed path, so the cache's
# keys stay stable from one process to the next
DEFAULT_CACHE_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def platform() -> str:
    """The default backend's platform: "gpu", "cpu", ..."""
    return jax.default_backend()


def use_rqs_kernel() -> bool:
    """Whether `backend="auto"` splines run the fused Triton RQS kernel."""
    return platform() == "gpu"


def mixed_dot_supported() -> bool:
    """Whether a bf16×bf16→f32 dot (`preferred_element_type`) compiles.
    XLA:CPU has no mixed-dtype dot thunk."""
    return platform() != "cpu"


def init_compile_cache(default_dir: str | os.PathLike = DEFAULT_CACHE_DIR
                       ) -> str:
    """Turn on JAX's persistent compilation cache.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing
    is set here. Otherwise the cache goes to ``default_dir``. Returns the
    directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(default_dir))
    return str(default_dir)
