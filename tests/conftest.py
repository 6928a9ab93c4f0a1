"""Test configuration: CPU backend with an 8-device virtual mesh + x64.

Multi-device tests run on a CPU-emulated mesh
(`--xla_force_host_platform_device_count=8`), and float64 is enabled so the
reference's Float64 tolerance tier (`test/flow.jl`, rtol 1e-6) can be
checked exactly. The platform is pinned before JAX is imported, so no test
process (xdist workers included) ever opens a GPU; on-card checks live in
`chip_smoke.py`.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8"
)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

# Persistent compilation cache (JAX_COMPILATION_CACHE_DIR if set, else
# <repo>/.jax_cache): XLA-CPU compiles dominate test wall-clock on small
# hosts; cache them across pytest processes.
from normalizingflows.jl_tpu.device import init_compile_cache  # noqa: E402

init_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

import pytest  # noqa: E402


@pytest.fixture(params=["float32", "float64"])
def dtype(request):
    import jax.numpy as jnp

    return {"float32": jnp.float32, "float64": jnp.float64}[request.param]


@pytest.fixture
def key():
    return jax.random.key(0)
