"""The device capability module (`device.py`): kernel choice, mixed-dtype
dots, the compile-cache rule — and the GPU-only measurement scripts'
refusal to run anywhere else."""

import importlib.util
import pathlib
import sys

import jax
import jax.numpy as jnp
import pytest

import normalizingflows as nf
from normalizingflows.jl_tpu import device
from normalizingflows.jl_tpu.models.nets import Dense

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _load(path):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[path.stem] = mod
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("platform,kernel", [("gpu", True), ("cpu", False)])
def test_auto_backend_follows_device(monkeypatch, platform, kernel):
    """`backend="auto"` traces the fused kernel on the GPU and the jnp
    oracle elsewhere, decided by `device.use_rqs_kernel` alone."""
    monkeypatch.setattr(device, "platform", lambda: platform)
    assert device.use_rqs_kernel() == kernel
    for scan in (True, False):
        flow = nf.nsf(jax.random.key(0), 4, (8,), K=4, nlayers=1, scan=scan)
        jaxpr = jax.make_jaxpr(flow.bijector.forward_and_log_det)(
            jnp.zeros((8, 4), jnp.float32))
        assert ("pallas_call" in str(jaxpr)) == kernel


@pytest.mark.parametrize("platform,acc", [("gpu", jnp.float32),
                                          ("cpu", jnp.bfloat16)])
def test_mixed_dense_accumulates_in_f32_off_cpu(monkeypatch, platform, acc):
    """The bf16 Dense asks for an f32 product (bf16×bf16→f32) everywhere
    but on the CPU, which has no mixed-dtype dot."""
    monkeypatch.setattr(device, "platform", lambda: platform)
    d = Dense.make(jax.random.key(0), 8, 4, compute_dtype=jnp.bfloat16)
    jaxpr = jax.make_jaxpr(d)(jnp.ones((2, 8), jnp.float32))
    dots = [e for e in jaxpr.jaxpr.eqns if e.primitive.name == "dot_general"]
    if not dots:  # inside the custom_vjp call
        inner = next(e for e in jaxpr.jaxpr.eqns
                     if "custom_vjp" in e.primitive.name)
        dots = [e for e in inner.params["call_jaxpr"].jaxpr.eqns
                if e.primitive.name == "dot_general"]
    assert [e.outvars[0].aval.dtype for e in dots] == [jnp.dtype(acc)]


def test_compile_cache_follows_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert device.init_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # JAX reads env


def test_compile_cache_defaults_to_repo(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        assert device.init_compile_cache() == str(ROOT / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == str(
            ROOT / ".jax_cache")
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_peaks_refuse_unknown_device_kind():
    roofline = _load(ROOT / "benchmarks" / "roofline.py")
    assert roofline.peaks("NVIDIA H100 80GB HBM3")["bf16"] == 989e12
    with pytest.raises(KeyError, match="no published peaks"):
        roofline.peaks("cpu")


@pytest.mark.parametrize("script", ["bench.py", "benchmarks/roofline.py",
                                    "benchmarks/nsf_kernel_ab.py"])
def test_measurements_refuse_cpu(script, capsys):
    """A measurement that finds no GPU fails and prints no result."""
    mod = _load(ROOT / script)
    argv = [] if script != "bench.py" else None
    rc = mod.main() if argv is None else mod.main(argv)
    assert rc != 0
    assert capsys.readouterr().out == ""
