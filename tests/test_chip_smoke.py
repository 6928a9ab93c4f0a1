"""`chip_smoke.py` pieces that run on the CPU: the final-line contract, the
refusal to run without a GPU, and the sharded-vs-per-shard equality that
its four-card phase checks, here on four virtual CPU devices."""

import importlib.util
import json
import pathlib
import sys

import jax
import pytest

import normalizingflows as nf
from normalizingflows.jl_tpu.parallel import batch_mesh

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = mod
    spec.loader.exec_module(mod)
    return mod


def test_result_line_is_the_contract(smoke):
    line = smoke.result_line("gpu", "NVIDIA H100 80GB HBM3", 1)
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}


@pytest.mark.parametrize("platform", ["cpu", "rocm"])
def test_result_line_refuses_other_platforms(smoke, platform):
    with pytest.raises(ValueError, match="GPU runs only"):
        smoke.result_line(platform, "x", 1)


def test_main_without_gpu_fails_and_prints_nothing(smoke, capsys):
    assert smoke.main([]) != 0
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("family", ["nsf", "realnvp"])
def test_sharded_step_matches_per_shard_reference(smoke, family):
    """`shard_objective` over a 4-device mesh equals the objective evaluated
    on fold_in(key, i) with n/4 samples per shard on one device, averaged —
    in loss and gradient — and every shard lands on its own device."""
    dim = 4
    make = {"nsf": lambda k: nf.nsf(k, dim, (8, 8), K=4, nlayers=2),
            "realnvp": lambda k: nf.realnvp(k, dim, (8, 8), nlayers=2)}
    flow = make[family](jax.random.key(0))
    logp = nf.Banana(dim, 1.0, 10.0).log_prob
    d_loss, d_grad, devices = smoke.sharded_matches_reference(
        flow, logp, 64, batch_mesh(4))
    assert len(devices) == 4
    assert d_loss <= smoke.SHARD_LOSS_RTOL
    assert d_grad <= smoke.SHARD_GRAD_RTOL
