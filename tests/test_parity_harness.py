"""Smoke the parity harness machinery on CPU: tiny-iter run of one
workload exercises training, multi-rep ELBO eval, moment + sliced-W2 +
grid-TV metrics, figure emission, JSON persistence, and report rendering
— so the parity deliverable can't bit-rot between runs on the card.
"""

import importlib.util
import json
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture()
def parity(tmp_path, monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "parity", ROOT / "benchmarks" / "parity.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules["parity"] = mod
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod, "JSON_PATH", tmp_path / "PARITY.json")
    monkeypatch.setattr(mod, "MD_PATH", tmp_path / "PARITY.md")
    monkeypatch.setattr(mod, "FIG_DIR", tmp_path / "figures")
    monkeypatch.setattr(mod, "N_EVAL", 256)
    monkeypatch.setattr(mod, "N_MOMENT", 2048)
    return mod


def test_parity_workload_end_to_end(parity):
    entry = parity.realnvp(30)
    parity.save(entry)

    required = {
        "workload", "iters", "elbo_before", "elbo_after",
        "elbo_before_sem", "elbo_after_sem", "elbo_train_tail",
        "mean_flow", "std_flow", "sliced_w2",
        "sliced_w2_floor", "grid_tv", "grid_tv_floor", "figure",
        "improved_significant", "device",
    }
    assert required <= set(entry), required - set(entry)
    assert entry["iters"] == 30
    # TV is a probability distance; floors are the identical-distribution
    # MC baselines and must be below/comparable to the achieved values
    assert 0.0 <= entry["grid_tv_floor"] <= 1.0
    assert 0.0 <= entry["grid_tv"] <= 1.0
    assert entry["sliced_w2_floor"] >= 0.0
    if entry["figure"] is not None:
        assert (parity.FIG_DIR / "realnvp_banana_hard.png").exists()

    data = json.loads(parity.JSON_PATH.read_text())
    assert "realnvp_banana_hard" in data

    parity.report()
    md = parity.MD_PATH.read_text()
    assert "realnvp_banana_hard" in md and "SW₂" in md
