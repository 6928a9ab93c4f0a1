"""Config subsystem: JSON round-trip, build, and end-to-end run.

SURVEY §5 ("Config / flag system"): the reference exposes every knob as a
keyword argument with defaults; this build packages them as dataclass
configs. These tests pin (a) serialization round-trip exactness, (b) that
`FlowConfig.build` hits every family with reference defaults, (c) that a
tiny `TrainConfig.run` improves the objective.
"""

import dataclasses

import jax
import jax.numpy as jnp
import pytest

import normalizingflows as nf
from normalizingflows.jl_tpu.config import (
    FlowConfig,
    OptimizerConfig,
    TrainConfig,
    config_from_json,
    config_to_json,
)


def test_json_roundtrip():
    cfg = TrainConfig(
        flow=FlowConfig(family="nsf", dim=3, nlayers=2, hdims=(8, 8), K=5,
                        B=4.0),
        optimizer=OptimizerConfig(learning_rate=3e-4),
        max_iters=50,
        n_samples=8,
        objective="elbo_stl",
        seed=7,
    )
    s = config_to_json(cfg)
    cfg2 = config_from_json(s)
    assert cfg2 == cfg
    # defaults round-trip too
    assert config_from_json(config_to_json(TrainConfig())) == TrainConfig()


@pytest.mark.parametrize("family", ["planar", "radial", "realnvp", "nsf",
                                    "maf", "iaf", "glow"])
def test_build_families(family):
    cfg = FlowConfig(family=family, dim=3, nlayers=2, hdims=(8, 8), K=5,
                     B=4.0)
    flow = cfg.build(jax.random.key(0))
    x = flow.sample(jax.random.key(1), (4,))
    assert x.shape == (4, 3)
    lp = flow.log_prob(x)
    assert lp.shape == (4,) and bool(jnp.all(jnp.isfinite(lp)))


def test_build_hamiltonian_needs_score():
    cfg = FlowConfig(family="hamiltonian", dim=2, nlayers=2)
    with pytest.raises(ValueError, match="score"):
        cfg.build(jax.random.key(0))
    target = nf.Funnel(2, 0.0, 3.0)
    flow = cfg.build(jax.random.key(0), score_fn=target.score)
    x = flow.sample(jax.random.key(1), (4,))
    assert x.shape == (4, 4)  # joint (x, ρ) space


@pytest.mark.parametrize("family,objective", [
    ("maf", "elbo_batch"), ("iaf", "elbo_stl"), ("glow", "elbo_iw"),
])
def test_run_new_families_json_roundtrip(family, objective):
    """VERDICT r3 item 8: each new family round-trips JSON → build → a few
    train steps."""
    target = nf.Banana(2, 1.0, 10.0)
    cfg = TrainConfig(
        flow=FlowConfig(family=family, dim=2, nlayers=2, hdims=(8, 8)),
        optimizer=OptimizerConfig(learning_rate=1e-2),
        max_iters=10,
        n_samples=8,
        objective=objective,
        check_every=10,
        seed=1,
    )
    cfg2 = config_from_json(config_to_json(cfg))
    assert cfg2 == cfg
    res = cfg2.run(target.log_prob)
    assert res.stats["loss"].shape == (10,)
    assert bool(jnp.all(jnp.isfinite(res.stats["loss"])))


def test_run_hamiltonian_config():
    target = nf.Funnel(2, 0.0, 3.0)
    cfg = TrainConfig(
        flow=FlowConfig(family="hamiltonian", dim=2, nlayers=2,
                        dtype="float64"),
        optimizer=OptimizerConfig(learning_rate=1e-3),
        max_iters=5, n_samples=4, objective="elbo", check_every=5, seed=0,
    )
    cfg2 = config_from_json(config_to_json(cfg))
    assert cfg2 == cfg

    def logp_joint(z):
        x, rho = z[..., :2], z[..., 2:]
        return target.log_prob(x) - 0.5 * jnp.sum(rho * rho, axis=-1) \
            - rho.shape[-1] / 2 * jnp.log(2 * jnp.pi)

    res = cfg2.run(logp_joint, score_fn=target.score)
    assert bool(jnp.all(jnp.isfinite(res.stats["loss"])))


def test_run_rejects_unknown_objective():
    cfg = TrainConfig(objective="loglikelihood")
    with pytest.raises(ValueError, match="objective"):
        cfg.run(lambda x: x.sum())


def test_run_improves_elbo():
    target = nf.Banana(2, 1.0, 10.0)
    cfg = TrainConfig(
        flow=FlowConfig(family="realnvp", dim=2, nlayers=2, hdims=(8, 8)),
        optimizer=OptimizerConfig(learning_rate=1e-2),
        max_iters=300,
        n_samples=32,
        check_every=100,
        seed=1,
    )
    res = cfg.run(target.log_prob)
    losses = res.stats["loss"]
    assert losses.shape == (300,)
    assert losses[-50:].mean() < losses[:50].mean()


def test_run_mle_end_to_end(tmp_path):
    """`TrainConfig(objective='mle')` trains forward-KL from data through
    `train_flow_mle` (VERDICT r4 item 9: the MLE path was config-
    unreachable), from an in-memory array AND from a data_path; the
    config round-trips through JSON with the MLE fields."""
    import numpy as np

    target = nf.Banana(2, 1.0, 10.0)
    data = np.asarray(target.sample(jax.random.key(0), (2048,)))

    cfg = TrainConfig(
        flow=FlowConfig(family="maf", dim=2, nlayers=2, hdims=(16, 16)),
        optimizer=OptimizerConfig(learning_rate=5e-3),
        objective="mle",
        max_iters=200,
        batch_size=256,
        check_every=100,
        seed=2,
    )
    cfg2 = config_from_json(config_to_json(cfg))
    assert cfg2 == cfg

    res = cfg.run(data=data)
    losses = res.stats["loss"]
    assert losses.shape == (200,)
    assert losses[-50:].mean() < losses[:50].mean()

    # data_path variant (npy file), and target_logp must not be required
    p = str(tmp_path / "banana.npy")
    np.save(p, data)
    cfg3 = dataclasses.replace(cfg, data_path=p, max_iters=50)
    res3 = cfg3.run()
    assert res3.stats["loss"].shape == (50,)

    with pytest.raises(ValueError, match="needs data"):
        dataclasses.replace(cfg, data_path=None).run()
