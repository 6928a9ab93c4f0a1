"""Declarative experiment configs (flows, optimizer, training loop).

The reference has no config system — every knob is a keyword argument with
a documented default (`src/NormalizingFlows.jl:59-62`, `src/optimize.jl:63-71`,
flow-constructor defaults in `src/flows/*.jl`). SURVEY §5 calls for
dataclass-style config objects mirroring those knobs: this module provides
them, with JSON round-tripping so a whole experiment (flow family +
hyperparameters + optimizer + loop settings) can be stored next to a
checkpoint and rebuilt exactly.

Every config is a plain frozen dataclass: `to_dict()`/`from_dict()` are
inverse, `FlowConfig.build(key)` constructs the flow, `TrainConfig.run(...)`
drives `train_flow`. Defaults equal the reference defaults cited per field.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Any, Callable, Sequence

import jax
import jax.numpy as jnp
import optax

from .models.autoregressive import iaf, maf
from .models.coupling import realnvp
from .models.linear import glow
from .models.hamiltonian import hamiltonian_flow
from .models.planar_radial import planarflow, radialflow
from .models.spline import nsf
from .train import TrainResult, train_flow

__all__ = [
    "FlowConfig",
    "OptimizerConfig",
    "TrainConfig",
    "config_to_json",
    "config_from_json",
]

_DTYPES = {"float32": jnp.float32, "float64": jnp.float64,
           "bfloat16": jnp.bfloat16}


@dataclass(frozen=True)
class FlowConfig:
    """Which flow to build, with the reference's constructor defaults.

    ``family``: 'planar' | 'radial' | 'realnvp' | 'nsf' | 'maf' | 'iaf' |
    'glow' | 'hamiltonian'.
    Defaults per family (reference `src/flows/planar_radial.jl:21-29,52-60`,
    `realnvp.jl:190-192`, `neuralspline.jl:232-234`): 10 layers; RealNVP/NSF
    conditioner hdims [32, 32]; NSF K=10 knots, B=30 box bound. For
    'hamiltonian', ``nlayers`` is the block count and the target's score
    function must be passed to :meth:`build` (it is code, not config —
    reference `demo_hamiltonian_flow.jl:128`).
    """

    family: str = "realnvp"
    dim: int = 2
    nlayers: int = 10
    hdims: tuple = (32, 32)
    K: int = 10
    B: float = 30.0
    dtype: str = "float32"  # the reference's `paramtype` knob
    leapfrog_steps: int = 3    # hamiltonian: L per block
    leapfrog_eps0: float = 0.05  # hamiltonian: initial step size

    def build(self, key: jax.Array, score_fn: Callable | None = None):
        dt = _DTYPES[self.dtype]
        if self.family == "planar":
            return planarflow(key, self.dim, self.nlayers, dtype=dt)
        if self.family == "radial":
            return radialflow(key, self.dim, self.nlayers, dtype=dt)
        if self.family == "realnvp":
            return realnvp(key, self.dim, tuple(self.hdims),
                           nlayers=self.nlayers, dtype=dt)
        if self.family == "nsf":
            return nsf(key, self.dim, tuple(self.hdims), K=self.K, B=self.B,
                       nlayers=self.nlayers, dtype=dt)
        if self.family == "maf":
            return maf(key, self.dim, tuple(self.hdims),
                       nlayers=self.nlayers, dtype=dt)
        if self.family == "iaf":
            return iaf(key, self.dim, tuple(self.hdims),
                       nlayers=self.nlayers, dtype=dt)
        if self.family == "glow":
            return glow(key, self.dim, tuple(self.hdims),
                        nlayers=self.nlayers, dtype=dt)
        if self.family == "hamiltonian":
            if score_fn is None:
                raise ValueError(
                    "family='hamiltonian' needs the target's score function: "
                    "FlowConfig.build(key, score_fn=jax.grad(target.log_prob))"
                )
            return hamiltonian_flow(
                self.dim, score_fn, n_blocks=self.nlayers,
                L=self.leapfrog_steps, eps0=self.leapfrog_eps0, dtype=dt)
        raise ValueError(f"unknown flow family {self.family!r}")


@dataclass(frozen=True)
class OptimizerConfig:
    """Optax rule by name. Reference default: `Optimisers.ADAM()` ==
    Adam(1e-3) (`src/NormalizingFlows.jl:60`)."""

    name: str = "adam"
    learning_rate: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def build(self) -> optax.GradientTransformation:
        if self.name == "adam":
            return optax.adam(self.learning_rate, b1=self.b1, b2=self.b2,
                              eps=self.eps)
        if self.name == "sgd":
            return optax.sgd(self.learning_rate)
        if self.name == "adamw":
            return optax.adamw(self.learning_rate, b1=self.b1, b2=self.b2,
                               eps=self.eps)
        raise ValueError(f"unknown optimizer {self.name!r}")


@dataclass(frozen=True)
class TrainConfig:
    """Loop knobs of `train_flow` (reference kwargs at
    `src/NormalizingFlows.jl:59-62` / `src/optimize.jl:63-71`)."""

    flow: FlowConfig = dataclasses.field(default_factory=FlowConfig)
    optimizer: OptimizerConfig = dataclasses.field(
        default_factory=OptimizerConfig)
    max_iters: int = 1000       # train_flow default (optimize's is 10_000)
    n_samples: int = 32         # MC samples per iteration
    # 'elbo'|'elbo_batch'|'elbo_stl'|'elbo_iw' (reverse KL), or 'mle'
    # (forward KL from data via `train_flow_mle` — the dataloader path the
    # reference leaves as a TODO, `src/objectives/loglikelihood.jl:35-43`)
    objective: str = "elbo_batch"
    check_every: int = 100
    show_progress: bool = False
    train_base: bool = False    # the reference's `@leaf MvNormal` freezing
    unroll: int = 1
    seed: int = 0
    # MLE-only knobs: dataset (path to a raw/npy file or in-memory array
    # passed to run(data=...)) and minibatch size
    data_path: str | None = None
    batch_size: int = 128

    def run(self, target_logp: Callable[[jax.Array], jax.Array] | None = None,
            score_fn: Callable | None = None,
            data: Any | None = None,
            **overrides: Any) -> TrainResult:
        """Build the flow and train it.

        Reverse-KL objectives train against ``target_logp``; for
        ``objective='mle'`` pass ``data`` (an (n, dim) array) or set
        ``data_path`` in the config — the flow maximizes data
        log-likelihood through `train_flow_mle` and ``target_logp`` is
        unused. ``score_fn`` is required for (and only used by) the
        hamiltonian family — pass the target's ∇logp."""
        from . import objectives

        key = jax.random.key(self.seed)
        kb, kt = jax.random.split(key)
        flow = self.flow.build(kb, score_fn=score_fn)

        if self.objective == "mle":
            from .train import train_flow_mle
            from .utils.data import make_loader

            source = data if data is not None else self.data_path
            if source is None:
                raise ValueError(
                    "objective='mle' needs data: pass run(data=array) or "
                    "set TrainConfig.data_path")
            loader = make_loader(source, self.batch_size)
            kwargs = dict(
                max_iters=self.max_iters,
                optimizer=self.optimizer.build(),
                train_base=self.train_base,
                check_every=self.check_every,
                show_progress=self.show_progress,
                unroll=self.unroll,
            )
            kwargs.update(overrides)
            try:
                return train_flow_mle(flow, loader, **kwargs)
            finally:
                loader.close()

        if self.objective not in ("elbo", "elbo_batch", "elbo_stl",
                                  "elbo_iw"):
            raise ValueError(f"unknown objective {self.objective!r}")
        if target_logp is None:
            raise ValueError(
                f"objective={self.objective!r} needs target_logp")
        vo = getattr(objectives, self.objective)
        # overrides may replace config-set knobs, not just add new kwargs
        kwargs = dict(
            max_iters=self.max_iters,
            optimizer=self.optimizer.build(),
            train_base=self.train_base,
            check_every=self.check_every,
            show_progress=self.show_progress,
            unroll=self.unroll,
        )
        kwargs.update(overrides)
        return train_flow(kt, vo, flow, target_logp, self.n_samples,
                          **kwargs)


def _to_dict(cfg: Any) -> Any:
    if dataclasses.is_dataclass(cfg):
        return {f.name: _to_dict(getattr(cfg, f.name))
                for f in dataclasses.fields(cfg)}
    if isinstance(cfg, (tuple, list)):
        return [_to_dict(v) for v in cfg]
    return cfg


def config_to_json(cfg: Any) -> str:
    """Serialize any config dataclass to JSON."""
    return json.dumps(_to_dict(cfg), indent=2)


def _coerce(cls: type, data: dict) -> Any:
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in data:
            continue
        v = data[f.name]
        if dataclasses.is_dataclass(f.type) or f.name in ("flow", "optimizer"):
            sub = {"flow": FlowConfig, "optimizer": OptimizerConfig}[f.name]
            v = _coerce(sub, v)
        elif isinstance(v, list):
            v = tuple(v)
        kwargs[f.name] = v
    return cls(**kwargs)


def config_from_json(s: str, cls: type = TrainConfig) -> Any:
    """Rebuild a config dataclass from `config_to_json` output."""
    return _coerce(cls, json.loads(s))
