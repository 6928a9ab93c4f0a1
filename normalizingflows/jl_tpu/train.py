"""Training API: the `train_flow` / `optimize` pair.

Reference: `src/NormalizingFlows.jl:51-86` (train_flow) driving
`src/optimize.jl:57-108` (generic SGD loop). Key re-design decisions:

  * No parameter flattening. The reference destructures the flow into a flat
    vector (`src/NormalizingFlows.jl:67`) and notes this blows up compile
    times for deep flows (`:65-66`). Here the flow pytree itself is the
    optimization variable; optax operates leaf-wise.
  * The whole per-iteration body (sample → transform → logdet → target logp
    → grad → Adam update) is ONE jitted `train_step`; iterations are run in
    `lax.scan` chunks so the hot loop never leaves the device. Host work
    (progress display, callbacks, convergence predicate) happens at chunk
    boundaries on fetched stats — the mapping described in SURVEY §3.1.
  * The AD-backend axis of the reference (`src/optimize.jl:8-14`, 5 backends
    via DifferentiationInterface) collapses to `jax.value_and_grad`; the
    "prepare" step maps to jit compilation caching.
  * Base-distribution freezing: the reference marks `@leaf MvNormal` in every
    demo (`test/interface.jl:21`); here `train_base=False` (default) freezes
    `flow.base` via a trainable mask.
"""

from __future__ import annotations

import time
from functools import partial
from typing import Any, Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from .models.distributions import TransformedDistribution
from .utils.pytree import apply_mask, global_norm, trainable_mask

__all__ = [
    "train_flow", "train_flow_mle", "train_flow_annealed",
    "optimize", "TrainResult", "TrainState",
]


class TrainState(NamedTuple):
    """Opaque resumable state (the reference returns opt-state `st` "for
    potential continuation of training", `src/optimize.jl:106-107`)."""

    flow: TransformedDistribution
    opt_state: Any
    iteration: int


class TrainResult(NamedTuple):
    flow: TransformedDistribution
    stats: dict  # {"iteration", "loss", "gradient_norm", ...} 1-D arrays
    state: TrainState


def _default_optimizer() -> optax.GradientTransformation:
    # Reference default: Optimisers.ADAM() == Adam(lr=1e-3)
    # (`src/NormalizingFlows.jl:60`).
    return optax.adam(1e-3)


def _drive_chunks(
    run_chunk: Callable,
    next_input: Callable[[jax.Array, int], Any],
    flow: TransformedDistribution,
    opt_state: Any,
    key: jax.Array,
    start_iter: int,
    max_iters: int,
    check_every: int,
    callback: Callable | None,
    hasconverged: Callable | None,
    show_progress: bool,
    label: str,
) -> TrainResult:
    """Shared host-side chunk driver for both training entry points.

    Per chunk: ``inp = next_input(chunk_key, chunk)`` on the host (PRNG key
    pass-through for reverse-KL; a stacked loader batch for MLE), then
    ``run_chunk(flow, opt_state, inp, chunk)`` — one jitted lax.scan — and
    the chunk-boundary bookkeeping the reference does per-iteration
    (`src/optimize.jl:85-105`): stats, callback merge, convergence
    predicate, progress line.
    """
    all_loss: list[np.ndarray] = []
    all_gnorm: list[np.ndarray] = []
    extra: dict[str, list] = {}
    it = start_iter
    converged = False
    t0 = time.perf_counter()

    while it < start_iter + max_iters and not converged:
        chunk = min(check_every, start_iter + max_iters - it)
        key, sub = jax.random.split(key)
        flow, opt_state, losses, gnorms = run_chunk(
            flow, opt_state, next_input(sub, chunk), chunk
        )
        losses = np.asarray(losses)
        gnorms = np.asarray(gnorms)
        all_loss.append(losses)
        all_gnorm.append(gnorms)
        it += chunk

        stat = {
            "iteration": it,
            "loss": float(losses[-1]),
            "gradient_norm": float(gnorms[-1]),
        }
        if callback is not None:
            merged = callback(it, stat, flow)
            if merged:
                stat.update(merged)
                for k, v in merged.items():
                    extra.setdefault(k, []).append(v)
        if hasconverged is not None:
            converged = bool(hasconverged(it, stat, flow, opt_state))
        if show_progress:
            rate = it / max(time.perf_counter() - t0, 1e-9)
            print(
                f"[{label}] iter {it:>7d}  loss {stat['loss']:+.6f}  "
                f"|g| {stat['gradient_norm']:.3e}  ({rate:.1f} it/s)",
                flush=True,
            )

    loss_arr = np.concatenate(all_loss) if all_loss else np.zeros((0,))
    gnorm_arr = np.concatenate(all_gnorm) if all_gnorm else np.zeros((0,))
    stats = {
        "iteration": np.arange(start_iter + 1,
                               start_iter + 1 + len(loss_arr)),
        "loss": loss_arr,
        "gradient_norm": gnorm_arr,
    }
    for k, v in extra.items():
        stats[k] = np.asarray(v)
    return TrainResult(flow, stats, TrainState(flow, opt_state, it))


def train_flow(
    key: jax.Array,
    objective: Callable[..., jax.Array],
    flow: TransformedDistribution,
    *args: Any,
    max_iters: int = 1000,
    optimizer: optax.GradientTransformation | None = None,
    train_base: bool = False,
    callback: Callable[[int, dict, TransformedDistribution], dict | None]
    | None = None,
    hasconverged: Callable[[int, dict, TransformedDistribution, Any], bool]
    | None = None,
    show_progress: bool = False,
    check_every: int = 100,
    unroll: int = 1,
    resume_state: TrainState | None = None,
    scan_inputs: Callable[[jax.Array, TransformedDistribution, int], Any]
    | None = None,
) -> TrainResult:
    """Train a flow by maximizing ``objective(key, flow, *args)``.

    Mirrors `train_flow(rng, vo, flow, args...; ...)` at
    `src/NormalizingFlows.jl:54-86`: the loss is the negated objective,
    per-iteration stats are ``(iteration, loss, gradient_norm)``
    (`src/optimize.jl:89`), ``callback(i, stats, flow)`` may return a dict
    merged into the stats (`src/optimize.jl:92-95`), and
    ``hasconverged(i, stats, flow, opt_state)`` early-stops the loop
    (`src/optimize.jl:103`). Callback/convergence checks run every
    ``check_every`` iterations (chunk boundary) rather than every iteration
    — the price of keeping the hot loop on-device.

    ``scan_inputs(chunk_key, flow, chunk) -> pytree`` customizes the
    per-step scan input (leading axis = chunk); the objective is called as
    ``objective(input_i, flow, *args)``. Default: split ``chunk_key`` into
    per-step PRNG keys. Pass `objectives.presample_base(n)` (with the
    `elbo_from_samples` objective) to hoist base sampling out of the hot
    loop into one fused chunk-level RNG op. Generation happens INSIDE the
    jitted chunk, so it fuses with the scan either way.
    """
    optimizer = optimizer or _default_optimizer()
    if scan_inputs is None:
        scan_inputs = lambda k, f, n: jax.random.split(k, n)  # noqa: E731

    frozen_pred = None if train_base else (lambda m: m is flow.base)
    mask = trainable_mask(flow, frozen=frozen_pred)

    if resume_state is not None:
        flow = resume_state.flow
        opt_state = resume_state.opt_state
        start_iter = resume_state.iteration
    else:
        opt_state = optimizer.init(flow)
        start_iter = 0

    def loss_fn(f, inp):
        return -objective(inp, f, *args)

    def train_step(carry, inp):
        f, st = carry
        loss_val, grads = jax.value_and_grad(loss_fn)(f, inp)
        grads = apply_mask(grads, mask)
        gnorm = global_norm(grads)
        updates, st = optimizer.update(grads, st, f)
        f = optax.apply_updates(f, updates)
        return (f, st), (loss_val, gnorm)

    @partial(jax.jit, static_argnums=3)
    def run_chunk(f, st, chunk_key, chunk):
        # unroll>1 lets XLA fuse across steps — worth ~25-30% on
        # latency-bound small-model workloads (the reference demo configs);
        # costs compile time on big flows, so default is 1.
        inputs = scan_inputs(chunk_key, f, chunk)
        (f, st), (losses, gnorms) = jax.lax.scan(
            train_step, (f, st), inputs, unroll=unroll
        )
        return f, st, losses, gnorms

    return _drive_chunks(
        run_chunk, lambda sub, chunk: sub, flow, opt_state, key, start_iter,
        max_iters, check_every, callback, hasconverged, show_progress,
        "train_flow",
    )


def train_flow_mle(
    flow: TransformedDistribution,
    loader,
    max_iters: int = 1000,
    optimizer: optax.GradientTransformation | None = None,
    train_base: bool = False,
    check_every: int = 100,
    show_progress: bool = False,
    callback: Callable | None = None,
    hasconverged: Callable[[int, dict, TransformedDistribution, Any], bool]
    | None = None,
    unroll: int = 1,
    resume_state: TrainState | None = None,
) -> TrainResult:
    """Forward-KL (maximum-likelihood) training from a data loader.

    Implements the dataloader variant the reference leaves as a TODO
    (`src/objectives/loglikelihood.jl:35-43`): ``loader`` is any object with
    ``next_batches(k) -> (k, batch, dim)`` (see `utils/data.py` — the
    C++ prefetching `NativeLoader` or the numpy fallback). Each chunk of
    ``check_every`` minibatches is transferred once and scanned on-device;
    the loss is the negated mean log-likelihood (density path §3.4).
    Shares the chunk driver (stats/callback/convergence/progress) with
    `train_flow` — only the per-chunk input source differs.
    """
    from .objectives import loglikelihood

    optimizer = optimizer or _default_optimizer()
    frozen_pred = None if train_base else (lambda m: m is flow.base)
    mask = trainable_mask(flow, frozen=frozen_pred)

    if resume_state is not None:
        flow = resume_state.flow
        opt_state = resume_state.opt_state
        start_iter = resume_state.iteration
    else:
        opt_state = optimizer.init(flow)
        start_iter = 0

    def train_step(carry, batch):
        f, st = carry
        loss_val, grads = jax.value_and_grad(
            lambda f: -loglikelihood(f, batch)
        )(f)
        grads = apply_mask(grads, mask)
        gnorm = global_norm(grads)
        updates, st = optimizer.update(grads, st, f)
        f = optax.apply_updates(f, updates)
        return (f, st), (loss_val, gnorm)

    @partial(jax.jit, static_argnums=3)
    def run_chunk(f, st, batches, chunk):
        (f, st), (losses, gnorms) = jax.lax.scan(train_step, (f, st),
                                                 batches, unroll=unroll)
        return f, st, losses, gnorms

    return _drive_chunks(
        run_chunk, lambda sub, chunk: jnp.asarray(loader.next_batches(chunk)),
        flow, opt_state, jax.random.key(0), start_iter, max_iters,
        check_every, callback, hasconverged, show_progress, "train_flow_mle",
    )


def train_flow_annealed(
    key: jax.Array,
    objective: Callable[..., jax.Array],
    flow: TransformedDistribution,
    logp: Callable[[jax.Array], jax.Array],
    n_samples: int,
    *,
    n_betas: int = 10,
    iters_per_beta: int = 500,
    final_iters: int | None = None,
    ref_logp: Callable[[jax.Array], jax.Array] | None = None,
    optimizer: optax.GradientTransformation | None = None,
    **kwargs: Any,
) -> TrainResult:
    """Annealed (tempered-path) reverse-KL training.

    Trains against ``log p_β = (1−β)·log q_ref + β·log p`` for β ramping
    linearly over ``n_betas`` segments of ``iters_per_beta`` iterations,
    then ``final_iters`` (default ``iters_per_beta``) at β=1. ``q_ref``
    defaults to the flow's base distribution, so the β=0 problem is the
    identity map. Optimizer state and the compiled train step carry across
    segments (β is a traced scalar argument — one compile total).

    Use when direct reverse-KL stalls in a gradient desert between the
    init and the target's mass (far-separated or heavily warped targets).
    New capability; geometric path per standard annealed VI / AIS.
    """
    from .objectives import tempered

    optimizer = optimizer or _default_optimizer()
    ref = ref_logp if ref_logp is not None else flow.base.log_prob
    vo = tempered(objective, ref)

    betas = [j / n_betas for j in range(1, n_betas + 1)]
    state: TrainState | None = kwargs.pop("resume_state", None)
    all_stats: list[dict] = []
    for j, beta in enumerate(betas):
        iters = (final_iters if final_iters is not None else
                 iters_per_beta) if j == n_betas - 1 else iters_per_beta
        key, sub = jax.random.split(key)
        res = train_flow(
            sub, vo, flow, logp, n_samples,
            jnp.asarray(beta, jnp.result_type(float)),
            max_iters=iters, optimizer=optimizer, resume_state=state,
            **kwargs,
        )
        flow, state = res.flow, res.state
        stats = dict(res.stats)
        stats["beta"] = np.full((len(stats["loss"]),), beta)
        all_stats.append(stats)

    merged = {
        k: np.concatenate([s[k] for s in all_stats])
        for k in all_stats[0]
    }
    return TrainResult(flow, merged, state)


def optimize(
    key: jax.Array,
    loss: Callable[..., jax.Array],
    params: Any,
    *args: Any,
    max_iters: int = 10_000,
    optimizer: optax.GradientTransformation | None = None,
    **kwargs: Any,
) -> TrainResult:
    """Generic minimization of ``loss(key, params, *args)`` over a pytree —
    the standalone analogue of `optimize` at `src/optimize.jl:57-108`
    (which `train_flow` wraps). Accepts the same kwargs as `train_flow`."""
    return train_flow(
        key,
        lambda k, p, *a: -loss(k, p, *a),
        params,
        *args,
        max_iters=max_iters,
        optimizer=optimizer,
        train_base=True,
        **kwargs,
    )

