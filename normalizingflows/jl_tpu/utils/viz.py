"""Visualization utilities for flows and 2-D synthetic targets.

JAX counterpart of the reference's example plotting helpers
(`example/utils.jl:5-58`: `compare_trained_and_untrained_flow` scatter
overlay; `example/SyntheticTargets.jl:12-19`: `visualize` pdf contour +
samples). Matplotlib (Agg, headless) instead of Plots.jl; figures are
returned and optionally saved, never shown.

All sampling/density math runs jitted on the accelerator in one batched
call; only the final (n, 2) sample arrays are fetched to the host for
drawing.
"""

from __future__ import annotations

from typing import Sequence

import jax
import numpy as np

__all__ = ["compare_trained_and_untrained_flow", "visualize", "plot_losses"]


def _mpl():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def _draw(dist, key, n_samples: int) -> np.ndarray:
    samples = jax.jit(
        lambda k: dist.sample(k, (n_samples,)), static_argnums=()
    )(key)
    return np.asarray(samples)


def compare_trained_and_untrained_flow(
    flow_trained,
    flow_untrained,
    target,
    key: jax.Array,
    n_samples: int = 1000,
    dims: Sequence[int] = (0, 1),
    save_to: str | None = None,
):
    """Scatter overlay of trained-flow, untrained-flow, and target samples.

    Mirrors `compare_trained_and_untrained_flow` at `example/utils.jl:5-46`
    (same three groups and default sample count). ``dims`` picks the two
    coordinates to plot for d > 2. Returns the matplotlib figure.
    """
    plt = _mpl()
    k1, k2, k3 = jax.random.split(key, 3)
    groups = [
        (_draw(flow_trained, k1, n_samples), "trained flow", "tab:blue", 0.5),
        (_draw(flow_untrained, k2, n_samples), "untrained flow",
         "tab:orange", 0.3),
        (_draw(target, k3, n_samples), "target", "tab:green", 0.5),
    ]
    i, j = dims
    fig, ax = plt.subplots(figsize=(6, 6))
    for samples, label, color, alpha in groups:
        ax.scatter(samples[:, i], samples[:, j], s=6, alpha=alpha,
                   color=color, label=label, linewidths=0)
    ax.set_xlabel(f"x[{i}]")
    ax.set_ylabel(f"x[{j}]")
    ax.legend(loc="best")
    ax.set_title("trained vs untrained flow vs target")
    fig.tight_layout()
    if save_to:
        fig.savefig(save_to, dpi=120)
    return fig


def visualize(
    target,
    samples: np.ndarray | jax.Array | None = None,
    key: jax.Array | None = None,
    n_samples: int = 1000,
    grid_lims: tuple[float, float, float, float] | None = None,
    grid_res: int = 200,
    save_to: str | None = None,
):
    """Density contour of a 2-D target with samples overlaid.

    Mirrors `visualize(p, samples)` at `example/SyntheticTargets.jl:12-19`
    (pdf contour + scatter). ``samples`` defaults to draws from the target;
    ``grid_lims`` (x0, x1, y0, y1) defaults to the sample bounding box
    padded 10%. Returns the matplotlib figure.
    """
    plt = _mpl()
    if samples is None:
        if key is None:
            key = jax.random.key(0)
        samples = _draw(target, key, n_samples)
    samples = np.asarray(samples)

    if grid_lims is None:
        lo = samples.min(axis=0)
        hi = samples.max(axis=0)
        pad = 0.1 * (hi - lo)
        grid_lims = (lo[0] - pad[0], hi[0] + pad[0],
                     lo[1] - pad[1], hi[1] + pad[1])
    xg = np.linspace(grid_lims[0], grid_lims[1], grid_res)
    yg = np.linspace(grid_lims[2], grid_lims[3], grid_res)
    xx, yy = np.meshgrid(xg, yg)
    pts = np.stack([xx.ravel(), yy.ravel()], axis=-1)
    logp = np.asarray(jax.jit(target.log_prob)(pts)).reshape(xx.shape)

    fig, ax = plt.subplots(figsize=(6, 6))
    ax.contourf(xx, yy, np.exp(logp), levels=30, cmap="viridis")
    ax.scatter(samples[:, 0], samples[:, 1], s=4, alpha=0.4, color="white",
               linewidths=0)
    ax.set_xlabel("x[0]")
    ax.set_ylabel("x[1]")
    fig.tight_layout()
    if save_to:
        fig.savefig(save_to, dpi=120)
    return fig


def plot_losses(stats: dict, save_to: str | None = None):
    """Training-loss curve from `TrainResult.stats` (the reference demos
    plot `map(x -> x.loss, stats)`, `example/demo_planar_flow.jl:50-55`)."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(7, 4))
    ax.plot(np.asarray(stats["iteration"]), np.asarray(stats["loss"]),
            lw=0.8)
    ax.set_xlabel("iteration")
    ax.set_ylabel("loss (−objective)")
    ax.set_yscale("symlog")
    fig.tight_layout()
    if save_to:
        fig.savefig(save_to, dpi=120)
    return fig
