"""Parity harness: run the five reference demo workloads to convergence and
record ELBO + posterior-moment parity (BASELINE.md / SURVEY.md §7 step 7).

The reference publishes no numbers (README.md:88 "- [ ] benchmarking"), so
parity is defined against the exact synthetic targets themselves: a trained
flow must (a) reach a final ELBO within MC error of the best observed for
that workload and (b) reproduce the target's per-coordinate mean/std within
MC error. Workload configs replicate the reference demos exactly (file:line
in WORKLOADS).

Usage:
    python benchmarks/parity.py --workload realnvp --iters 50000
    python benchmarks/parity.py --workload all --quick   # CI-speed pass
    python benchmarks/parity.py --report                 # PARITY.md from json

Results append to benchmarks/PARITY.json (one entry per workload, newest
wins) and --report renders benchmarks/PARITY.md.
"""

from __future__ import annotations

import argparse
import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import optax

import normalizingflows as nf

HERE = Path(__file__).resolve().parent
JSON_PATH = HERE / "PARITY.json"
MD_PATH = HERE / "PARITY.md"
FIG_DIR = HERE / "figures"

N_EVAL = 4096     # MC samples for final ELBO estimates
N_MOMENT = 65536  # samples for moment comparison


def _moments(samples):
    mean = jnp.mean(samples, axis=0)
    std = jnp.std(samples, axis=0)
    return mean, std


def _figure(name, trained, untrained, target_samples):
    """Trained-vs-untrained-vs-target scatter overlay PNG — the evidence
    format of the reference docs (`docs/src/comparison.png`,
    `PlanarFlow.md:102-125`). Returns the saved path (or None headless)."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return None
    FIG_DIR.mkdir(exist_ok=True)
    fig, ax = plt.subplots(figsize=(6, 6))
    n = 4096
    for s, label, color, alpha in [
        (target_samples, "target", "tab:green", 0.35),
        (untrained, "untrained flow", "tab:orange", 0.35),
        (trained, "trained flow", "tab:blue", 0.45),
    ]:
        s = jnp.asarray(s)[:n]
        ax.scatter(s[:, 0], s[:, 1], s=4, alpha=alpha, color=color,
                   label=label, linewidths=0)
    ax.legend(loc="best")
    ax.set_title(name)
    ax.set_xlabel("x[0]")
    ax.set_ylabel("x[1]")
    fig.tight_layout()
    path = FIG_DIR / f"{name}.png"
    fig.savefig(path, dpi=110)
    plt.close(fig)
    try:
        return str(path.relative_to(HERE))  # md-relative link
    except ValueError:  # FIG_DIR redirected (tests)
        return str(path)


def _run(name, flow, target_logp, target_sampler, objective, n_per_iter,
         optimizer, max_iters, check_every, seed=123, dtype=jnp.float32,
         project=None, n_eval=N_EVAL, eval_reps=1):
    key = jax.random.key(seed)
    ke, kt, km1, km2 = jax.random.split(key, 4)

    # jitted eval: one compiled program instead of hundreds of individually
    # dispatched ops
    eval_jit = jax.jit(
        lambda k, f: nf.elbo_batch(k, f, target_logp, n_eval))

    def eval_elbo(f, k0):
        # mean ± sem over eval_reps independent estimates (heavy-tailed
        # targets like the funnel have per-estimate stdev ~1 nat even at
        # 16k samples — a single estimate can fake a training regression)
        vals = [
            float(eval_jit(jax.random.fold_in(k0, r), f))
            for r in range(eval_reps)
        ]
        mean = sum(vals) / len(vals)
        if len(vals) > 1:
            var = sum((v - mean) ** 2 for v in vals) / (len(vals) - 1)
            sem = math.sqrt(var / len(vals))
        else:
            sem = 0.0
        return mean, sem

    before, before_sem = eval_elbo(flow, ke)
    res = nf.train_flow(
        kt, objective, flow, target_logp, n_per_iter,
        max_iters=max_iters, optimizer=optimizer,
        check_every=check_every,
    )
    after, after_sem = eval_elbo(res.flow, jax.random.key(7))
    # less-noisy convergence indicator: mean train loss over the last decile
    tail = res.stats["loss"][-max(max_iters // 10, 1):]
    tail_elbo = -float(sum(tail) / len(tail))

    flow_samples = jax.jit(
        lambda k: res.flow.sample(k, (N_MOMENT,))
    )(km1)
    untrained_samples = jax.jit(
        lambda k: flow.sample(k, (N_MOMENT,))
    )(km1)
    if project is not None:
        flow_samples = project(flow_samples)
        untrained_samples = project(untrained_samples)
    target_samples = target_sampler(km2, N_MOMENT)
    fm, fs = _moments(flow_samples)
    tm, ts = _moments(target_samples)
    # MC standard error of the mean/std estimates, used as the parity yard-
    # stick: |Δ| should be a small multiple of the MC error at N_MOMENT
    sem = float(jnp.max(ts)) / math.sqrt(N_MOMENT)

    # distribution-level parity: sliced-W2 + 2-D grid TV between trained
    # flow and exact target samples, each against its two-independent-
    # target-draws MC floor (the value "identical distributions" scores)
    kw, km3 = jax.random.split(jax.random.key(11))
    target_b = target_sampler(km3, N_MOMENT)
    sw2 = float(nf.sliced_wasserstein2(kw, flow_samples, target_samples))
    sw2_floor = float(nf.sliced_wasserstein2(kw, target_b, target_samples))
    tv = float(nf.grid_total_variation(flow_samples, target_samples))
    tv_floor = float(nf.grid_total_variation(target_b, target_samples))
    fig_path = _figure(name, flow_samples, untrained_samples, target_samples)

    return {
        "workload": name,
        "iters": int(max_iters),
        "elbo_before": round(before, 4),
        "elbo_after": round(after, 4),
        "elbo_before_sem": round(before_sem, 4),
        "elbo_after_sem": round(after_sem, 4),
        "elbo_train_tail": round(tail_elbo, 4),
        "mean_flow": [round(float(v), 4) for v in fm],
        "mean_target": [round(float(v), 4) for v in tm],
        "std_flow": [round(float(v), 4) for v in fs],
        "std_target": [round(float(v), 4) for v in ts],
        "max_abs_mean_err": round(float(jnp.max(jnp.abs(fm - tm))), 4),
        "max_abs_std_err": round(float(jnp.max(jnp.abs(fs - ts))), 4),
        "mc_sem": round(sem, 5),
        "sliced_w2": round(sw2, 4),
        "sliced_w2_floor": round(sw2_floor, 4),
        "grid_tv": round(tv, 4),
        "grid_tv_floor": round(tv_floor, 4),
        "figure": fig_path,
        "improved_significant": bool(
            after - before > 2.0 * (before_sem + after_sem)
        ),
        "device": jax.devices()[0].device_kind,
    }


def planar(iters):
    """`example/demo_planar_flow.jl:16-48`: Banana(2,1,10), f64, 10 layers,
    32 samples/iter, Adam(1e-2), elbo_batch."""
    jax.config.update("jax_enable_x64", True)
    dtype = jnp.float64
    t = nf.Banana(2, jnp.asarray(1.0, dtype), jnp.asarray(10.0, dtype))
    flow = jax.jit(
        lambda k: nf.planarflow(k, nf.DiagNormal.standard(2, dtype),
                                nlayers=10, dtype=dtype)
    )(jax.random.key(0))
    return _run("planar_banana_easy", flow, t.log_prob,
                lambda k, n: t.sample(k, (n,)), nf.elbo_batch, 32,
                optax.adam(1e-2), iters, max(iters // 10, 1), dtype=dtype)


def radial(iters):
    """`example/demo_radial_flow.jl:16-49`: WarpedGauss, f64, 10 layers,
    32 samples/iter, Adam(1e-2), elbo_batch."""
    jax.config.update("jax_enable_x64", True)
    dtype = jnp.float64
    t = nf.WarpedGauss(jnp.asarray(1.0, dtype), jnp.asarray(0.12, dtype))
    flow = jax.jit(
        lambda k: nf.radialflow(k, nf.DiagNormal.standard(2, dtype),
                                nlayers=10, dtype=dtype)
    )(jax.random.key(0))
    return _run("radial_warpedgauss", flow, t.log_prob,
                lambda k, n: t.sample(k, (n,)), nf.elbo_batch, 32,
                optax.adam(1e-2), iters, max(iters // 10, 1), dtype=dtype)


def realnvp(iters):
    """`example/demo_RealNVP.jl:20-61`: hard Banana(2,1,100), f32, 3 layers
    [16,16], 16 samples/iter, Adam(5e-4), elbo_batch (≈50k to converge)."""
    t = nf.Banana(2, 1.0, 100.0)
    flow = jax.jit(
        lambda k: nf.realnvp(k, 2, (16, 16), nlayers=3)
    )(jax.random.key(0))
    return _run("realnvp_banana_hard", flow, t.log_prob,
                lambda k, n: t.sample(k, (n,)), nf.elbo_batch, 16,
                optax.adam(5e-4), iters, max(iters // 10, 1))


def nsf(iters):
    """`example/demo_neural_spline_flow.jl:20-53`: hard Banana(2,1,100),
    f32, defaults (10 layers, [32,32], K=10, B=30), 64 samples/iter,
    elbo_batch — PLUS the trainable affine envelope
    (``affine_wrap=True``) that lifts the bare architecture's box
    ceiling (the RQS spline is the identity outside [−B,B], so with the
    reference defaults every sample lies in [−30,30]² and the best
    achievable ELBO is log(Z_box/2) = −2.600 — benchmarks/NSF_DIAGNOSE.md
    derives the bound and records the envelope beating it at −0.219,
    past RealNVP's −0.565). identity_init + warmup-cosine(peak 5e-4):
    the measured-best recipe from nsf_diagnose.py."""
    t = nf.Banana(2, 1.0, 100.0)
    flow = jax.jit(
        lambda k: nf.nsf(k, 2, identity_init=True, affine_wrap=True)
    )(jax.random.key(0))
    sched = optax.warmup_cosine_decay_schedule(
        0.0, 5e-4, warmup_steps=500, decay_steps=iters, end_value=1e-5)
    return _run("nsf_banana_hard", flow, t.log_prob,
                lambda k, n: t.sample(k, (n,)), nf.elbo_batch, 64,
                optax.adam(sched), iters, max(iters // 10, 1), eval_reps=4)


def hamiltonian(iters):
    """`example/demo_hamiltonian_flow.jl:105-171`: Funnel(2,−8,5), f64,
    15 blocks × 3 leapfrog, ϵ₀=0.05, per-sample elbo on the joint space,
    16 samples/iter, Adam(3e-4)."""
    from normalizingflows.jl_tpu.models.hamiltonian import joint_logp

    jax.config.update("jax_enable_x64", True)
    dtype = jnp.float64
    dim = 2
    t = nf.Funnel(dim, jnp.asarray(-8.0, dtype), jnp.asarray(5.0, dtype))
    flow = jax.jit(
        lambda _: nf.hamiltonian_flow(dim, t.score, n_blocks=15, L=3,
                                      eps0=0.05, dtype=dtype)
    )(0)
    lp = joint_logp(t.log_prob, dim)

    def sample_joint_x(k, n):
        # compare x-marginal moments only; momenta are exactly N(0, I)
        return t.sample(k, (n,))

    # the flow lives on the 2d joint space: compare the x block's moments
    return _run("hamiltonian_funnel", flow, lp, sample_joint_x, nf.elbo, 16,
                optax.adam(3e-4), iters, max(iters // 10, 1), dtype=dtype,
                project=lambda s: s[:, :dim], n_eval=65536, eval_reps=8)


def _run_mle(name, flow, target, batch, optimizer, max_iters, check_every,
             n_train=65536, seed=123):
    """Forward-KL (MLE) analogue of `_run`: train on exact target draws
    via `train_flow_mle`, score by held-out mean log-likelihood (the
    reference's `loglikelihood` objective, `src/objectives/
    loglikelihood.jl`), plus the same SW₂/TV/figure evidence."""
    from normalizingflows.jl_tpu.utils.data import make_loader

    key = jax.random.key(seed)
    kd, kh, km1, km2 = jax.random.split(key, 4)
    train_data = target.sample(kd, (n_train,))
    heldout = target.sample(kh, (N_EVAL,))
    loader = make_loader(jnp.asarray(train_data), batch, seed=seed)

    ll = jax.jit(lambda f, x: nf.loglikelihood(f, x))
    before = float(ll(flow, heldout))
    res = nf.train_flow_mle(flow, loader, max_iters=max_iters,
                            optimizer=optimizer, check_every=check_every)
    after = float(ll(res.flow, heldout))
    loader.close()
    tail = res.stats["loss"][-max(max_iters // 10, 1):]

    flow_samples = jax.jit(lambda k: res.flow.sample(k, (N_MOMENT,)))(km1)
    untrained_samples = jax.jit(lambda k: flow.sample(k, (N_MOMENT,)))(km1)
    target_samples = target.sample(km2, (N_MOMENT,))
    fm, fs = _moments(flow_samples)
    tm, ts = _moments(target_samples)
    sem = float(jnp.max(ts)) / math.sqrt(N_MOMENT)
    kw, km3 = jax.random.split(jax.random.key(11))
    target_b = target.sample(km3, (N_MOMENT,))
    sw2 = float(nf.sliced_wasserstein2(kw, flow_samples, target_samples))
    sw2_floor = float(nf.sliced_wasserstein2(kw, target_b, target_samples))
    tv = float(nf.grid_total_variation(flow_samples, target_samples))
    tv_floor = float(nf.grid_total_variation(target_b, target_samples))
    fig_path = _figure(name, flow_samples, untrained_samples, target_samples)
    return {
        "workload": name,
        "metric": "heldout_mean_loglik (forward-KL MLE; other rows: ELBO)",
        "iters": int(max_iters),
        "elbo_before": round(before, 4),
        "elbo_after": round(after, 4),
        "elbo_train_tail": round(-float(sum(tail) / len(tail)), 4),
        "mean_flow": [round(float(v), 4) for v in fm],
        "mean_target": [round(float(v), 4) for v in tm],
        "std_flow": [round(float(v), 4) for v in fs],
        "std_target": [round(float(v), 4) for v in ts],
        "max_abs_mean_err": round(float(jnp.max(jnp.abs(fm - tm))), 4),
        "max_abs_std_err": round(float(jnp.max(jnp.abs(fs - ts))), 4),
        "mc_sem": round(sem, 5),
        "sliced_w2": round(sw2, 4),
        "sliced_w2_floor": round(sw2_floor, 4),
        "grid_tv": round(tv, 4),
        "grid_tv_floor": round(tv_floor, 4),
        "figure": fig_path,
        "improved_significant": bool(after > before),
        "device": jax.devices()[0].device_kind,
    }


def glow_w(iters):
    """Glow on the Cross target (the family's demo config,
    `examples/demo_glow.py`: 6 blocks [32,32], data-dependent ActNorm
    init, 64 samples/iter, Adam(2e-3)). No reference counterpart —
    beyond-reference family, evidenced with the same metric discipline
    (VERDICT r4 item 5)."""
    t = nf.Cross()
    kf, ki = jax.random.split(jax.random.key(0))
    flow = jax.jit(lambda k: nf.glow(k, 2, (32, 32), nlayers=6))(kf)
    flow = nf.glow_init_actnorms(flow, flow.base.sample(ki, (1024,)))
    return _run("glow_cross", flow, t.log_prob,
                lambda k, n: t.sample(k, (n,)), nf.elbo_batch, 64,
                optax.adam(2e-3), iters, max(iters // 10, 1), eval_reps=4)


def iaf_w(iters):
    """IAF reverse-KL on the easy Banana(2,1,10) (planar demo target):
    5 layers [32,32], 64 samples/iter, Adam(2e-3). Sampling direction is
    the one-pass parallel direction for IAF, so reverse-KL training is
    its natural objective. Beyond-reference family."""
    t = nf.Banana(2, 1.0, 10.0)
    flow = jax.jit(
        lambda k: nf.iaf(k, 2, (32, 32), nlayers=5)
    )(jax.random.key(0))
    return _run("iaf_banana_easy", flow, t.log_prob,
                lambda k, n: t.sample(k, (n,)), nf.elbo_batch, 64,
                optax.adam(2e-3), iters, max(iters // 10, 1))


def maf_w(iters):
    """MAF forward-KL MLE on exact Banana(2,1,10) draws (the family's
    demo config, `examples/demo_maf_mle.py`: 5 layers [32,32], batch 256,
    Adam(1e-3)); density evaluation is MAF's one-pass direction, so MLE
    is its natural objective. Beyond-reference family + the reference's
    TODO dataloader path exercised at parity scale."""
    t = nf.Banana(2, 1.0, 10.0)
    flow = jax.jit(
        lambda k: nf.maf(k, 2, (32, 32), nlayers=5)
    )(jax.random.key(0))
    return _run_mle("maf_banana_mle", flow, t, 256, optax.adam(1e-3),
                    iters, max(iters // 10, 1))


WORKLOADS = {
    "planar": (planar, 10_000, 500),
    "radial": (radial, 10_000, 500),
    "realnvp": (realnvp, 50_000, 2_000),
    # 50k = the iteration count the reference demo itself recommends
    # (`demo_neural_spline_flow.jl:46` "change to larger number of
    # iterations (e.g., 50_000) for better results"); at 20k the flow is
    # still mid-collapse (round-2 PARITY recorded ELBO −6.06 there)
    "nsf": (nsf, 50_000, 1_000),
    # the reference comment recommends ≥50k for "better results"
    # (`demo_hamiltonian_flow.jl:164`); at 1k iters the trained affine
    # base has not yet reached the funnel's μ=−8 (round-1/2 artifacts
    # recorded a regression that was pure under-training + estimator
    # noise: the funnel ELBO estimate has ~1-nat stdev per 16k draws)
    "hamiltonian": (hamiltonian, 20_000, 100),
    # beyond-reference families (VERDICT r4 item 5)
    "glow": (glow_w, 10_000, 500),
    "iaf": (iaf_w, 10_000, 500),
    "maf": (maf_w, 3_000, 300),  # ~12 epochs over 65k samples
}


def save(entry):
    data = {}
    if JSON_PATH.exists():
        data = json.loads(JSON_PATH.read_text())
    data[entry["workload"]] = entry
    JSON_PATH.write_text(json.dumps(data, indent=1))
    print(json.dumps(entry))


def report():
    data = json.loads(JSON_PATH.read_text())
    lines = [
        "# PARITY — reference demo workloads + beyond-reference families,"
        " self-measured",
        "",
        "The first five rows replicate the reference demos exactly",
        "(docstrings in `benchmarks/parity.py` cite file:line);",
        "glow/iaf/maf are beyond-reference families evidenced with the",
        "same metric discipline (maf's column is held-out mean",
        "log-likelihood — it trains forward-KL MLE). Moment parity is the",
        "trained flow's per-coordinate mean/std vs exact target samples",
        f"({N_MOMENT} draws each); `mc_sem` is the Monte-Carlo standard",
        "error of those estimates — the parity yardstick.",
        "",
        "| workload | iters | ELBO before → after (±sem) | train-tail ELBO |"
        " SW₂ (floor) | grid TV (floor) | max |Δmean| |"
        " max |Δstd| | device |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    figures: list[tuple[str, str]] = []
    for k in WORKLOADS:
        if k not in {e.split("_")[0] for e in data} and not any(
            v["workload"].startswith(k) for v in data.values()
        ):
            continue
        v = next(v for v in data.values() if v["workload"].startswith(k))
        sem_b = v.get("elbo_before_sem", 0.0)
        sem_a = v.get("elbo_after_sem", 0.0)
        pm = (f"{v['elbo_before']}±{sem_b} → {v['elbo_after']}±{sem_a}"
              if sem_b or sem_a else
              f"{v['elbo_before']} → {v['elbo_after']}")
        sw = (f"{v['sliced_w2']} ({v['sliced_w2_floor']})"
              if "sliced_w2" in v else "—")
        tv = (f"{v['grid_tv']} ({v['grid_tv_floor']})"
              if "grid_tv" in v else "—")
        lines.append(
            f"| {v['workload']} | {v['iters']} | {pm} | "
            f"{v.get('elbo_train_tail', '—')} | "
            f"{sw} | {tv} | "
            f"{v['max_abs_mean_err']} | {v['max_abs_std_err']} | "
            f"{v['device']} |"
        )
        if v.get("figure"):
            figures.append((v["workload"], v["figure"]))
    if figures:
        lines.append("")
        lines.append("Trained vs untrained vs target (scatter overlays, "
                     "the reference docs' evidence format — "
                     "`docs/src/comparison.png`):")
        lines.append("")
        for wname, fpath in figures:
            lines.append(f"![{wname}]({fpath})")
    lines += [
        "",
        "Reading the numbers:",
        "",
        "- The primary parity metric is the final ELBO: for a normalized",
        "  target it equals −KL(q‖p), so values near 0 mean the flow matches",
        "  the target. The reference publishes no numbers (BASELINE.md);",
        "  these self-measured values are the baseline for future rounds.",
        "- `SW₂`/`grid TV` are distribution-level two-sample metrics",
        "  (sliced 2-Wasserstein; total variation on a 64×64 histogram)",
        "  between 65k trained-flow samples and 65k exact target draws;",
        "  the parenthesized floor is the same metric between two",
        "  INDEPENDENT target draws — the score identical distributions",
        "  get at this sample size. Values near the floor mean full",
        "  distributional match; values far above it quantify the",
        "  mode-seeking gap that per-coordinate moments can't adjudicate.",
        "- The ELBO and the two-sample metrics are CONSISTENT, not",
        "  contradictory (round-2 question): for a normalized target,",
        "  final ELBO = −KL(q‖p), and Pinsker bounds TV ≤ √(KL/2) — e.g.",
        "  planar's ELBO −0.32 permits TV up to 0.40, and the measured",
        "  grid TV is 0.27. A mode-seeking q can under-cover a long",
        "  low-density tail (large SW₂, which is tail-dominated) while",
        "  paying only tenths of a nat of KL (which weights by q).",
        "- Reverse-KL training is mode-seeking: on the HARD banana",
        "  (var=100) the flow concentrates on the density crown, so sample",
        "  moments legitimately differ from the full-target moments even at",
        "  ELBO ≈ −0.5 nats. The easy/radial workloads show tight moment",
        "  parity. This matches the reference's own objective/config",
        "  (`example/demo_RealNVP.jl:20-61`) — not an implementation gap.",
        "- nsf_banana_hard: the BARE reference architecture has an ELBO",
        "  ceiling — the RQS spline maps [−B,B]→[−B,B] (identity outside),",
        "  so with the reference defaults (B=30, q0=N(0,I)) every sample",
        "  lies in [−30,30]² while the target mode sits at (0,100); the",
        "  best achievable ELBO is log(Z_box/2) = −2.600 nats, which",
        "  round 4 saturated (−2.605). The row above trains",
        "  `nsf(..., affine_wrap=True)` — a trainable affine envelope the",
        "  reference architecture cannot express — which LIFTS the",
        "  ceiling: −0.22 beats both the old bound and RealNVP's −0.565",
        "  on the same target (derivation + controlled experiments:",
        "  `benchmarks/NSF_DIAGNOSE.md`).",
        "- The Hamiltonian workload trains per-dim leapfrog step sizes on a",
        "  chaotic dynamic (reference `demo_hamiltonian_flow.jl:107`). On",
        "  the funnel target the ELBO ESTIMATOR itself is heavy-tailed: a",
        "  single 16k-sample estimate has ~1-nat stdev, enough to fake a",
        "  regression. The before/after column therefore averages several",
        "  independent estimates (±sem shown), and `train-tail ELBO` (the",
        "  negated mean train loss over the last decile of iterations) is",
        "  the stabler convergence indicator.",
    ]
    MD_PATH.write_text("\n".join(lines) + "\n")
    print(MD_PATH.read_text())


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--workload", default=None,
                   help="one of %s, 'all', or a comma-separated list"
                        % ", ".join(WORKLOADS))
    p.add_argument("--iters", type=int, default=None)
    p.add_argument("--quick", action="store_true",
                   help="CI-speed iteration counts")
    p.add_argument("--report", action="store_true")
    a = p.parse_args()

    if a.report:
        report()
        return
    names = (list(WORKLOADS) if a.workload in (None, "all")
             else a.workload.split(","))
    unknown = [n for n in names if n not in WORKLOADS]
    if unknown:
        p.error(f"unknown workload(s): {unknown}")
    for name in names:
        fn, full, quick = WORKLOADS[name]
        iters = a.iters or (quick if a.quick else full)
        save(fn(iters))


if __name__ == "__main__":
    main()
