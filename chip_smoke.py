"""On-card smoke run of the flow-VI trainer.

    python chip_smoke.py            # every phase, on one GPU
    python chip_smoke.py --gpus 4   # only the sharded wide-NSF step, 4 GPUs

Drives the main path through the entry points a user calls (`nf.nsf`,
`nf.realnvp`, `nf.train_flow`, `shard_objective`) at the widths of the wide
configurations, runs the fused RQS kernel as compiled for the card, and
checks the kernel and the trainer against the plain references. Phases run
in order; the script exits non-zero if any fails, and at once if JAX finds
no GPU. Step and phase times are smoke numbers, printed with the card's
name and power limit. The last line of stdout is one JSON object.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import subprocess
import sys
import time
import traceback

import jax
import jax.numpy as jnp
import numpy as np

# wide NSF (the wide throughput config): d=64, [128,128]×10, K=10, B=30,
# batch 4096, bf16 conditioners, selective remat
NSF_WIDE = dict(dim=64, hdims=(128, 128), K=10, nlayers=10, batch=4096)
# wide RealNVP: d=128, [256,256]×10, batch 4096
REALNVP_WIDE = dict(dim=128, hdims=(256, 256), nlayers=10, batch=4096)
# step-0 agreement of the bf16-conditioner NSF with the oracle backend
# (the kernel takes raw in bf16, the oracle in f32): measured 6e-5 and 1.5e-3
# on the H100, so tightened from 1e-3 and 1e-2
NSF_LOSS_RTOL, NSF_GNORM_RTOL = 3e-4, 5e-3
# sharded step against its per-shard single-device twin
SHARD_LOSS_RTOL, SHARD_GRAD_RTOL = 1e-5, 1e-4

# Fixed limits of the RQS kernel against the oracle in float64, raw f32 and
# bf16, at 131,072 elements, K=10, B=30 (PERF.md lists each one's readings).
# Values: exp/softmax ulps shift knots by ~1e-6 relative, which B=30 and
# the local slope scale to a few 1e-4 in y; a kernel computing in bf16
# fails "y max". Round trip: the inverse amplifies y-side rounding by up to
# 1/slope in near-flat bins, so the bulk is bound tightly, the worst element
# loosely. Gradients jump at knots (the spline is C¹) and a 1-ulp knot shift
# flips a border element's bin, so VJPs bound the 99.9th percentile and the
# share beyond 1e-2, not the max. "gx p999" is 1e-3, not 5e-4: the f32 XLA
# oracle alone reads 5.2e-4 against float64. The inverse VJP's gradients
# reach 1/slope (up to ~1e3 with random raw), so its absolute limits sit
# above the f32 XLA oracle's own readings (0.32, 1.1e-2, 8.9e-2, 3.9e-3).
RQS_LIMITS = {
    "y max": 5e-4, "ld max": 1e-3,
    "round trip p999": 1e-3, "round trip max": 2e-2,
    "ld round trip max": 5e-3,
    "gx p999": 1e-3, "gx share>1e-2": 2e-3,
    "graw p999": 5e-4, "graw share>1e-2": 2e-3,
    "inverse gx p999": 0.5, "inverse gx share>1e-2": 2e-2,
    "inverse graw p999": 0.15, "inverse graw share>1e-2": 6e-3,
}

# Wide RealNVP against the CPU reference. One Dense (4096x256 @ 256x256),
# forward and VJP, each scaled by the reference's largest magnitude: exact
# arithmetic on both sides but the summation order, ~1e-6 (a TF32 control
# reads 3e-4 to 7e-2, a bf16-rounded product 2e-3 to 3e-3).
DENSE_LIMIT = 5e-5
# Whole-flow step 0, keyed by (dtype, depth). At random init and full depth
# it is ill-conditioned (loss ~2.6e7, driven by a few extreme samples): on
# the CPU, changing only the reference's summation order moved f32 by up
# to loss 4e-5, y 1.5e-4, ld 3.5e-4, grad leaf 6.1e-3, |g| 3.3e-3 (batches
# 512, 2048); f32 limits sit ~10x above. In bf16 each ulp that flips a
# bf16 rounding is amplified through 20 couplings: on the H100 the card
# read loss 4.8e-2 and |g| 0.14 against the reference, as far as a control
# with bf16-rounded products (6.8e-2, 1.5e-2), so no limit there separates
# a sound card from that fault and the depth-10 bf16 readings are printed,
# not held; the Dense check above is what catches it. bf16 is held at depth
# 1 (same widths, two couplings, loss ~4.9e3), where the CPU read loss 1e-7
# and |g| 5e-6: 10x tighter than 1e-3 and 1e-2, bf16 conditioners' bounds.
STEP0_LIMITS = {
    ("f32", 10): {"loss": 1e-3, "y": 3e-3, "ld": 5e-3, "grad": 0.1,
                  "|g|": 3e-2},
    ("bf16", 10): {},
    ("bf16", 1): {"loss": 1e-4, "|g|": 1e-3},
}


def result_line(platform: str, kind: str, count: int) -> str:
    """The final stdout line. Only a GPU run may report success."""
    if platform != "gpu":
        raise ValueError(f"chip_smoke reports GPU runs only, not {platform!r}")
    return json.dumps({"ok": True, "device": {"platform": platform,
                                              "kind": kind, "count": count}})


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return "; ".join(line.strip() for line in out.stdout.splitlines()
                     if line.strip())


def _rel(a, b) -> float:
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def _train(flow, logp, batch, iters, lr, check_every):
    """`nf.train_flow` on the ELBO; returns (result, steady seconds/step
    from the chunk boundaries after the first, compiling, chunk)."""
    import optax

    import normalizingflows as nf

    marks = []
    res = nf.train_flow(
        jax.random.key(1), nf.elbo_batch, flow, logp, batch,
        max_iters=iters, optimizer=optax.adam(lr), check_every=check_every,
        callback=lambda it, stat, f: marks.append(time.perf_counter()))
    steps = [(b - a) / check_every for a, b in zip(marks, marks[1:])]
    return res, (float(np.median(steps)) if steps else float("nan"))


def _check_trains(name, res):
    loss = np.asarray(res.stats["loss"])
    gnorm = np.asarray(res.stats["gradient_norm"])
    assert np.all(np.isfinite(loss)) and np.all(np.isfinite(gnorm)), name
    assert loss[-5:].mean() < loss[0], (name, loss[0], loss[-5:])


def sharded_matches_reference(flow, logp, n, mesh):
    """One ELBO value-and-gradient through `shard_objective` over ``mesh``
    against its single-device twin: the objective on
    ``fold_in(key, i)`` with n/ndev samples for each shard i, averaged.
    Equal in exact arithmetic. Returns (loss relative diff, gradient max
    abs diff relative to the largest gradient entry, devices that held a
    shard)."""
    from jax.sharding import PartitionSpec as P

    import normalizingflows as nf
    from normalizingflows.jl_tpu.parallel import shard_objective
    from normalizingflows.jl_tpu.parallel.mesh import BATCH_AXIS
    from normalizingflows.jl_tpu.utils.pytree import (
        apply_mask, trainable_mask,
    )

    ndev = mesh.shape[BATCH_AXIS]
    key = jax.random.key(3)
    mask = trainable_mask(flow, frozen=lambda m: m is flow.base)
    sharded = shard_objective(nf.elbo_batch, mesh)

    def reference(k, f):
        vals = [nf.elbo_batch(jax.random.fold_in(k, i), f, logp, n // ndev)
                for i in range(ndev)]
        return sum(vals) / ndev

    def vg(obj):
        loss, g = jax.jit(jax.value_and_grad(
            lambda f: -obj(key, f)))(flow)
        return float(loss), jax.tree_util.tree_leaves(apply_mask(g, mask))

    with jax.default_matmul_precision("highest"):
        l_s, g_s = vg(lambda k, f: sharded(k, f, logp, n))
        l_r, g_r = vg(reference)
    scale = max(float(jnp.max(jnp.abs(g))) for g in g_r)
    gdiff = max(float(jnp.max(jnp.abs(a - b))) for a, b in zip(g_s, g_r))

    @jax.jit
    def shard_ids():
        return jax.shard_map(
            lambda: jax.lax.axis_index(BATCH_AXIS)[None], mesh=mesh,
            in_specs=(), out_specs=P(BATCH_AXIS))()

    ids = shard_ids()
    devices = {s.device for s in ids.addressable_shards}
    assert sorted(np.asarray(ids).tolist()) == list(range(ndev))
    return _rel(l_s, l_r), gdiff / max(scale, 1e-30), devices


class Smoke:
    def __init__(self, card: str):
        self.card = card
        self.failed: list[str] = []

    def say(self, msg: str):
        print(f"[{self.card}] {msg}", flush=True)

    def run(self, fn):
        t0 = time.perf_counter()
        try:
            fn(self)
            status = "PASS"
        except Exception:  # report every phase, then fail the run
            traceback.print_exc()
            status = "FAIL"
            self.failed.append(fn.__name__)
        self.say(f"{status} {fn.__name__} ({time.perf_counter() - t0:.1f} s)")


def _nsf_wide(backend):
    import normalizingflows as nf

    c = NSF_WIDE
    return jax.jit(lambda k: nf.nsf(
        k, c["dim"], c["hdims"], K=c["K"], nlayers=c["nlayers"],
        identity_init=True, compute_dtype=jnp.bfloat16, remat=True,
        backend=backend))(jax.random.key(0))


def phase_wide_nsf(s: Smoke):
    """Wide NSF through `train_flow` with ``backend="auto"``; step 0 against
    the same flow on the `ops/rqs.py` oracle backend, on the card."""
    import normalizingflows as nf
    from normalizingflows.jl_tpu import device

    assert device.use_rqs_kernel()
    logp = nf.Banana(NSF_WIDE["dim"], 1.0, 100.0).log_prob
    runs = {}
    for backend in ("auto", "oracle"):
        runs[backend], step_s = _train(_nsf_wide(backend), logp,
                                       NSF_WIDE["batch"], 30, 1e-3, 10)
        s.say(f"wide NSF bf16 [{backend}] train_flow step "
              f"{step_s * 1e3:.3f} ms (smoke)")
    _check_trains("wide NSF", runs["auto"])
    k, o = runs["auto"].stats, runs["oracle"].stats
    d_loss = _rel(k["loss"][0], o["loss"][0])
    d_g = _rel(k["gradient_norm"][0], o["gradient_norm"][0])
    s.say(f"wide NSF step-0 kernel vs oracle: loss rel {d_loss:.3e}, "
          f"|g| rel {d_g:.3e}; loss {k['loss'][0]:.6f} -> {k['loss'][-1]:.6f}")
    assert d_loss <= NSF_LOSS_RTOL and d_g <= NSF_GNORM_RTOL


def _round(v, bits):
    """``v`` rounded to ``bits`` mantissa bits (23: f32, kept as is)."""
    if bits >= 23:
        return v
    return jax.lax.reduce_precision(v, exponent_bits=8, mantissa_bits=bits)


@functools.partial(jax.custom_vjp, nondiff_argnums=(2, 3))
def _emulated_matmul(x, W, bits, out_bits):
    """``x @ W`` with both operands rounded to ``bits`` mantissa bits, the
    products summed in exact f32 (precision "highest"), the result rounded
    to ``out_bits`` (None: left in f32). The backward rounds the cotangent
    the same way before its two matmuls, as the mixed-precision Dense's
    custom VJP does."""
    y = jnp.matmul(_round(x, bits), _round(W, bits),
                   precision=jax.lax.Precision.HIGHEST)
    return y if out_bits is None else _round(y, out_bits)


def _emulated_matmul_fwd(x, W, bits, out_bits):
    return _emulated_matmul(x, W, bits, out_bits), (x, W)


def _emulated_matmul_bwd(bits, out_bits, res, g):
    x, W = res
    g = _round(g, bits)
    hi = jax.lax.Precision.HIGHEST
    gx = jnp.matmul(g, _round(W, bits).T, precision=hi)
    gW = jnp.matmul(_round(x, bits).reshape(-1, x.shape[-1]).T,
                    g.reshape(-1, g.shape[-1]), precision=hi)
    if out_bits is not None:
        gx, gW = _round(gx, out_bits), _round(gW, out_bits)
    return gx, gW


_emulated_matmul.defvjp(_emulated_matmul_fwd, _emulated_matmul_bwd)


@contextlib.contextmanager
def _emulated_dense(bits, out_bits):
    """Every `nets.Dense` takes its product through `_emulated_matmul`."""
    from normalizingflows.jl_tpu.models import nets

    def call(self, x):
        y = _emulated_matmul(x, self.W, bits, out_bits) + self.b
        return y if self.activation is None else self.activation(y)

    native, nets.Dense.__call__ = nets.Dense.__call__, call
    try:
        yield
    finally:
        nets.Dense.__call__ = native


def _on_cpu(fn, *args):
    """``fn(*args)`` jitted on the CPU device of this process, as numpy.
    Traced anew on every call (a fresh lambda), so `_emulated_dense` takes
    effect."""
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        out = jax.jit(lambda *a: fn(*a))(*jax.device_put(args, cpu))
        return jax.tree_util.tree_map(np.asarray, out)


def _scaled(u, v) -> float:
    """Largest difference of ``u`` from ``v`` over ``v``'s largest
    magnitude."""
    u, v = np.asarray(u, np.float64), np.asarray(v, np.float64)
    return float(np.max(np.abs(u - v)) / np.max(np.abs(v)))


def _dense_vjp(layer, x, gy):
    """A Dense's output and its VJP (input and weight cotangents)."""
    y, vjp = jax.vjp(lambda lay, x: lay(x), layer, x)
    g_layer, gx = vjp(gy)
    return y, gx, g_layer.W


def _step0(flow, logp, z):
    """Step-0 readings of the ELBO step at base draws ``z``: loss, the
    flow's output and log-det, and the trainable gradient's leaves."""
    import normalizingflows as nf
    from normalizingflows.jl_tpu.utils.pytree import (
        apply_mask, trainable_mask,
    )

    def loss(f):
        y, ld = f.bijector.forward_and_log_det(z)
        return -nf.elbo_from_samples(z, f, logp), (y, ld)

    (value, (y, ld)), g = jax.value_and_grad(loss, has_aux=True)(flow)
    g = apply_mask(g, trainable_mask(flow, frozen=lambda m: m is flow.base))
    return value, y, ld, jax.tree_util.tree_leaves(g)


def _step0_deviation(a, b) -> dict:
    """How far step-0 readings ``a`` lie from ``b``: loss and gradient norm
    relative, the rest `_scaled` (each gradient leaf on its own)."""
    def norm(leaves):
        return np.sqrt(sum(np.sum(np.square(np.asarray(g, np.float64)))
                           for g in leaves))

    return {"loss": _rel(a[0], b[0]), "y": _scaled(a[1], b[1]),
            "ld": _scaled(a[2], b[2]),
            "grad": max(_scaled(u, v) for u, v in zip(a[3], b[3])
                        if np.any(np.asarray(v))),
            "|g|": _rel(norm(a[3]), norm(b[3]))}


def phase_wide_realnvp(s: Smoke):
    """Wide RealNVP f32 and bf16: training through `train_flow` on the card,
    then the card against a reference on the CPU of this process that
    shares none of the card's code (`_emulated_matmul`: f32 — exact f32
    products; bf16 — bf16-rounded operands and cotangents, exact f32 sums):
    one hidden Dense at full width, forward and VJP, and the flow's step 0
    (`STEP0_LIMITS`). A control run on the CPU with the fault the limits
    must catch — TF32 operands for f32, products rounded to bf16 for bf16 —
    has to break every Dense limit and, in f32, at least one step-0
    limit."""
    import normalizingflows as nf
    from normalizingflows.jl_tpu.models.nets import Dense, leaky_relu

    c = REALNVP_WIDE
    logp = nf.Banana(c["dim"], 1.0, 100.0).log_prob
    z = nf.DiagNormal.standard(c["dim"]).sample(jax.random.key(7),
                                                 (c["batch"],))
    h = c["hdims"][-1]
    kx, kg, kw = jax.random.split(jax.random.key(8), 3)
    x = jax.random.normal(kx, (c["batch"], h))
    gy = jax.random.normal(kg, (c["batch"], h))
    # (dtype, reference and control (operand, result) mantissa bits)
    runs = (("f32", None, (23, None), (10, None)),
            ("bf16", jnp.bfloat16, (7, None), (7, 7)))
    bad = []

    def build(cd, nlayers):
        return jax.jit(lambda k: nf.realnvp(
            k, c["dim"], c["hdims"], nlayers=nlayers, compute_dtype=cd,
            remat=True))(jax.random.key(0))

    def check(what, d, dc, lim, control_breaks):
        for m in d:
            held = f"limit {lim[m]:.1e}" if m in lim else "not held"
            s.say(f"wide RealNVP {what} {m} vs CPU reference: card "
                  f"{d[m]:.3e}, control {dc[m]:.3e} ({held})")
        bad.extend(f"{what} {m}" for m in lim if not d[m] <= lim[m])
        if control_breaks and not control_breaks(dc[m] > lim[m]
                                                 for m in lim):
            bad.append(f"{what}: control kept within the limits")

    def step0(f, z):
        return _step0(f, logp, z)

    for name, cd, ref_bits, ctrl_bits in runs:
        flow = build(cd, c["nlayers"])
        res, step_s = _train(flow, logp, c["batch"], 30, 1e-3, 10)
        _check_trains(f"wide RealNVP {name}", res)
        s.say(f"wide RealNVP {name} train_flow step {step_s * 1e3:.3f} ms "
              "(smoke)")

        layer = Dense.make(kw, h, h, leaky_relu, compute_dtype=cd)
        card = jax.jit(_dense_vjp)(layer, x, gy)
        with _emulated_dense(*ref_bits):
            ref = _on_cpu(_dense_vjp, layer, x, gy)
        with _emulated_dense(*ctrl_bits):
            ctrl = _on_cpu(_dense_vjp, layer, x, gy)
        names = ("y", "gx", "gW")
        d = {m: _scaled(a, b) for m, a, b in zip(names, card, ref)}
        dc = {m: _scaled(a, b) for m, a, b in zip(names, ctrl, ref)}
        check(f"{name} Dense", d, dc, dict.fromkeys(names, DENSE_LIMIT), all)

        for (dt, depth), lim in STEP0_LIMITS.items():
            if dt != name:
                continue
            f = flow if depth == c["nlayers"] else build(cd, depth)
            card = jax.jit(step0)(f, z)
            with _emulated_dense(*ref_bits):
                ref = _on_cpu(step0, f, z)
            with _emulated_dense(*ctrl_bits):
                ctrl = _on_cpu(step0, f, z)
            check(f"{name} depth {depth} step 0", _step0_deviation(card, ref),
                  _step0_deviation(ctrl, ref), lim,
                  any if name == "f32" else None)
    assert not bad, bad


def phase_demos(s: Smoke):
    """The two demo configurations: ELBO must improve over 400 steps."""
    import normalizingflows as nf

    logp = nf.Banana(2, 1.0, 100.0).log_prob
    demos = {
        "RealNVP demo": (lambda k: nf.realnvp(k, 2, (16, 16), nlayers=3),
                         16, 5e-4),
        "NSF demo": (lambda k: nf.nsf(k, 2, identity_init=True), 64, 1e-4),
    }
    for name, (make, batch, lr) in demos.items():
        flow = jax.jit(make)(jax.random.key(0))
        before = float(nf.elbo_batch(jax.random.key(5), flow, logp, 4096))
        res, step_s = _train(flow, logp, batch, 400, lr, 100)
        after = float(nf.elbo_batch(jax.random.key(5), res.flow, logp, 4096))
        s.say(f"{name} train_flow step {step_s * 1e6:.1f} us (smoke); "
              f"ELBO {before:.4f} -> {after:.4f}")
        assert np.isfinite(after) and after > before, name


def _rqs_inputs(n, K, B, seed, raw_dtype):
    kx, kr, kg = jax.random.split(jax.random.key(seed), 3)
    x = jax.random.uniform(kx, (n,), jnp.float32, -1.2 * B, 1.2 * B)
    raw = jax.random.normal(kr, (n, 3 * K - 1), jnp.float32).astype(raw_dtype)
    gy = jax.random.normal(kg, (n,), jnp.float32)
    return x, raw, gy


def phase_rqs_kernel_vs_oracle(s: Smoke):
    """The compiled RQS kernel at the wide config's per-call width (131,072
    elements, K=10, B=30), raw in f32 and in bf16, against the oracle run in
    float64 on the CPU — the exact answer that both f32 paths approximate —
    with the XLA-compiled f32 oracle on the same card printed beside it.
    Each reading is held to its fixed limit in `RQS_LIMITS`."""
    from normalizingflows.jl_tpu.ops import rqs, rqs_pallas

    K, B, n = 10, 30.0, NSF_WIDE["batch"] * NSF_WIDE["dim"] // 2

    def oracle(x, raw, inverse=False):
        p = rqs.rqs_params_from_raw(raw.astype(x.dtype), B)
        return (rqs.rqs_inverse if inverse else rqs.rqs_forward)(x, *p)

    def kernel(x, raw, inverse=False):
        return rqs_pallas.rqs_fused(x, raw, B, inverse=inverse)

    def grad(fn, gy, inverse=False):
        return jax.jit(jax.grad(lambda x, r: (lambda y, ld: jnp.sum(
            y * gy.astype(y.dtype)) + jnp.sum(ld))(*fn(x, r, inverse)),
            (0, 1)))

    def f64(f, *args):
        cpu = jax.devices("cpu")[0]
        with jax.enable_x64(True), jax.default_device(cpu):
            args = [jnp.asarray(np.asarray(a.astype(jnp.float32)),
                                jnp.float64) for a in args]
            return [np.asarray(o) for o in f(*args)]

    def err(a, b):
        return np.abs(np.asarray(a.astype(jnp.float32), np.float64)
                      - b).ravel()

    readings = []  # (tag, limit name, kernel, XLA oracle or None)

    def vjp_readings(tag, prefix, g_k, g_o, g_64):
        for name, a, b, t in zip(("gx", "graw"), g_k, g_o, g_64):
            ek, eo = err(a, t), err(b, t)
            if a.dtype == jnp.bfloat16:
                # a cotangent stored in bf16 is off by up to one bf16 ulp
                # (2^-8 relative) by its storage alone: count the excess
                slack = 2.0 ** -8 * np.abs(t).ravel()
                ek, eo = (np.maximum(e - slack, 0) for e in (ek, eo))
            for stat, fn in (("p999", lambda e: np.quantile(e, 0.999)),
                             ("share>1e-2", lambda e: np.mean(e > 1e-2))):
                readings.append((tag, f"{prefix}{name} {stat}", fn(ek),
                                 fn(eo)))

    for dt in (jnp.float32, jnp.bfloat16):
        tag = jnp.dtype(dt).name
        x, raw, gy = _rqs_inputs(n, K, B, 0, dt)
        y64, ld64 = f64(jax.jit(oracle), x, raw)
        g_64 = f64(grad(oracle, gy), x, raw)
        with jax.default_matmul_precision("highest"):
            y_o, ld_o = jax.jit(oracle)(x, raw)
            g_o = grad(oracle, gy)(x, raw)
        y, ld = jax.jit(kernel)(x, raw)
        xi, ldi = jax.jit(lambda y, r: kernel(y, r, True))(y, raw)
        g_k = grad(kernel, gy)(x, raw)
        rt = err(xi, np.asarray(x))
        readings += [
            (tag, "y max", err(y, y64).max(), err(y_o, y64).max()),
            (tag, "ld max", err(ld, ld64).max(), err(ld_o, ld64).max()),
            (tag, "round trip p999", np.quantile(rt, 0.999), None),
            (tag, "round trip max", rt.max(), None),
            (tag, "ld round trip max", err(ldi, -np.asarray(ld)).max(),
             None)]
        vjp_readings(tag, "", g_k, g_o, g_64)

    # inverse-direction VJP (the density path): the kernel differentiates
    # the exact root (implicit function theorem), the oracle its closed form
    x, raw, gy = _rqs_inputs(n, K, B, 1, jnp.float32)
    y = jax.jit(lambda x, r: kernel(x, r)[0])(x, raw)
    g_64 = f64(grad(oracle, gy, True), y, raw)
    g_o = grad(oracle, gy, True)(y, raw)
    g_k = grad(kernel, gy, True)(y, raw)
    vjp_readings("float32", "inverse ", g_k, g_o, g_64)

    bad = []
    for tag, name, k_err, o_err in readings:
        limit = RQS_LIMITS[name]
        o_txt = "" if o_err is None else f", XLA oracle {o_err:.3e}"
        s.say(f"rqs n={n} {tag} {name} vs f64: kernel {k_err:.3e}{o_txt} "
              f"(limit {limit:.1e})")
        if not k_err <= limit:
            bad.append(f"{tag} {name}")
    assert not bad, bad


def _roundtrip(flow, x):
    y, ld = jax.jit(flow.bijector.forward_and_log_det)(x)
    x2, ld2 = jax.jit(flow.bijector.inverse_and_log_det)(y)
    y, ld, x2, ld2 = map(np.asarray, (y, ld, x2, ld2))
    x = np.asarray(x)
    scale = max(float(np.max(np.abs(x))), 1.0)
    ld_scale = max(float(np.max(np.abs(ld))), 1.0)
    assert np.max(np.abs(x2 - x)) <= 1e-4 * scale, np.max(np.abs(x2 - x))
    assert np.max(np.abs(ld + ld2)) <= 1e-4 * ld_scale
    return y, ld


def phase_pair_stacks_and_glow(s: Smoke):
    """Split-carry RealNVP stack and glow (PLU InvertibleLinear at HIGHEST):
    fwd/inv round trip on the card, and parity with the CPU. The CPU bound
    is loose on purpose: tanh/exp differ by ~1e-6 between backends and the
    conditioners amplify that through every block; the tight guards are the
    same-device round trips."""
    import normalizingflows as nf

    cases = {
        "realnvp pair stack": (lambda k: nf.realnvp(k, 8, (16, 16),
                                                    nlayers=4), 2),
        "glow": (lambda k: nf.glow(k, 8, (16, 16), nlayers=3), 8),
    }
    for name, (make, seed) in cases.items():
        flow = jax.jit(make)(jax.random.key(seed))
        x = jax.random.normal(jax.random.key(seed + 1), (256, 8))
        y, ld = _roundtrip(flow, x)
        y_c, ld_c = _on_cpu(
            lambda f, x: f.bijector.forward_and_log_det(x), flow, x)
        dy, dld = np.max(np.abs(y - y_c)), np.max(np.abs(ld - ld_c))
        s.say(f"{name}: card vs CPU y {dy:.3e}, ld {dld:.3e}")
        assert dy <= 1e-2 and dld <= 5e-2, name


def phase_nsf_backends(s: Smoke):
    """A whole NSF flow on the kernel backend against the oracle backend,
    both compiled on the card (f32 conditioners, so f32-level bounds)."""
    import normalizingflows as nf

    def build(backend):
        return jax.jit(lambda k: nf.nsf(k, 3, (8, 8), K=8, B=5.0, nlayers=2,
                                        backend=backend))(jax.random.key(4))

    x = jax.random.normal(jax.random.key(5), (512, 3))
    y1, ld1 = jax.jit(build("pallas").bijector.forward_and_log_det)(x)
    y2, ld2 = jax.jit(build("oracle").bijector.forward_and_log_det)(x)
    d_y = float(np.max(np.abs(np.asarray(y1) - np.asarray(y2))))
    d_ld = float(np.max(np.abs(np.asarray(ld1) - np.asarray(ld2))))
    s.say(f"NSF kernel vs oracle backend: y {d_y:.3e}, ld {d_ld:.3e}")
    assert d_y <= 1e-5 and d_ld <= 1e-4


def phase_trajectory_vs_cpu(s: Smoke):
    """200 RealNVP demo steps on the card and on the CPU from the same keys:
    the mean of the last 20 losses agrees within f32 slack."""
    import normalizingflows as nf

    logp = nf.Banana(2, 1.0, 100.0).log_prob

    def run(dev):
        with jax.default_device(dev):
            flow = jax.jit(lambda k: nf.realnvp(k, 2, (16, 16), nlayers=3))(
                jax.random.key(6))
            res, _ = _train(flow, logp, 64, 200, 5e-4, 200)
        return np.asarray(res.stats["loss"])

    l_gpu = run(jax.devices()[0])
    l_cpu = run(jax.devices("cpu")[0])
    assert np.all(np.isfinite(l_gpu))
    assert l_gpu[-20:].mean() < l_gpu[:20].mean()
    d = abs(l_gpu[-20:].mean() - l_cpu[-20:].mean())
    s.say(f"200-step trajectory card vs CPU: last-20 mean diff {d:.3e}")
    assert d <= 0.15, d


def phase_sharded_wide_nsf(s: Smoke):
    """The wide NSF step over a 1-D batch mesh of 4 cards through
    `shard_objective` + `train_flow`, and its value and gradient against the
    per-shard single-card reference."""
    import normalizingflows as nf
    from normalizingflows.jl_tpu.parallel import batch_mesh, shard_objective

    mesh = batch_mesh(4)
    flow = _nsf_wide("auto")
    logp = nf.Banana(NSF_WIDE["dim"], 1.0, 100.0).log_prob
    d_loss, d_g, devices = sharded_matches_reference(
        flow, logp, NSF_WIDE["batch"], mesh)
    s.say(f"sharded vs per-shard reference: loss rel {d_loss:.3e}, "
          f"grad max rel {d_g:.3e}, shards on {sorted(map(str, devices))}")
    assert len(devices) == 4
    # same per-shard shapes on both sides; only the cross-shard mean and the
    # gradient psum sum in another order (f32 reduction-order slack)
    assert d_loss <= SHARD_LOSS_RTOL and d_g <= SHARD_GRAD_RTOL
    marks = []
    res = nf.train_flow(
        jax.random.key(1), shard_objective(nf.elbo_batch, mesh), flow, logp,
        NSF_WIDE["batch"], max_iters=30, check_every=10,
        callback=lambda it, st, f: marks.append(time.perf_counter()))
    _check_trains("sharded wide NSF", res)
    step = float(np.median(np.diff(marks[1:]))) / 10 if len(marks) > 2 \
        else float("nan")
    s.say(f"sharded wide NSF (4 cards) train_flow step {step * 1e3:.3f} ms "
          "(smoke)")


SINGLE = [phase_rqs_kernel_vs_oracle, phase_wide_nsf, phase_wide_realnvp,
          phase_demos, phase_nsf_backends, phase_pair_stacks_and_glow,
          phase_trajectory_vs_cpu]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--gpus", type=int, default=1, choices=(1, 4))
    a = p.parse_args(argv)

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX found {devices[0].platform}); "
              "nothing run", file=sys.stderr)
        return 3
    if len(devices) < a.gpus:
        print(f"chip_smoke: need {a.gpus} GPUs, JAX found {len(devices)}",
              file=sys.stderr)
        return 3

    from normalizingflows.jl_tpu.device import init_compile_cache

    card = card_line()
    s = Smoke(card)
    s.say(f"device_kind {devices[0].device_kind}, {len(devices)} visible, "
          f"compile cache {init_compile_cache()}")
    t0 = time.perf_counter()
    for fn in ([phase_sharded_wide_nsf] if a.gpus == 4 else SINGLE):
        s.run(fn)
    s.say(f"total {time.perf_counter() - t0:.1f} s; failed: {s.failed}")
    if s.failed:
        return 1
    print(result_line(devices[0].platform, devices[0].device_kind, a.gpus),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
