"""Neural spline flow (rational-quadratic coupling).

Re-design of reference `src/flows/neuralspline.jl`:
  * `NeuralSplineCoupling` (`neuralspline.jl:35-144`): the conditioner net
    maps x_B to (3K−1)·|A| raw spline parameters (`:55-57`); these are
    normalized into monotone knot tables and the transformed dims pass
    through the elementwise RQS (`ops/rqs.py`). log|det J| is the sum of
    elementwise spline log-derivatives over the transformed dims.
  * `NSF_layer` (`neuralspline.jl:169-184`): two couplings with
    complementary alternating masks.
  * `nsf` (`neuralspline.jl:218-234`): defaults hdims=[32,32], K=10, B=30,
    nlayers=10.

Unlike the reference — where NSF is Zygote-only because of the
KernelAbstractions kernels (`neuralspline.jl:207-212`) — both forward and
inverse here are fully differentiable under `jax.grad`, including through
the closed-form inverse.
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.ad_checkpoint import checkpoint_name

from .. import device
from ..ops import rqs
from ..ops import rqs_pallas
from ..ops.masks import PartitionMask
from ..utils.pytree import module, static_field
from .bijector import Bijector, Chain
from .distributions import DiagNormal, Distribution, TransformedDistribution
from .flows import create_flow
from .nets import MLP, Dense, fnn

__all__ = ["NeuralSplineCoupling", "NSF_layer", "SplinePairStack", "nsf"]

def _use_kernel(backend: str) -> bool:
    if backend == "auto":
        return device.use_rqs_kernel()
    return backend == "pallas"


@module
class NeuralSplineCoupling(Bijector):
    """RQS coupling layer (Durkan et al. 2019)."""

    __trainable__ = ("nn",)  # mirrors `@functor NeuralSplineCoupling (nn,)`,
    # reference `src/flows/neuralspline.jl:63`

    nn: MLP
    K: int = static_field()          # number of spline bins
    B: float = static_field()        # box half-width: spline acts on [−B, B]
    mask: PartitionMask = static_field()
    # 'auto' → fused Triton kernel where `device.use_rqs_kernel()`, jnp
    # oracle elsewhere; 'oracle' / 'pallas' force a path (tests pin them
    # against each other)
    backend: str = static_field(default="auto")

    @staticmethod
    def make(
        key: jax.Array,
        dim: int,
        hdims: Sequence[int],
        K: int,
        B: float,
        mask_idx: Sequence[int],
        dtype=jnp.float32,
        backend: str = "auto",
        identity_init: bool = False,
        compute_dtype=None,
    ) -> "NeuralSplineCoupling":
        mask = PartitionMask.make(dim, mask_idx)
        n_t = mask.n_transformed
        nn = fnn(key, dim - n_t, hdims, (3 * K - 1) * n_t, dtype=dtype,
                 compute_dtype=compute_dtype)
        if identity_init:
            # Make the layer the exact identity at initialization: zero the
            # final Dense (W=0, widths/heights softmax(0) → uniform knots,
            # xs == ys) and bias the derivative slots so softplus recovers
            # slope exactly 1 at every interior knot. Standard NSF practice
            # (Durkan et al. 2019 reference impl); cures the enormous
            # random-warp init loss (measured −202k ELBO on the hard-banana
            # demo config) that poisons early Adam steps.
            from ..ops.rqs import DEFAULT_MIN_DERIVATIVE

            last = nn.layers[-1]
            b = jnp.zeros_like(last.b).reshape(n_t, 3 * K - 1)
            c = float(np.log(np.expm1(1.0 - DEFAULT_MIN_DERIVATIVE)))
            b = b.at[:, 2 * K:].set(jnp.asarray(c, dtype))
            last = Dense(jnp.zeros_like(last.W), b.reshape(-1),
                         last.activation, last.compute_dtype)
            nn = MLP(nn.layers[:-1] + (last,))
        return NeuralSplineCoupling(nn, K, float(B), mask, backend)

    def _raw(self, x_b: jax.Array):
        """Conditioner output reshaped to (..., n_transformed, 3K−1)."""
        raw = self.nn(x_b)
        n_t = self.mask.n_transformed
        return raw.reshape(raw.shape[:-1] + (n_t, 3 * self.K - 1))

    def _transform(self, v: jax.Array, cond: jax.Array, inverse: bool):
        raw = self._raw(cond)
        if _use_kernel(self.backend):
            # bf16 raw under the mixed-precision policy — see
            # SplinePairStack._transform for the traffic rationale
            cd = getattr(self.nn.layers[-1], "compute_dtype", None)
            if cd is not None:
                raw = raw.astype(cd)
            return rqs_pallas.rqs_fused(v, raw, self.B, inverse=inverse)
        xs, ys, ds = rqs.rqs_params_from_raw(raw, self.B)
        fn = rqs.rqs_inverse if inverse else rqs.rqs_forward
        return fn(v, xs, ys, ds)

    def forward_and_log_det(self, x):
        x_a, x_b, x_c = self.mask.partition(x)
        y_a, ld = self._transform(x_a, x_b, inverse=False)
        return self.mask.combine(y_a, x_b, x_c), jnp.sum(ld, axis=-1)

    def inverse_and_log_det(self, y):
        y_a, y_b, y_c = self.mask.partition(y)
        x_a, ld = self._transform(y_a, y_b, inverse=True)
        return self.mask.combine(x_a, y_b, y_c), jnp.sum(ld, axis=-1)


@module
class SplinePairStack(Bijector):
    """N NSF blocks (complementary even/odd `NeuralSplineCoupling` pairs)
    as ONE split-carry ``lax.scan`` — the NSF analogue of
    `coupling.CouplingPairStack`: partition once, carry ``(x_even,
    x_odd)``, riffle-combine once; per-block lane shuffles telescope away.
    Mathematically identical to the `Repeated(Chain([...]))` layout
    (pinned by tests/test_flows.py)."""

    stacked: dict  # {'even'|'odd': MLP} conditioners, leading n axis
    K: int = static_field()
    B: float = static_field()
    dim: int = static_field()
    n: int = static_field()
    backend: str = static_field(default="auto")
    remat: bool = static_field(default=False)

    @staticmethod
    def from_pairs(pairs, remat: bool = False) -> "SplinePairStack":
        c0, c1 = pairs[0]
        dim = c0.mask.dim
        even = tuple(range(0, dim, 2))
        odd = tuple(range(1, dim, 2))
        for c_e, c_o in pairs:
            if c_e.mask.idx_a != even or c_o.mask.idx_a != odd:
                raise ValueError(
                    "SplinePairStack requires alternating even/odd masks; "
                    "use the generic Repeated path for custom masks")

        def stack(pick):
            return jax.tree_util.tree_map(
                lambda *leaves: jnp.stack(leaves), *[pick(p) for p in pairs]
            )

        stacked = {
            "even": stack(lambda p: p[0].nn),
            "odd": stack(lambda p: p[1].nn),
        }
        return SplinePairStack(stacked, c0.K, c0.B, dim, len(pairs),
                               c0.backend, remat)

    def _transform(self, v, nn, cond, inverse):
        n_t = v.shape[-1]
        use_kernel = _use_kernel(self.backend)
        if use_kernel and v.ndim == 2:
            return self._transform_param_major(v, nn, cond, inverse)
        raw = nn(cond).reshape(cond.shape[:-1] + (n_t, 3 * self.K - 1))
        if use_kernel:
            # When the conditioners run the bf16 mixed-precision policy,
            # hand the kernel its raw params in bf16 too: raw is 29 of
            # the ~32 words/element of kernel traffic (in-kernel math
            # still runs in x's dtype; the kernel upcasts on load).
            cd = getattr(nn.layers[-1], "compute_dtype", None)
            if cd is not None:
                raw = raw.astype(cd)
            y, ld = rqs_pallas.rqs_fused(v, raw, self.B, inverse=inverse)
        else:
            xs, ys, ds = rqs.rqs_params_from_raw(raw, self.B)
            fn = rqs.rqs_inverse if inverse else rqs.rqs_forward
            y, ld = fn(v, xs, ys, ds)
        # named for the selective-remat policy of `_remat`
        y = checkpoint_name(y, "rqs_out")
        ld = checkpoint_name(ld, "rqs_out")
        return y, jnp.sum(ld, axis=-1)

    def _transform_param_major(self, v, nn, cond, inverse):
        """The kernel's feed for (batch, n_t) inputs: permute the LAST
        conditioner Dense's columns from (t, p) to (p, t) order at trace
        time (a tiny parameter-side gather) so its output transposes into
        the kernel's param-major (3K−1, N) layout as one (batch,
        (3K−1)·n_t) transpose instead of a (batch·n_t, 3K−1) one. Same
        math — columns of a matmul commute — pinned against the
        `NeuralSplineCoupling` feed in tests. On the H100 it is +30% on the
        NSF demo and −1.6% on the wide NSF against that feed
        (`PERF.md`)."""
        batch, n_t = v.shape
        P = 3 * self.K - 1
        h = cond
        for layer in nn.layers[:-1]:
            h = layer(h)
        last = nn.layers[-1]
        perm = np.arange(P * n_t).reshape(n_t, P).T.reshape(-1)
        lastp = Dense(last.W[:, perm], last.b[perm], last.activation,
                      last.compute_dtype)
        z = lastp(h)  # (batch, P·n_t), minor axis p-major
        cd = last.compute_dtype
        if cd is not None:
            z = z.astype(cd)
        raw_t = z.T.reshape(P, n_t * batch)
        x_flat = v.T.reshape(-1)  # element order t·batch + b — matches
        y_flat, ld_flat = rqs_pallas.rqs_fused_t(
            x_flat, raw_t, float(self.B), bool(inverse))
        y_flat = checkpoint_name(y_flat, "rqs_out")
        ld_flat = checkpoint_name(ld_flat, "rqs_out")
        y = y_flat.reshape(n_t, batch).T
        ld_sum = jnp.sum(ld_flat.reshape(n_t, batch), axis=0)
        return y, ld_sum

    def _remat(self, body):
        """Selective remat: save the spline outputs y and log-det (one word
        each per element, named "rqs_out" on both the kernel and the oracle
        path) and rematerialize everything else. The backward then
        recomputes the conditioner matmuls but never re-runs a spline
        forward (plain `jax.checkpoint` does: each block's second coupling
        consumes the first spline's output)."""
        return jax.checkpoint(
            body,
            policy=jax.checkpoint_policies.save_only_these_names(
                "rqs_out"),
        )

    def forward_and_log_det(self, x):
        from ..ops.masks import interleave

        xa, xb = x[..., 0::2], x[..., 1::2]

        def body(carry, nns):
            xa, xb, ld = carry
            ya, lde = self._transform(xa, nns["even"], xb, False)
            yb, ldo = self._transform(xb, nns["odd"], ya, False)
            return (ya, yb, ld + lde + ldo), None

        if self.remat:
            body = self._remat(body)
        (xa, xb, ld), _ = jax.lax.scan(
            body, (xa, xb, x[..., 0] * 0), self.stacked, length=self.n
        )
        return interleave(xa, xb, self.dim), ld

    def inverse_and_log_det(self, y):
        from ..ops.masks import interleave

        ya, yb = y[..., 0::2], y[..., 1::2]

        def body(carry, nns):
            ya, yb, ld = carry
            xb, ldo = self._transform(yb, nns["odd"], ya, True)
            xa, lde = self._transform(ya, nns["even"], xb, True)
            return (xa, xb, ld + lde + ldo), None

        if self.remat:
            body = self._remat(body)
        (ya, yb, ld), _ = jax.lax.scan(
            body, (ya, yb, y[..., 0] * 0), self.stacked, length=self.n,
            reverse=True,
        )
        return interleave(ya, yb, self.dim), ld


def NSF_layer(
    key: jax.Array,
    dim: int,
    hdims: Sequence[int],
    K: int,
    B: float,
    dtype=jnp.float32,
    backend: str = "auto",
    identity_init: bool = False,
    compute_dtype=None,
) -> list[NeuralSplineCoupling]:
    """One NSF block: two spline couplings with complementary masks
    (reference `neuralspline.jl:169-184`)."""
    k1, k2 = jax.random.split(key)
    c1 = NeuralSplineCoupling.make(k1, dim, hdims, K, B, range(0, dim, 2),
                                   dtype, backend, identity_init,
                                   compute_dtype)
    c2 = NeuralSplineCoupling.make(k2, dim, hdims, K, B, range(1, dim, 2),
                                   dtype, backend, identity_init,
                                   compute_dtype)
    return [c1, c2]


def nsf(
    key: jax.Array,
    q0: Distribution | int,
    hdims: Sequence[int] = (32, 32),
    K: int = 10,
    B: float = 30.0,
    nlayers: int = 10,
    dtype=jnp.float32,
    backend: str = "auto",
    scan: bool = True,
    identity_init: bool = False,
    remat: bool = False,
    compute_dtype=None,
    affine_wrap: bool = False,
) -> TransformedDistribution:
    """Neural spline flow (reference `neuralspline.jl:218-234` defaults).

    ``scan=True`` stacks the blocks into a `Repeated` lax.scan — one spline
    call site regardless of depth (depth-independent compile).
    ``backend``: ``"auto"`` runs the fused Triton RQS kernel where
    `device.use_rqs_kernel()` says so and the `ops/rqs.py` oracle elsewhere;
    ``"pallas"`` / ``"oracle"`` force one.
    ``identity_init=True`` zero-initializes every coupling's final conditioner
    layer so the whole flow starts as the exact identity map — the stable
    initialization of the Durkan et al. reference implementation.

    ``affine_wrap=True`` composes the spline stack with a trainable
    per-dimension affine envelope (an identity-initialized `ActNorm` on
    each side). This LIFTS the architecture's box ceiling: an RQS spline
    maps [−B, B] onto itself and is the identity outside, so a bare NSF's
    samples are confined to the base distribution's support ∪ [−B, B]^d —
    on the hard-banana demo target (mode at (0, 100), B=30) the best
    achievable ELBO is log Z_box/2 = −2.600 nats no matter how long it
    trains (benchmarks/NSF_DIAGNOSE.md derives the bound). The OUTER
    ActNorm learns to map the box onto the target's support; the INNER one
    learns to spread the base draws (σ=1 ≪ B=30: without it, all mass
    lands in a fraction of one knot bin, wasting the spline's resolution).
    The reference hard-codes the box with no escape
    (`/root/reference/src/flows/neuralspline.jl:218-234`) — this is a
    capability the reference architecture cannot express."""
    if isinstance(q0, int):
        q0 = DiagNormal.standard(q0, dtype)
    dim = q0.event_dim
    pairs = [
        NSF_layer(k, dim, hdims, K, B, dtype, backend, identity_init,
                  compute_dtype)
        for k in jax.random.split(key, nlayers)
    ]
    if scan:
        # split-carry scan (see SplinePairStack): per-block
        # partition/combine elided, one RQS call site at any depth
        layers = [SplinePairStack.from_pairs(pairs, remat=remat)]
    else:
        layers = [Chain(p) for p in pairs]
    if affine_wrap:
        from .linear import ActNorm

        layers = ([ActNorm.identity(dim, dtype)] + layers
                  + [ActNorm.identity(dim, dtype)])
    return create_flow(layers, q0)
