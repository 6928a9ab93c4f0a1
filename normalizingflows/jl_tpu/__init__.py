"""Normalizing-flow variational inference engine in JAX.

A from-scratch JAX/XLA/Pallas re-design with the capabilities of
TuringLang/NormalizingFlows.jl (see SURVEY.md): a bijector protocol with
fused forward/inverse + log-det-Jacobian, a flow zoo (planar, radial,
RealNVP affine coupling, rational-quadratic neural spline, leapfrog /
Hamiltonian), reverse-KL ELBO (plain, batched, sticking-the-landing) and
forward-KL log-likelihood objectives, a jitted Adam training loop, synthetic
targets, and a batch-sharded multi-chip execution path.

Public API parity map (reference `src/NormalizingFlows.jl:17,138-141`):
  train_flow, optimize           -> .train
  elbo, elbo_batch, loglikelihood-> .objectives  (+ new: elbo_stl)
  create_flow                    -> .models.flows
  planarflow, radialflow         -> .models.planar_radial
  realnvp, RealNVP_layer, AffineCoupling -> .models.coupling
  nsf, NSF_layer, NeuralSplineCoupling   -> .models.spline
  mlp3, fnn                      -> .models.nets
"""

from .models.bijector import (
    Bijector,
    Chain,
    Identity,
    Inverse,
    Repeated,
    Scale,
    Shift,
    Stacked,
    chain,
    invert,
    stack_bijectors,
)
from .models.distributions import (
    DiagNormal,
    Distribution,
    StandardNormal,
    TransformedDistribution,
    transformed,
)
from .models.flows import create_flow
from .models.nets import MLP, fnn, mlp3
from .models.coupling import (
    AffineCoupling,
    CouplingPairStack,
    RealNVP_layer,
    realnvp,
)
from .models.spline import (
    NeuralSplineCoupling,
    NSF_layer,
    SplinePairStack,
    nsf,
)
from .models.linear import (
    ActNorm,
    GlowBlock,
    InvertibleLinear,
    glow,
    glow_init_actnorms,
)
from .models.autoregressive import (
    MADE,
    MaskedAutoregressive,
    Permute,
    iaf,
    maf,
    maf_layer,
)
from .models.planar_radial import (
    PlanarLayer,
    RadialLayer,
    planarflow,
    radialflow,
)
from .models.hamiltonian import (
    LeapFrog,
    hamiltonian_flow,
    momentum_normalization_layer,
)
from .models.targets import Banana, Cross, Funnel, GaussianMixture, WarpedGauss
from .objectives import (
    elbo,
    elbo_batch,
    elbo_from_samples,
    elbo_iw,
    elbo_single_sample,
    elbo_stl,
    loglikelihood,
    presample_base,
    tempered,
)
from .train import (
    TrainResult,
    TrainState,
    optimize,
    train_flow,
    train_flow_annealed,
    train_flow_mle,
)
from .config import (
    FlowConfig,
    OptimizerConfig,
    TrainConfig,
    config_from_json,
    config_to_json,
)
from .diagnostics import (
    FlowDiagnostics,
    elbo_with_sem,
    ess,
    evaluate_flow,
    grid_total_variation,
    log_normalizer,
    log_weights,
    sliced_wasserstein2,
)

__version__ = "0.1.0"


__all__ = [
    # bijectors
    "Bijector", "Chain", "Identity", "Inverse", "Repeated", "Scale", "Shift",
    "Stacked", "chain", "invert", "stack_bijectors",
    # distributions
    "DiagNormal", "Distribution", "StandardNormal",
    "TransformedDistribution", "transformed",
    # flows
    "create_flow", "MLP", "fnn", "mlp3",
    "AffineCoupling", "CouplingPairStack", "RealNVP_layer", "realnvp",
    "NeuralSplineCoupling", "NSF_layer", "SplinePairStack", "nsf",
    "MADE", "MaskedAutoregressive", "Permute", "iaf", "maf", "maf_layer",
    "ActNorm", "GlowBlock", "InvertibleLinear", "glow", "glow_init_actnorms",
    "PlanarLayer", "RadialLayer", "planarflow", "radialflow",
    "LeapFrog", "hamiltonian_flow", "momentum_normalization_layer",
    # targets
    "Banana", "Cross", "Funnel", "GaussianMixture", "WarpedGauss",
    # objectives
    "elbo", "elbo_batch", "elbo_from_samples", "elbo_iw",
    "elbo_single_sample", "elbo_stl", "loglikelihood", "presample_base",
    "tempered",
    # training
    "TrainResult", "TrainState", "optimize", "train_flow",
    "train_flow_annealed", "train_flow_mle",
    # configs
    "FlowConfig", "OptimizerConfig", "TrainConfig",
    "config_from_json", "config_to_json",
    # diagnostics
    "FlowDiagnostics", "elbo_with_sem", "ess", "evaluate_flow",
    "grid_total_variation", "log_normalizer", "log_weights",
    "sliced_wasserstein2",
]
