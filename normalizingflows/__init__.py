"""normalizingflows — normalizing-flow variational inference in JAX.

The implementation lives in :mod:`normalizingflows.jl_tpu`; this root
re-exports its public API so ``import normalizingflows as nf`` works.
"""

from .jl_tpu import *  # noqa: F401,F403
from .jl_tpu import __all__, __version__  # noqa: F401

