"""PyTorch/CUDA port of tt_irt_tpu: tensor-train inverse Rosenblatt
transport, served on an NVIDIA GPU through hand-written kernels.

The JAX package ``tt_irt_tpu`` stays the reference; this package imports
neither it nor ``jax``.  Entry points take ``device=`` (default "cuda";
pass "cpu" to run the plain PyTorch versions of the kernels).  Each
kernel's wrapper and plain version (``*_cuda``, ``*_ref``) live in
``ops.dim_step``, ``ops.odim_step``, ``ops.step`` and ``ops.fused_irt``.
"""

from .models.lorenz import LorenzProblem, lorenz_ll, lorenz_rhs
from .ops.fused_irt import build_fused_data, fused_irt_sqr
from .ops.kernel_plan import condition_update, dim_step, gram_conditional
from .ops.tt import TT
from .samplers.debias import mcmc_prune
from .samplers.diagnostics import essinv
from .samplers.dirt import DIRT, serve_precision
from .samplers.irt import tt_irt_sqr, tt_rt_sqr
from .samplers.irt_scan import HI_STEPS, irt_scan, resolved_serve_modes
from .samplers.reference import (randref, reference_sigma,
                                 tnormal_logdensity_shift,
                                 tnormal_to_uniform, uniform_to_tnormal)
from .samplers.serve import DirtSampler, IrtSampler
from .utils.checkpoint import (dirt_from_numpy, load_dirt, save_dirt,
                               tt_from_numpy)

__all__ = [
    "TT", "DIRT", "DirtSampler", "HI_STEPS", "IrtSampler", "LorenzProblem",
    "resolved_serve_modes",
    "build_fused_data", "condition_update", "dim_step", "dirt_from_numpy",
    "essinv", "fused_irt_sqr", "gram_conditional", "irt_scan", "load_dirt",
    "lorenz_ll",
    "lorenz_rhs", "mcmc_prune", "randref", "reference_sigma", "save_dirt",
    "serve_precision", "tnormal_logdensity_shift", "tnormal_to_uniform",
    "tt_from_numpy", "tt_irt_sqr", "tt_rt_sqr", "uniform_to_tnormal",
]
