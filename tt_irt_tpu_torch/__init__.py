"""PyTorch/CUDA port of tt_irt_tpu: tensor-train inverse Rosenblatt
transport, served on an NVIDIA GPU through hand-written kernels.

The JAX package ``tt_irt_tpu`` stays the reference; this package imports
neither it nor ``jax``.  Entry points take ``device=`` (default "cuda";
pass "cpu" to run the plain PyTorch versions of the kernels).  The
constructors (``amen_cross_s``, ``greedy_cross``, ``tt_dirt_approx``,
``als_cross_parametric``) sweep on the host in numpy and evaluate each
probe batch (or solve each reduced system) on the device.  Each kernel's wrapper and plain version (``*_cuda``, ``*_ref``)
live in ``ops.dim_step``, ``ops.odim_step``, ``ops.step`` and ``ops.fused_irt``.
"""

__version__ = "0.1.0"

from .api import PosteriorResult, sample_posterior
from .constructors.als_cross import AlsCrossResult, als_cross_parametric
from .constructors.amen_cross import CrossResult, amen_cross_s
from .constructors.dirt_build import DirtOptions, tt_dirt_approx
from .constructors.finetune import dirt_finetune
from .constructors.greedy_cross import greedy_cross
from .models.diffusion import DiffusionProblem
from .models.lorenz import LorenzProblem, lorenz_ll, lorenz_rhs
from .models.ode import (dopri5_step, integrate_adaptive, integrate_observed,
                         integrate_observed_adaptive, integrate_to, rk4)
from .models.predator_prey import PredatorPreyProblem
from .models.shock_absorber import ShockConfig
from .ops.fused_irt import build_fused_data, fused_irt_sqr
from .ops.interp import lagrange_matrix, tt_sample_lagrange
from .ops.kernel_plan import condition_update, dim_step, gram_conditional
from .ops.maxvol import localcross, maxvol, maxvol_rect, trunc_svd
from .ops.tt import (TT, tkron, tt_add, tt_dot, tt_eval_indices,
                     tt_from_dense, tt_full, tt_hadamard, tt_mean_field,
                     tt_meshgrid, tt_norm, tt_ones, tt_orthogonalize,
                     tt_partial_eval, tt_permute, tt_rand, tt_reverse,
                     tt_round, tt_scale, tt_sum_many, tt_sum_modes)
from .samplers.chebyshev import tt_irt_cheb
from .samplers.conditional import tt_dirt_cond_sample, tt_irt_cond
from .samplers.debias import (IWResult, iw_prune, mcmc_prune,
                              rejection_histogram, tt_irt_debias)
from .samplers.diagnostics import essinv, hellinger, iact, tt_marginals
from .samplers.dirt import (DIRT, dirt_permute, dirt_round, serve_precision,
                            tt_dirt_inverse, tt_dirt_sample)
from .samplers.fourier import tt_irt_fourier
from .samplers.irt import tt_irt_lin, tt_irt_sqr, tt_rt_sqr
from .samplers.irt_scan import HI_STEPS, irt_scan, resolved_serve_modes
from .samplers.qmc import cbc_lattice, qmcnodes
from .samplers.reference import (randref, reference_sigma,
                                 tnormal_logdensity_shift,
                                 tnormal_to_uniform, uniform_to_tnormal)
from .samplers.serve import DirtSampler, IrtSampler
from .utils.checkpoint import (dirt_from_numpy, load_dirt, save_dirt,
                               tt_from_numpy)

__all__ = [
    "__version__", "TT", "DIRT", "AlsCrossResult", "CrossResult", "DiffusionProblem",
    "DirtOptions", "DirtSampler", "HI_STEPS", "IWResult", "IrtSampler",
    "LorenzProblem", "PosteriorResult", "PredatorPreyProblem",
    "ShockConfig", "als_cross_parametric", "amen_cross_s",
    "build_fused_data", "cbc_lattice", "condition_update", "dim_step",
    "dirt_finetune", "dirt_from_numpy", "dirt_permute", "dirt_round",
    "dopri5_step", "essinv", "fused_irt_sqr", "gram_conditional",
    "greedy_cross", "hellinger", "iact", "integrate_adaptive",
    "integrate_observed", "integrate_observed_adaptive", "integrate_to",
    "irt_scan", "iw_prune", "lagrange_matrix", "load_dirt", "localcross",
    "lorenz_ll", "lorenz_rhs", "maxvol", "maxvol_rect", "mcmc_prune",
    "qmcnodes", "randref", "reference_sigma", "rejection_histogram",
    "resolved_serve_modes", "rk4", "sample_posterior", "save_dirt",
    "serve_precision", "tkron", "tnormal_logdensity_shift",
    "tnormal_to_uniform", "trunc_svd", "tt_add", "tt_dirt_approx",
    "tt_dirt_cond_sample", "tt_dirt_inverse", "tt_dirt_sample", "tt_dot",
    "tt_eval_indices", "tt_from_dense", "tt_from_numpy", "tt_full",
    "tt_hadamard", "tt_irt_cheb", "tt_irt_cond", "tt_irt_debias",
    "tt_irt_fourier", "tt_irt_lin", "tt_irt_sqr", "tt_marginals",
    "tt_mean_field", "tt_meshgrid", "tt_norm", "tt_ones",
    "tt_orthogonalize", "tt_partial_eval", "tt_permute", "tt_rand",
    "tt_reverse", "tt_round", "tt_rt_sqr", "tt_sample_lagrange",
    "tt_scale", "tt_sum_many", "tt_sum_modes", "uniform_to_tnormal",
]
