"""Single decision point for the port's kernels (counterpart of
``tt_irt_tpu/ops/pallas_plan.py``).

The JAX package keeps its Pallas kernels opt-in because each lost an
A/B test on the TPU; that verdict does not carry over to the card.  Here
the choice follows the tensor's device alone: CUDA tensors go to the
hand-written kernel, which launches or raises (on an f64 tensor too);
CPU tensors go to its plain PyTorch version.  The kernels are f32 (as
the TPU kernels are), so the 'f64' precision, the oracle of the others,
has none: ``gram_step`` hands the Gram forward pass the plain pair for
an f64 contraction, and ``factor_step`` does the same for the f64 carry
of 'ds', chosen by the precision of the prepared operands and not by
whatever dtype a tensor arrives in.  ``cdf_invert`` likewise hands an
f64 conditional (the CDF dtype of 'f64', 'mixed' and the other f64-CDF
paths) to the plain version on either device.  There is no switch that
turns a kernel off on the card, and no other module chooses between a
kernel and its plain version.
"""

from __future__ import annotations

import torch

from .cdf import cdf_invert_cuda, cdf_invert_into_ref
from .dim_step import dim_step_cuda, dim_step_ref
from .fused_irt import fused_irt_sqr_cuda, fused_irt_sqr_ref
from .odim_step import odim_step_cuda, odim_step_ref
from .step import (cdf_bracket_factor_cuda, cdf_bracket_factor_ref,
                   condition_update_cuda, condition_update_ref,
                   factor_conditional_cuda, factor_conditional_ref,
                   gram_conditional_cuda, gram_conditional_ref)

__all__ = ["dim_step", "odim_step", "cdf_bracket_factor",
           "factor_conditional", "gram_conditional", "condition_update",
           "gram_step", "factor_step", "fused_irt_rows", "cdf_invert"]


def dim_step(phi, qp32, um32, bmat, cmat, hrow, xg, mode="irt"):
    """One 'hi' factor-form dimension step (operands and outputs as in
    ops/dim_step.py): the CUDA kernel on CUDA tensors, which launches or
    raises; the plain version on CPU tensors."""
    if phi.device.type == "cpu":
        return dim_step_ref(phi, qp32, um32, bmat, cmat, hrow, xg, mode)
    return dim_step_cuda(phi, qp32, um32, bmat, cmat, hrow, xg, mode)


def odim_step(psi, qp32, um32, qmat, hrow, xg, mode="irt"):
    """One 'hi' dimension step on orthonormal cores (operands and
    outputs as in ops/odim_step.py): the CUDA kernel on CUDA tensors,
    which launches or raises; the plain version on CPU tensors."""
    if psi.device.type == "cpu":
        return odim_step_ref(psi, qp32, um32, qmat, hrow, xg, mode)
    return odim_step_cuda(psi, qp32, um32, qmat, hrow, xg, mode)


def cdf_bracket_factor(phi, qp32, bmat, hrow, xg, mode="irt"):
    """Conditional, CDF, bracket and readout of one factor-form
    dimension, (out9, i0) (ops/step.py): the CUDA kernel on CUDA
    tensors, which launches or raises; the plain version on CPU
    tensors."""
    if phi.device.type == "cpu":
        return cdf_bracket_factor_ref(phi, qp32, bmat, hrow, xg, mode)
    return cdf_bracket_factor_cuda(phi, qp32, bmat, hrow, xg, mode)


def factor_conditional(phi, bmat):
    """fk[m, x] = ||phi[m] B_x||^2 (ops/step.py): the CUDA kernel on
    CUDA tensors, which launches or raises; the plain version on CPU
    tensors."""
    if phi.device.type == "cpu":
        return factor_conditional_ref(phi, bmat)
    return factor_conditional_cuda(phi, bmat)


def gram_conditional(phi, pmat):
    """fk[m, x] = phi[m] P_x phi[m]^T (ops/step.py): the CUDA kernel on
    CUDA tensors, which launches or raises; the plain version on CPU
    tensors."""
    if phi.device.type == "cpu":
        return gram_conditional_ref(phi, pmat)
    return gram_conditional_cuda(phi, pmat)


def condition_update(phi, i0, la, lb, cmat):
    """The normalised prefix update from (i0, la, lb) (ops/step.py): the
    CUDA kernel on CUDA tensors (f32, i0 int32), which launches or
    raises; the plain version on CPU tensors."""
    if phi.device.type == "cpu":
        return condition_update_ref(phi, i0, la, lb, cmat)
    return condition_update_cuda(phi, i0, la, lb, cmat)


def gram_step(contraction_dtype):
    """The (gram_conditional, condition_update) pair of a Gram forward
    pass whose prepared operands have ``contraction_dtype``: the plain
    versions at 'f64', which has no kernel; the device's choice above
    at 'f32' and 'mixed'."""
    if contraction_dtype == torch.float64:
        return gram_conditional_ref, condition_update_ref
    return gram_conditional, condition_update


def factor_step(contraction_dtype):
    """The (factor_conditional, condition_update) pair of a split
    factor-form forward pass whose prepared operands have
    ``contraction_dtype``: the plain versions at f64 (precision 'ds',
    whose carry is f64 and which has no kernel); the device's choice
    above at f32 ('hi' at hi_step="pair", 'hid')."""
    if contraction_dtype == torch.float64:
        return factor_conditional_ref, condition_update_ref
    return factor_conditional, condition_update


def fused_irt_rows(q, p2, coreu, x, h):
    """The whole f32 transform on prepared operands
    (ops/fused_irt.py): the CUDA kernel on CUDA tensors, which launches
    or raises; the plain version on CPU tensors."""
    if q.device.type == "cpu":
        return fused_irt_sqr_ref(q, p2, coreu, x, h)
    return fused_irt_sqr_cuda(q, p2, coreu, x, h)


def cdf_invert(mode, fk, xp, h, qp, out, lf):
    """The Gram family's CDF build, bracket and in-cell solve
    (ops/cdf.py): writes the sample into ``out`` (M,), adds dlf into
    ``lf`` (M,) in place and returns (la, lb, i0).  An f32 ``fk`` on a
    CUDA device goes to the kernel, which launches or raises (i0 int32);
    a CPU ``fk``, and an f64 one on either device, to the plain version
    (i0 int64)."""
    if fk.device.type == "cpu" or fk.dtype == torch.float64:
        return cdf_invert_into_ref(mode, fk, xp, h, qp, out, lf)
    return cdf_invert_cuda(mode, fk, xp, h, qp, out, lf)
