"""Interpolation utilities (counterpart of ``tt_irt_tpu/ops/interp.py``):
dense Lagrange matrices and TT evaluation at arbitrary points, in f64 on
the TT's device.

The Lagrange weights are products of many differences, so they are
accumulated as logs and signs (no overflow or underflow); the TT is
evaluated as one batched contraction chain over all points.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .tt import TT

__all__ = ["lagrange_matrix", "tt_sample_lagrange"]


def lagrange_matrix(x, y, device=None) -> torch.Tensor:
    """Dense Lagrange interpolation matrix L (m, n) with f(y) ~= L @ f(x),
    in f64 on ``device`` (default: where ``x`` lies, else the CPU)."""
    if device is None:
        device = x.device if torch.is_tensor(x) else "cpu"
    x = torch.as_tensor(x, dtype=torch.float64, device=device).reshape(-1)
    y = torch.as_tensor(y, dtype=torch.float64, device=device).reshape(-1)
    n = x.shape[0]
    diff_yx = y[:, None] - x[None, :]                  # (m, n)
    diff_xx = x[:, None] - x[None, :]                  # (n, n)
    eye = torch.eye(n, dtype=torch.bool, device=device)
    one = torch.ones((), dtype=torch.float64, device=device)
    offd = torch.where(eye, one, diff_xx)
    logw = torch.sum(torch.log(torch.abs(offd)), dim=1)
    sgnw = torch.prod(torch.sign(offd), dim=1)
    hit = diff_yx == 0.0
    safe = torch.where(hit, one, diff_yx)
    # numerator: product over j != i of (y - x_j)
    log_num_all = torch.sum(torch.log(torch.abs(safe)), dim=1)   # (m,)
    sgn_num_all = torch.prod(torch.sign(safe), dim=1)
    log_num = log_num_all[:, None] - torch.log(torch.abs(safe))
    sgn_num = sgn_num_all[:, None] * torch.sign(safe)
    lmat = sgn_num * torch.exp(log_num - logw[None, :]) / sgnw[None, :]
    # exact hit: y == x_i -> the row is the unit vector
    any_hit = torch.any(hit, dim=1, keepdim=True)
    return torch.where(any_hit, hit.to(lmat.dtype), lmat)


def tt_sample_lagrange(t: TT, grids: Sequence, points) -> torch.Tensor:
    """A TT at arbitrary points by per-dimension Lagrange interpolation:
    points (M, d) -> values (M,) (or (M, b) for a block TT whose right
    boundary rank b > 1), on the TT's device."""
    dev = t.device
    points = torch.as_tensor(points, dtype=torch.float64, device=dev)
    m = points.shape[0]
    r0 = t.cores[0].shape[0]
    prefix = torch.ones((m, r0), dtype=t.dtype, device=dev)
    for k in range(t.d):
        lmat = lagrange_matrix(grids[k], points[:, k], device=dev)
        pc = torch.einsum("ma,anb->mnb", prefix, t.cores[k])
        prefix = torch.einsum("mnb,mn->mb", pc, lmat.to(t.dtype))
    if prefix.shape[1] == 1:
        return prefix[:, 0]
    return prefix
