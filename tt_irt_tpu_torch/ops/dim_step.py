"""One whole 'hi' factor-form IRT dimension for a batch of rows.

Counterpart of ``tt_irt_tpu/ops/pallas_dim.py::dim_step``.
``dim_step_cuda`` launches the hand-written CUDA kernel
``csrc/dim_step.cu`` (``csrc/dim_step_rt.cu`` and ``dim_step_rt_t64.cu``
in mode 'rt'; past n, r of 64 or its shared memory, the wide tier of
``csrc/factor_wide.cu``)
and takes CUDA tensors only; ``dim_step_ref`` is the
same function in plain PyTorch (``irt_scan._step_factor_b`` +
``_cdf_rows32`` of the JAX package; the CDF part is
``ops/rowmath.cdf_rows32``).  Which of the two a tensor gets is
decided in one place, ``ops/kernel_plan.py``; there is no fallback from
the kernel to the plain version on the card.

Operands (all f32, contiguous):
  phi (M, r)        prefix interface, max-normalised
  qp32, um32 (M,)   the f32 seed and f32(1 - seed)
  bmat (r, n*r)     the factor B_k = C_k L_k, unfolded
  cmat (n, r*r)     the core C_k, cmat[x, i*r + j] = C_k[i, x, j]
  hrow (n-1,)       grid spacings x[1:] - x[:-1]
  xg (2, n)         the grid as an f32 pair: x = xg[0] + xg[1]
Returns phi_next (M, r) and out9 (M, 9) with columns
[c1, cr2, f1, f2, x1h, x1l, x2h, x2l, tot] for the f64 epilogue.
"""

from __future__ import annotations

import ctypes

import torch

from .rowmath import (SMEM_LIMIT, cdf_rows32, check_cuda_operands,
                      full_f32_matmul)
from .step import _factor_launcher

__all__ = ["dim_step_cuda", "dim_step_ref", "SMEM_LIMIT"]


def dim_step_ref(phi, qp32, um32, bmat, cmat, hrow, xg, mode="irt"):
    """Plain PyTorch version of the kernel (same operands and outputs)."""
    m, r = phi.shape
    n = cmat.shape[0]
    with full_f32_matmul():
        v = torch.matmul(phi, bmat).reshape(m, n, r)
    fk = torch.sum(v * v, dim=2)
    out9, i0, la = cdf_rows32(mode, fk, xg[0], xg[1], hrow, qp32, um32)
    b = (la[:, None] * cmat[i0] + (1.0 - la)[:, None] * cmat[i0 + 1])
    with full_f32_matmul():
        phin = torch.bmm(phi[:, None, :], b.reshape(m, r, r))[:, 0, :]
    scale = torch.amax(torch.abs(phin), dim=1, keepdim=True)
    return phin / torch.clamp(scale, min=1e-30), out9


def dim_step_cuda(phi, qp32, um32, bmat, cmat, hrow, xg, mode="irt"):
    """One dimension step through the CUDA kernel; raises on anything
    but f32 CUDA tensors of the documented shapes.
    ``dim_step_cuda.launches`` counts kernel launches."""
    if mode not in ("irt", "rt"):
        raise ValueError(f"unknown mode {mode!r}")
    if phi.ndim != 2 or cmat.ndim != 2:
        raise ValueError("dim_step_cuda: phi and cmat must be matrices")
    m, r = phi.shape
    n = cmat.shape[0]
    f32 = torch.float32
    check_cuda_operands("dim_step_cuda", phi.device, {
        "phi": (phi, f32, (m, r)), "qp32": (qp32, f32, (m,)),
        "um32": (um32, f32, (m,)), "bmat": (bmat, f32, (r, n * r)),
        "cmat": (cmat, f32, (n, r * r)), "hrow": (hrow, f32, (n - 1,)),
        "xg": (xg, f32, (2, n))})
    p = ctypes.c_void_p
    # the narrow tier is three sources built in parallel: csrc/dim_step.cu
    # (mode 'irt'), dim_step_rt.cu (mode 'rt', rank tiers 8-32) and
    # dim_step_rt_t64.cu (mode 'rt', tier 64)
    name = "dim_step" if mode != "rt" else (
        "dim_step_rt" if r <= 32 else "dim_step_rt_t64")
    launch = _factor_launcher("dim_step_cuda", name, name + "_launch",
                              "dim_step_wide_launch",
                              [p] * 9 + [ctypes.c_int] * 5 + [p], n, r,
                              phi.device)
    phin = torch.empty((m, r), dtype=torch.float32, device=phi.device)
    out9 = torch.empty((m, 9), dtype=torch.float32, device=phi.device)
    with torch.cuda.device(phi.device):
        stream = torch.cuda.current_stream(phi.device).cuda_stream
        err = launch(
            phi.data_ptr(), qp32.data_ptr(), um32.data_ptr(),
            bmat.data_ptr(), cmat.data_ptr(), hrow.data_ptr(),
            xg.data_ptr(), phin.data_ptr(), out9.data_ptr(), m, n, r,
            int(mode == "rt"), phi.device.index, stream)
    if err != 0:
        raise RuntimeError(f"dim_step kernel launch failed: cudaError {err}")
    dim_step_cuda.launches += 1
    return phin, out9


dim_step_cuda.launches = 0
