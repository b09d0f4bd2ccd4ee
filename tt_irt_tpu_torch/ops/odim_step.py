"""One whole 'hi' IRT dimension on weighted-orthonormal cores for a
batch of rows (``hi_step="odim"``).

Counterpart of ``tt_irt_tpu/ops/pallas_odim.py::odim_step``.
``odim_step_cuda`` launches the hand-written CUDA kernel
``csrc/odim_step.cu`` (past n, r of 64 ``csrc/factor_wide.cu``'s stage,
then the cell-grouped readout of ``csrc/cell_readout.cu``) and takes CUDA
tensors only; ``odim_step_ref`` is
the same function in plain PyTorch (``irt_scan._step_factor_ob`` +
``_cdf_rows32`` of the JAX package).  Which of the two a tensor gets is
decided in one place, ``ops/kernel_plan.py``; there is no fallback from
the kernel to the plain version on the card.

Operands (all f32, contiguous):
  psi (M, r)        prefix interface in the orthonormal basis,
                    psi_k = phi_k L_k, max-normalised
  qp32, um32 (M,)   the f32 seed and f32(1 - seed)
  qmat (r, n*r)     Q_k = L_k^{-1} C_k L_{k+1} unfolded, with
                    sum_x w2[x] Q_k(x) Q_k(x)^T = I
  hrow (n-1,)       grid spacings x[1:] - x[:-1]
  xg (2, n)         the grid as an f32 pair: x = xg[0] + xg[1]
Returns psi_next (M, r) and out9 (M, 9) with columns
[c1, cr2, f1, f2, x1h, x1l, x2h, x2l, tot] for the f64 epilogue.  The
prefix update is the 2-point readout la v[i0] + (1 - la) v[i0+1] of the
conditional matrix v = psi Q: there is no core operand.  The TPU
kernel's bf16 K-packed ``qmat``, its 0/1 structure matrices and its
``dmat`` operand are not ported.
"""

from __future__ import annotations

import ctypes

import torch

from .rowmath import cdf_rows32, check_cuda_operands, full_f32_matmul
from .step import _factor_launcher

__all__ = ["odim_step_cuda", "odim_step_ref"]


def odim_step_ref(psi, qp32, um32, qmat, hrow, xg, mode="irt"):
    """Plain PyTorch version of the kernel (same operands and outputs)."""
    m, r = psi.shape
    n = xg.shape[1]
    with full_f32_matmul():
        v = torch.matmul(psi, qmat).reshape(m, n, r)
    fk = torch.sum(v * v, dim=2)
    out9, i0, la = cdf_rows32(mode, fk, xg[0], xg[1], hrow, qp32, um32)
    rows = torch.arange(m, device=psi.device)
    psin = la[:, None] * v[rows, i0] + (1.0 - la)[:, None] * v[rows, i0 + 1]
    scale = torch.amax(torch.abs(psin), dim=1, keepdim=True)
    return psin / torch.clamp(scale, min=1e-30), out9


def odim_step_cuda(psi, qp32, um32, qmat, hrow, xg, mode="irt"):
    """One dimension step through the CUDA kernel; raises on anything
    but f32 CUDA tensors of the documented shapes.
    ``odim_step_cuda.launches`` counts kernel launches."""
    if mode not in ("irt", "rt"):
        raise ValueError(f"unknown mode {mode!r}")
    if psi.ndim != 2 or xg.ndim != 2:
        raise ValueError("odim_step_cuda: psi and xg must be matrices")
    m, r = psi.shape
    n = xg.shape[1]
    f32 = torch.float32
    check_cuda_operands("odim_step_cuda", psi.device, {
        "psi": (psi, f32, (m, r)), "qp32": (qp32, f32, (m,)),
        "um32": (um32, f32, (m,)), "qmat": (qmat, f32, (r, n * r)),
        "hrow": (hrow, f32, (n - 1,)), "xg": (xg, f32, (2, n))})
    p = ctypes.c_void_p
    launch = _factor_launcher("odim_step_cuda", "odim_step",
                              "odim_step_launch", "odim_step_wide_launch",
                              [p] * 8 + [ctypes.c_int] * 5 + [p], n, r,
                              psi.device, readout=True)
    psin = torch.empty((m, r), dtype=f32, device=psi.device)
    out9 = torch.empty((m, 9), dtype=f32, device=psi.device)
    with torch.cuda.device(psi.device):
        stream = torch.cuda.current_stream(psi.device).cuda_stream
        err = launch(
            psi.data_ptr(), qp32.data_ptr(), um32.data_ptr(),
            qmat.data_ptr(), hrow.data_ptr(), xg.data_ptr(),
            psin.data_ptr(), out9.data_ptr(), m, n, r, int(mode == "rt"),
            psi.device.index, stream)
    if err != 0:
        raise RuntimeError(f"odim_step kernel launch failed: cudaError {err}")
    odim_step_cuda.launches += 1
    return psin, out9


odim_step_cuda.launches = 0
