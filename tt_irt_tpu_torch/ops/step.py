"""The two contractions of one Gram-form IRT dimension ('f32'/'mixed').

Counterpart of ``tt_irt_tpu/ops/pallas_step.py::gram_conditional`` and
``::condition_update``.  The ``*_cuda`` functions launch the hand-written
kernels of ``csrc/step.cu`` and take CUDA tensors only; the ``*_ref``
functions are the same functions in plain PyTorch (any float dtype, any
device).  Which of the two a tensor gets is decided in
``ops/kernel_plan.py``; there is no fallback from a kernel to its plain
version on the card.

Operands (f32 and contiguous for the kernels):
  phi (M, r)        prefix interface, max-normalised
  pmat (r*r, n)     semi-marginal Gram field, pmat[i*r + j, x] = P_x[i, j]
  cmat (n, r*r)     the core, cmat[x, i*r + j] = C[i, x, j]
  i0 (M,) int32     left node of each row's cell, 0 <= i0 <= n-2
  la, lb (M,)       interpolation weights of the two nodes
``gram_conditional``: fk[m, x] = phi[m] P_x phi[m]^T, (M, n).
``condition_update``: phi'[m] = phi[m] (la[m] C[i0[m]] + lb[m] C[i0[m]+1])
divided by its largest absolute entry (floored at 1e-30), (M, r).
"""

from __future__ import annotations

import ctypes

import torch

from ._build import load_library
from .rowmath import SMEM_LIMIT, check_cuda_operands, full_f32_matmul

__all__ = ["gram_conditional_cuda", "gram_conditional_ref",
           "condition_update_cuda", "condition_update_ref"]


def gram_conditional_ref(phi, pmat):
    """Plain PyTorch version: the (M, r*r) outer product times pmat."""
    m, r = phi.shape
    g = (phi[:, :, None] * phi[:, None, :]).reshape(m, r * r)
    with full_f32_matmul():
        return torch.matmul(g, pmat)


def condition_update_ref(phi, i0, la, lb, cmat):
    """Plain PyTorch version: gather the two core slices, interpolate,
    row-vector times matrix, normalise by the largest absolute entry."""
    m, r = phi.shape
    i0 = i0.long()
    b = la[:, None] * cmat[i0] + lb[:, None] * cmat[i0 + 1]
    with full_f32_matmul():
        phin = torch.bmm(phi[:, None, :], b.reshape(m, r, r))[:, 0, :]
    scale = torch.amax(torch.abs(phin), dim=1, keepdim=True)
    return phin / torch.clamp(scale, min=1e-30)


def _lib():
    lib = load_library("step")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gram_conditional_launch.argtypes = [p, p, p, i, i, i, i, p]
        lib.gram_conditional_launch.restype = i
        lib.condition_update_launch.argtypes = [p] * 6 + [i, i, i, p]
        lib.condition_update_launch.restype = i
        for f in ("step_max_n", "step_max_r"):
            getattr(lib, f).restype = i
        lib.gram_conditional_smem_bytes.argtypes = [i, i]
        lib.gram_conditional_smem_bytes.restype = ctypes.c_longlong
        lib._typed = True
    return lib


def _check_caps(fn, lib, n, r):
    if not (2 <= n <= lib.step_max_n() and 1 <= r <= lib.step_max_r()):
        raise ValueError(f"{fn}: n={n}, r={r} outside the kernel's caps "
                         f"n<={lib.step_max_n()}, r<={lib.step_max_r()}")


def gram_conditional_cuda(phi, pmat):
    """fk through the CUDA kernel; raises on anything but f32 CUDA
    tensors of the documented shapes.
    ``gram_conditional_cuda.launches`` counts kernel launches."""
    fn = "gram_conditional_cuda"
    if phi.ndim != 2 or pmat.ndim != 2:
        raise ValueError(f"{fn}: phi and pmat must be matrices")
    m, r = phi.shape
    n = pmat.shape[1]
    f32 = torch.float32
    check_cuda_operands(fn, phi.device, {"phi": (phi, f32, (m, r)),
                                         "pmat": (pmat, f32, (r * r, n))})
    lib = _lib()
    _check_caps(fn, lib, n, r)
    smem = lib.gram_conditional_smem_bytes(n, r)
    if smem > SMEM_LIMIT:
        raise ValueError(f"{fn}: n={n}, r={r} needs {smem} bytes of shared "
                         f"memory (limit {SMEM_LIMIT})")
    fk = torch.empty((m, n), dtype=f32, device=phi.device)
    with torch.cuda.device(phi.device):
        stream = torch.cuda.current_stream(phi.device).cuda_stream
        err = lib.gram_conditional_launch(
            phi.data_ptr(), pmat.data_ptr(), fk.data_ptr(), m, n, r,
            phi.device.index, stream)
    if err != 0:
        raise RuntimeError(f"gram_conditional kernel launch failed: "
                           f"cudaError {err}")
    gram_conditional_cuda.launches += 1
    return fk


gram_conditional_cuda.launches = 0


def condition_update_cuda(phi, i0, la, lb, cmat):
    """phi' through the CUDA kernel; raises on anything but f32 CUDA
    tensors (i0: int32) of the documented shapes.  The caller keeps i0
    within [0, n-2]; the kernel clips it so that no read leaves cmat.
    ``condition_update_cuda.launches`` counts kernel launches."""
    fn = "condition_update_cuda"
    if phi.ndim != 2 or cmat.ndim != 2:
        raise ValueError(f"{fn}: phi and cmat must be matrices")
    m, r = phi.shape
    n = cmat.shape[0]
    f32 = torch.float32
    check_cuda_operands(fn, phi.device, {
        "phi": (phi, f32, (m, r)), "i0": (i0, torch.int32, (m,)),
        "la": (la, f32, (m,)), "lb": (lb, f32, (m,)),
        "cmat": (cmat, f32, (n, r * r))})
    lib = _lib()
    _check_caps(fn, lib, n, r)
    phin = torch.empty((m, r), dtype=f32, device=phi.device)
    with torch.cuda.device(phi.device):
        stream = torch.cuda.current_stream(phi.device).cuda_stream
        err = lib.condition_update_launch(
            phi.data_ptr(), i0.data_ptr(), la.data_ptr(), lb.data_ptr(),
            cmat.data_ptr(), phin.data_ptr(), m, n, r, stream)
    if err != 0:
        raise RuntimeError(f"condition_update kernel launch failed: "
                           f"cudaError {err}")
    condition_update_cuda.launches += 1
    return phin


condition_update_cuda.launches = 0
