"""The per-dimension kernels of the split IRT steps: the two
contractions of a Gram-form dimension ('f32'/'mixed'/'gs') and the two
first halves of a split factor-form dimension ('hi' at
``hi_step="pair"``/``"bracket"``, 'hid').

Counterpart of ``tt_irt_tpu/ops/pallas_step.py``: ``gram_conditional``,
``condition_update``, ``factor_conditional`` and ``cdf_bracket_factor``.
The ``*_cuda`` functions launch the hand-written kernels of
``csrc/step.cu`` (the first two), ``csrc/factor_conditional.cu`` and
``csrc/factor_step.cu`` (``cdf_bracket_factor``), the last two past
n, r of 64 through ``csrc/factor_wide.cu``, ``gram_conditional`` past its
narrow tier through ``csrc/gram_wide.cu`` and ``condition_update`` past
n, r of 64 through ``csrc/cell_readout.cu``, and take CUDA tensors only;
the ``*_ref`` functions are the same functions in plain PyTorch (any
float dtype, any device).  Which of the
two a tensor gets is decided in ``ops/kernel_plan.py``; there is no
fallback from a kernel to its plain version on the card.

Operands (f32 and contiguous for the kernels):
  phi (M, r)        prefix interface, max-normalised
  pmat (r*r, n)     semi-marginal Gram field, pmat[i*r + j, x] = P_x[i, j]
  cmat (n, r*r)     the core, cmat[x, i*r + j] = C[i, x, j]
  i0 (M,) int32     left node of each row's cell, 0 <= i0 <= n-2
  la, lb (M,)       interpolation weights of the two nodes
  bmat (r, n*r)     the factor B = C L, unfolded
  qp32 (M,)         the f32 seed (the point, in 'rt' mode)
  hrow (n-1,)       grid spacings x[1:] - x[:-1]
  xg (2, n)         the grid as an f32 pair: x = xg[0] + xg[1]
``gram_conditional``: fk[m, x] = phi[m] P_x phi[m]^T, (M, n).
``condition_update``: phi'[m] = phi[m] (la[m] C[i0[m]] + lb[m] C[i0[m]+1])
divided by its largest absolute entry (floored at 1e-30), (M, r).
``factor_conditional``: fk[m, x] = ||phi[m] B_x||^2, (M, n).
``cdf_bracket_factor``: that conditional, the f32 trapezoid CDF from both
sides, the count-based bracket and its readout: out9 (M, 9) =
[c1, cr2, f1, f2, x1h, x1l, x2h, x2l, tot] and i0 (M,) int32.  Like the
TPU kernel it takes no f32(1 - seed): the right-tail target is
(1 - qp32) * tot formed in f32, which is 0 for a seed within 2^-25 of 1
(``dim_step`` and ``odim_step`` take ``um32`` for that reason); the f64
epilogue that follows uses (1 - q) * tot in f64.
"""

from __future__ import annotations

import ctypes

import torch

from . import cell_readout
from ._build import load_library
from .rowmath import (cdf_rows32, check_cuda_operands, check_factor_caps,
                      full_f32_matmul)

__all__ = ["gram_conditional_cuda", "gram_conditional_ref",
           "condition_update_cuda", "condition_update_ref",
           "factor_conditional_cuda", "factor_conditional_ref",
           "cdf_bracket_factor_cuda", "cdf_bracket_factor_ref"]


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


class _StepLibrary:
    """``csrc/step.cu``'s library (its C functions as attributes), with
    ``gram_conditional_launch`` / ``gram_conditional_smem_bytes`` and
    ``condition_update_launch`` / ``condition_update_smem_bytes`` taking
    every shape within the caps, by the same arguments: past step.cu's
    tiers (``gram_conditional_tier``: ``csrc/gram_wide.cu``'s
    ``gram_wide_launch``; ``condition_update_tier``:
    ``csrc/cell_readout.cu``'s ``condition_update_wide_launch``) the wide
    library and its shared memory, the launch's scratch allocated a call
    on its device; step.cu's own below."""

    def __init__(self, lib):
        self._lib = lib

    def __getattr__(self, name):
        return getattr(self._lib, name)

    def gram_conditional_smem_bytes(self, n, r):
        if self._lib.gram_conditional_tier(n, r):
            return _gram_wide_lib().gram_wide_smem_bytes(n, r)
        return self._lib.gram_conditional_smem_bytes(n, r)

    def gram_conditional_launch(self, phi, pmat, fk, m, n, r, device,
                                stream):
        if not self._lib.gram_conditional_tier(n, r):
            return self._lib.gram_conditional_launch(phi, pmat, fk, m, n, r,
                                                     device, stream)
        wide = _gram_wide_lib()
        scratch = torch.empty((wide.gram_wide_scratch_floats(n, r),),
                              dtype=torch.float32,
                              device=torch.device("cuda", device))
        return wide.gram_wide_launch(phi, pmat, fk, m, n, r, device, stream,
                                     scratch.data_ptr())

    def condition_update_smem_bytes(self, n, r):
        if self._lib.condition_update_tier(n, r):
            return cell_readout.lib().cell_readout_smem_bytes(n, r)
        return self._lib.condition_update_smem_bytes(n, r)

    def condition_update_launch(self, phi, i0, la, lb, cmat, phin, m, n, r,
                                device, stream):
        if not self._lib.condition_update_tier(n, r):
            return self._lib.condition_update_launch(
                phi, i0, la, lb, cmat, phin, m, n, r, device, stream)
        wide = cell_readout.lib()
        scratch = torch.empty(
            (wide.condition_update_wide_scratch_words(m, n, r),),
            dtype=torch.int32, device=torch.device("cuda", device))
        return wide.condition_update_wide_launch(
            phi, i0, la, lb, cmat, phin, m, n, r, device, stream,
            scratch.data_ptr())


def _gram_wide_lib():
    """``csrc/gram_wide.cu``'s library, typed."""
    lib = load_library("gram_wide")
    if lib.gram_wide_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gram_wide_launch.argtypes = [p, p, p, i, i, i, i, p, p]
        lib.gram_wide_launch.restype = i
        lib.gram_wide_split_launch.argtypes = [p, p, i, i, i, p]
        lib.gram_wide_split_launch.restype = i
        for f in ("gram_wide_smem_bytes", "gram_wide_scratch_floats"):
            getattr(lib, f).argtypes = [i, i]
            getattr(lib, f).restype = ctypes.c_longlong
    return lib


_STEP_LIBRARY = None


def _lib():
    global _STEP_LIBRARY
    if _STEP_LIBRARY is None:
        lib = load_library("step")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gram_conditional_launch.argtypes = [p, p, p, i, i, i, i, p]
        lib.gram_conditional_launch.restype = i
        lib.condition_update_launch.argtypes = [p] * 6 + [i, i, i, i, p]
        lib.condition_update_launch.restype = i
        for f in ("step_max_n", "step_max_r"):
            getattr(lib, f).restype = i
        for f in ("gram_conditional", "condition_update"):
            fn = getattr(lib, f + "_smem_bytes")
            fn.argtypes, fn.restype = [i, i], ctypes.c_longlong
        for f in ("gram_conditional_rows", "gram_conditional_tier",
                  "condition_update_staged", "condition_update_tier"):
            getattr(lib, f).argtypes = [i, i]
            getattr(lib, f).restype = i
        _STEP_LIBRARY = _StepLibrary(lib)
    return _STEP_LIBRARY


def gram_conditional_cuda(phi, pmat):
    """fk through the CUDA kernel (past step.cu's tier the Gram stage of
    ``csrc/gram_wide.cu``: two launches, P's split and the stage, counted
    as one); raises on anything but f32 CUDA tensors of the documented
    shapes.
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
    check_factor_caps(fn, n, r, lib.step_max_n(), lib.step_max_r(),
                      lib.gram_conditional_smem_bytes(n, r))
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
    """phi' through the CUDA kernel (past n or r of 64 the cell-grouped
    readout of ``csrc/cell_readout.cu``); raises on anything but f32 CUDA
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
    check_factor_caps(fn, n, r, lib.step_max_n(), lib.step_max_r(),
                      lib.condition_update_smem_bytes(n, r))
    phin = torch.empty((m, r), dtype=f32, device=phi.device)
    with torch.cuda.device(phi.device):
        stream = torch.cuda.current_stream(phi.device).cuda_stream
        err = lib.condition_update_launch(
            phi.data_ptr(), i0.data_ptr(), la.data_ptr(), lb.data_ptr(),
            cmat.data_ptr(), phin.data_ptr(), m, n, r, phi.device.index,
            stream)
    if err != 0:
        raise RuntimeError(f"condition_update kernel launch failed: "
                           f"cudaError {err}")
    condition_update_cuda.launches += 1
    return phin


condition_update_cuda.launches = 0


def factor_conditional_ref(phi, bmat):
    """Plain PyTorch version: v = phi B, squared and summed per node."""
    m, r = phi.shape
    with full_f32_matmul():
        v = torch.matmul(phi, bmat).reshape(m, bmat.shape[1] // r, r)
    return torch.sum(v * v, dim=2)


def cdf_bracket_factor_ref(phi, qp32, bmat, hrow, xg, mode="irt"):
    """Plain PyTorch version: the conditional, then the CDF rows of
    ``rowmath.cdf_rows32`` with the kernel's own right-tail target."""
    fk = factor_conditional_ref(phi, bmat)
    out9, i0, _ = cdf_rows32(mode, fk, xg[0], xg[1], hrow, qp32, 1.0 - qp32)
    return out9, i0.to(torch.int32)


_FACTOR_WIDE_SOURCE = {"cdf_bracket_factor_wide_launch": "factor_wide_cond",
                       "factor_conditional_wide_launch": "factor_wide_cond"}


def _factor_launcher(fn, name, launch_fn, wide_fn, argtypes, n, r, device,
                     readout=False):
    """The launch function of the factor-family tier that takes (n, r):
    ``wide_fn`` of ``csrc/factor_wide.cu`` (``factor_wide_cond.cu`` for
    cdf_bracket_factor and factor_conditional) past the narrow tier's caps
    (n, r <= 64) or shared memory, else ``launch_fn`` of
    ``csrc/<name>.cu`` (the rule is ``factor_wide_tier``'s), typed with
    ``argtypes``; raises past the wide tier's caps (n, r <= 128).  A wide
    launch also takes the tier's scratch (the factor split once a call),
    which the returned function allocates on ``device`` with the
    caller's arguments and holds until the launch is queued.  With
    ``readout`` (odim_step, whose arguments are (psi, qp, um, qmat, h, xg,
    psin, out9, m, n, r, rt, device, stream)) the wide launch writes each
    row's cell in place of psin, and ``csrc/cell_readout.cu``'s
    ``cell_readout_launch`` then forms psin from them and the split on
    the same stream."""
    wide = load_library("factor_wide")
    if wide.factor_wide_tier.argtypes is None:
        for f in ("factor_wide_tier", "factor_wide_smem_bytes",
                  "factor_wide_scratch_floats"):
            getattr(wide, f).argtypes = [ctypes.c_int] * 2
        for f in ("factor_wide_tier", "factor_wide_max_n",
                  "factor_wide_max_r"):
            getattr(wide, f).restype = ctypes.c_int
        for f in ("factor_wide_smem_bytes", "factor_wide_scratch_floats"):
            getattr(wide, f).restype = ctypes.c_longlong
    check_factor_caps(fn, n, r, wide.factor_wide_max_n(),
                      wide.factor_wide_max_r(),
                      wide.factor_wide_smem_bytes(n, r))
    if not wide.factor_wide_tier(n, r):
        launch = getattr(load_library(name), launch_fn)
        if launch.argtypes is None:
            launch.argtypes, launch.restype = argtypes, ctypes.c_int
        return launch
    # dim_step's and odim_step's wide instances are factor_wide.cu's,
    # cdf_bracket_factor's and factor_conditional's factor_wide_cond.cu's
    # (two sources, built in parallel)
    launch = getattr(load_library(_FACTOR_WIDE_SOURCE.get(wide_fn,
                                                          "factor_wide")),
                     wide_fn)
    if launch.argtypes is None:
        launch.argtypes = argtypes + [ctypes.c_void_p]
        launch.restype = ctypes.c_int
    floats = wide.factor_wide_scratch_floats(n, r)

    def call(*args):
        scratch = torch.empty((floats,), dtype=torch.float32, device=device)
        return launch(*args, scratch.data_ptr())

    if not readout:
        return call
    cr = cell_readout.lib()

    def call_readout(*args):
        m = args[8]
        split = torch.empty((floats,), dtype=torch.float32, device=device)
        cell = torch.empty((2 * m,), dtype=torch.int32, device=device)
        plan = torch.empty((cr.cell_readout_plan_words(m, n),),
                           dtype=torch.int32, device=device)
        err = launch(*args[:6], cell.data_ptr(), *args[7:],
                     split.data_ptr())
        if err != 0:
            return err
        return cr.cell_readout_launch(
            args[0], cell.data_ptr(), cell.data_ptr() + 4 * m, None,
            split.data_ptr(), args[6], m, n, r, args[12], args[13],
            plan.data_ptr())

    return call_readout


def factor_conditional_cuda(phi, bmat):
    """fk through the CUDA kernel; raises on anything but f32 CUDA
    tensors of the documented shapes.
    ``factor_conditional_cuda.launches`` counts kernel launches."""
    fn = "factor_conditional_cuda"
    if phi.ndim != 2 or bmat.ndim != 2 or bmat.shape[1] % phi.shape[1]:
        raise ValueError(f"{fn}: phi (M, r) and bmat (r, n*r) must be "
                         "matrices")
    m, r = phi.shape
    n = bmat.shape[1] // r
    f32 = torch.float32
    check_cuda_operands(fn, phi.device, {"phi": (phi, f32, (m, r)),
                                         "bmat": (bmat, f32, (r, n * r))})
    p, i = ctypes.c_void_p, ctypes.c_int
    launch = _factor_launcher(fn, "factor_conditional",
                              "factor_conditional_launch",
                              "factor_conditional_wide_launch",
                              [p, p, p, i, i, i, i, p], n, r, phi.device)
    fk = torch.empty((m, n), dtype=f32, device=phi.device)
    with torch.cuda.device(phi.device):
        stream = torch.cuda.current_stream(phi.device).cuda_stream
        err = launch(
            phi.data_ptr(), bmat.data_ptr(), fk.data_ptr(), m, n, r,
            phi.device.index, stream)
    if err != 0:
        raise RuntimeError(f"factor_conditional kernel launch failed: "
                           f"cudaError {err}")
    factor_conditional_cuda.launches += 1
    return fk


factor_conditional_cuda.launches = 0


def cdf_bracket_factor_cuda(phi, qp32, bmat, hrow, xg, mode="irt"):
    """(out9, i0) through the CUDA kernel; raises on anything but f32
    CUDA tensors of the documented shapes.
    ``cdf_bracket_factor_cuda.launches`` counts kernel launches."""
    fn = "cdf_bracket_factor_cuda"
    if mode not in ("irt", "rt"):
        raise ValueError(f"unknown mode {mode!r}")
    if phi.ndim != 2 or xg.ndim != 2:
        raise ValueError(f"{fn}: phi and xg must be matrices")
    m, r = phi.shape
    n = xg.shape[1]
    f32 = torch.float32
    check_cuda_operands(fn, phi.device, {
        "phi": (phi, f32, (m, r)), "qp32": (qp32, f32, (m,)),
        "bmat": (bmat, f32, (r, n * r)), "hrow": (hrow, f32, (n - 1,)),
        "xg": (xg, f32, (2, n))})
    p, i = ctypes.c_void_p, ctypes.c_int
    launch = _factor_launcher(fn, "factor_step", "cdf_bracket_factor_launch",
                              "cdf_bracket_factor_wide_launch",
                              [p] * 7 + [i] * 5 + [p], n, r, phi.device)
    out9 = torch.empty((m, 9), dtype=f32, device=phi.device)
    i0 = torch.empty((m,), dtype=torch.int32, device=phi.device)
    with torch.cuda.device(phi.device):
        stream = torch.cuda.current_stream(phi.device).cuda_stream
        err = launch(
            phi.data_ptr(), qp32.data_ptr(), bmat.data_ptr(),
            hrow.data_ptr(), xg.data_ptr(), out9.data_ptr(), i0.data_ptr(),
            m, n, r, int(mode == "rt"), phi.device.index, stream)
    if err != 0:
        raise RuntimeError(f"cdf_bracket_factor kernel launch failed: "
                           f"cudaError {err}")
    cdf_bracket_factor_cuda.launches += 1
    return out9, i0


cdf_bracket_factor_cuda.launches = 0
