"""The whole f32 SIRT transform in one kernel launch.

Counterpart of ``tt_irt_tpu/ops/pallas_irt.py``.  ``build_fused_data``
prepares the per-dimension operands once (backward pass in f64 with the
Gram carry, then cast); ``fused_irt_sqr_cuda`` packs them
(``pack_fused``: each dimension's operands as one contiguous block in the
layout the kernel stages) and launches the hand-written kernel
``csrc/fused_irt.cu`` on CUDA tensors; ``fused_irt_sqr_ref`` is the
same function in plain PyTorch, a Python loop over the dimensions that
follows the kernel step by step.  Past n, r of 64 (or where no launch
plan of ``fused_irt.cu`` fits shared memory) the wrapper launches the
wide tier ``csrc/fused_wide.cu``, which takes the operands unpacked and
splits every dimension's Gram field and core once a call into scratch
that the wrapper allocates (its Gram stage is ``csrc/tc_gram.cuh``'s,
which ``gram_conditional``'s wide tier runs too).  ``fused_irt_sqr`` is
the public entry point.  The inversion is one-sided (from the left,
against q * total), so the numerics are those of the JAX package's
whole-transform kernel, not of ``tt_irt_sqr(precision='f32')``.

Operands (all f32, contiguous):
  q (M, d)             seeds in [0, 1]
  p2 (d, r*r, n)       semi-marginal Gram fields, p2[k, i*r + j, x]
  coreu (d, n, r*r)    cores, coreu[k, x, i*r + j] = C_k[i, x, j]
  x (d, n)             grids
  h (d, n-1)           grid spacings x[:, 1:] - x[:, :-1]
Returns samples (M, d) f32 and log-densities (M,) f32.  The JAX
package's ``scum`` matrices (the trapezoid cumsum as a matmul) are a
TPU device and have no counterpart here.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ._build import load_library
from .rowmath import check_cuda_operands, check_factor_caps, cumsum_rows
from .step import condition_update_ref, gram_conditional_ref

__all__ = ["build_fused_data", "fused_irt_sqr", "fused_irt_sqr_cuda",
           "fused_irt_sqr_ref", "fused_layout", "pack_fused", "fused_irt_plan"]


def build_fused_data(tt, grids, dtype=torch.float32) -> dict:
    """Per-dimension operands of the whole-transform kernel: the
    backward marginalisation in f64 with the Gram carry, cast to
    ``dtype``.  Returns {"p2", "coreu", "x", "h", "d", "n", "r"} on the
    cores' device."""
    from ..samplers.irt import _canon_grid
    from ..samplers.irt_scan import _prepare_scan, stack_padded

    gs, tt = _canon_grid(grids, tt)
    cstack, xstack = stack_padded(tt, gs)
    cstack = cstack.to(torch.float64)
    xstack = xstack.to(torch.float64)
    pstack, hstack = _prepare_scan(cstack, xstack, stable=False)
    d, r, n, _ = cstack.shape
    return {
        "p2": pstack.reshape(d, r * r, n).to(dtype).contiguous(),
        "coreu": cstack.transpose(1, 2).reshape(d, n, r * r).to(
            dtype).contiguous(),
        "x": xstack.to(torch.float32).contiguous(),
        "h": hstack[:, 1:].to(dtype).contiguous(),
        "d": d, "n": n, "r": r,
    }


def fused_irt_sqr_ref(q, p2, coreu, x, h):
    """Plain PyTorch version of the kernel (same operands and outputs):
    one pass over the dimensions on (M, .) tensors."""
    m, d = q.shape
    r2, n = p2.shape[1], p2.shape[2]
    r = int(round(r2 ** 0.5))
    phi = torch.zeros((m, r), dtype=q.dtype, device=q.device)
    phi[:, 0] = 1.0
    lf = torch.zeros((m,), dtype=q.dtype, device=q.device)
    out = torch.empty((m, d), dtype=q.dtype, device=q.device)
    zero = torch.zeros((m, 1), dtype=q.dtype, device=q.device)
    for k in range(d):
        fk = gram_conditional_ref(phi, p2[k])
        dc = 0.5 * (fk[:, :-1] + fk[:, 1:]) * h[k]
        cvals = torch.cat([zero, cumsum_rows(dc)], dim=1)
        bad = cvals[:, -1:] <= 0.0
        cvals = torch.where(bad, (x[k] - x[k, 0]).expand(m, n), cvals)
        fk = torch.where(bad, torch.ones_like(fk), fk)
        total = cvals[:, -1]
        qk = q[:, k]
        below = cvals < (qk * total)[:, None]
        i0 = torch.clamp(torch.sum(below, dim=1) - 1, 0, n - 2)
        i1 = i0 + 1

        def read(rows, idx):
            return torch.gather(rows, 1, idx[:, None])[:, 0]

        c1 = read(cvals, i0) / total
        f1 = read(fk, i0) / total
        f2 = read(fk, i1) / total
        x1, x2 = x[k][i0], x[k][i1]
        h3 = x2 - x1
        aq = 0.5 * (f2 - f1) / h3
        t = qk - c1
        dq = f1 * f1 + 4.0 * aq * t
        flat = aq == 0.0
        zf1 = f1 == 0.0
        x_quad = x1 + (-f1 + torch.sqrt(torch.abs(dq))) / (
            2.0 * torch.where(flat, torch.ones_like(aq), aq))
        x_lin = x1 + t / torch.where(zf1, torch.ones_like(f1), f1)
        xk = torch.where(flat, torch.where(zf1, x1, x_lin), x_quad)
        xk = torch.minimum(torch.maximum(xk, x1), x2)
        out[:, k] = xk
        la = (x2 - xk) / h3
        lb = (xk - x1) / h3
        lf = lf + torch.log(torch.clamp(f1 * la + f2 * lb, min=1e-30))
        phi = condition_update_ref(phi, i0, la, lb, coreu[k])
    return out, lf


def fused_layout(n: int, r: int, cstride: int | None = None):
    """(rj, cstride, block) of one dimension's block of the packed
    operand: P regrouped by node and padded to rj = r rounded up to 4
    (n*r*rj floats), the core at node stride cstride (r*r made odd by
    default, so that rows at different nodes read different banks), the
    grid (n) and the spacings (n-1), zero-padded to block floats, a
    multiple of 4 (16-byte copies)."""
    rj = -(-r // 4) * 4
    if cstride is None:
        cstride = (r * r) | 1
    used = n * r * rj + n * cstride + 2 * n - 1
    return rj, cstride, -(-used // 4) * 4


def pack_fused(p2, coreu, x, h, cstride: int | None = None):
    """The kernel's operand (d, block): for each dimension k the
    contiguous block [P_k by node | C_k | x_k | h_k | 0], with
    block[(x*r + i)*rj + j] = p2[k, i*r + j, x] (j < r; 0 up to rj) and
    block[n*r*rj + x*cstride + i*r + j] = coreu[k, x, i*r + j]."""
    d, rr, n = p2.shape
    r = int(round(rr ** 0.5))
    rj, cstride, block = fused_layout(n, r, cstride)
    pn = F.pad(p2.reshape(d, r, r, n).permute(0, 3, 1, 2), (0, rj - r))
    cn = F.pad(coreu, (0, cstride - rr))
    pack = torch.cat([pn.reshape(d, -1), cn.reshape(d, -1), x, h], dim=1)
    return F.pad(pack, (0, block - pack.shape[1])).contiguous()


def _lib():
    lib = load_library("fused_irt")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fused_irt_launch.argtypes = [p] * 4 + [i] * 7 + [p]
        lib.fused_irt_launch.restype = i
        for f in ("fused_irt_max_n", "fused_irt_max_r"):
            getattr(lib, f).restype = i
        ip = ctypes.POINTER(ctypes.c_int)
        lib.fused_irt_smem_bytes.argtypes = [i] * 5 + [ip] * 3
        lib.fused_irt_smem_bytes.restype = ctypes.c_longlong
        lib._typed = True
    return lib


def _wide_lib():
    lib = load_library("fused_wide")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fused_wide_launch.argtypes = [p] * 7 + [i] * 5 + [p, p]
        lib.fused_wide_launch.restype = i
        lib.fused_wide_split_launch.argtypes = [p, p] + [i] * 4 + [p, p]
        lib.fused_wide_split_launch.restype = i
        lib.fused_wide_scratch_floats.argtypes = [i, i, i]
        lib.fused_wide_scratch_floats.restype = ctypes.c_longlong
        for f in ("fused_wide_max_n", "fused_wide_max_r"):
            getattr(lib, f).restype = i
        lib.fused_wide_smem_bytes.argtypes = [i, i]
        lib.fused_wide_smem_bytes.restype = ctypes.c_longlong
        lib._typed = True
    return lib


def fused_irt_plan(n: int, r: int, m: int = 1, device: int | None = None):
    """The kernel's launch plan for m rows at (n, r) on CUDA device
    ``device`` (default: the current one): (rows a thread, staging
    buffers, shared-memory bytes of a block, blocks of the grid); rows 0
    where no plan fits.  Loads the kernel's library (the card's machine
    only)."""
    if device is None:
        device = torch.cuda.current_device()
    rows, bufs, grid = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    smem = _lib().fused_irt_smem_bytes(
        n, r, fused_layout(n, r)[2], m, device, ctypes.byref(rows),
        ctypes.byref(bufs), ctypes.byref(grid))
    if smem < 0:
        raise RuntimeError("fused_irt: the launch plan's CUDA query failed")
    return rows.value, bufs.value, smem, grid.value


def fused_irt_sqr_cuda(q, p2, coreu, x, h):
    """The whole transform through the CUDA kernel: ``csrc/fused_irt.cu``
    where its caps (n, r <= 64) and a launch plan of it allow, else the
    wide tier ``csrc/fused_wide.cu`` (n, r <= 128; three launches: the
    splits of P and C, then the transform); raises on anything
    but f32 CUDA tensors of the documented shapes, and past the wide
    tier's caps.
    ``fused_irt_sqr_cuda.launches`` counts kernel launches."""
    fn = "fused_irt_sqr_cuda"
    if q.ndim != 2 or p2.ndim != 3:
        raise ValueError(f"{fn}: q must be (M, d) and p2 (d, r*r, n)")
    m, d = q.shape
    r2, n = p2.shape[1], p2.shape[2]
    r = int(round(r2 ** 0.5))
    f32 = torch.float32
    check_cuda_operands(fn, q.device, {
        "q": (q, f32, (m, d)), "p2": (p2, f32, (d, r * r, n)),
        "coreu": (coreu, f32, (d, n, r * r)), "x": (x, f32, (d, n)),
        "h": (h, f32, (d, n - 1))})
    lib = _lib()
    narrow = (2 <= n <= lib.fused_irt_max_n()
              and 1 <= r <= lib.fused_irt_max_r()
              and fused_irt_plan(n, r, m, q.device.index)[0] > 0)
    if not narrow:
        wide = _wide_lib()
        check_factor_caps(fn, n, r, wide.fused_wide_max_n(),
                          wide.fused_wide_max_r(),
                          wide.fused_wide_smem_bytes(n, r))
    out = torch.empty((m, d), dtype=torch.float32, device=q.device)
    lf = torch.empty((m,), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if narrow:
            _, cstride, block = fused_layout(n, r)
            pack = pack_fused(p2, coreu, x, h)
            err = lib.fused_irt_launch(
                q.data_ptr(), pack.data_ptr(), out.data_ptr(), lf.data_ptr(),
                m, d, n, r, cstride, block, q.device.index, stream)
        else:
            scratch = torch.empty((wide.fused_wide_scratch_floats(d, n, r),),
                                  dtype=torch.float32, device=q.device)
            err = wide.fused_wide_launch(
                q.data_ptr(), p2.data_ptr(), coreu.data_ptr(), x.data_ptr(),
                h.data_ptr(), out.data_ptr(), lf.data_ptr(), m, d, n, r,
                q.device.index, stream, scratch.data_ptr())
    if err != 0:
        raise RuntimeError(f"fused_irt kernel launch failed: cudaError {err}")
    fused_irt_sqr_cuda.launches += 1
    return out, lf


fused_irt_sqr_cuda.launches = 0


def fused_irt_sqr(grids, tt, q, block: int = 128, device="cuda"):
    """Whole-transform SIRT (f32): seeds (M, d) in [0, 1] to samples and
    log-densities, like ``tt_irt_sqr(precision='f32')`` but one-sided.

    Runs on ``device`` (default "cuda": one kernel launch; "cpu": the
    plain version).  Rows are zero-padded to a whole number of ``block``
    rows and cut again, as the JAX package's entry point does."""
    from ..utils.device import resolve_device
    from .kernel_plan import fused_irt_rows

    dev = resolve_device(device)
    data = build_fused_data(tt.to(dev), grids)
    q = torch.as_tensor(q, device=dev).to(torch.float32)
    m, dq = q.shape
    if dq != data["d"]:
        raise ValueError("full-dimension seeds required")
    mpad = -(-m // block) * block
    if mpad != m:
        q = torch.cat([q, torch.zeros((mpad - m, dq), dtype=q.dtype,
                                      device=dev)], dim=0)
    out, lf = fused_irt_rows(q.contiguous(), data["p2"], data["coreu"],
                             data["x"], data["h"])
    return out[:m], lf[:m]
