"""The Gram family's CDF build, bracket and in-cell solve: the
two-sided trapezoid CDF of each row of an unnormalised conditional, the
count-based bracket of each seed and the quadratic inversion within the
cell (in mode 'rt' the CDF evaluated at a point).

The JAX package has no kernel for this step (its
``samplers/irt_scan.py::_cdf_invert`` is plain ``jnp`` between the two
Pallas kernels).  ``cdf_invert_ref`` is the function in plain PyTorch
(any float dtype, any device), and ``cdf_invert_into_ref`` the same
with the kernel's calling convention; ``cdf_invert_cuda`` launches the
hand-written kernel of ``csrc/cdf_invert.cu`` on f32 CUDA tensors,
one launch where the plain version runs about a hundred PyTorch
operations.  Which of the two runs is decided in ``ops/kernel_plan.py``;
there is no fallback from the kernel to the plain version on the card.

Operands:
  fk (M, n)    the conditional of each row, unnormalised (at 'f32' it
               may come out slightly negative from the Gram contraction
               and is left so: the running sums need not be monotone)
  xp (n,)      the grid
  h (n,)       its spacings, h[0] = 0, h[j] = xp[j] - xp[j-1]
  qp (M,)      the seeds (the points, in mode 'rt')
Results: the sample (the CDF value, in mode 'rt'), the log-density of
the normalised conditional at it (dlf), the weights la, lb of the
cell's two nodes at it, and the cell's left node i0.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.profiling import span
from ._build import load_library
from .rowmath import SERVED_ANY, check_cuda_operands, cumsum_rows
from .rowmath import invert_quadratic as _invert_quadratic

__all__ = ["cdf_invert_ref", "cdf_invert_into_ref", "cdf_invert_cuda",
           "CDF_MAX_N"]

# The largest n the kernel takes: gram_conditional's on the card.
CDF_MAX_N = 128


def cdf_invert_ref(mode, fk, xp, h, qp):
    """CDF build, bracket and in-cell quadratic solve in fk's dtype.

    TWO-SIDED: seeds past the median invert against the right-tail mass
    (a reversed cumsum of only-small terms), so the perturbation stays at
    eps * (local tail mass) in both tails.  fk (M, n) unnormalised,
    xp (n,) grid, h (n,) spacings with h[0] = 0, qp (M,) seeds (x values
    in 'rt' mode).  Returns (out, dlf, la, lb, i0)."""
    with span("ttirt.cdf"):
        n = fk.shape[-1]
        dc = 0.5 * (fk[:, :-1] + fk[:, 1:]) * h[1:]
        total = torch.sum(dc, dim=-1, keepdim=True)
        # degenerate rows (no mass) fall back to the uniform density
        bad = total <= 0.0
        dc = torch.where(bad, (xp[1:] - xp[:-1]).expand_as(dc), dc)
        fk = torch.where(bad, torch.ones_like(fk), fk)
        total = torch.sum(dc, dim=-1, keepdim=True)
        dc = dc / total
        fk = fk / total
        zero = torch.zeros((fk.shape[0], 1), dtype=fk.dtype, device=fk.device)
        ck = torch.cat([zero, cumsum_rows(dc)], dim=1)
        cr = torch.cat([torch.flip(cumsum_rows(torch.flip(dc, [1])), [1]),
                        zero], dim=1)
        if mode == "rt":
            i0 = torch.sum(xp[None, :] < qp[:, None], dim=1) - 1
        else:
            right = qp > 0.5
            i0l = torch.sum(ck < qp[:, None], dim=1) - 1
            i0r = torch.sum(cr > (1.0 - qp)[:, None], dim=1) - 1
            i0 = torch.where(right, i0r, i0l)
        i0 = torch.clamp(i0, 0, n - 2)
        i1 = i0 + 1

        def read(rows, idx):
            return torch.gather(rows, 1, idx[:, None])[:, 0]

        c1 = read(ck, i0)
        cr2 = read(cr, i1)
        f1 = read(fk, i0)
        f2 = read(fk, i1)
        x1, x2 = xp[i0], xp[i1]
        if mode == "rt":
            xk = qp
            aq = 0.5 * (f2 - f1) / (x2 - x1)
            cl_ = aq * (xk - x1) ** 2 + f1 * (xk - x1) + c1
            yk = x2 - xk
            cr_ = 1.0 - (f2 * yk - aq * yk * yk + cr2)
            out = torch.where(cl_ > 0.5, cr_, cl_)
        else:
            xl_ = _invert_quadratic(f1, f2, c1, qp, x1, x2)
            xr_ = -_invert_quadratic(f2, f1, cr2, 1.0 - qp, -x2, -x1)
            xk = torch.where(right, xr_, xl_)
            out = xk
        la = (x2 - xk) / (x2 - x1)
        lb = (xk - x1) / (x2 - x1)
        dlf = torch.log(f1 * la + f2 * lb)
        return out, dlf, la, lb, i0


def cdf_invert_into_ref(mode, fk, xp, h, qp, out, lf):
    """``cdf_invert_ref`` called as ``cdf_invert_cuda`` is: writes the
    sample into ``out`` (M,), adds dlf into ``lf`` (M,) in place and
    returns (la, lb, i0), i0 int64."""
    x, dlf, la, lb, i0 = cdf_invert_ref(mode, fk, xp, h, qp)
    out.copy_(x)
    lf.add_(dlf)
    return la, lb, i0


_CDF_LIBRARY = None


def _lib():
    global _CDF_LIBRARY
    if _CDF_LIBRARY is None:
        lib = load_library("cdf_invert")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.cdf_invert_launch.argtypes = [p] * 9 + [i, i, i, p]
        lib.cdf_invert_launch.restype = i
        _CDF_LIBRARY = lib
    return _CDF_LIBRARY


def cdf_invert_cuda(mode, fk, xp, h, qp, out, lf):
    """``cdf_invert_ref``'s function through the CUDA kernel, on f32 CUDA
    tensors with n <= ``CDF_MAX_N``; raises on anything else.  Mode 'rt'
    evaluates the CDF; every other mode ('sqr', 'lin') inverts it.  The
    kernel writes the sample into ``out`` (M,) and adds dlf into ``lf``
    (M,) in place; returns (la, lb, i0) with i0 int32, what
    ``condition_update`` takes.  It sums a row's total in order with a
    compensation term where the plain version sums a tree, so the two
    differ by that rounding.
    ``cdf_invert_cuda.launches`` counts kernel launches."""
    fn = "cdf_invert_cuda"
    if fk.ndim != 2:
        raise ValueError(f"{fn}: fk must be a matrix")
    m, n = fk.shape
    f32 = torch.float32
    check_cuda_operands(fn, fk.device, {
        "fk": (fk, f32, (m, n)), "xp": (xp, f32, (n,)), "h": (h, f32, (n,)),
        "qp": (qp, f32, (m,)), "out": (out, f32, (m,)),
        "lf": (lf, f32, (m,))})
    if not 2 <= n <= CDF_MAX_N:
        raise ValueError(f"{fn}: n={n} outside the kernel's caps "
                         f"2<=n<={CDF_MAX_N}; {SERVED_ANY}")
    with span("ttirt.cdf"):
        la = torch.empty((m,), dtype=f32, device=fk.device)
        lb = torch.empty((m,), dtype=f32, device=fk.device)
        i0 = torch.empty((m,), dtype=torch.int32, device=fk.device)
        with torch.cuda.device(fk.device):
            stream = torch.cuda.current_stream(fk.device).cuda_stream
            err = _lib().cdf_invert_launch(
                fk.data_ptr(), xp.data_ptr(), h.data_ptr(), qp.data_ptr(),
                out.data_ptr(), lf.data_ptr(), la.data_ptr(), lb.data_ptr(),
                i0.data_ptr(), m, n, int(mode == "rt"), stream)
    if err != 0:
        raise RuntimeError(f"cdf_invert kernel launch failed: cudaError {err}")
    cdf_invert_cuda.launches += 1
    return la, lb, i0


cdf_invert_cuda.launches = 0
