"""Small pieces shared by the kernels' plain versions and the samplers:
the in-cell quadratic inversion, the row-wise running sum, the f32 CDF
rows of the 'hi' family, the full-f32 matmul guard, the operand and
shape checks of the kernel wrappers and the card's shared-memory limit.  Nothing here imports
from ``samplers/``."""

from __future__ import annotations

import contextlib

import torch

__all__ = ["invert_quadratic", "full_f32_matmul", "cumsum_rows", "cdf_sums32",
           "cdf_rows32", "check_cuda_operands", "check_factor_caps",
           "SMEM_LIMIT", "SERVED_ANY"]

# Dynamic shared memory one block may use on Hopper (232,448 bytes).
SMEM_LIMIT = 232448
# What serves a shape on the card past the kernels' wide tiers (n, r <=
# 128).
SERVED_ANY = "on the card precision 'f64' (no kernel) serves any shape"


def invert_quadratic(f1, f2, c1, q, x1, x2):
    """Solve A (x-x1)^2 + f1 (x-x1) = q - c1 on [x1, x2] in the
    citardauq form 2t / (f1 + sqrt(f1^2 + 4At)), which needs no A == 0
    special case and does not cancel on flat cells; clipped into
    [x1, x2].  Works in the inputs' dtype."""
    h3 = x2 - x1
    aq = 0.5 * (f2 - f1) / h3
    t = q - c1
    dq = f1 * f1 + 4.0 * aq * t
    den = f1 + torch.sqrt(torch.clamp(dq, min=0.0))
    bad = den <= 0.0
    safe = torch.where(bad, torch.ones_like(den), den)
    xk = torch.where(bad, x1, x1 + 2.0 * t / safe)
    return torch.minimum(torch.maximum(xk, x1), x2)


def check_cuda_operands(fn, dev, operands) -> None:
    """Raise ValueError unless ``dev`` is a CUDA device and every entry
    name -> (tensor, dtype, shape) is a contiguous tensor of that dtype
    and shape on it: what a kernel wrapper checks before it hands
    pointers to its kernel."""
    if dev.type != "cuda":
        raise ValueError(f"{fn}: needs CUDA tensors, got {dev}")
    for name, (t, dtype, shape) in operands.items():
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"{fn}: {name} must be {dtype} on {dev}, got "
                             f"{t.dtype} on {t.device}")
        if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous "
                             f"{tuple(shape)}, got {tuple(t.shape)}")


def check_factor_caps(fn, n, r, max_n, max_r, smem,
                      served=SERVED_ANY) -> None:
    """Raise ValueError for a shape (n, r) outside a kernel's caps or
    needing more than ``SMEM_LIMIT`` bytes of shared memory; the message
    ends with ``served``, what serves such a shape instead."""
    if not (2 <= n <= max_n and 1 <= r <= max_r):
        raise ValueError(f"{fn}: n={n}, r={r} outside the kernel's caps "
                         f"n<={max_n}, r<={max_r}; {served}")
    if smem > SMEM_LIMIT:
        raise ValueError(f"{fn}: n={n}, r={r} needs {smem} bytes of "
                         f"shared memory (limit {SMEM_LIMIT})")


def cumsum_rows(t: torch.Tensor) -> torch.Tensor:
    """Running sum along dim 1 of an (M, n) tensor, taken on its
    (n, M) copy: PyTorch's scan along a short innermost dimension is
    slow on the card (1.5 ms for (2^18, 16) f32 on an H100, against
    0.05 ms-class elementwise passes), the scan along an outer
    dimension is not."""
    return torch.cumsum(t.T.contiguous(), dim=0).T


def cdf_sums32(fk, h32):
    """The trapezoid CDF of fk (M, n) summed from both sides in fk's
    dtype, with spacings h32 (n-1,).  A row without mass gets fk = 1 (a
    uniform conditional).  Returns (fk, ck, cr): ck[:, j] the mass left
    of node j, cr[:, j] the mass right of it; ck[:, -1] is the total."""
    m = fk.shape[0]
    dc = 0.5 * (fk[:, :-1] + fk[:, 1:]) * h32
    bad = torch.sum(dc, dim=1, keepdim=True) <= 0.0
    dc = torch.where(bad, h32.expand_as(dc), dc)
    fk = torch.where(bad, torch.ones_like(fk), fk)
    zero = torch.zeros((m, 1), dtype=fk.dtype, device=fk.device)
    ck = torch.cat([zero, cumsum_rows(dc)], dim=1)
    cr = torch.cat([torch.flip(cumsum_rows(torch.flip(dc, [1])), [1]),
                    zero], dim=1)
    return fk, ck, cr


def cdf_rows32(mode, fk, x32, xlo, h32, qp32, um32):
    """f32 trapezoid CDF from both sides, count-based bracket, readout
    and the f32 weight of the sample in its cell (``_cdf_rows32`` of the
    JAX package): the CDF stage shared by the plain versions of
    dim_step, odim_step and cdf_bracket_factor and by the 'gs' forward
    pass.  fk (M, n) f32 unnormalised, x32/xlo (n,) the grid as an f32
    pair, h32 (n-1,) spacings, qp32 the f32 seeds (points in 'rt' mode),
    um32 = f32(1 - seed).  Returns (out9 (M, 9), i0 (M,) int64, la (M,))
    with out9 = [c1, cr2, f1, f2, x1h, x1l, x2h, x2l, tot]."""
    n = fk.shape[1]
    fk, ck, cr = cdf_sums32(fk, h32)
    tot = ck[:, -1]
    if mode == "rt":
        i0 = torch.sum(x32[None, :] < qp32[:, None], dim=1) - 1
        right = torch.zeros_like(qp32, dtype=torch.bool)
        qt = ut = torch.zeros_like(qp32)
    else:
        right = qp32 > 0.5
        qt = qp32 * tot
        ut = um32 * tot
        i0l = torch.sum(ck < qt[:, None], dim=1) - 1
        i0r = torch.sum(cr > ut[:, None], dim=1) - 1
        i0 = torch.where(right, i0r, i0l)
    i0 = torch.clamp(i0, 0, n - 2)
    i1 = i0 + 1

    def read(rows, idx):
        return torch.gather(rows, 1, idx[:, None])[:, 0]

    c1 = read(ck, i0)
    cr2 = read(cr, i1)
    f1 = read(fk, i0)
    f2 = read(fk, i1)
    x1, x2 = x32[i0], x32[i1]
    out9 = torch.stack([c1, cr2, f1, f2, x1, xlo[i0], x2, xlo[i1], tot],
                       dim=1)
    if mode == "rt":
        xk = qp32
    else:
        xl_ = invert_quadratic(f1, f2, c1, qt, x1, x2)
        xr_ = -invert_quadratic(f2, f1, cr2, ut, -x2, -x1)
        xk = torch.where(right, xr_, xl_)
    la = torch.clamp((x2 - xk) / (x2 - x1), 0.0, 1.0)
    return out9, i0, la


@contextlib.contextmanager
def full_f32_matmul():
    """f32 matmuls in full f32 inside the block; the caller's setting is
    restored on exit.  TF32 keeps ~10 mantissa bits, far above the 1e-6
    sample-parity budget of the f32 paths."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
