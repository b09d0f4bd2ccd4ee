"""Small pieces shared by the kernels' plain versions and the samplers:
the in-cell quadratic inversion, the row-wise running sum, the full-f32
matmul guard, the operand check of the kernel wrappers and the card's
shared-memory limit.  Nothing here imports
from ``samplers/``."""

from __future__ import annotations

import contextlib

import torch

__all__ = ["invert_quadratic", "full_f32_matmul", "cumsum_rows",
           "check_cuda_operands", "SMEM_LIMIT"]

# Dynamic shared memory one block may use on Hopper (232,448 bytes).
SMEM_LIMIT = 232448


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


def cumsum_rows(t: torch.Tensor) -> torch.Tensor:
    """Running sum along dim 1 of an (M, n) tensor, taken on its
    (n, M) copy: PyTorch's scan along a short innermost dimension is
    slow on the card (1.5 ms for (2^18, 16) f32 on an H100, against
    0.05 ms-class elementwise passes), the scan along an outer
    dimension is not."""
    return torch.cumsum(t.T.contiguous(), dim=0).T


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
