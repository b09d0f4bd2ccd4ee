"""Batched gather-GEMM primitive (`tracemult` parity).

Counterpart of ``tt_irt_tpu/ops/tracemult.py``.  The reference's C
kernel (matlab/utils/tracemult.c, MATLAB fallback tracemultm.m) computes
``C[:, :, i] = A[:, :, i] @ B[:, :, j[i]]``, a batched matmul with a
gather on B's batch index, and the 2-argument gather ``C[i] = A[i,
j[i]]``.  The samplers never call it; it is part of the reference's
utility surface, kept for user code built on it.  No Pallas kernel
stands behind it in the JAX package, so here it is plain PyTorch
(``torch.bmm`` and ``torch.gather``) on whatever device its inputs are.

Layout: the batch axis leads, (batch, n1, n2), as in the JAX package.
"""

from __future__ import annotations

import torch

__all__ = ["tracemult", "tracemult_gather"]


def tracemult(a, b, j=None):
    """C[i] = A[i] @ B[j[i]] (j defaults to arange: plain batched matmul).

    a: (M, p, q); b: (K, q, r); j: (M,) int indices into b's batch.
    Returns (M, p, r) on a's device.
    """
    a = torch.as_tensor(a)
    b = torch.as_tensor(b, device=a.device)
    if j is not None:
        b = b[torch.as_tensor(j, device=a.device).long()]
    return torch.bmm(a, b.to(a.dtype))


def tracemult_gather(a, j):
    """C[i] = A[i, j[i]] (the reference's 2-argument form, used for the
    CDF bisection gathers).  a: (M, n); j: (M,) int."""
    a = torch.as_tensor(a)
    j = torch.as_tensor(j, device=a.device).long()
    return torch.gather(a, 1, j[:, None])[:, 0]
