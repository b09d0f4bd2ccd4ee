"""Stein variational Newton, the comparison baseline (counterpart of
``tt_irt_tpu/samplers/svn.py``).

Particles move under the Stein-Newton update with a Hessian-scaled RBF
kernel.  Gradients and Hessians of -log posterior come from
``torch.func.vmap`` over ``torch.func.grad`` and ``torch.func.hessian``
(in place of ``jax.grad`` and ``jax.hessian``); a host loop over the
steps takes the place of ``lax.scan``.  The JAX package has no Pallas
kernel here; this is plain PyTorch on the device.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch.func import grad, hessian, vmap

from ..utils.device import resolve_device

__all__ = ["svn", "SVNResult"]


class SVNResult(NamedTuple):
    particles: torch.Tensor  # (N, d)
    steps: int
    grad_norm: torch.Tensor


def svn(neg_logpost: Callable, x0, *, steps: int = 30,
        step_size: float = 1.0, damping: float = 1e-2,
        max_step: float | None = None, bounds=None,
        spd_mode: str = "eigh", device="cuda") -> SVNResult:
    """Stein variational Newton with a Hessian-scaled RBF kernel.

    Args:
      neg_logpost: scalar function of one sample (d,) -> () on torch
        tensors; mapped over the particles and differentiated here.
      x0: (N, d) initial particles.
      steps, step_size: iterations and their step length.
      damping: eigenvalue floor of the SPD Hessians, and the shift of
        the Newton metric.
      max_step: trust-region cap on a particle's displacement (default
        std(x0) + 0.1).
      bounds: optional (lo, hi) box; particles are clipped into it.
      spd_mode: how each Hessian is made SPD: 'eigh' (eigenvalues
        clipped at ``damping``; default) or 'gershgorin' (the diagonal
        shifted by the Gershgorin bound of the least eigenvalue).
      device: where the particles live (default "cuda").
    """
    if spd_mode not in ("eigh", "gershgorin"):
        raise ValueError(f"spd_mode={spd_mode!r}")
    dev = resolve_device(device)
    x = torch.as_tensor(x0, dtype=torch.float64, device=dev)
    n, d = x.shape
    if max_step is None:
        max_step = float(torch.std(x, correction=0) + 0.1)
    grad_f = vmap(grad(neg_logpost))
    hess_f = vmap(hessian(neg_logpost))
    eye = torch.eye(d, dtype=x.dtype, device=dev)
    lo = hi = None
    if bounds is not None:
        lo = torch.as_tensor(bounds[0], dtype=x.dtype, device=dev)
        hi = torch.as_tensor(bounds[1], dtype=x.dtype, device=dev)

    def spdify(h):
        if spd_mode == "eigh":
            w, v = torch.linalg.eigh(h)
            w = torch.clamp(w, min=damping)
            return torch.einsum("nab,nb,ncb->nac", v, w, v)
        h = 0.5 * (h + h.transpose(1, 2))
        diag = torch.diagonal(h, dim1=1, dim2=2)
        offsum = torch.sum(torch.abs(h), dim=2) - torch.abs(diag)
        lmin = torch.amin(diag - offsum, dim=1)
        shift = torch.clamp(damping - lmin, min=0.0)
        return h + shift[:, None, None] * eye

    for _ in range(steps):
        g = grad_f(x)                                   # (N, d)
        h = spdify(hess_f(x))                           # (N, d, d)
        m = torch.mean(h, dim=0)                        # kernel metric
        diff = x[:, None, :] - x[None, :, :]            # (N, N, d)
        md = torch.einsum("nmd,de,nme->nm", diff, m, diff) / d
        kmat = torch.exp(-0.5 * md)
        gk = -torch.einsum("nm,de,nme->nmd", kmat, m, diff) / d
        phi = (-(kmat.T @ g) + torch.sum(gk, dim=0)) / n
        hsum = (torch.einsum("mn,mab->nab", kmat ** 2, h) / n
                + torch.einsum("mnd,mne->nde", gk, gk) / n + damping * eye)
        dx = torch.cholesky_solve(phi[:, :, None],
                                  torch.linalg.cholesky(hsum))[:, :, 0]
        nrm = torch.linalg.norm(dx, dim=1, keepdim=True)
        dx = dx * torch.clamp(max_step / torch.clamp(nrm, min=1e-30),
                              max=1.0)
        x = x + step_size * dx
        if lo is not None:
            x = torch.minimum(torch.maximum(x, lo), hi)
    gnorm = torch.linalg.norm(grad_f(x)) / n
    return SVNResult(x, steps, gnorm)
