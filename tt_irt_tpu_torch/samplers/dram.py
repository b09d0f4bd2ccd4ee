"""DRAM: delayed-rejection adaptive Metropolis, the comparison baseline
(counterpart of ``tt_irt_tpu/samplers/dram.py``).

Independent chains move together as one batch on the device; a host
loop over the steps takes the place of ``lax.scan`` (the adaptation
schedule depends on the step alone, so the loop never reads the device).
Gaussian proposals with an adapted covariance (Haario et al.'s AM, a
running mean and second moment over all chains), bounds by rejection, a
second delayed-rejection stage scaled down by ``drscale`` (Mira 2001, as
in dramrun), and burn-in.  A ``torch.Generator`` takes the place of the
JAX key, so chains are compared with the JAX package's by statistics.
The JAX package has no Pallas kernel here; this is plain PyTorch.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..utils.device import resolve_device

__all__ = ["dram", "DRAMResult"]


class DRAMResult(NamedTuple):
    chain: torch.Tensor        # (nsteps - burnin, nchains, d)
    logpost: torch.Tensor      # (nsteps - burnin, nchains)
    accept_rate: torch.Tensor  # scalar
    cov: torch.Tensor          # final adapted covariance (d, d)


def dram(logpost: Callable, x0, nsteps: int, *, generator=None,
         cov0=None, bounds=None, adapt_start: int = 100,
         adapt_interval: int = 10, drscale: float = 5.0,
         scale: Optional[float] = None, burnin: int = 0,
         device="cuda") -> DRAMResult:
    """Run DRAM chains.

    Args:
      logpost: (M, d) -> (M,) log posterior on f64 tensors.
      x0: (nchains, d) initial states (or (d,) for one chain).
      nsteps: chain length before burn-in is dropped.
      generator: a ``torch.Generator`` on ``device`` (default: seed 0).
      cov0: initial proposal covariance (default 0.1 I).
      bounds: optional (lo, hi); proposals outside are rejected.
      adapt_start, adapt_interval: the covariance adapts every
        ``adapt_interval`` steps after ``adapt_start``.
      drscale: the second stage's proposal shrink factor.
      scale: proposal scale (default 2.38 / sqrt(d)).
      burnin: leading steps dropped from the result.
      device: where the chains run (default "cuda").
    """
    dev = resolve_device(device)
    f64 = torch.float64
    x = torch.atleast_2d(torch.as_tensor(x0, dtype=f64, device=dev))
    nchains, d = x.shape
    gen = (generator if generator is not None
           else torch.Generator(device=dev).manual_seed(0))
    if scale is None:
        scale = 2.38 / np.sqrt(d)
    cov0 = (torch.eye(d, dtype=f64, device=dev) * 0.1 if cov0 is None
            else torch.as_tensor(cov0, dtype=f64, device=dev))
    lo = hi = None
    if bounds is not None:
        lo = torch.as_tensor(bounds[0], dtype=f64, device=dev)
        hi = torch.as_tensor(bounds[1], dtype=f64, device=dev)
    eye = torch.eye(d, dtype=f64, device=dev)
    ninf = torch.tensor(-torch.inf, dtype=f64, device=dev)

    def logpost_in(y):
        if lo is None:
            return logpost(y)
        inside = torch.all((y >= lo) & (y <= hi), dim=-1)
        return torch.where(inside, logpost(y), ninf)

    def q1_log(a, b, chol):
        sol = torch.linalg.solve_triangular(chol, (a - b).T,
                                            upper=False).T / scale
        return -0.5 * torch.sum(sol * sol, dim=-1)

    def normal():
        return torch.randn((nchains, d), generator=gen, dtype=f64,
                           device=dev)

    def uniform():
        return torch.rand((nchains,), generator=gen, dtype=f64, device=dev)

    lp = logpost(x)
    mean = torch.zeros(d, dtype=f64, device=dev)
    m2 = torch.zeros((d, d), dtype=f64, device=dev)
    nacc = torch.zeros((), dtype=torch.int64, device=dev)
    chol = torch.linalg.cholesky(cov0)
    chain, lps = [], []
    for it in range(1, nsteps + 1):
        # stage 1
        y1 = x + scale * normal() @ chol.T
        lpy1 = logpost_in(y1)
        a1 = torch.exp(torch.clamp(lpy1 - lp, max=0.0))
        acc1 = uniform() < a1
        # stage 2 (delayed rejection) for the chains stage 1 rejects
        y2 = x + (scale / drscale) * normal() @ chol.T
        lpy2 = logpost_in(y2)
        a_y2y1 = torch.exp(torch.clamp(lpy1 - lpy2, max=0.0))
        la2 = (lpy2 - lp + q1_log(y2, y1, chol) - q1_log(x, y1, chol)
               + torch.log1p(-torch.clamp(a_y2y1, max=1.0 - 1e-15))
               - torch.log1p(-torch.clamp(a1, max=1.0 - 1e-15)))
        a2 = torch.exp(torch.clamp(la2, max=0.0))
        acc2 = (~acc1) & (uniform() < a2) & torch.isfinite(lpy2)
        x = torch.where(acc1[:, None], y1, torch.where(acc2[:, None], y2, x))
        lp = torch.where(acc1, lpy1, torch.where(acc2, lpy2, lp))
        nacc = nacc + torch.sum(acc1 | acc2)
        # AM adaptation over all chains
        count = it * nchains
        delta = x - mean
        mean = mean + torch.sum(delta, dim=0) / count
        m2 = m2 + delta.T @ (x - mean)
        if it > adapt_start and it % adapt_interval == 0:
            chol = torch.linalg.cholesky(m2 / max(count - 1, 1)
                                         + 1e-10 * eye)
        chain.append(x)
        lps.append(lp)
    count = nsteps * nchains
    return DRAMResult(torch.stack(chain[burnin:]), torch.stack(lps[burnin:]),
                      nacc / count, m2 / max(count - 1, 1))
