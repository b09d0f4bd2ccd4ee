"""One-call front end over the whole pipeline (counterpart of
``tt_irt_tpu/api.py``): build a TT of the density by cross (or a DIRT
stack over a tempering ladder), transport seeds, debias, and compute the
diagnostics, returning every intermediate object.

``logpost`` is a function on torch tensors: (M, d) f64 on ``device`` ->
(M,).  A ``torch.Generator`` seeded from ``seed`` takes the place of the
JAX keys, so pseudo-random runs match the JAX package's in distribution,
not number for number; the ``qmc=True`` path takes ``qmcnodes`` seeds
and matches it number for number wherever the two crosses do.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .constructors.amen_cross import amen_cross_s
from .constructors.dirt_build import tt_dirt_approx
from .samplers.debias import mcmc_prune
from .samplers.diagnostics import essinv, hellinger
from .samplers.dirt import tt_dirt_sample
from .samplers.irt import tt_irt_sqr
from .samplers.qmc import qmcnodes
from .samplers.reference import randref
from .utils.device import resolve_device

__all__ = ["sample_posterior", "PosteriorResult"]


@dataclass
class PosteriorResult:
    """Everything the pipeline produced (nothing hidden)."""

    samples: torch.Tensor          # debiased posterior samples (M, d)
    logpost: torch.Tensor          # exact unnormalised log-density there
    weights: Optional[np.ndarray]  # IS weights ('iw' / qmc), else None
    ess_inv: float                 # N/ESS of the raw transport proposals
    hellinger: float               # Hellinger(proposal, posterior)
    num_rejects: Optional[int]     # MH rejections ('mcmc'), else None
    transport: object              # the TT (single level) or DIRT stack
    grids: list                    # the grid vectors used
    evalcnt: np.ndarray            # model evaluations spent building

    def __repr__(self):
        mode = "iw" if self.weights is not None else "mcmc"
        return (f"PosteriorResult(M={self.samples.shape[0]}, "
                f"d={self.samples.shape[1]}, N/ESS={self.ess_inv:.3f}, "
                f"hellinger={self.hellinger:.3g}, debias={mode!r})")


def sample_posterior(logpost: Callable, grids: Sequence, m: int, *,
                     beta: Optional[Sequence[float]] = None,
                     tol: float = 1e-4,
                     debias: str = "mcmc",
                     qmc: bool = False,
                     seed: int = 0,
                     reference: str = "uniform",
                     verb: int = 0,
                     cross_kwargs: Optional[dict] = None,
                     dirt_kwargs: Optional[dict] = None,
                     device="cuda") -> PosteriorResult:
    """Draw ``m`` debiased samples from an unnormalised log-density.

    Args:
      logpost: ``x (M, d) -> (M,)`` unnormalised log-density, on torch
        f64 tensors on ``device``.
      grids: d grid vectors covering the support.
      m: number of samples.
      beta: tempering ladder.  None or one value builds a single-level TT
        of sqrt(density) by AMEn cross (TT-MH / TT-qIW); an increasing
        ladder builds a DIRT stack.
      tol: cross tolerance.
      debias: 'mcmc' (Metropolis rejection) or 'iw' (importance weights).
      qmc: transport ``qmcnodes`` points instead of pseudo-random seeds
        (TT-qIW; forces debias='iw').
      seed: seeds the cross, the DIRT build, ``qmcnodes`` and the
        ``torch.Generator`` of the seeds and the MH uniforms.
      reference: DIRT reference measure ('uniform' or e.g. 'n4').
      cross_kwargs / dirt_kwargs: forwarded to ``amen_cross_s`` /
        ``tt_dirt_approx``.
      device: where everything runs (default "cuda").

    Returns a PosteriorResult.
    """
    dev = resolve_device(device)
    grids = [np.asarray(g, dtype=np.float64).reshape(-1) for g in grids]
    d = len(grids)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if qmc:
        debias = "iw"
    if debias not in ("mcmc", "iw"):
        raise ValueError(f"debias={debias!r} (want 'mcmc' or 'iw')")
    deep = beta is not None and len(list(beta)) > 1

    def seeds():
        if qmc:
            pts = qmcnodes(d, int(np.ceil(np.log2(m))), seed=seed)[:m]
            return torch.from_numpy(pts).to(dev)
        return torch.rand((m, d), generator=gen, dtype=torch.float64,
                          device=dev)

    if deep:
        dirt = tt_dirt_approx(grids, lambda x, b0, b1:
                              (b1 - b0) * logpost(x),
                              list(beta), reference=reference, verb=verb,
                              seed=seed, device=dev, **(dirt_kwargs or {}))
        z, lfapp, lfex = tt_dirt_sample(dirt, randref(reference, seeds()),
                                        logpost, device=dev)
        transport, evalcnt = dirt, np.atleast_1d(dirt.evalcnt)
    else:
        gr = [torch.from_numpy(g).to(dev) for g in grids]

        def fun(ind):
            ind = ind.long()
            pts = torch.stack([gr[k][ind[:, k]] for k in range(d)], 1)
            return torch.exp(0.5 * logpost(pts))

        res = amen_cross_s([len(g) for g in grids], fun, tol, tol_exit=tol,
                           verb=verb, seed=seed, torch_fun=True, device=dev,
                           **(cross_kwargs or {}))
        z, lfapp = tt_irt_sqr(grids, res.tt, seeds(), device=dev)
        lfex = logpost(z)
        transport, evalcnt = res.tt, np.atleast_1d(res.evalcnt)

    einv = float(essinv(lfex, lfapp))
    hell = float(hellinger(lfex, lfapp))
    if debias == "mcmc":
        mh = mcmc_prune(z, lfex, lfapp, generator=gen)
        return PosteriorResult(mh.y, mh.lfex, None, einv, hell,
                               int(mh.num_rejects), transport, grids,
                               evalcnt)
    return PosteriorResult(z, lfex, _iw_weights(lfex, lfapp).cpu().numpy(),
                           einv, hell, None, transport, grids, evalcnt)


def _iw_weights(lfex, lfapp) -> torch.Tensor:
    """Self-normalised importance weights exp(lfex - lfapp) / sum."""
    lfex1 = lfex[:, 0] if lfex.ndim == 2 else lfex
    lw = lfex1 - lfapp
    w = torch.exp(lw - torch.max(lw))
    return w / torch.sum(w)
