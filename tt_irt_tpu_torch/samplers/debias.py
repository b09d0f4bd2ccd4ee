"""Debiasing of transport proposals (counterpart of
``tt_irt_tpu/samplers/debias.py``): Metropolis-Hastings rejection
(``mcmc_prune``), self-normalised importance weights (``iw_prune``) and
the single-TT entry point ``tt_irt_debias``.

The proposals are independent, so MH acceptance depends only on the
log-density pairs: the sequential chain runs as a plain host loop over
f64 scalars, and the pruned rows are then gathered on the device.
"""

from __future__ import annotations

import math
import time
from typing import NamedTuple

import numpy as np
import torch

from ..ops.tt import TT
from ..utils.device import resolve_device
from .irt import tt_irt_lin

__all__ = ["mcmc_prune", "rejection_histogram", "MCMCResult", "IWResult",
           "iw_prune", "tt_irt_debias"]


class MCMCResult(NamedTuple):
    y: torch.Tensor          # pruned samples (M, d)
    lfex: torch.Tensor       # exact data at pruned samples (M,) or (M, R+1)
    lfapp: torch.Tensor      # proposal log density at pruned samples (M,)
    num_rejects: int
    accepted: torch.Tensor   # bool mask: proposal i accepted
    rej_hist: np.ndarray     # rejection-run histogram


def rejection_histogram(accepted) -> np.ndarray:
    """hist[k-1] = number of length-k rejection runs terminated by an
    acceptance (a trailing unterminated run is not counted)."""
    a = np.asarray(accepted)[1:]
    idx = np.nonzero(a)[0]
    if idx.size == 0:
        return np.zeros(0, np.int64)
    prev = np.concatenate([[-1], idx[:-1]])
    runs = idx - prev - 1
    runs = runs[runs > 0]
    if runs.size == 0:
        return np.zeros(0, np.int64)
    return np.bincount(runs)[1:]


def mcmc_prune(y, lfex, lfapp, generator=None, u=None) -> MCMCResult:
    """Independence-proposal MH rejection over a proposed chain.

    Args:
      y: (M, d) proposals; lfex: (M,) or (M, R+1) exact log-density
        (column 0) and quantities of interest; lfapp: (M,) proposal
        log-density.
      u: (M-1,) uniforms, or a ``torch.Generator`` to draw them (f64,
        on the generator's device).
    """
    lfapp = lfapp.reshape(-1)
    m = y.shape[0]
    if u is None:
        if generator is None:
            raise ValueError("mcmc_prune needs uniforms u or a generator")
        u = torch.rand((m - 1,), generator=generator, dtype=torch.float64,
                       device=generator.device)
    le = (lfex if lfex.ndim == 1 else lfex[:, 0]).detach().cpu()
    le = le.to(torch.float64).tolist()
    la = lfapp.detach().cpu().to(torch.float64).tolist()
    uu = torch.as_tensor(u).detach().cpu().to(torch.float64).tolist()
    src = np.empty(m, np.int64)
    acc = np.empty(m, bool)
    src[0], acc[0] = 0, True
    cur = 0
    for i in range(1, m):
        a = ((le[i] - le[cur]) - la[i]) + la[cur]
        # exp(a) >= u: for a > 0 the ratio exceeds 1 > u (also where exp
        # would overflow)
        ok = a > 0.0 or math.exp(a) >= uu[i - 1]
        if ok:
            cur = i
        src[i], acc[i] = cur, ok
    idx = torch.as_tensor(src, device=y.device)
    return MCMCResult(y[idx], lfex[idx], lfapp[idx],
                      int(m - 1 - acc[1:].sum()),
                      torch.as_tensor(acc, device=y.device),
                      rejection_histogram(acc))


class IWResult(NamedTuple):
    lfex: torch.Tensor       # weighted data: data * (Fex/Fapp) / Z
    isstd: torch.Tensor      # relative std of the normalised ratio
    max_ratio: torch.Tensor  # largest normalised ratio
    err1: torch.Tensor       # empirical L1 error <|Fex/Z - Fapp| / Fapp>


def iw_prune(lfex, lfapp) -> IWResult:
    """Self-normalised importance-weight correction.  lfex is (M,) or
    (M, R+1) with the log-density in column 0."""
    lfex = torch.as_tensor(lfex)
    lfapp = torch.as_tensor(lfapp).reshape(-1)
    lfex2 = lfex if lfex.ndim == 2 else lfex[:, None]
    ratio = torch.exp(lfex2[:, 0] - lfapp)
    renorm = torch.mean(ratio)
    w = ratio / renorm
    err1 = torch.mean(torch.abs(torch.exp(lfex2[:, 0] - torch.log(renorm))
                                - torch.exp(lfapp)) / torch.exp(lfapp))
    weighted = lfex2 * w[:, None]
    if lfex.ndim == 1:
        weighted = weighted[:, 0]
    isstd = torch.sqrt(torch.mean((w - 1.0) ** 2))
    return IWResult(weighted, isstd, torch.max(w), err1)


def _host_read(*ts) -> None:
    """Wait for the tensors' values by reading a sum of each on the
    host (the timings below end on it)."""
    for t in ts:
        float(torch.as_tensor(t).sum())


def tt_irt_debias(m, lffun, f: TT, grid, correction: str = "mcmc",
                  generator=None, device="cuda"):
    """Single-level TT proposal and its debiasing.

    Args:
      m: number of samples (uniform seeds drawn from ``generator``) or
        an (M, d) seed array.
      lffun: exact log-density, (M, d) -> (M,) or (M, R+1).
      f: TT of the density itself (not its square root); its dtype sets
        tt_irt_lin's precision ('f64' or 'f32').
      grid: the grids, as tt_irt_lin takes them.
      correction: 'mcmc' (mcmc_prune, uniforms from ``generator``) or
        'iw' (iw_prune).
      generator: a ``torch.Generator`` on ``device``; needed for an
        integer m and for 'mcmc'.
      device: where the proposal runs (default "cuda").
    Returns a dict with the JAX package's keys: y, lFex, lFapp, bias
    (the rejection count, or isstd), accepted or max_ratio and err1, and
    time_invcdf / time_eval (seconds to a forced host read of the
    proposal, and of the exact log-density).
    """
    dev = resolve_device(device)
    d = f.d
    if isinstance(m, (int, np.integer)):
        if generator is None:
            raise ValueError("tt_irt_debias needs a generator to draw "
                             "seeds")
        z = torch.rand((int(m), d), generator=generator,
                       dtype=torch.float64, device=dev)
    else:
        z = torch.as_tensor(m, dtype=torch.float64, device=dev)
    t0 = time.perf_counter()
    y, lfapp = tt_irt_lin(grid, f, z, device=dev)
    _host_read(y, lfapp)
    time_invcdf = time.perf_counter() - t0
    t0 = time.perf_counter()
    lfex = lffun(y)
    _host_read(lfex)
    time_eval = time.perf_counter() - t0
    if correction.lower().startswith("mcmc"):
        res = mcmc_prune(y, lfex, lfapp, generator=generator)
        return {"y": res.y, "lFex": res.lfex, "lFapp": res.lfapp,
                "bias": res.num_rejects, "accepted": res.accepted,
                "time_invcdf": time_invcdf, "time_eval": time_eval}
    res = iw_prune(lfex, lfapp)
    return {"y": y, "lFex": res.lfex, "lFapp": lfapp, "bias": res.isstd,
            "max_ratio": res.max_ratio, "err1": res.err1,
            "time_invcdf": time_invcdf, "time_eval": time_eval}
