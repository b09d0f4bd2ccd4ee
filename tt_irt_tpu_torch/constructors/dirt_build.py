"""DIRT construction: stacked SIRT layers over a tempering ladder
(counterpart of ``tt_irt_tpu/constructors/dirt_build.py``).

Re-design of matlab/constructors/tt_dirt_approx.m: each level builds a TT
approximation of sqrt(density ratio) by the AMEn cross; the ratio at
level l is evaluated by pushing the cross's probe points through the
already-built transform stack (``dualbetafun``, tt_dirt_approx.m:463-479).

Level self-testing (N/ESS gate with bounded recomputes,
tt_dirt_approx.m:418-453), the overflow baseline ``lFshift``
(:276-281,443-450), per-level vector hyperparameters (:101-122) and
resume from an existing DIRT (:154-173) are all kept.

The cross's sweep runs on the host; each probe batch arrives as an index
tensor on the build's device, where the grid gather, the pushes through
the stack and (for a torch density) the density run.  The pushes of one
level attempt go through one ``DirtSampler``, prepared once for that
attempt's stack: its outputs equal ``tt_dirt_sample``'s bit for bit.
Random draws (test samples, the MH test) come from one
``torch.Generator`` seeded with ``seed``; the cross draws from numpy.
"""

from __future__ import annotations

import functools
import time
import warnings
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..ops.tt import TT, tt_round
from ..parallel.mesh import canonical, check_mesh, sharded_rows
from ..samplers.debias import mcmc_prune
from ..samplers.diagnostics import essinv, hellinger
from ..samplers.chebyshev import lobatto_nodes
from ..samplers.dirt import DIRT, tt_dirt_sample
from ..samplers.reference import randref, reference_sigma
from ..samplers.serve import DirtSampler
from ..utils.checkpoint import save_dirt
from ..utils.device import resolve_device
from .amen_cross import amen_cross_s
from .greedy_cross import greedy_cross

__all__ = ["tt_dirt_approx", "DirtOptions"]


@dataclass
class DirtOptions:
    """Hyperparameters of DIRT construction (defaults match
    tt_dirt_approx.m:43-57).  ``nswp``/``kickrank``/``stoptol``/
    ``trunctol``/``y0`` may be scalars or per-level vectors."""

    nq: Optional[Sequence[int]] = None
    stoptol: float | Sequence[float] = 0.4
    trunctol: float | Sequence[float] = 0.0
    y0: int | Sequence[int] = 1
    kickrank: float | Sequence[float] = 4
    nswp: int | Sequence[int] = 4
    boundary: bool = False
    testsamples: int = 10_000
    recompute: float = 50.0
    irtdenom: bool | Sequence[bool] = False
    reference: str = "uniform"
    # 'spline', 'chebyshev' (levels >= 1 on Lobatto nodes) or 'fourier'
    # (levels >= 1 on the uniform grid without its left border); level 0
    # is spline in all three, and the spectral two force boundary=True
    interpolation: str = "spline"
    # 'amen' (default) or 'greedy': the level-TT cross backend
    # (tt_dirt_approx.m:177-188 'crossmethod' amen_cross_s /
    # greedy2_cross; greedy uses the grid-midpoint rank-1 start and
    # grows rank one pivot per bond per sweep)
    crossmethod: str = "amen"
    verb: int = 0
    seed: int = 0
    rmax: Optional[int] = None
    # Precision of the construction-time pushes through the stack, any
    # precision name of the serve path (None: by the cores' dtype, 'f64'
    # for the f64 TTs the cross builds; 'hi' runs them through dim_step
    # on the card).  Reduced-precision inverse-CDF errors compound
    # through the level composition, so the default is f64.
    precision: Optional[str] = None
    # save the stack after every accepted level (resume with
    # load_dirt(...) + irtstruct=...)
    checkpoint_path: Optional[str] = None
    # optional parallel.sample_mesh: the construction-time probe batches
    # (the DIRT pushes and the density evaluations) run with their
    # sample axis sharded over it; it needs a torch density (vec True or
    # 'auto')
    mesh: Optional[object] = None
    # How the user density is evaluated (the reference drives arbitrary
    # user functions, including non-vectorized ones, tt_dirt_approx.m:
    # 483-499):
    #   'auto' (default) — call it with torch tensors on the device; if
    #     it raises TypeError or returns something other than a tensor
    #     (a numpy density), fall back to the host path below for good,
    #     with a warning.
    #   True  — require a torch density (tensors in, a tensor out).
    #   'host' — vectorized host function: the pushes still run on the
    #     device, only the density is called with numpy (M, d) points.
    #   False — non-vectorized host function: called one (1, d) row at
    #     a time (the parfor-wrapper analog).
    vec: bool | str = "auto"
    extra: dict = field(default_factory=dict)


def _per_level(v, nlvl):
    arr = np.atleast_1d(np.asarray(v, dtype=object))
    if arr.shape[0] == 1:
        arr = np.repeat(arr, nlvl + 1)
    if arr.shape[0] < nlvl + 1:
        arr = np.concatenate(
            [arr, np.repeat(arr[-1:], nlvl + 1 - arr.shape[0])])
    return arr


def _chebyshev_extrema(n):
    """0.5*(cos(pi*(n-1..0)/(n-1)) + 1): the level>=1 grid on [0,1] for a
    uniform reference (tt_dirt_approx.m:306)."""
    return 0.5 * (np.cos(np.pi * np.arange(n - 1, -1, -1) / (n - 1)) + 1.0)


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def tt_dirt_approx(x0, logpostfun: Callable, beta, *,
                   options: DirtOptions | None = None,
                   irtstruct: DIRT | None = None, device="cuda",
                   profile: dict | None = None, **kwargs) -> DIRT:
    """Build (or extend) a DIRT for the log-density ``logpostfun``.

    Args:
      x0: list of d level-0 grid vectors (with boundaries).
      logpostfun: ``f(x, beta_min, beta_max) -> (M,)`` log density-ratio,
        vectorized over the sample axis: a torch function of (M, d) f64
        tensors on ``device``, or a numpy one (``vec``).
      beta: increasing bridging ladder (beta[0] is level 0).
      options / kwargs: DirtOptions fields.
      irtstruct: existing DIRT to resume/extend (appends levels).
      device: where the stack is built (default "cuda").
      profile: optional dict, filled with wall seconds summed over the
        build: the amen crosses' stages (amen_cross_s's ``profile=``;
        'eval_fun' is the probe batches: grid gather, pushes, density
        and the copies back to the host), and within it 'dirt_push' (the
        pushes through the stack) and 'density' (``logpostfun`` on the
        device); 'test_samples' (the level self-tests).  Each timed
        region ends in a device synchronisation.
    Returns a DIRT stack on ``device``, ready for tt_dirt_sample.
    """
    opt = options or DirtOptions()
    for k, v in kwargs.items():
        if not hasattr(opt, k):
            raise TypeError(f"unknown DIRT option {k!r}")
        setattr(opt, k, v)
    mesh = None if opt.mesh is None else check_mesh(opt.mesh)
    interpolation = opt.interpolation.lower()
    dev = resolve_device(device)

    beta = np.asarray(beta, dtype=np.float64).reshape(-1)
    nlvl = beta.shape[0] - 1
    d = len(x0)
    x0 = [_host(g).astype(np.float64).reshape(-1) for g in x0]

    nswp = _per_level(opt.nswp, nlvl)
    kickrank = _per_level(opt.kickrank, nlvl)
    stoptol = _per_level(opt.stoptol, nlvl)
    trunctol = _per_level(opt.trunctol, nlvl)
    y0v = _per_level(opt.y0, nlvl)
    irtdenom = _per_level(opt.irtdenom, nlvl)

    reference = opt.reference.lower() if isinstance(opt.reference, str) \
        else opt.reference
    sigma = reference_sigma(reference)
    boundary = opt.boundary
    if not interpolation.startswith("s"):
        # spectral levels need the boundary values (dirt_approx.m:124-127)
        boundary = True

    nq = opt.nq
    if nq is None:
        nq = [g.shape[0] for g in x0]
    nq = [int(v) for v in (nq if np.ndim(nq) else [nq] * d)]

    gen = torch.Generator(device=dev).manual_seed(opt.seed)

    def _timed(key, fn, *args, **kw):
        if profile is None:
            return fn(*args, **kw)
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        profile[key] = profile.get(key, 0.0) + time.perf_counter() - t0
        return out

    evalcnt = np.zeros(nlvl + 1, dtype=np.int64)
    # Structured construction trace (DIRT.history): one dict per cross
    # attempt, including rejected ones (tt_dirt_approx.m:354-412).
    history: list = []

    def _record(level, b_hi, attempt, accepted, res, *, tau=None,
                hell=None, rej=None, ntest=0, z=None, shift):
        rec = {
            "level": int(level),
            "beta": float(b_hi),
            "attempt": int(attempt),
            "accepted": bool(accepted),
            "ranks": [int(r) for r in res.tt.ranks],
            "evals": int(sum(res.evalcnt)),
            "tau": None if tau is None else float(tau),
            "hellinger": None if hell is None else float(hell),
            "reject_rate": None if rej is None else float(rej),
            "ntest": int(ntest),
            "lfshift": float(shift),
        }
        if z is not None:
            # marginal evolution of the level test chain
            # (tt_dirt_approx.m:354-412)
            zs = _host(z)
            rec["marginal_mean"] = [float(v) for v in zs.mean(axis=0)]
            rec["marginal_std"] = [float(v) for v in zs.std(axis=0)]
        history.append(rec)

    def cross_grids(grids):
        if boundary:
            return [g for g in grids]
        return [g[1:-1] for g in grids]

    def _gather(grids_t, ind):
        """Grid points at an index batch (a tensor on the device)."""
        return torch.stack([grids_t[k][ind[:, k]] for k in range(d)], dim=1)

    # ------------------------------------------------------------------
    # Density-evaluation mode (tt_dirt_approx.m:483-499)
    # ------------------------------------------------------------------
    vec = opt.vec
    if mesh is not None and (vec is False or str(vec) == "host"):
        raise ValueError("mesh sharding requires a torch density "
                         f"(vec=True or 'auto'); vec={vec!r} given")
    # sticky host-fallback state: once the density fails on tensors,
    # every later evaluation (and the retry of the current one) takes
    # the host path
    _hoststate = {"on": vec is False or str(vec) == "host"}
    _auto = str(vec) == "auto" and mesh is None

    def _logpost_host(x, blo, bhi):
        """User density on the host, numpy in and out.  vec=False
        densities are called one (1, d) row at a time (the reference's
        parfor wrapper, tt_dirt_approx.m:488-498)."""
        x = _host(x)
        if vec is False:
            return np.stack([
                np.atleast_1d(_host(
                    logpostfun(x[k:k + 1], blo, bhi))).reshape(-1)[0]
                for k in range(x.shape[0])])
        return _host(logpostfun(x, blo, bhi)).reshape(-1)

    def _logpost_dev(x, blo, bhi):
        out = logpostfun(x, blo, bhi)
        if not torch.is_tensor(out):
            raise TypeError(f"logpostfun returned {type(out).__name__}, "
                            "not a torch tensor")
        return out

    def _logpost_eval(x, blo, bhi):
        """Density at test points: host path when active, else on the
        device."""
        if _hoststate["on"]:
            return torch.as_tensor(_logpost_host(x, blo, bhi),
                                   dtype=torch.float64, device=dev)
        return _logpost_dev(x, blo, bhi)

    def _batch_eval(fn, host_fn):
        """One probe batch through ``fn`` (device density) or
        ``host_fn`` (host density): host_fn when vec is False/'host', or
        for good once fn raised TypeError under vec='auto'."""
        if _hoststate["on"]:
            return host_fn
        if mesh is not None:
            return functools.partial(sharded_rows, mesh, fn)

        def call(x):
            if _hoststate["on"]:
                return host_fn(x)
            try:
                return fn(x)
            except TypeError as e:
                if not _auto:
                    raise
                warnings.warn(
                    f"logpostfun does not run on torch tensors ({e}); "
                    "falling back to host-side density evaluation (DIRT "
                    "pushes stay on the device). Pass vec='host' (or "
                    "vec=False for non-vectorized functions) to silence "
                    "this.", stacklevel=2)
                _hoststate["on"] = True
                return host_fn(x)

        return call

    def _cross(grids, fun, lvl, seed, y0_init):
        if str(opt.crossmethod).lower().startswith("greedy"):
            return greedy_cross(
                [g.shape[0] for g in grids], fun,
                max(float(trunctol[lvl]), 1e-12),
                tol_exit=float(stoptol[lvl]), nswp=int(nswp[lvl]),
                verb=opt.verb, seed=seed, rmax=opt.rmax, torch_fun=True,
                device=dev)
        return amen_cross_s(
            [g.shape[0] for g in grids], fun, float(trunctol[lvl]),
            tol_exit=float(stoptol[lvl]), y0=y0_init,
            kickrank=kickrank[lvl], nswp=int(nswp[lvl]), verb=opt.verb,
            seed=seed, rmax=opt.rmax, torch_fun=True, device=dev,
            profile=profile)

    # ------------------------------------------------------------------
    # Level 0
    # ------------------------------------------------------------------
    if irtstruct is None:
        lvl0_grids = cross_grids(x0)
        lvl0_t = [torch.as_tensor(g, device=dev) for g in lvl0_grids]
        b0 = float(beta[0])
        eval0 = _batch_eval(
            lambda x: torch.exp(0.5 * _logpost_dev(x, 0.0, b0)),
            lambda x: np.exp(0.5 * _logpost_host(x, 0.0, b0)))

        def fun0(ind):
            return eval0(_gather(lvl0_t, ind))

        res = _cross(lvl0_grids, fun0, 0, opt.seed,
                     int(np.max(np.atleast_1d(y0v[0]))))
        f0 = res.tt
        evalcnt[0] += sum(res.evalcnt)

        dirt = DIRT(f0, [], x0, [], beta[:1], 0.0,
                    reference=reference, interpolation=interpolation,
                    evalcnt=evalcnt)
        lfshift = 0.0
        tau0 = z0 = None
        ntest0 = 0
        if opt.testsamples > 0:
            ntest0 = int(min(max(sum(res.evalcnt), 2), opt.testsamples))
            y = randref(reference, gen, (ntest0, d))
            z0, lfapp, lfex = _timed(
                "test_samples", tt_dirt_sample, dirt, y,
                lambda x: _logpost_eval(x, 0.0, b0), device=dev)
            tau0 = float(essinv(lfex, lfapp))
            if opt.verb:
                print(f"[dirt] level 0 beta={beta[0]:g}: N/ESS = {tau0:g}")
            evalcnt[0] += ntest0
            lfshift = float(torch.max(lfex))
            if bool(irtdenom[0]):
                lfshift -= float(torch.max(lfapp))
        _record(0, beta[0], 0, True, res, tau=tau0, ntest=ntest0,
                z=z0, shift=lfshift)
        dirt = DIRT(f0, [], x0, [], beta[:1], lfshift,
                    reference=reference, interpolation=interpolation,
                    evalcnt=evalcnt, history=history)
        ilvl = 1
        fprev_rank = int(np.max(np.atleast_1d(y0v[min(1, nlvl)])))
        fprev = None
    else:
        dirt = irtstruct.to(dev)
        ilvl = dirt.nlevels + 1
        # The checkpoint is authoritative for everything it stores
        # (tt_dirt_approx.m:154-173 restores F/beta/lFshift/Fprev and
        # keeps IRTstruct.x0): a resume must not silently re-grid
        # existing level TTs from the caller's x0/nq.
        ck_beta = _host(dirt.beta)
        if beta.shape[0] < dirt.nlevels + 1:
            raise ValueError(
                f"beta ladder ({beta.shape[0]} entries) is shorter than "
                f"the existing DIRT's {dirt.nlevels + 1} levels")
        if not np.allclose(beta[:dirt.nlevels + 1], ck_beta):
            raise ValueError("beta ladder prefix must match existing DIRT")
        if str(dirt.reference).lower() != str(reference).lower():
            raise ValueError(
                f"reference {reference!r} does not match the existing "
                f"DIRT's {dirt.reference!r}")
        if not str(dirt.interpolation).lower().startswith(
                interpolation[:1]):
            raise ValueError(
                f"interpolation {interpolation!r} does not match the "
                f"existing DIRT's {dirt.interpolation!r}")
        ck_x0 = [_host(g).astype(np.float64).reshape(-1) for g in dirt.x0]
        if len(ck_x0) != d or any(
                a.shape != b.shape or not np.allclose(a, b)
                for a, b in zip(ck_x0, x0)):
            raise ValueError("x0 grids do not match the existing DIRT's "
                             "stored level-0 grids")
        x0 = ck_x0
        prev = np.atleast_1d(dirt.evalcnt)
        ncopy = min(len(prev), len(evalcnt))
        evalcnt[:ncopy] = prev[:ncopy]
        lfshift = float(np.asarray(dirt.lfshift))
        fprev = dirt.fprev
        fprev_rank = int(np.max(np.atleast_1d(y0v[min(1, nlvl)])))
        if fprev is not None and max(fprev.ranks) > fprev_rank:
            # same cap the level loop below applies to next-level warm
            # starts: a resumed build must not probe at the full stored
            # rank when the caller asked for a smaller y0
            fprev = tt_round(fprev, 0.0, rmax=fprev_rank)
        if getattr(dirt, "history", None):
            history.extend(dirt.history)  # resume extends the trace

    if nlvl == 0:
        return dirt

    # ------------------------------------------------------------------
    # Grids for levels >= 1 (reference space)
    # ------------------------------------------------------------------
    if irtstruct is not None and len(dirt.x) > 0:
        # resume: existing level TTs were built on the stored grids
        xg = [_host(g).astype(np.float64).reshape(-1) for g in dirt.x]
        if opt.nq is not None and [g.shape[0] for g in xg] != nq:
            raise ValueError(
                f"nq={nq} does not match the existing DIRT's level "
                f"grid sizes {[g.shape[0] for g in xg]}")
    elif sigma is None:
        xg = [_chebyshev_extrema(nk) for nk in nq]
    elif interpolation.startswith("s"):
        xg = [np.linspace(0.0, 1.0, nk) * 2 * sigma - sigma for nk in nq]
    elif interpolation.startswith("c"):
        xg = [lobatto_nodes(nk, -sigma, sigma) for nk in nq]
    else:
        # the Fourier grid: an even number of points on (-sigma, sigma]
        xg = [(np.arange(1, 2 * ((nk + 1) // 2) + 1)
               * (2 * sigma / (2 * ((nk + 1) // 2))) - sigma) for nk in nq]

    # ------------------------------------------------------------------
    # Levels 1..nlvl with the ESS-gated recompute loop
    # ------------------------------------------------------------------
    recompute_count = 0
    fs = list(dirt.fs)
    lvl_grids = cross_grids(xg)
    lvl_t = [torch.as_tensor(g, device=dev) for g in lvl_grids]
    while ilvl <= nlvl:
        b_lo, b_hi = float(beta[ilvl - 1]), float(beta[ilvl])
        if opt.verb:
            print(f"[dirt] approximating level {ilvl} for beta={b_hi:g}")
        cur_dirt = DIRT(dirt.f0, fs, x0, xg, beta[:ilvl], lfshift,
                        reference=reference, interpolation=interpolation,
                        evalcnt=evalcnt)
        # every probe batch of this attempt pushes through the same
        # stack: prepare it once a device (bit for bit tt_dirt_sample's
        # outputs), on the build's device and on each mesh device
        pushes = {d: DirtSampler(cur_dirt, precision=opt.precision,
                                 device=d)
                  for d in dict.fromkeys([canonical(dev), *(mesh or ())])}
        push = pushes[canonical(dev)]

        use_denom = bool(irtdenom[ilvl])
        if use_denom:
            # The carried lfshift baselines the tempered-ratio mode; the
            # denominator-mode ratio logpost(z,0,b) - lFapp lives on a
            # different scale, so re-baseline from a probe batch through
            # the current stack (tt_dirt_approx.m:443-450, same intent).
            yp = randref(reference, gen, (256, d))
            zp, lfp = push(yp)
            lrp = _logpost_eval(zp, 0.0, b_hi) - lfp
            lfshift = float(torch.max(lrp))
            evalcnt[ilvl] += 256

        def _push_ratio(x, _blo=b_lo, _bhi=b_hi, _shift=lfshift,
                        _denom=use_denom, _pushes=pushes):
            z, lfapp = _timed("dirt_push", _pushes[x.device], x)
            blo = 0.0 if _denom else _blo
            lr = _timed("density", _logpost_dev, z, blo, _bhi) - _shift
            if _denom:
                # ratio against the realized IRT density instead of the
                # previous tempered density (tt_dirt_approx.m:466-473)
                lr = lr - lfapp
            if sigma is not None:
                lr = lr - 0.5 * torch.sum(x * x, dim=1)
            return torch.exp(0.5 * lr)

        def _push_ratio_host(x, _blo=b_lo, _bhi=b_hi, _shift=lfshift,
                             _denom=use_denom, _push=push):
            z, lfapp = _timed("dirt_push", _push, x)
            blo = 0.0 if _denom else _blo
            lr = _logpost_host(z, blo, _bhi) - _shift
            if _denom:
                lr = lr - _host(lfapp)
            if sigma is not None:
                lr = lr - 0.5 * np.sum(_host(x) ** 2, axis=1)
            return np.exp(0.5 * lr)

        evall = _batch_eval(_push_ratio, _push_ratio_host)

        def funl(ind, _evall=evall):
            return _evall(_gather(lvl_t, ind))

        y0_init = None
        if not str(opt.crossmethod).lower().startswith("greedy"):
            if fprev is not None:
                # A checkpoint-loaded fprev carries boundary-extended
                # cores (the samplers extrapolate to the full grid, and
                # save_dirt persists that form) while the level cross
                # runs on the interior grid: restrict the warm start to
                # the interior slices.
                want = [g.shape[0] for g in lvl_grids]
                have = [int(v) for v in fprev.n]
                if have != want:
                    if all(h == w + 2 for h, w in zip(have, want)):
                        fprev = TT([c[:, 1:-1, :] for c in fprev.cores])
                    else:
                        fprev = None
            y0_init = fprev if fprev is not None else \
                int(np.max(np.atleast_1d(y0v[min(ilvl, len(y0v) - 1)])))
        res = _cross(lvl_grids, funl, ilvl,
                     opt.seed + ilvl + 1000 * recompute_count, y0_init)
        evalcnt[ilvl] += sum(res.evalcnt)
        f_new = res.tt

        fs = fs[:ilvl - 1] + [f_new]
        cand = DIRT(dirt.f0, fs, x0, xg, beta[:ilvl + 1], lfshift,
                    reference=reference, interpolation=interpolation,
                    evalcnt=evalcnt)

        accept = True
        if opt.testsamples > 0:
            ntest = int(min(max(sum(res.evalcnt), 2), opt.testsamples))
            y = randref(reference, gen, (ntest, d))
            z, lfapp, lfex = _timed(
                "test_samples", tt_dirt_sample, cand, y,
                lambda x: _logpost_eval(x, 0.0, b_hi), device=dev)
            nrej = mcmc_prune(z, lfex, lfapp, generator=gen).num_rejects
            tau = float(essinv(lfex, lfapp))
            hl = float(hellinger(lfex, lfapp))
            if opt.verb:
                print(f"[dirt] level {ilvl}: N/ESS = {tau:g}, "
                      f"Hellinger = {hl:.3e}, "
                      f"rejects = {100.0 * float(nrej) / ntest:.1f}%")
            evalcnt[ilvl] += ntest
            accept = tau <= opt.recompute
            _record(ilvl, b_hi, recompute_count, accept, res, tau=tau,
                    hell=hl, rej=float(nrej) / ntest, ntest=ntest, z=z,
                    shift=lfshift)
            if not accept:
                recompute_count += 1
                if recompute_count > 4:
                    taus = ", ".join(f"{h['tau']:.4g}" for h in history
                                     if h["level"] == ilvl)
                    raise RuntimeError(
                        f"too poor approximation at beta={b_hi:g} after 5 "
                        f"attempts (N/ESS {taus}), giving up "
                        "(tt_dirt_approx.m:437-440)")
            else:
                recompute_count = 0
                if ilvl < nlvl:
                    if bool(irtdenom[ilvl]):
                        lfshift = float(torch.max(lfex)) * \
                            float(beta[ilvl + 1]) / b_hi - \
                            float(torch.max(lfapp))
                    else:
                        lfshift = float(torch.max(lfex)) * \
                            (float(beta[ilvl + 1]) - b_hi) / b_hi
        else:
            _record(ilvl, b_hi, 0, True, res, shift=lfshift)
        if not accept:
            fs = fs[:ilvl - 1]
            continue

        # Rank-limited initial guess for the next level
        fprev = tt_round(f_new, 0.0, rmax=fprev_rank)
        dirt = DIRT(dirt.f0, fs, x0, xg, beta[:ilvl + 1], lfshift,
                    reference=reference, interpolation=interpolation,
                    evalcnt=evalcnt, fprev=fprev, history=history)
        if opt.checkpoint_path:
            save_dirt(opt.checkpoint_path, dirt)
        ilvl += 1

    return dirt
