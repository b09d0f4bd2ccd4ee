"""Deep Inverse Rosenblatt Transport stack (counterpart of
``tt_irt_tpu/samplers/dirt.py``): ``DIRT``, ``serve_precision``, the
per-level preparation, ``dirt_round``, ``dirt_permute`` and the
functional API ``tt_dirt_sample`` / ``tt_dirt_inverse``.

Spline stacks prepare their upper levels per rank bucket (the scan path
of samplers/irt_scan.py); Chebyshev and Fourier stacks (levels >= 1 on
Lobatto nodes or the uniform Fourier grid, level 0 spline as in
tt_dirt_sample.m:69-71) one spectral precompute a level
(samplers/chebyshev.py, samplers/fourier.py).  ``tt_dirt_sample``
prepares every level on each call; ``DirtSampler`` (samplers/serve.py)
prepares once and gives the same outputs bit for bit on the same seeds.
``tt_dirt_sample(use_fused=True)`` serves a spline stack with every
level padded to the stack's largest rank, the shapes of the JAX
package's whole-stack program (samplers/dirt_scan.py)."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..ops.tt import TT, tt_permute, tt_round
from ..utils.device import resolve_device
from .chebyshev import cheb_precompute, tt_irt_cheb
from .dirt_scan import can_fuse
from .fourier import _MAX_BLOCK, fourier_precompute, tt_irt_fourier
from .irt import _canon_grid, auto_block, tt_irt_sqr, tt_rt_sqr
from .irt_scan import _prep, can_use_scan, fwd_blocked, prep_level, \
    stack_padded
from .reference import (reference_sigma, tnormal_logdensity_shift,
                        tnormal_to_uniform, uniform_to_tnormal)

__all__ = ["DIRT", "serve_precision", "dirt_round", "dirt_permute",
           "tt_dirt_sample", "tt_dirt_inverse"]

# Default rank-bucket step of the upper-level preparation: the JAX
# package's default ragged_step.
RAGGED_STEP = 4


def serve_precision(dirt: "DIRT") -> str:
    """Dimension-aware default serving precision: 'hi' (factor-form
    conditionals) at d >= 40, 'f32' below, as in the JAX package (the
    f32 Gram form's tail error compounds along the dimension chain)."""
    return "hi" if dirt.d >= 40 else "f32"


class DIRT:
    """DIRT stack: level-0 sqrt-density TT + L sqrt-ratio TTs over a
    beta ladder, with grids, all as torch tensors on one device."""

    __slots__ = ("f0", "fs", "x0", "x", "beta", "lfshift", "reference",
                 "interpolation", "evalcnt", "fprev", "history")

    def __init__(self, f0: TT, fs: Sequence[TT], x0, x, beta,
                 lfshift=0.0, reference: str = "uniform",
                 interpolation: str = "spline", evalcnt=None, fprev=None,
                 history=None):
        dev = f0.device
        self.f0 = f0
        self.fs = tuple(fs)
        self.x0 = [torch.as_tensor(g, device=dev).reshape(-1) for g in x0]
        self.x = ([torch.as_tensor(g, device=dev).reshape(-1) for g in x]
                  if x is not None else [])
        self.beta = torch.as_tensor(beta, device=dev)
        self.lfshift = lfshift
        self.reference = reference
        self.interpolation = interpolation
        self.evalcnt = (evalcnt if evalcnt is not None
                        else np.zeros(0, np.int64))
        self.fprev = fprev
        self.history = history

    @property
    def nlevels(self) -> int:
        return len(self.fs)

    @property
    def d(self) -> int:
        return self.f0.d

    @property
    def sigma(self) -> Optional[float]:
        return reference_sigma(self.reference)

    @property
    def device(self) -> torch.device:
        return self.f0.device

    def to(self, device) -> "DIRT":
        return DIRT(self.f0.to(device), [f.to(device) for f in self.fs],
                    [g.to(device) for g in self.x0],
                    [g.to(device) for g in self.x], self.beta.to(device),
                    self.lfshift, self.reference, self.interpolation,
                    evalcnt=self.evalcnt,
                    fprev=None if self.fprev is None
                    else self.fprev.to(device),
                    history=self.history)

    def __repr__(self):
        return (f"DIRT(d={self.d}, levels={self.nlevels}, "
                f"beta={self.beta.cpu().numpy()}, "
                f"reference={self.reference!r}, "
                f"interpolation={self.interpolation!r})")


def _resolve_precision(dirt: DIRT, precision):
    if precision is not None:
        return precision
    return "f64" if dirt.f0.dtype == torch.float64 else "f32"


def _prepare_level_preps(dirt: DIRT, precision: str = "hi",
                         hi_step: str = "dim",
                         ragged_step: int = RAGGED_STEP):
    """Per-level forward preparations of the spline upper levels at
    ``precision`` (and, at 'hi', ``hi_step``), batched per rank bucket.

    Levels are zero-padded to their rank rounded up to a multiple of
    ``ragged_step`` (capped at the stack max; 0 pads every level to the
    stack max) and prepared together per bucket, exactly as the JAX
    package buckets them (padding changes the prep only at working
    precision, so both packages must pad alike to compare).  Returns a
    per-level list of preps, or None when the stack is not
    scan-eligible."""
    if dirt.nlevels < 1:
        return None
    level_cs, xstack = [], None
    for f in dirt.fs:
        gs, fc = _canon_grid(dirt.x, f)
        if not can_use_scan(fc, gs, fc.d):
            return None
        cs, xstack = stack_padded(fc, gs)
        level_cs.append(cs)
    if len({(c.shape[0], c.shape[2]) for c in level_cs}) > 1:
        return None
    rmax = max(c.shape[1] for c in level_cs)
    step = int(ragged_step)
    buckets: dict = {}
    for j, cs in enumerate(level_cs):
        rb = rmax if step <= 0 else min(-(-cs.shape[1] // step) * step, rmax)
        buckets.setdefault(rb, []).append((j, cs))
    per_level = [None] * dirt.nlevels
    for rb, items in sorted(buckets.items()):
        padded = []
        for _, cs in items:
            r = cs.shape[1]
            if r < rb:
                cs = torch.nn.functional.pad(cs, (0, rb - r, 0, 0,
                                                  0, rb - r))
            padded.append(cs)
        preps = _prep(torch.stack(padded, dim=0), xstack, precision,
                      hi_step=hi_step)
        for pos, (j, _) in enumerate(items):
            per_level[j] = prep_level(preps, pos)
    return per_level


def dirt_round(dirt: DIRT, eps: float, rmax=None) -> DIRT:
    """Every level's TT rounded to relative accuracy ``eps``
    (ops/tt.py ``tt_round``): a serve-side rank knob.  Serving cost per
    level goes about as r^2 with rank-bucketed preparation
    (``ragged_step``); debiasing stays exact, since the log-density is
    that of the realised map."""
    return DIRT(tt_round(dirt.f0, eps, rmax),
                [tt_round(t, eps, rmax) for t in dirt.fs],
                dirt.x0, dirt.x, dirt.beta, dirt.lfshift, dirt.reference,
                dirt.interpolation, evalcnt=dirt.evalcnt, fprev=dirt.fprev,
                history=dirt.history)


def dirt_permute(dirt: DIRT, perm, eps: float = 1e-12) -> DIRT:
    """The stack on permuted coordinates: each level's TT permuted
    (ops/tt.py ``tt_permute``, relative truncation <= ``eps``) and the
    grids with it.  Every level's map is dimension-wise, so this is the
    stack that would have been built on the permuted target."""
    perm = [int(p) for p in perm]
    return DIRT(tt_permute(dirt.f0, perm, eps),
                [tt_permute(t, perm, eps) for t in dirt.fs],
                [dirt.x0[p] for p in perm],
                [dirt.x[p] for p in perm] if dirt.x else dirt.x,
                dirt.beta, dirt.lfshift, dirt.reference, dirt.interpolation,
                evalcnt=dirt.evalcnt, fprev=None, history=dirt.history)


def _is_spline(dirt: DIRT) -> bool:
    return str(dirt.interpolation).lower().startswith("s")


def _prepare_upper(dirt: DIRT, precision: str, hi_step: str = "dim",
                   ragged_step: int = RAGGED_STEP):
    """Per-level preparations of levels 1..L: the rank-bucketed scan
    preps of a spline stack (None where it is not scan-eligible), or one
    ``ChebPrep`` / ``FourierPrep`` a level of a spectral stack (the
    reference's precompute-struct reuse, tt_irt_fourier.m:106-137)."""
    if not dirt.nlevels:
        return None
    if _is_spline(dirt):
        return _prepare_level_preps(dirt, precision, hi_step, ragged_step)
    pre = (cheb_precompute if str(dirt.interpolation).lower().startswith("c")
           else fourier_precompute)
    return [pre(dirt.x, f) for f in dirt.fs]


def _serve_upper_levels(dirt: DIRT, preps, z, lfapp, precision: str,
                        hi_step: str = "dim", block: int | None = None):
    """Levels L..1, each through its preparation (``preps``, from
    _prepare_upper): a spline level's blocked forward pass in blocks of
    ``block`` rows, a spectral level's sampler in its own blocks; a
    spline stack that is not scan-eligible (``preps`` None) goes through
    ``_level_irt``.  ``precision`` is resolved (the spectral levels are
    f64 at every precision, as in the JAX package).  Returns
    (z, lfapp)."""
    sigma = dirt.sigma
    spline = _is_spline(dirt)
    block = auto_block(z.shape[0], block)
    for j in range(dirt.nlevels - 1, -1, -1):
        if sigma is not None:
            z = tnormal_to_uniform(z, sigma)
        if preps is not None and spline:
            z, dlf = fwd_blocked("sqr", preps[j], z, block)
        else:
            z, dlf = _level_irt(dirt, dirt.fs[j] if preps is None
                                else preps[j], z, precision, hi_step, block)
        lfapp = lfapp + dlf
        if sigma is not None:
            lfapp = lfapp - tnormal_logdensity_shift(
                z, sigma, reduced=precision != "f64")
    return z, lfapp


def _level_irt(dirt: DIRT, f, z, precision=None, hi_step="dim",
               block: int | None = None):
    """One upper level's transform by the stack's interpolation: the
    spline IRT (any TT, through the general path where the scan path
    does not apply) in blocks of ``block`` rows, or the Chebyshev or
    Fourier sampler (``f`` a TT or its prep) in blocks of at most 2^15
    rows (the spectral samplers' cap)."""
    interp = str(dirt.interpolation).lower()
    if interp.startswith("s"):
        return tt_irt_sqr(dirt.x, f, z, block=block, precision=precision,
                          device=z.device, hi_step=hi_step)
    block = None if block is None else min(int(block), _MAX_BLOCK)
    if interp.startswith("c"):
        return tt_irt_cheb(dirt.x, f, z, block=block, device=z.device)
    return tt_irt_fourier(dirt.x, f, z, block=block, device=z.device)


def tt_dirt_sample(dirt: DIRT, q, logpostfun=None, precision=None,
                   hi_step: str = "dim", use_fused=None, device="cuda"):
    """Push reference seeds through the stack: levels L..1, then the
    level-0 spline IRT.  Every level is prepared on this call.

    Args:
      dirt: a DIRT stack (moved to ``device``): spline, Chebyshev or
        Fourier upper levels.
      q: (M, d) seeds: [0, 1]^d for a uniform reference, the truncated
        normal's box otherwise.
      logpostfun: optional exact log-density, evaluated at the output.
      precision: any precision name (samplers/irt_scan.py) of the spline
        transforms; None = by the cores' dtype.  Spectral levels are f64.
      hi_step: the algorithm of the 'hi' step; only legal at 'hi'.
      use_fused: True serves every upper level padded to the stack's
        largest rank (one prepared shape, as the JAX package's
        whole-stack program has it; ValueError where
        samplers/dirt_scan.py ``can_fuse`` says no); None or False pad
        per rank bucket.  The JAX package's default turns its program
        on only under tracing, which torch does not have.
      device: where the stack is served (default "cuda").
    Returns:
      (z, lfapp) or (z, lfapp, logpostfun(z)).
    """
    dev = resolve_device(device)
    dirt = dirt.to(dev)
    z = torch.as_tensor(q, dtype=torch.float64, device=dev)
    prec = _resolve_precision(dirt, precision)
    if use_fused and not can_fuse(dirt, z.shape[1]):
        raise ValueError(
            "use_fused=True needs a spline stack with levels, seeds of "
            "the full dimension, one grid size and boundary ranks 1 "
            "(dirt_scan.can_fuse)")
    lfapp = torch.zeros((z.shape[0],), dtype=z.dtype, device=dev)
    preps = _prepare_upper(dirt, prec, hi_step,
                           0 if use_fused else RAGGED_STEP)
    z, lfapp = _serve_upper_levels(dirt, preps, z, lfapp, prec, hi_step)
    if dirt.sigma is not None:
        z = tnormal_to_uniform(z, dirt.sigma)
    z, dlf = tt_irt_sqr(dirt.x0, dirt.f0, z, precision=precision,
                        device=dev, hi_step=hi_step)
    lfapp = lfapp + dlf
    if logpostfun is not None:
        return z, lfapp, logpostfun(z)
    return z, lfapp


def tt_dirt_inverse(dirt: DIRT, x, device="cuda"):
    """The inverse map, samples -> reference seeds: level 0's forward
    Rosenblatt transform, then levels 1..L (spline stacks only, as in
    the JAX package).  Returns (q, lfapp)."""
    if not str(dirt.interpolation).lower().startswith("s"):
        raise NotImplementedError(
            "tt_dirt_inverse supports spline interpolation only")
    dev = resolve_device(device)
    dirt = dirt.to(dev)
    sigma = dirt.sigma
    q = torch.as_tensor(x, dtype=torch.float64, device=dev)
    q, lfapp = tt_rt_sqr(dirt.x0, dirt.f0, q, device=dev)
    if sigma is not None:
        q = uniform_to_tnormal(q, sigma)
    for j in range(dirt.nlevels):
        if sigma is not None:
            lfapp = lfapp + 0.5 * torch.sum(q * q, dim=-1)
        q, dlf = tt_rt_sqr(dirt.x, dirt.fs[j], q, device=dev)
        lfapp = lfapp + dlf
        if sigma is not None:
            q = uniform_to_tnormal(q, sigma)
    return q, lfapp
