"""Deep Inverse Rosenblatt Transport stack (counterpart of
``tt_irt_tpu/samplers/dirt.py``: ``DIRT``, ``serve_precision``,
``_resolve_precision`` and the rank-bucketed level preparation)."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..ops.tt import TT
from .irt import _canon_grid
from .irt_scan import _prep, can_use_scan, prep_level, stack_padded
from .reference import reference_sigma

__all__ = ["DIRT", "serve_precision"]

# Rank-bucket step of the upper-level preparation: the JAX package's
# default ragged_step.
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
                         hi_step: str = "dim"):
    """Per-level forward preparations of the spline upper levels at
    ``precision`` (and, at 'hi', ``hi_step``), batched per rank bucket.

    Levels are zero-padded to their rank rounded up to a multiple of
    ``RAGGED_STEP`` (capped at the stack max) and prepared together per
    bucket, exactly as the JAX package buckets them (padding changes
    the prep only at working precision, so both packages must pad
    alike to compare).  Returns a per-level list of preps, or None
    when the stack is not scan-eligible."""
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
    buckets: dict = {}
    for j, cs in enumerate(level_cs):
        rb = min(-(-cs.shape[1] // RAGGED_STEP) * RAGGED_STEP, rmax)
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
