"""Production serving: prepare once, push many sample batches
(counterpart of ``tt_irt_tpu/samplers/serve.py``).

    sampler = DirtSampler(load_dirt(path), precision="auto")
    z, lfapp = sampler(q)        # forward passes only

Every precision name runs on spline stacks; ``hi_step`` names the
algorithm of the 'hi' per-dimension step (samplers/irt_scan.py).
"""

from __future__ import annotations

import torch

from ..utils.device import resolve_device
from .dirt import DIRT, _prepare_level_preps, _resolve_precision, \
    serve_precision
from .irt import _canon_grid, auto_block
from .irt_scan import _prep, can_use_scan, check_precision, fwd_blocked, \
    stack_padded
from .reference import tnormal_logdensity_shift, tnormal_to_uniform

__all__ = ["DirtSampler", "IrtSampler"]


def _as_rows(q, device) -> torch.Tensor:
    return torch.as_tensor(q, dtype=torch.float64, device=device)


class IrtSampler:
    """Prepared single-TT Rosenblatt transform: the backward
    marginalisation runs once at construction; calls are forward passes.

    Args:
      grid: list of d grid vectors (or one shared / concatenated vector).
      f: TT of sqrt(PDF) on the grid.
      mode: 'sqr' (inverse Rosenblatt, seeds -> samples) or 'rt'
        (forward Rosenblatt, samples -> seeds).
      precision: 'f64', 'f32', 'mixed', 'hi', 'hid', 'ds' or 'gs'; None
        = by the cores' dtype.
      block: forward block size (default auto_block).
      device: where the transform runs (default "cuda").
      hi_step: "dim", "odim", "bracket" or "pair"; only legal with
        precision 'hi'.
    """

    def __init__(self, grid, f, mode: str = "sqr",
                 precision: str | None = None, block: int | None = None,
                 device="cuda", hi_step: str = "dim"):
        if mode not in ("sqr", "rt", "lin"):
            raise ValueError(f"unknown mode {mode!r}")
        if mode == "lin":
            raise NotImplementedError(
                "mode 'lin' is not ported to PyTorch yet (see ROADMAP.md)")
        self.device = resolve_device(device)
        f = f.to(self.device)
        grids, fc = _canon_grid(grid, f)
        if precision is None:
            precision = "f64" if fc.dtype == torch.float64 else "f32"
        check_precision(precision, hi_step)
        if not can_use_scan(fc, grids, fc.d):
            raise NotImplementedError(
                "only the rank-padded scan path (uniform grid sizes, "
                "boundary ranks 1) is ported (see ROADMAP.md)")
        self.mode = mode
        self.precision = precision
        self.hi_step = hi_step
        self.block = block
        cs, xs = stack_padded(fc, grids)
        self._prep = _prep(cs, xs, precision, hi_step=hi_step)

    def sample(self, q):
        """Transform seeds ('sqr') or samples ('rt'); returns (x, lf)."""
        q = _as_rows(q, self.device)
        return fwd_blocked(self.mode, self._prep, q,
                           auto_block(q.shape[0], self.block))

    __call__ = sample


class DirtSampler:
    """Prepared DIRT transport: backward marginalisations cached.

    Args:
      dirt: a DIRT stack (built or loaded from a checkpoint); it is
        moved to ``device``.
      precision: any of the seven precision names, 'auto'
        (serve_precision: 'hi' at d >= 40, 'f32' below) or None (by the
        cores' dtype).
      block: forward block size (default auto_block).
      device: where the stack is served (default "cuda").
      hi_step: "dim", "odim", "bracket" or "pair"; only legal with
        precision 'hi'.  Level 0 and the rank-bucketed upper levels are
        all prepared with it.
    """

    def __init__(self, dirt: DIRT, precision: str | None = None,
                 block: int | None = None, device="cuda",
                 hi_step: str = "dim"):
        self.device = resolve_device(device)
        if precision == "auto":
            precision = serve_precision(dirt)
        self.precision = _resolve_precision(dirt, precision)
        check_precision(self.precision, hi_step)
        self.hi_step = hi_step
        if dirt.nlevels and not str(dirt.interpolation).startswith("s"):
            raise NotImplementedError(
                "only spline DIRT stacks are ported (see ROADMAP.md)")
        self.dirt = dirt.to(self.device)
        self.block = block
        self._sigma = self.dirt.sigma
        self._upper = []
        if self.dirt.nlevels:
            self._upper = _prepare_level_preps(self.dirt, self.precision,
                                               hi_step)
            if self._upper is None:
                raise NotImplementedError(
                    "only scan-eligible level TTs are ported "
                    "(see ROADMAP.md)")
        gs0, f0c = _canon_grid(self.dirt.x0, self.dirt.f0)
        if not can_use_scan(f0c, gs0, f0c.d):
            raise NotImplementedError(
                "only a scan-eligible level-0 TT is ported (see ROADMAP.md)")
        self._prep0 = _prep(*stack_padded(f0c, gs0), self.precision,
                            hi_step=hi_step)

    def sample(self, q, logpostfun=None):
        """Push reference seeds through levels L..1 and level 0; returns
        (z, lfapp) or (z, lfapp, logpostfun(z))."""
        z = _as_rows(q, self.device)
        sigma = self._sigma
        block = auto_block(z.shape[0], self.block)
        lfapp = torch.zeros((z.shape[0],), dtype=z.dtype, device=z.device)
        reduced = self.precision != "f64"
        for j in range(self.dirt.nlevels - 1, -1, -1):
            if sigma is not None:
                z = tnormal_to_uniform(z, sigma)
            z, dlf = fwd_blocked("sqr", self._upper[j], z, block)
            lfapp = lfapp + dlf
            if sigma is not None:
                lfapp = lfapp - tnormal_logdensity_shift(z, sigma,
                                                         reduced=reduced)
        if sigma is not None:
            z = tnormal_to_uniform(z, sigma)
        z, dlf = fwd_blocked("sqr", self._prep0, z, block)
        lfapp = lfapp + dlf
        if logpostfun is not None:
            return z, lfapp, logpostfun(z)
        return z, lfapp

    __call__ = sample
