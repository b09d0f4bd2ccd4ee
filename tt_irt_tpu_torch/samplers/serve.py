"""Production serving: prepare once, push many sample batches
(counterpart of ``tt_irt_tpu/samplers/serve.py``).

    sampler = DirtSampler(load_dirt(path), precision="auto")
    z, lfapp = sampler(q)        # forward passes only

Every precision name runs the spline transforms; ``hi_step`` names the
algorithm of the 'hi' per-dimension step (samplers/irt_scan.py).  A TT
that the rank-padded scan path does not take (ragged grid sizes,
boundary ranks above 1) is served through the general path of
samplers/irt.py on every call, as the JAX package does.  The Chebyshev
and Fourier levels of a spectral stack are precomputed once a level and
served in f64.
"""

from __future__ import annotations

import torch

from ..utils.device import resolve_device
from ..utils.profiling import span
from .dirt import DIRT, RAGGED_STEP, _prepare_upper, _resolve_precision, \
    _serve_upper_levels, serve_precision
from .irt import _canon_grid, auto_block, tt_irt_lin, tt_irt_sqr, tt_rt_sqr
from .irt_scan import _prep, can_use_scan, check_precision, fwd_blocked, \
    stack_padded
from .reference import tnormal_to_uniform

__all__ = ["DirtSampler", "IrtSampler"]


def _as_rows(q, device) -> torch.Tensor:
    return torch.as_tensor(q, dtype=torch.float64, device=device)


class IrtSampler:
    """Prepared single-TT Rosenblatt transform: the backward
    marginalisation runs once at construction; calls are forward passes.

    Args:
      grid: list of d grid vectors (or one shared / concatenated vector).
      f: TT of sqrt(PDF) ('sqr', 'rt') or of the PDF ('lin') on the
        grid.
      mode: 'sqr' (inverse Rosenblatt, seeds -> samples), 'rt'
        (forward Rosenblatt, samples -> seeds) or 'lin' (inverse
        Rosenblatt through the density itself).
      precision: 'f64', 'f32', 'mixed', 'hi', 'hid', 'ds' or 'gs'; None
        = by the cores' dtype.
      block: forward block size (default auto_block).
      device: where the transform runs (default "cuda").
      hi_step: "dim", "odim", "bracket" or "pair"; only legal with
        precision 'hi' (mode 'lin' has no factor form and ignores it).

    A TT the scan path does not take is transformed through the general
    path on every call (the prepare-once benefit does not apply there).
    """

    def __init__(self, grid, f, mode: str = "sqr",
                 precision: str | None = None, block: int | None = None,
                 device="cuda", hi_step: str = "dim"):
        if mode not in ("sqr", "rt", "lin"):
            raise ValueError(f"unknown mode {mode!r}")
        self.device = resolve_device(device)
        f = f.to(self.device)
        grids, fc = _canon_grid(grid, f)
        if precision is None:
            precision = "f64" if fc.dtype == torch.float64 else "f32"
        check_precision(precision, hi_step)
        self.mode = mode
        self.precision = precision
        self.hi_step = hi_step
        self.block = block
        self._grid, self._f = grid, f
        self._prep = None
        if can_use_scan(fc, grids, fc.d):
            cs, xs = stack_padded(fc, grids)
            self._prep = _prep(cs, xs, precision, hi_step=hi_step, mode=mode)

    def sample(self, q):
        """Transform seeds ('sqr', 'lin') or samples ('rt'); returns
        (x, lf)."""
        with span("ttirt.sample"):
            q = _as_rows(q, self.device)
            if self._prep is None:
                fn = {"sqr": tt_irt_sqr, "rt": tt_rt_sqr,
                      "lin": tt_irt_lin}[self.mode]
                return fn(self._grid, self._f, q, block=self.block,
                          precision=self.precision, device=self.device)
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
      block: forward block size (default auto_block; a Chebyshev or
        Fourier level's blocks are capped at 2^15 rows, the spectral
        samplers' cap).
      device: where the stack is served (default "cuda").
      hi_step: "dim", "odim", "bracket" or "pair"; only legal with
        precision 'hi'.  Level 0 and the rank-bucketed upper levels are
        all prepared with it.
      ragged_step: the upper levels are zero-padded to their rank
        rounded up to a multiple of this (capped at the stack max) and
        prepared per bucket, so a rounded level costs about its own r^2;
        0 pads every level to the stack max.  The default is
        tt_dirt_sample's, whose outputs this sampler's equal bit for bit.

    Upper levels that are not scan-eligible (or that disagree on (d, n))
    are served level by level through the general path, and so is a
    level 0 that is not, on every call.  A Chebyshev or Fourier stack's
    levels are precomputed here once each (``precision`` applies to its
    spline level 0).
    """

    def __init__(self, dirt: DIRT, precision: str | None = None,
                 block: int | None = None, device="cuda",
                 hi_step: str = "dim", ragged_step: int = RAGGED_STEP):
        self.device = resolve_device(device)
        if precision == "auto":
            precision = serve_precision(dirt)
        self.precision = _resolve_precision(dirt, precision)
        check_precision(self.precision, hi_step)
        self.hi_step = hi_step
        self.dirt = dirt.to(self.device)
        self.block = block
        self._sigma = self.dirt.sigma
        self._upper = _prepare_upper(self.dirt, self.precision, hi_step,
                                     ragged_step)
        gs0, f0c = _canon_grid(self.dirt.x0, self.dirt.f0)
        self._prep0 = None
        if can_use_scan(f0c, gs0, f0c.d):
            self._prep0 = _prep(*stack_padded(f0c, gs0), self.precision,
                                hi_step=hi_step)

    def sample(self, q, logpostfun=None):
        """Push reference seeds through levels L..1 and level 0; returns
        (z, lfapp) or (z, lfapp, logpostfun(z))."""
        with span("ttirt.sample"):
            z = _as_rows(q, self.device)
            sigma = self._sigma
            block = auto_block(z.shape[0], self.block)
            lfapp = torch.zeros((z.shape[0],), dtype=z.dtype,
                                device=z.device)
            z, lfapp = _serve_upper_levels(self.dirt, self._upper, z,
                                           lfapp, self.precision,
                                           self.hi_step, block)
            if sigma is not None:
                z = tnormal_to_uniform(z, sigma)
            if self._prep0 is not None:
                z, dlf = fwd_blocked("sqr", self._prep0, z, block)
            else:
                z, dlf = tt_irt_sqr(self.dirt.x0, self.dirt.f0, z,
                                    block=block, precision=self.precision,
                                    device=self.device)
            lfapp = lfapp + dlf
        if logpostfun is not None:
            return z, lfapp, logpostfun(z)
        return z, lfapp

    __call__ = sample
