"""Shared pieces of the inverse Rosenblatt transforms (counterpart of
the helpers in ``tt_irt_tpu/samplers/irt.py``).

Ported: block sizing, grid spacings, row padding, boundary
extrapolation, grid canonicalisation, and the public ``tt_irt_sqr`` /
``tt_rt_sqr`` on the rank-padded scan path (samplers/irt_scan.py).  The
general unrolled path and ``tt_irt_lin`` are not ported yet.
"""

from __future__ import annotations

import torch

from ..ops.tt import TT
from ..utils.device import resolve_device

__all__ = ["auto_block", "tt_irt_sqr", "tt_rt_sqr"]

_MAX_BLOCK = 1 << 18
_MIN_BLOCK = 1 << 10


def auto_block(m: int, block=None) -> int:
    """Forward block size: the smallest power of two >= m within
    [2^10, 2^18], unless ``block`` is given."""
    if block is not None:
        return int(block)
    b = _MIN_BLOCK
    while b < m and b < _MAX_BLOCK:
        b <<= 1
    return b


def _grid_spacings(x: torch.Tensor) -> torch.Tensor:
    """h[..., 0] = 0, h[..., i] = x[..., i] - x[..., i-1]."""
    zero = torch.zeros(x.shape[:-1] + (1,), dtype=x.dtype, device=x.device)
    return torch.cat([zero, torch.diff(x, dim=-1)], dim=-1)


def _num_blocks(m: int, mb: int) -> int:
    return -(-m // mb)


def _pad_rows(a: torch.Tensor, rows: int) -> torch.Tensor:
    if a.shape[0] == rows:
        return a
    pad = torch.zeros((rows - a.shape[0],) + tuple(a.shape[1:]),
                      dtype=a.dtype, device=a.device)
    return torch.cat([a, pad], dim=0)


def _extrapolate_boundary(core: torch.Tensor, x: torch.Tensor):
    """If the core misses the two boundary grid points, extend it by
    linear extrapolation."""
    n = x.shape[0]
    if core.shape[1] == n:
        return core
    if core.shape[1] != n - 2:
        raise ValueError(
            f"core has {core.shape[1]} points, grid has {n}: expected n "
            "or n-2")
    h = torch.diff(x)
    left = core[:, 0:1, :] - (core[:, 1:2, :] - core[:, 0:1, :]) * (
        h[0] / h[1])
    right = core[:, -1:, :] + (core[:, -1:, :] - core[:, -2:-1, :]) * (
        (h[-1] + h[-2]) / h[-2])
    return torch.cat([left, core, right], dim=1)


def _canon_grid(grid, tt: TT):
    """Normalise grid input to a list of d 1-D tensors (on the cores'
    device) and extrapolate cores to the boundary if needed.  Accepts a
    list of vectors, one shared vector, or the per-dim grids
    concatenated."""
    d = tt.d
    dev = tt.device
    if isinstance(grid, (list, tuple)):
        gs = [torch.as_tensor(g, device=dev).reshape(-1) for g in grid]
    else:
        g = torch.as_tensor(grid, device=dev).reshape(-1)
        total = sum(c.shape[1] for c in tt.cores)
        total_b = sum(c.shape[1] + 2 for c in tt.cores)
        if d > 1 and g.shape[0] in (total, total_b):
            gs, pos = [], 0
            for c in tt.cores:
                nk = c.shape[1] if g.shape[0] == total else c.shape[1] + 2
                gs.append(g[pos:pos + nk])
                pos += nk
        else:
            gs = [g] * d
    cores = [_extrapolate_boundary(c, x) for c, x in zip(tt.cores, gs)]
    return gs, TT(cores)


def _dispatch(mode, grid, f, q, block, precision, device, hi_step):
    """Run the rank-padded scan path on ``device``; a TT it does not
    cover (non-uniform grid sizes, boundary ranks above 1, a marginal of
    the first D < d variables) raises."""
    from .irt_scan import can_use_scan, irt_scan, stack_padded

    dev = resolve_device(device)
    q = torch.as_tensor(q, device=dev)
    grids, f = _canon_grid(grid, f.to(dev))
    if not can_use_scan(f, grids, min(f.d, q.shape[1])):
        raise NotImplementedError(
            "only the rank-padded scan path (uniform grid sizes, boundary "
            "ranks 1, all d variables) is ported (see ROADMAP.md)")
    if precision is None:
        precision = "f64" if f.dtype == torch.float64 else "f32"
    cstack, xstack = stack_padded(f, grids)
    return irt_scan(mode, cstack, xstack, q,
                    auto_block(q.shape[0], block), precision, hi_step)


def tt_irt_sqr(grid, f: TT, q, block: int | None = None,
               precision: str | None = None, device="cuda",
               hi_step: str = "dim"):
    """SIRT: inverse Rosenblatt transform through sqrt(density) in TT.

    Args:
      grid: list of d grid vectors (with boundaries), one shared vector,
        or the per-dim grids concatenated.
      f: TT of sqrt(PDF) on the grid (boundary points may be missing;
        they are restored by linear extrapolation).
      q: (M, d) seeds in [0, 1]^d.
      block: forward block size (default auto_block).
      precision: 'f64', 'f32', 'mixed', 'hi', 'hid', 'ds' or 'gs'
        (samplers/irt_scan.py); default by the cores' dtype.
      device: where the transform runs (default "cuda").
      hi_step: the algorithm of the 'hi' per-dimension step: "dim",
        "odim", "bracket" or "pair" (samplers/irt_scan.py); only legal
        with precision 'hi'.
    Returns:
      (xq, lFapp): samples (M, d) and log approximate density (M,).
    """
    return _dispatch("sqr", grid, f, q, block, precision, device, hi_step)


def tt_rt_sqr(grid, f: TT, x, block: int | None = None,
              precision: str | None = None, device="cuda",
              hi_step: str = "dim"):
    """Forward Rosenblatt transform (x -> u), inverse of tt_irt_sqr."""
    return _dispatch("rt", grid, f, x, block, precision, device, hi_step)
