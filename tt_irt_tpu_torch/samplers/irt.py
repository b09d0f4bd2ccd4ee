"""Shared pieces of the inverse Rosenblatt transforms (counterpart of
the helpers in ``tt_irt_tpu/samplers/irt.py``).

Block sizing, grid spacings, row padding, boundary extrapolation, grid
canonicalisation, the public ``tt_irt_sqr`` / ``tt_rt_sqr`` /
``tt_irt_lin``, and the general unrolled path.  ``_dispatch`` takes the
rank-padded scan path (samplers/irt_scan.py, every precision name) where
a TT allows it, and else the general path: per-dimension ranks, ragged
grid sizes, boundary ranks above 1 and marginals of the first D < d
variables, all in the cores' dtype (the precision name does not apply
there, as in the JAX package).  The JAX package has no Pallas kernel on
the general path, so it is plain PyTorch on the device.
"""

from __future__ import annotations

import math

import torch

from ..ops.rowmath import invert_quadratic as _invert_quadratic
from ..ops.tt import TT
from ..utils.device import resolve_device

__all__ = ["auto_block", "tt_irt_lin", "tt_irt_sqr", "tt_rt_sqr"]

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


def _trapz_w2(h):
    """Composite trapezoid weights of grids (..., n) from their spacings
    (h[..., 0] = 0)."""
    return 0.5 * torch.cat([h[..., 1:2], h[..., 1:-1] + h[..., 2:],
                            h[..., -1:]], dim=-1)


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


# ---- the general (unrolled) path ----

def _trapz_cdf(fk, h):
    """Cumulative trapezoid integral along the last axis; C[..., 0] = 0."""
    dc = 0.5 * (fk[..., :-1] + fk[..., 1:]) * h[1:]
    zero = torch.zeros(fk.shape[:-1] + (1,), dtype=fk.dtype, device=fk.device)
    return torch.cat([zero, torch.cumsum(dc, dim=-1)], dim=-1)


def _fix_degenerate(fk, ck, x):
    """Rows without CDF mass fall back to the uniform density on the
    grid box; then both are normalised by the total."""
    bad = ck[..., -1:] <= 0.0
    fk = torch.where(bad, torch.ones_like(fk), fk)
    ck = torch.where(bad, (x - x[0]).expand_as(ck), ck)
    total = ck[..., -1:]
    return fk / total, ck / total


def _bisect_cdf(ck, q, n: int):
    """Largest i0 with ck[m, i0] < q[m], clipped to [0, n-2], by a
    bisection of fixed trip count."""
    lo = torch.zeros(q.shape, dtype=torch.long, device=q.device)
    hi = torch.full(q.shape, n - 1, dtype=torch.long, device=q.device)
    for _ in range(max(1, math.ceil(math.log2(max(n - 1, 2))) + 1)):
        mid = (lo + hi) // 2
        left = q > _gather_cols(ck, mid)
        lo = torch.where(left, mid, lo)
        hi = torch.where(left, hi, mid)
    return torch.clamp(lo, 0, n - 2)


def _gather_cols(a, idx):
    return torch.gather(a, 1, idx[:, None])[:, 0]


def _interp_prefix(phi, core, i0, la, lb):
    """phi'[m] = phi[m] (la[m] core[:, i0[m], :] + lb[m] core[:, i0[m]+1, :]),
    divided by its largest absolute entry (floored at 1e-300)."""
    g = (core[:, i0, :] * la[None, :, None]
         + core[:, i0 + 1, :] * lb[None, :, None])
    phi = torch.einsum("mi,imj->mj", phi, g)
    scale = torch.clamp(torch.amax(torch.abs(phi), dim=1, keepdim=True),
                        min=1e-300)
    return phi / scale


def _prepare_sqr(tt: TT, grids, stable: bool = True):
    """Right-to-left semi-marginalisation of the squared sampler:
    P_k = int f^(>=k) x f^(>=k) dx_(>k), an (r_k, r_k, n_k) field per
    dimension.  The integral over x_(>k) is carried as the thin R factor
    of a QR (``stable=True``) or as the Gram matrix itself, renormalised
    by its largest entry.  Returns (ps, hs)."""
    d = tt.d
    ps, hs = [None] * d, [None] * d
    carry = torch.eye(tt.cores[-1].shape[2], dtype=tt.dtype, device=tt.device)
    for k in range(d - 1, -1, -1):
        core = tt.cores[k]
        r1 = core.shape[0]
        h = _grid_spacings(grids[k].to(tt.dtype))
        hs[k] = h
        if stable:
            b = torch.einsum("anb,bc->anc", core, carry)
            ps[k] = torch.einsum("anc,bnc->abn", b, b)
            if k > 0:
                w = torch.sqrt(_trapz_w2(h))
                mat = (b * w[None, :, None]).reshape(r1, -1).T
                rfac = torch.linalg.qr(mat, mode="reduced").R.T
                carry = rfac / torch.clamp(rfac.abs().max(), min=1e-300)
        else:
            t = torch.einsum("anc,cd->and", core, carry)
            ps[k] = torch.einsum("and,bnd->abn", t, core)
            if k > 0:
                g = torch.einsum("abn,n->ab", ps[k], _trapz_w2(h))
                g = 0.5 * (g + g.T)
                carry = g / torch.clamp(g.abs().max(), min=1e-300)
    return ps, hs


def _prepare_lin(tt: TT, grids):
    """Right-to-left trapezoid integration of the raw cores:
    P_k = int f^(>=k) dx_(>k), an (r_k, n_k) field per dimension."""
    d = tt.d
    ps, hs = [None] * d, [None] * d
    pprev = torch.ones((tt.cores[-1].shape[2],), dtype=tt.dtype,
                       device=tt.device)
    for k in range(d - 1, -1, -1):
        h = _grid_spacings(grids[k].to(tt.dtype))
        hs[k] = h
        b = torch.einsum("anb,b->an", tt.cores[k], pprev)
        ps[k] = b
        if k > 0:
            pprev = torch.sum(0.5 * (b[:, :-1] + b[:, 1:]) * h[1:], dim=1)
            pprev = pprev / torch.clamp(pprev.abs().max(), min=1e-300)
    return ps, hs


def _forward_block(mode, q, cores, ps, grids, dsample):
    """One block of rows through the first ``dsample`` dimensions, in
    the prepared fields' dtype: 'sqr' and 'lin' invert the conditional
    CDF at the seeds q, 'rt' evaluates it at the points q.  The
    conditional is the quadratic form phi P_k phi^T ('sqr', 'rt') or
    |phi P_k| ('lin').  Returns (out (M, dsample), lf (M,))."""
    mb = q.shape[0]
    dtype = ps[0].dtype
    phi = torch.ones((mb, cores[0].shape[0]), dtype=dtype, device=q.device)
    lf = torch.zeros((mb,), dtype=dtype, device=q.device)
    outs = []
    for k in range(dsample):
        x = grids[k].to(dtype)
        n = x.shape[0]
        if mode == "lin":
            fk = torch.abs(phi @ ps[k])
        else:
            fk = torch.einsum("mj,mjn->mn", phi,
                              torch.einsum("mi,ijn->mjn", phi, ps[k]))
        fk, ck = _fix_degenerate(fk, _trapz_cdf(fk, _grid_spacings(x)), x)
        qk = q[:, k].to(dtype)
        if mode == "rt":
            i0 = _bisect_cdf(x.expand(mb, n), qk, n)
        else:
            i0 = _bisect_cdf(ck, qk, n)
        c1 = _gather_cols(ck, i0)
        f1 = _gather_cols(fk, i0)
        f2 = _gather_cols(fk, i0 + 1)
        x1, x2 = x[i0], x[i0 + 1]
        if mode == "rt":
            xk = qk
            h3 = x2 - x1
            aq = 0.5 * (f2 - f1) / h3
            outs.append(aq * (xk - x1) ** 2 + f1 * (xk - x1) + c1)
        else:
            xk = _invert_quadratic(f1, f2, c1, qk, x1, x2)
            outs.append(xk)
        la = (x2 - xk) / (x2 - x1)
        lb = (xk - x1) / (x2 - x1)
        lf = lf + torch.log(f1 * la + f2 * lb)
        if k < dsample - 1:
            phi = _interp_prefix(phi, cores[k], i0, la, lb)
    return torch.stack(outs, dim=1), lf


def _general_block(mode, grids, tt: TT, q):
    """The general path on one block: the preparation, then the forward
    pass over the first min(d, D) dimensions."""
    ps, _ = (_prepare_lin(tt, grids) if mode == "lin"
             else _prepare_sqr(tt, grids))
    return _forward_block(mode, q, tt.cores, ps, grids, min(tt.d, q.shape[1]))


def _host_blocked(mode, grids, tt: TT, seeds, block: int):
    """Block loop of the general path (each block prepares afresh, as
    the JAX package's jitted block program does): rows are zero-padded
    to a whole number of blocks when there is more than one."""
    m = seeds.shape[0]
    nb = _num_blocks(m, block)
    if nb <= 1:
        return _general_block(mode, grids, tt, seeds)
    padded = _pad_rows(seeds, nb * block)
    xs_parts, lf_parts = [], []
    for b in range(nb):
        xb, lb = _general_block(mode, grids, tt,
                                padded[b * block:(b + 1) * block])
        xs_parts.append(xb)
        lf_parts.append(lb)
    return (torch.cat(xs_parts, dim=0)[:m], torch.cat(lf_parts, dim=0)[:m])


def _dispatch(mode, grid, f, q, block, use_scan, precision, device,
              hi_step="dim"):
    """The rank-padded scan path where the TT allows it (``use_scan``
    None: automatic), else the general path, on ``device``."""
    from .irt_scan import can_use_scan, irt_scan, stack_padded

    dev = resolve_device(device)
    q = torch.as_tensor(q, device=dev)
    grids, f = _canon_grid(grid, f.to(dev))
    block = auto_block(q.shape[0], block)
    if use_scan is None:
        use_scan = can_use_scan(f, grids, min(f.d, q.shape[1]))
    if not use_scan:
        return _host_blocked(mode, grids, f, q, block)
    if precision is None:
        precision = "f64" if f.dtype == torch.float64 else "f32"
    cstack, xstack = stack_padded(f, grids)
    return irt_scan(mode, cstack, xstack, q, block, precision, hi_step)


def tt_irt_sqr(grid, f: TT, q, block: int | None = None,
               use_scan: bool | None = None, precision: str | None = None,
               device="cuda", hi_step: str = "dim"):
    """SIRT: inverse Rosenblatt transform through sqrt(density) in TT.

    Args:
      grid: list of d grid vectors (with boundaries), one shared vector,
        or the per-dim grids concatenated.
      f: TT of sqrt(PDF) on the grid (boundary points may be missing;
        they are restored by linear extrapolation).
      q: (M, D) seeds in [0, 1]^D; D < d samples the marginal of the
        first D variables (general path).
      block: forward block size (default auto_block).
      use_scan: force (True) or forbid (False) the rank-padded scan path;
        None takes it where the TT allows it (uniform grid sizes,
        boundary ranks 1, D == d).
      precision: 'f64', 'f32', 'mixed', 'hi', 'hid', 'ds' or 'gs'
        (samplers/irt_scan.py; scan path only); default by the cores'
        dtype.
      device: where the transform runs (default "cuda").
      hi_step: the algorithm of the 'hi' per-dimension step: "dim",
        "odim", "bracket" or "pair" (samplers/irt_scan.py); only legal
        with precision 'hi'.
    Returns:
      (xq, lFapp): samples (M, D) and log approximate density (M,).
    """
    return _dispatch("sqr", grid, f, q, block, use_scan, precision, device,
                     hi_step)


def tt_irt_lin(grid, f: TT, q, block: int | None = None,
               use_scan: bool | None = None, precision: str | None = None,
               device="cuda"):
    """Inverse Rosenblatt transform through the density itself in TT
    (linear splines; the conditional is |phi P_k|).  Arguments as
    tt_irt_sqr's; every precision name runs the Gram family's dtypes
    (the factor form has no 'lin' counterpart)."""
    return _dispatch("lin", grid, f, q, block, use_scan, precision, device)


def tt_rt_sqr(grid, f: TT, x, block: int | None = None,
              use_scan: bool | None = None, precision: str | None = None,
              device="cuda", hi_step: str = "dim"):
    """Forward Rosenblatt transform (x -> u), inverse of tt_irt_sqr."""
    return _dispatch("rt", grid, f, x, block, use_scan, precision, device,
                     hi_step)
