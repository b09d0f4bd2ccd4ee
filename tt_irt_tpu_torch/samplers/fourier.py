"""Fourier-basis SIRT: trigonometric interpolation of the TT cores,
analytic CDF integration and masked Newton inversion (counterpart of
``tt_irt_tpu/samplers/fourier.py``; reference tt_irt_fourier.m).

* The host precompute (``fourier_precompute``) is the JAX package's, in
  numpy complex128: coefficients by an explicit inverse DFT of each
  core, the core's interpolant on the 4n-point fine grid, and the
  right-chunk Gram carried with rectangular quadrature (exact for
  products of band-limited interpolants on the uniform grid), whose
  Cholesky factor turns the semi-marginal into a sum of squares.
* The prep lives on the device as complex128.  The JAX package carries
  complex values as doubled real pairs because its TPU backend has no
  complex type; the card has one, so the prefix and the fine-grid
  factor stay complex here.  The DFT of the conditional, its analytic
  CDF and the Newton residual act on real rows in both packages and
  are the same real products.
* The shrinking active-set Newton of the reference (:248-279; a
  ``lax.while_loop`` in the JAX package) runs a fixed
  ``_NEWTON_MAX_ITERS`` masked iterations with no host sync: rows that
  have converged do not move, so the result is the same.

Grid convention (reference :6): uniform without the left border,
x = ((-n+1):n)*h + X0, period interval (-S, S] + X0.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..ops.tt import TT
from ..utils.device import resolve_device
from .irt import auto_block, _num_blocks, _pad_rows

__all__ = ["FourierPrep", "fourier_precompute", "tt_irt_fourier"]

_NEWTON_MAX_ITERS = 16    # tt_irt_fourier.m:20
_NEWTON_TOL = 1e-7        # tt_irt_fourier.m:21
# Largest forward block: the JAX package's cap (its rows carry
# O(block * 4n * 2r) temporaries per dimension).
_MAX_BLOCK = 1 << 15


class FourierDim(NamedTuple):
    """One dimension's sampling data on the device."""

    lfine: torch.Tensor    # (r1, 4n, rc) c128: fine-grid factor
    coeffs: torch.Tensor   # (r1, 2n, r2) c128: Fourier coefficients
    einv2: torch.Tensor    # (4n, 8n): fine values -> [Re | Im] coefficients
    ef2: torch.Tensor      # (8n, 4n): [cr | ci] -> CDF on the fine grid
    km: torch.Tensor       # (4n,): s / (pi m), 0 at m = 0
    sign_m: torch.Tensor   # (4n,): (-1)^m
    mfine: torch.Tensor    # (4n,): m = -2n+1 .. 2n
    mcoarse: torch.Tensor  # (2n,): m = -n+1 .. n
    xf: torch.Tensor       # (4n,): centred fine grid
    x0: float
    s: float
    h: float
    nhalf: int


class FourierPrep(NamedTuple):
    """Per-dimension Fourier data (the reference's reusable struct,
    tt_irt_fourier.m:106-137)."""

    dims: tuple


def prep_on(prep, device):
    """A FourierPrep or ChebPrep with its tensors on ``device``."""
    if prep.dims[0].lfine.device == device:
        return prep
    return type(prep)(tuple(
        p._replace(**{k: v.to(device) for k, v in p._asdict().items()
                      if torch.is_tensor(v)}) for p in prep.dims))


def _freqs(n):
    """Frequency integers m = -n+1 .. n."""
    return np.arange(-n + 1, n + 1)


def _split_grids(grid, f: TT):
    d = f.d
    if isinstance(grid, (list, tuple)):
        return [_host(g).reshape(-1) for g in grid]
    g = _host(grid).reshape(-1)
    total = sum(c.shape[1] for c in f.cores)
    if d > 1 and g.shape[0] == total:
        grids, pos = [], 0
        for c in f.cores:
            grids.append(g[pos:pos + c.shape[1]])
            pos += c.shape[1]
        return grids
    return [g] * d


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _fine_constants(n: int, s: float, h: float):
    """The real matrices and vectors of one dimension's forward step,
    as the JAX package builds them per call."""
    n4 = 4 * n
    mfine = np.arange(-2 * n + 1, 2 * n + 1).astype(np.float64)
    xf = np.arange(-2 * n + 1, 2 * n + 1) * (h / 2.0)
    ang_inv = (-math.pi / s) * np.outer(xf, mfine)
    einv2 = np.concatenate([np.cos(ang_inv), np.sin(ang_inv)], axis=1) / n4
    km = np.where(mfine == 0.0, 0.0,
                  s / (math.pi * np.where(mfine == 0.0, 1.0, mfine)))
    sign_m = (-1.0) ** np.arange(-2 * n + 1, 2 * n + 1)
    ang_f = (math.pi / s) * np.outer(xf, mfine)
    ef2 = np.concatenate([np.cos(ang_f), -np.sin(ang_f)], axis=1).T
    mcoarse = _freqs(n).astype(np.float64)
    return einv2, ef2, km, sign_m, mfine, mcoarse, xf


def fourier_precompute(grid, f: TT, device=None) -> FourierPrep:
    """Per-dimension Fourier data of the sqrt-density TT ``f`` on
    ``grid`` (one shared vector, d vectors, or the vectors concatenated),
    computed on the host and placed on ``device`` (default: the TT's).
    Raises ValueError for an odd number of points or a non-uniform
    grid."""
    dev = f.device if device is None else resolve_device(device)
    d = f.d
    grids = _split_grids(grid, f)
    out = []
    gram = np.eye(f.cores[-1].shape[2])
    # backward pass: real Gram carry with rectangular quadrature
    for k in range(d - 1, -1, -1):
        core = _host(f.cores[k]).astype(np.float64)
        r1, n2, r2 = core.shape
        x = grids[k]
        if n2 % 2:
            raise ValueError("Fourier SIRT needs an even number of grid "
                             "points (tt_irt_fourier.m:43-45)")
        if x.shape[0] != n2:
            raise ValueError("grid/core size mismatch")
        n = n2 // 2
        h = x[1] - x[0]
        if not np.allclose(np.diff(x), h, atol=1e-12):
            raise ValueError(f"grid not uniform in dim {k}")
        s = n * h
        x0 = (x[0] - h + x[-1]) * 0.5     # midpoint (reference :66)
        xc = x - x0                        # centred: (-n+1..n)*h
        m = _freqs(n)
        # coefficients: inverse DFT of values, c = E^{-1} v
        einv = np.exp(-1j * math.pi * np.outer(m, xc / s)) / (2 * n)
        ck = np.einsum("mj,ajb->amb", einv, core)          # (r1, 2n, r2)
        # fine grid: 4n points (-2n+1..2n)*(h/2)
        xf = np.arange(-2 * n + 1, 2 * n + 1) * (h / 2.0)
        efine = np.exp(1j * math.pi * np.outer(xf / s, m))  # (4n, 2n)
        ffine = np.einsum("fm,amb->afb", efine, ck)        # (r1, 4n, r2)
        # Cholesky factor of the right Gram: |.|^2 form of the marginal
        lchol = np.linalg.cholesky(
            gram + 1e-300 * np.eye(gram.shape[0])
            + 1e-14 * np.trace(gram) * np.eye(gram.shape[0]))
        lf_c = np.einsum("afb,bc->afc", ffine, lchol)      # (r1, 4n, rc)
        consts = _fine_constants(n, float(s), float(h))

        def t(a):
            return torch.tensor(a, device=dev)

        out.append(FourierDim(t(lf_c), t(ck), *(t(c) for c in consts),
                              x0=float(x0), s=float(s), h=float(h),
                              nhalf=int(n)))
        # Gram update: exact rectangular quadrature on the coarse grid
        gram_new = h * np.einsum("ajc,cd,bjd->ab", core, gram, core)
        gram = 0.5 * (gram_new + gram_new.T)
        gram = gram / max(np.max(np.abs(gram)), 1e-300)
    return FourierPrep(tuple(reversed(out)))


def _take(a, idx):
    return torch.gather(a, 1, idx[:, None])[:, 0]


def _bracket(cvals, fvals, target, nf: int):
    """Fine-grid bisection of the CDF rows for the cell of ``target``,
    ceil(log2(nf)) + 1 steps as in the JAX package.  Returns (i0, c1,
    f1, f2)."""
    mb = cvals.shape[0]
    lo = torch.zeros((mb,), dtype=torch.int64, device=cvals.device)
    hi = torch.full((mb,), nf - 1, dtype=torch.int64, device=cvals.device)
    for _ in range(int(math.ceil(math.log2(nf))) + 1):
        mid = (lo + hi) // 2
        left = target > _take(cvals, mid)
        lo = torch.where(left, mid, lo)
        hi = torch.where(left, hi, mid)
    i0 = torch.clamp(lo, 0, nf - 2)
    return i0, _take(cvals, i0), _take(fvals, i0), _take(fvals, i0 + 1)


def _quadratic_guess(f1, f2, target, c1, x1, width):
    """citardauq root of the in-cell quadratic (see irt's inversion):
    stable when the density is nearly flat."""
    aq = 0.5 * (f2 - f1) / width
    tq = target - c1
    dq = f1 * f1 + 4.0 * aq * tq
    den = f1 + torch.sqrt(torch.clamp(dq, min=0.0))
    safe_den = torch.where(den <= 0.0, torch.ones_like(den), den)
    return torch.where(den <= 0.0, x1, x1 + 2.0 * tq / safe_den)


def masked_newton(x, resid_fn, lo: float, hi: float):
    """Damped Newton x <- x - r/(|r'| + |r|), clipped to [lo, hi], on the
    rows whose |residual| is still above the tolerance: a fixed
    ``_NEWTON_MAX_ITERS`` masked iterations (a row that has converged
    keeps its x).  Returns (x, |r'(x)|)."""
    active = torch.ones(x.shape, dtype=torch.bool, device=x.device)
    for _ in range(_NEWTON_MAX_ITERS):
        resid, fval = resid_fn(x)
        still = torch.abs(resid) > _NEWTON_TOL
        xn = torch.clamp(x - resid / (torch.abs(fval) + torch.abs(resid)),
                         lo, hi)
        active = active & still
        x = torch.where(active, xn, x)
    _, fx = resid_fn(x)
    return x, torch.abs(fx)


def _forward_block(q, prep: FourierPrep, dsample: int):
    mb = q.shape[0]
    dev = q.device
    r0 = prep.dims[0].lfine.shape[0]
    phi = torch.zeros((mb, r0), dtype=torch.complex128, device=dev)
    phi.real.fill_(1.0)
    lf = torch.zeros((mb,), dtype=torch.float64, device=dev)
    xq = torch.empty((mb, dsample), dtype=torch.float64, device=dev)
    for k in range(dsample):
        p = prep.dims[k]
        s, n = p.s, p.nhalf
        n4 = 4 * n
        r1, _, rc = p.lfine.shape
        # conditional marginal on the fine grid: sum_e |phi L|^2 >= 0
        w = torch.matmul(phi, p.lfine.reshape(r1, n4 * rc))
        w = torch.view_as_real(w).reshape(mb, n4, 2 * rc)
        fvals = torch.sum(w * w, dim=2)                      # (Mb, 4n)
        # degenerate rows -> uniform
        bad = torch.all(fvals <= 0.0, dim=1, keepdim=True)
        fvals = torch.where(bad, torch.ones_like(fvals), fvals)
        # Fourier coefficients of the conditional, [Re | Im]
        g2 = torch.matmul(fvals, p.einv2)                    # (Mb, 8n)
        gr, gi = g2[:, :n4], g2[:, n4:]
        g0 = gr[:, 2 * n - 1]                                # m = 0 slot
        # CDF: C(x) = g0 (x + S) + sum_{m != 0} ghat_m S/(i pi m)
        #                           (e^{i pi m x/S} - (-1)^m)
        cr = gi * p.km
        ci = -gr * p.km
        cconst = g0 * s - torch.sum(cr * p.sign_m, dim=1)
        cvals = (torch.matmul(torch.cat([cr, ci], dim=1), p.ef2)
                 + g0[:, None] * p.xf + cconst[:, None])     # (Mb, 4n)
        cmax = cvals[:, -1]
        qk = q[:, k]
        target = qk * cmax
        i0, c1, f1, f2 = _bracket(cvals, fvals, target, n4)
        hf = p.h / 2.0
        xg = _quadratic_guess(f1, f2, target, c1, p.xf[i0], hf)
        xg = torch.clamp(xg, -s, s)
        # Newton on the normalised residual C(x)/cmax - q
        cr_n = cr / cmax[:, None]
        ci_n = ci / cmax[:, None]
        a0_n = g0 / cmax
        shift = cconst / cmax - qk
        dfreq = (-math.pi / s) * p.mfine

        def resid_fn(x):
            # Re[c e] = cr cos - ci sin; d/dx = -(pi m / s)(cr sin + ci cos)
            ang = (math.pi / s) * x[:, None] * p.mfine
            er, ei = torch.cos(ang), torch.sin(ang)
            resid = torch.sum(cr_n * er - ci_n * ei, dim=1) + a0_n * x + shift
            fval = torch.sum(dfreq * (cr_n * ei + ci_n * er), dim=1) + a0_n
            return resid, fval

        xk, jac = masked_newton(xg, resid_fn, -s, s)
        xq[:, k] = xk + p.x0
        lf = lf + torch.log(torch.clamp(jac, min=1e-300))
        if k < dsample - 1:
            # condition the prefix on xk through the core's trigonometric
            # interpolant (reference :290-301): phi <- phi B(xk),
            # B(x) = sum_m c_m e^{i pi m x / S}
            e = torch.polar(torch.ones_like(xk)[:, None],
                            (math.pi / s) * xk[:, None] * p.mcoarse)
            _, nc, r2 = p.coeffs.shape
            outer = (phi[:, :, None] * e[:, None, :]).reshape(mb, r1 * nc)
            phi = torch.matmul(outer, p.coeffs.reshape(r1 * nc, r2))
            scale = torch.clamp(torch.view_as_real(phi).abs().amax(
                dim=(1, 2)), min=1e-300)
            phi = phi / scale[:, None]
    return xq, lf


def spectral_blocked(forward, prep, q, block: int | None):
    """The block loop of the spectral samplers: rows in blocks of
    ``block`` (default min(auto_block(M), 2^15)), zero-padded to a whole
    number of blocks when there is more than one."""
    dsample = min(len(prep.dims), q.shape[1])
    m = q.shape[0]
    if block is None:
        block = min(auto_block(m), _MAX_BLOCK)
    nb = _num_blocks(m, block)
    if nb <= 1:
        return forward(q, prep, dsample)
    padded = _pad_rows(q, nb * block)
    xs = torch.empty((nb * block, dsample), dtype=torch.float64,
                     device=q.device)
    lf = torch.empty((nb * block,), dtype=torch.float64, device=q.device)
    for b in range(nb):
        sl = slice(b * block, (b + 1) * block)
        xs[sl], lf[sl] = forward(padded[sl], prep, dsample)
    return xs[:m], lf[:m]


def tt_irt_fourier(grid, f, q, block: int | None = None, device="cuda"):
    """Inverse Rosenblatt transform through sqrt(density) with
    trigonometric interpolation (reference tt_irt_fourier.m).

    Args:
      grid: uniform grids without their left border (ignored when ``f``
        is a FourierPrep).
      f: TT of sqrt(PDF) values on the grid, or a ``FourierPrep`` (the
        reference's struct-reuse mode, :106-137).
      q: (M, D) seeds in [0, 1]^D; D < d samples the first D variables.
      block: forward block size (default min(auto_block(M), 2^15)).
      device: where the transform runs (default "cuda").
    Returns (samples (M, D), log density (M,)), f64.
    """
    dev = resolve_device(device)
    if isinstance(f, FourierPrep):
        prep = prep_on(f, dev)
    else:
        prep = fourier_precompute(grid, f.to(dev))
    q = torch.as_tensor(q, dtype=torch.float64, device=dev)
    return spectral_blocked(_forward_block, prep, q, block)
