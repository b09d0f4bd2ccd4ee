"""Chebyshev-spectral SIRT: polynomial interpolation of the TT cores with
exact squaring, analytic CDF integration and masked Newton inversion
(counterpart of ``tt_irt_tpu/samplers/chebyshev.py``, the analog of the
reference's ftt.m / build_ftt functional-TT SIRT).

* Cores live on Chebyshev-Gauss-Lobatto nodes; coefficients come from
  the small cosine Vandermonde solve.  The host precompute
  (``cheb_precompute``) is the JAX package's, in numpy.
* The square of a degree-(n-1) interpolant is exact on the 2n-1-point
  Lobatto fine grid; the CDF integrates coefficient-wise
  (int T_k = T_{k+1}/(2(k+1)) - T_{k-1}/(2(k-1))); the backward
  semi-marginal carries a Gram with Clenshaw-Curtis weights on the fine
  grid (exact for products of the interpolants).
* Inversion: fine-grid bisection bracket, quadratic initial guess, and
  the damped masked Newton of the Fourier sampler (samplers/fourier.py:
  a fixed number of masked iterations, no host sync), with T_k and T'_k
  in angle form (cos(k acos t), k sin(k th)/sin th; the endpoint limits
  T'_k(+-1) = (+-1)^(k+1) k^2).

DIRT uses it with ``interpolation='chebyshev'`` (levels >= 1 on Lobatto
nodes; level 0 stays spline, tt_dirt_sample.m:69-71).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.tt import TT
from ..utils.device import resolve_device
from .fourier import (_bracket, _host, _quadratic_guess, masked_newton,
                      prep_on, spectral_blocked)

__all__ = ["ChebPrep", "cheb_precompute", "lobatto_nodes", "tt_irt_cheb"]


def lobatto_nodes(n: int, a: float = -1.0, b: float = 1.0) -> np.ndarray:
    """n Chebyshev-Gauss-Lobatto nodes on [a, b], ascending."""
    t = np.cos(np.pi * np.arange(n - 1, -1, -1) / (n - 1))
    return 0.5 * (b - a) * (t + 1.0) + a


def _cheb_vander(t, ncoef):
    """V[j, k] = T_k(t_j) in angle form (|t| <= 1)."""
    th = np.arccos(np.clip(t, -1.0, 1.0))
    return np.cos(np.outer(th, np.arange(ncoef)))


def _clenshaw_curtis_weights(nf):
    """Quadrature weights on the nf Lobatto nodes (ascending), exact for
    polynomials of degree <= nf-1: w = V^{-T} m with the Chebyshev
    moments m_k = int_{-1}^1 T_k = 2/(1-k^2) (even k), 0 (odd)."""
    t = np.cos(np.pi * np.arange(nf - 1, -1, -1) / (nf - 1))
    v = _cheb_vander(t, nf)
    k = np.arange(nf)
    mom = np.where(k % 2 == 0, 2.0 / (1.0 - k ** 2 + (k % 2)), 0.0)
    mom[1::2] = 0.0
    return np.linalg.solve(v.T, mom)


def _integrate_coeffs_matrix(nc):
    """Matrix B (nc+1, nc): Chebyshev coefficients of the antiderivative
    int_{-1}^t sum c_k T_k, zero at t = -1."""
    b = np.zeros((nc + 1, nc))
    b[1, 0] = 1.0
    if nc > 1:
        b[2, 1] = 0.25
    for k in range(2, nc):
        b[k + 1, k] += 1.0 / (2.0 * (k + 1))
        b[k - 1, k] -= 1.0 / (2.0 * (k - 1))
    # the constant: the value at t=-1 is sum_j b[j] (-1)^j
    tm1 = (-1.0) ** np.arange(nc + 1)
    b[0, :] -= tm1 @ b
    return b


class ChebDim(NamedTuple):
    """One dimension's sampling data on the device."""

    lfine: torch.Tensor    # (r1, nf, rc): factor values on the fine nodes
    coeffs: torch.Tensor   # (r1, n, r2): Chebyshev coefficients
    vinv_f: torch.Tensor   # (nf, nf): fine values -> fine coefficients
    bint: torch.Tensor     # (nf+1, nf): antiderivative map
    vfull: torch.Tensor    # (nf, nf+1): T_k at the fine nodes, k <= nf
    tf: torch.Tensor       # (nf,): fine Lobatto nodes on [-1, 1]
    mid: float
    half: float
    nmode: int


class ChebPrep(NamedTuple):
    """Per-dimension Chebyshev data (cf. FourierPrep)."""

    dims: tuple


def cheb_precompute(grid, f: TT, device=None) -> ChebPrep:
    """Per-dimension Chebyshev data of the sqrt-density TT ``f`` on
    Lobatto grids (one shared vector or d vectors), computed on the host
    and placed on ``device`` (default: the TT's)."""
    dev = f.device if device is None else resolve_device(device)
    d = f.d
    if isinstance(grid, (list, tuple)):
        grids = [_host(g).reshape(-1) for g in grid]
    else:
        grids = [_host(grid).reshape(-1)] * d
    out = []
    gram = np.eye(f.cores[-1].shape[2])
    for k in range(d - 1, -1, -1):
        core = _host(f.cores[k]).astype(np.float64)
        r1, n, r2 = core.shape
        x = grids[k]
        if x.shape[0] != n:
            raise ValueError("grid/core size mismatch")
        a, b = float(x[0]), float(x[-1])
        mid, half = 0.5 * (a + b), 0.5 * (b - a)
        t = (x - mid) / half
        tref = lobatto_nodes(n)
        if not np.allclose(t, tref, atol=1e-8):
            raise ValueError(f"dim {k}: grid is not Chebyshev-Lobatto "
                             "(use lobatto_nodes)")
        v = _cheb_vander(tref, n)
        ck = np.einsum("kj,ajb->akb", np.linalg.inv(v), core)
        nf = 2 * n - 1
        tf = lobatto_nodes(nf)
        vf = _cheb_vander(tf, n)                    # coarse on the fine grid
        ffine = np.einsum("fk,akb->afb", vf, ck)    # (r1, nf, r2)
        lchol = np.linalg.cholesky(
            gram + 1e-300 * np.eye(gram.shape[0])
            + 1e-14 * np.trace(gram) * np.eye(gram.shape[0]))

        def t_(a_):
            return torch.tensor(a_, device=dev)

        out.append(ChebDim(
            t_(np.einsum("afb,bc->afc", ffine, lchol)), t_(ck),
            t_(np.linalg.inv(_cheb_vander(tf, nf))),
            t_(_integrate_coeffs_matrix(nf)),
            t_(_cheb_vander(tf, nf + 1)), t_(tf),
            mid=mid, half=half, nmode=int(n)))
        # Gram update: Clenshaw-Curtis on the fine grid is exact for the
        # degree-(2n-2) product (times the half-width Jacobian)
        wcc = _clenshaw_curtis_weights(nf) * half
        gram_new = np.einsum("ajc,j,cd,bjd->ab", ffine, wcc, gram, ffine)
        gram = 0.5 * (gram_new + gram_new.T)
        gram = gram / max(np.max(np.abs(gram)), 1e-300)
    return ChebPrep(tuple(reversed(out)))


def _cheb_eval_batch(coefs, t):
    """sum_k coefs[:, k] T_k(t) and its derivative, per row; coefs
    (Mb, nc), t (Mb,) in [-1, 1]."""
    nc = coefs.shape[1]
    th = torch.arccos(torch.clamp(t, -1.0, 1.0))
    kk = torch.arange(nc, dtype=torch.float64, device=t.device)
    val = torch.sum(coefs * torch.cos(th[:, None] * kk), dim=1)
    # T'_k = k sin(k th)/sin th, with the endpoint limits
    # T'_k(1) = k^2, T'_k(-1) = (-1)^(k+1) k^2
    sth = torch.sin(th)
    st = torch.sin(th[:, None] * kk)
    safe = sth > 1e-7
    one = torch.ones((), dtype=torch.float64, device=t.device)
    endsign = torch.where(t[:, None] >= 0.0, one,
                          torch.where(kk % 2 == 0, -one, one))
    dct = torch.where(safe[:, None],
                      kk * st / torch.where(safe, sth, one)[:, None],
                      kk ** 2 * endsign)
    return val, torch.sum(coefs * dct, dim=1)


def _forward_block(q, prep: ChebPrep, dsample: int):
    mb = q.shape[0]
    dev = q.device
    r0 = prep.dims[0].lfine.shape[0]
    phi = torch.ones((mb, r0), dtype=torch.float64, device=dev)
    lf = torch.zeros((mb,), dtype=torch.float64, device=dev)
    xq = torch.empty((mb, dsample), dtype=torch.float64, device=dev)
    for k in range(dsample):
        p = prep.dims[k]
        nf = 2 * p.nmode - 1
        r1, _, rc = p.lfine.shape
        # conditional on the fine nodes: positive sum of squares
        w = torch.matmul(phi, p.lfine.reshape(r1, nf * rc)).reshape(
            mb, nf, rc)
        fvals = torch.sum(w * w, dim=2)              # (Mb, nf)
        bad = torch.all(fvals <= 0.0, dim=1, keepdim=True)
        fvals = torch.where(bad, torch.ones_like(fvals), fvals)
        # Chebyshev coefficients of the conditional (exact: degree 2n-2),
        # those of its antiderivative, and its CDF on the fine grid
        ghat = fvals @ p.vinv_f.T
        chat = ghat @ p.bint.T                       # (Mb, nf+1)
        cvals = chat @ p.vfull.T                     # (Mb, nf)
        cmax = cvals[:, -1]
        qk = q[:, k]
        target = qk * cmax
        i0, c1, f1, f2 = _bracket(cvals, fvals, target, nf)
        t1 = p.tf[i0]
        tg = _quadratic_guess(f1, f2, target, c1, t1,
                              torch.clamp(p.tf[i0 + 1] - t1, min=1e-300))
        tg = torch.clamp(tg, -1.0, 1.0)
        # masked damped Newton on C(t)/cmax - q
        chat_n = chat / cmax[:, None]

        def resid_fn(t):
            val, der = _cheb_eval_batch(chat_n, t)
            return val - qk, der

        tk, jac_t = masked_newton(tg, resid_fn, -1.0, 1.0)
        xq[:, k] = tk * p.half + p.mid
        # density of the realised map in x units: |C'(t)|/half
        lf = lf + torch.log(torch.clamp(jac_t / p.half, min=1e-300))
        if k < dsample - 1:
            nck = p.coeffs.shape[1]
            th = torch.arccos(torch.clamp(tk, -1.0, 1.0))
            tkb = torch.cos(th[:, None] * torch.arange(
                nck, dtype=torch.float64, device=dev))
            r2 = p.coeffs.shape[2]
            outer = (phi[:, :, None] * tkb[:, None, :]).reshape(mb, r1 * nck)
            phi = torch.matmul(outer, p.coeffs.reshape(r1 * nck, r2))
            scale = torch.clamp(torch.amax(torch.abs(phi), dim=1,
                                           keepdim=True), min=1e-300)
            phi = phi / scale
    return xq, lf


def tt_irt_cheb(grid, f, q, block: int | None = None, device="cuda"):
    """Inverse Rosenblatt transform through sqrt(density) with
    Chebyshev-spectral interpolation.

    Args:
      grid: Chebyshev-Gauss-Lobatto nodes per dimension
        (``lobatto_nodes``; ignored when ``f`` is a ChebPrep).
      f: TT of sqrt-density values on them, or a ``ChebPrep``.
      q: (M, D) seeds in [0, 1]^D.
      block: forward block size (default min(auto_block(M), 2^15)).
      device: where the transform runs (default "cuda").
    Returns (samples (M, D), log density (M,)), f64.
    """
    dev = resolve_device(device)
    if isinstance(f, ChebPrep):
        prep = prep_on(f, dev)
    else:
        prep = cheb_precompute(grid, f.to(dev))
    q = torch.as_tensor(q, dtype=torch.float64, device=dev)
    return spectral_blocked(_forward_block, prep, q, block)
