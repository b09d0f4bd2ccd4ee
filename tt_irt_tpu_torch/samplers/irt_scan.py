"""Rank-padded scan path of the IRT/RT transforms (counterpart of
``tt_irt_tpu/samplers/irt_scan.py``): every precision name of the JAX
package ('f64', 'f32', 'mixed', 'hi', 'hid', 'ds', 'gs'), modes 'sqr',
'rt' and 'lin'.

All TT ranks are zero-padded to the maximum rank so every dimension has
the same shape (exact: every contraction is linear in the padded
entries).

* Gram family ('f64'/'f32'/'mixed').  The backward pass
  (``_prepare_scan``) emits the semi-marginal fields P_k, with the QR
  carry (``stable=True``, the default of every entry point) or the Gram
  carry.  The forward pass runs, per dimension, the conditional
  fk = (phi x phi) P_k, the two-sided CDF inversion of ops/cdf.py in
  the CDF dtype, and the prefix update.  At 'f32'/'mixed' the two
  contractions are the CUDA kernels of ops/step.py on the card and their
  plain versions on the CPU; at 'f64' they are plain PyTorch on either
  device (the kernels are f32), which makes 'f64' the oracle of the rest.
  The CDF is the CUDA kernel of ops/cdf.py where it is f32 ('f32') on the
  card, and plain PyTorch otherwise.  'mixed' is f32 contractions with
  the CDF in native f64.
* 'hi'.  ``_prepare_scan_factor`` carries the suffix Gram in f64 and
  emits the factors B_k = C_k L_k.  The keyword ``hi_step`` names the
  algorithm of the per-dimension step; each value has its own kernel(s)
  on the card and its own plain version on the CPU:
    "dim"      one ``dim_step`` per dimension, nine bracket scalars per
               row, one batched f64 epilogue ``_serve_solve`` (default);
    "odim"     the same on the weighted-orthonormal cores
               Q_k = L_k^{-1} B_k (``_prepare_scan_factor(ortho=True)``):
               one ``odim_step`` per dimension, whose prefix update is a
               2-point readout of the conditional matrix;
    "bracket"  ``cdf_bracket_factor`` -> per-dimension f64
               ``_serve_solve`` -> ``condition_update``;
    "pair"     ``factor_conditional`` -> ``_cdf_invert_serve`` (f32 rows,
               f64 bracket scalars) -> ``condition_update``.
* 'lin' (the density itself in TT, linear splines) has no factor form:
  every precision name runs it in the Gram family's dtypes (the JAX
  package's table: 'f64' f64 throughout, 'f32' f32 throughout, every
  other name f32 contractions with an f64 CDF).  ``_prepare_scan_lin``
  integrates the raw cores backward into fields P_k (r, n); the
  conditional is fk = |phi P_k| (a plain product, as in the JAX
  package), then the Gram family's CDF inversion and prefix update, the
  latter through ``condition_update`` at an f32 contraction.
* 'hid' is "pair" with the CDF in native f64 (``_cdf_invert`` on
  fk.double()); 'ds' is the factor form with an f64 carry, plain PyTorch
  on either device; 'gs' is the Gram conditional on f64-prepared,
  f32-cast fields with the f32 CDF rows of 'hi' and the batched f64
  epilogue.

Which of a kernel and its plain version runs is decided in
ops/kernel_plan.py alone.

TPU workarounds of the JAX module that are not ported: the bf16
K-packing of the big matmuls, the double-single epilogue, CDF rows and
carries (``_cdf_invert_fast``, ``_serve_solve_ds``, ``_step_ds``), the
two-stream scan, and 0/1 structure matmuls in place of cumsums and
gathers.  FP64 is native on the card, so those parts are plain f64.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import kernel_plan
from ..ops.cdf import cdf_invert_ref as _cdf_invert
from ..ops.rowmath import cdf_rows32, cdf_sums32, full_f32_matmul
from ..ops.rowmath import invert_quadratic as _invert_quadratic
from ..ops.tt import TT
from ..utils.profiling import span
from .irt import _grid_spacings, _num_blocks, _pad_rows, _trapz_w2

__all__ = ["stack_padded", "can_use_scan", "FactorPrep", "OrthoPrep",
           "GramPrep", "GramBPrep", "LinPrep", "fwd_blocked", "irt_scan",
           "HI_STEPS", "resolved_serve_modes"]

# name -> (contraction dtype, CDF dtype, family), as the JAX package's
# table, except that 'ds' contracts in native f64 here (there: f32 pairs).
_PRECISIONS = {
    "f64": (torch.float64, torch.float64, "gram"),
    "f32": (torch.float32, torch.float32, "gram"),
    "mixed": (torch.float32, torch.float64, "gram"),
    "hi": (torch.float32, torch.float64, "factor"),
    "hid": (torch.float32, torch.float64, "factor"),
    "ds": (torch.float64, torch.float64, "ds"),
    "gs": (torch.float32, torch.float64, "gramb"),
}
PRECISIONS = tuple(_PRECISIONS)
# Mode 'lin': name -> (contraction dtype, CDF dtype); the Gram family's
# dtypes of the JAX package's table for every name.
_LIN_DTYPES = {name: ((torch.float64, torch.float64) if name == "f64" else
                      (torch.float32, torch.float32) if name == "f32" else
                      (torch.float32, torch.float64))
               for name in _PRECISIONS}
# The algorithms of the 'hi' per-dimension step (module docstring).
HI_STEPS = ("dim", "odim", "bracket", "pair")


def check_precision(precision, hi_step: str = "dim") -> None:
    """Raise ValueError for an unknown precision or ``hi_step``, and for
    a non-default ``hi_step`` with a precision other than 'hi'."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    if hi_step not in HI_STEPS:
        raise ValueError(f"unknown hi_step {hi_step!r}: one of {HI_STEPS}")
    if hi_step != "dim" and precision != "hi":
        raise ValueError(f"hi_step={hi_step!r} names an algorithm of "
                         f"precision 'hi'; got precision {precision!r}")


def _family(precision) -> str:
    return _PRECISIONS[precision][2]


def can_use_scan(tt: TT, grids, dsample: int) -> bool:
    n0 = grids[0].shape[0]
    return (dsample == tt.d
            and all(g.shape[0] == n0 for g in grids)
            and all(c.shape[1] == n0 for c in tt.cores)
            and tt.cores[0].shape[0] == 1
            and tt.cores[-1].shape[2] == 1)


def stack_padded(tt: TT, grids):
    """Zero-pad all cores to (rmax, n, rmax) and stack: (d, r, n, r);
    stack grids to (d, n)."""
    rmax = max(max(c.shape[0], c.shape[2]) for c in tt.cores)
    cores = []
    for c in tt.cores:
        r1, n, r2 = c.shape
        cp = torch.zeros((rmax, n, rmax), dtype=c.dtype, device=c.device)
        cp[:r1, :, :r2] = c
        cores.append(cp)
    return torch.stack(cores, dim=0), torch.stack(list(grids), dim=0)


def _prepare_scan(cstack, xstack, stable: bool = False):
    """Backward semi-marginalisation in Gram form, in cstack's dtype.

    cstack (..., d, r, n, r) — any leading batch dims (levels) — and
    xstack (d, n).  Two carries for the integral over x_{>k}:
    * stable=True: the thin R factor of a QR (full working precision
      even for ill-conditioned semi-marginals).  Rank padding leaves
      exact-zero columns, so 1e-14 * scale * I rows are appended as the
      JAX package does (there for the gradient; here so that the values
      match);
    * stable=False: the Gram matrix G = R R^T itself, renormalised by
      its max (squares the condition number).
    Returns (pstack (..., d, r, r, n), hstack (d, n)) with
    pstack[k, i, j, x] = P_k(x)[i, j]."""
    dt = cstack.dtype
    xstack = xstack.to(dt)
    d, r, n = cstack.shape[-4], cstack.shape[-3], cstack.shape[-2]
    hstack = _grid_spacings(xstack)
    w2 = _trapz_w2(hstack)
    batch = tuple(cstack.shape[:-4])
    eye = torch.eye(r, dtype=dt, device=cstack.device)
    carry = eye.expand(batch + (r, r))

    def amax(t):
        return torch.clamp(torch.amax(torch.abs(t), dim=(-2, -1),
                                      keepdim=True), min=1e-300)

    out = [None] * d
    with full_f32_matmul():
        for k in range(d - 1, -1, -1):
            core = cstack[..., k, :, :, :]
            if stable:
                b = torch.einsum("...anb,...bc->...anc", core, carry)
                pk = torch.einsum("...anc,...bnc->...abn", b, b)
                wb = b * torch.sqrt(w2[k])[:, None]
                mat = wb.reshape(batch + (r, n * r)).transpose(-1, -2)
                mat = torch.cat([mat, (1e-14 * amax(mat)) * eye], dim=-2)
                # mode "reduced": PyTorch has no backward for mode "r"
                rnew = torch.linalg.qr(mat, mode="reduced").R.transpose(
                    -1, -2)
                carry = rnew / amax(rnew)
            else:
                t = torch.einsum("...anc,...cd->...and", core, carry)
                pk = torch.einsum("...and,...bnd->...abn", t, core)
                gnew = torch.einsum("...abn,n->...ab", pk, w2[k])
                gnew = 0.5 * (gnew + gnew.transpose(-1, -2))
                carry = gnew / amax(gnew)
            out[k] = pk
    return torch.stack(out, dim=-4), hstack


def _prepare_scan_lin(cstack, xstack):
    """Backward trapezoid integration of the raw cores for mode 'lin',
    in cstack's dtype: P_k = C_k p_(k+1) with p_(k+1) the integral of
    the suffix over x_(>k), renormalised by its largest entry.
    cstack (d, r, n, r), xstack (d, n).  Returns (pstack (d, r, n),
    hstack (d, n))."""
    xstack = xstack.to(cstack.dtype)
    d, r = cstack.shape[0], cstack.shape[1]
    hstack = _grid_spacings(xstack)
    pprev = torch.zeros((r,), dtype=cstack.dtype, device=cstack.device)
    pprev[0] = 1.0
    out = [None] * d
    with full_f32_matmul():
        for k in range(d - 1, -1, -1):
            b = torch.einsum("anb,b->an", cstack[k], pprev)
            pnext = torch.sum(0.5 * (b[:, :-1] + b[:, 1:]) * hstack[k, 1:],
                              dim=1)
            pprev = pnext / torch.clamp(pnext.abs().max(), min=1e-300)
            out[k] = b
    return torch.stack(out, dim=0), hstack


def _chol_jittered(gram):
    """Cholesky of a batch of PSD Grams with tiered jitter: the first
    finite factor of gram + (e * max diag + 1e-290) I for
    e = 1e-14, 1e-10, 1e-6 (the last one if none is).  Rank-padded zero
    lanes and rounding-negative trailing eigenvalues of rank-deficient
    Grams need it."""
    r = gram.shape[-1]
    eye = torch.eye(r, dtype=gram.dtype, device=gram.device)
    dmax = torch.amax(torch.diagonal(gram, dim1=-2, dim2=-1), dim=-1)
    out = None
    for e in (1e-6, 1e-10, 1e-14):
        jit = (e * dmax + 1e-290)[..., None, None]
        lfac, info = torch.linalg.cholesky_ex(gram + jit * eye)
        if out is None:
            out = lfac
            continue
        ok = (info == 0) & torch.isfinite(lfac).all(dim=-1).all(dim=-1)
        out = torch.where(ok[..., None, None], lfac, out)
    return out


def _prepare_scan_factor(cstack, xstack, ortho: bool = False):
    """Backward semi-marginalisation in factor form, f64 throughout.

    cstack (..., d, r, n, r) — any leading batch dims (levels) — and
    xstack (d, n).  Carries the suffix Gram G_k (renormalised by its
    max) and emits B_k = C_k L_k with G_k = L_k L_k^T.  With
    ``ortho=True`` it emits the weighted-right-orthonormal cores
    Q_k = L_new^{-1} B_k instead, L_new the jittered Cholesky factor of
    the renormalised Gram after the update, so that
    sum_x w2[x] Q_k(x) Q_k(x)^T = I up to the jitter; the forward carry
    is then psi_k = phi_k L_k.  Rank-padded rows of Q_k are exact zeros
    (B's padded rows are zero and L_new is block diagonal there).  The
    jitter tier of each Cholesky is chosen per batch entry.  Returns
    (bstack or qstack (..., d, r, n, r), hstack (d, n))."""
    cstack = cstack.to(torch.float64)
    xstack = xstack.to(torch.float64)
    d, r = cstack.shape[-4], cstack.shape[-3]
    hstack = _grid_spacings(xstack)
    w2 = _trapz_w2(hstack)
    batch = tuple(cstack.shape[:-4])
    gram = torch.eye(r, dtype=torch.float64, device=cstack.device).expand(
        batch + (r, r))
    out = [None] * d
    for k in range(d - 1, -1, -1):
        core = cstack[..., k, :, :, :]
        lfac = _chol_jittered(gram)
        b = torch.einsum("...anc,...cd->...and", core, lfac)
        gnew = torch.einsum("...anc,...bnc,n->...ab", b, b, w2[k])
        gnew = 0.5 * (gnew + gnew.transpose(-1, -2))
        scale = torch.amax(torch.abs(gnew), dim=(-2, -1), keepdim=True)
        gram = gnew / torch.clamp(scale, min=1e-300)
        if ortho:
            n = b.shape[-2]
            b = torch.linalg.solve_triangular(
                _chol_jittered(gram), b.reshape(batch + (r, n * r)),
                upper=False).reshape(batch + (r, n, r))
        out[k] = b
    return torch.stack(out, dim=-4), hstack


class FactorPrep(NamedTuple):
    """Per-dimension operands of the raw-factor forward passes (one
    TT).  ``step`` names the forward pass: the ``hi_step`` values "dim",
    "bracket", "pair" of 'hi', "hid", or "ds" (whose bmat and cmat are
    f64)."""

    bmat: torch.Tensor    # (d, r, n*r) B_k unfolded
    cmat: torch.Tensor    # (d, n, r*r) C_k unfolded
    xg: torch.Tensor      # (d, 2, n) f32 pair of the grids
    hrow: torch.Tensor    # (d, n-1) f32 spacings
    xs: torch.Tensor      # (d, n) f64 grids
    hs: torch.Tensor      # (d, n) f64 spacings, hs[:, 0] = 0
    step: str = "dim"


class OrthoPrep(NamedTuple):
    """Per-dimension operands of the orthonormal-core 'hi' forward pass
    (``hi_step="odim"``, one TT)."""

    qmat: torch.Tensor    # (d, r, n*r) f32, Q_k unfolded
    xg: torch.Tensor      # (d, 2, n) f32 pair of the grids
    hrow: torch.Tensor    # (d, n-1) f32 spacings


class GramBPrep(NamedTuple):
    """Per-dimension operands of the 'gs' forward pass (one TT): Gram
    fields prepared in f64 and cast to f32."""

    pmat: torch.Tensor    # (d, r*r, n) f32
    cmat: torch.Tensor    # (d, n, r*r) f32
    xg: torch.Tensor      # (d, 2, n) f32 pair of the grids
    hrow: torch.Tensor    # (d, n-1) f32 spacings


class GramPrep(NamedTuple):
    """Per-dimension operands of the Gram-family forward pass (one TT).
    pmat and cmat carry the contraction dtype, xs and hs the CDF dtype;
    together they identify the precision ('f64', 'f32' or 'mixed')."""

    pmat: torch.Tensor    # (d, r*r, n), pmat[k, i*r + j, x] = P_k(x)[i, j]
    cmat: torch.Tensor    # (d, n, r*r), C_k unfolded
    xs: torch.Tensor      # (d, n) grids
    hs: torch.Tensor      # (d, n) spacings, hs[:, 0] = 0


class LinPrep(NamedTuple):
    """Per-dimension operands of the 'lin' forward pass (one TT): the
    fields and the core in the contraction dtype, grids and spacings in
    the CDF dtype."""

    pmat: torch.Tensor    # (d, r, n), pmat[k, i, x] = P_k(x)[i]
    cmat: torch.Tensor    # (d, n, r*r), C_k unfolded
    xs: torch.Tensor      # (d, n) grids
    hs: torch.Tensor      # (d, n) spacings, hs[:, 0] = 0


def prep_level(prep, j: int):
    """Level j of a prep whose tensor fields carry a leading level
    axis."""
    return type(prep)(*(t[j].contiguous() if torch.is_tensor(t) else t
                        for t in prep))


def _per_level(lead, t):
    """t repeated over the leading level axes ``lead``."""
    return t.expand(tuple(lead) + tuple(t.shape)).contiguous()


def _grid_pair(xstack, hstack):
    """(xg (d, 2, n), hrow (d, n-1)): the f64 grids as f32 pairs
    x = xg[:, 0] + xg[:, 1], and the f32 spacings."""
    xs = xstack.to(torch.float64)
    x32 = xs.to(torch.float32)
    xlo = (xs - x32.to(torch.float64)).to(torch.float32)
    return torch.stack([x32, xlo], dim=1), hstack.to(torch.float32)[:, 1:]


def _unfold_cores(cstack):
    """cmat (..., d, n, r*r) with cmat[x, i*r + j] = C[i, x, j]."""
    *lead, d, r, n, _ = cstack.shape
    return cstack.transpose(-3, -2).reshape(tuple(lead) + (d, n, r * r))


def _prep_factor(cstack, xstack, step: str = "dim"):
    """Backward preparation for the factor families: 'hi' (``step`` one
    of HI_STEPS), 'hid' and 'ds'.  The pass runs in f64; the emitted
    factor is cast to f32 except for "ds"."""
    bstack, hstack = _prepare_scan_factor(cstack, xstack,
                                          ortho=step == "odim")
    *lead, d, r, n, _ = bstack.shape
    lead = tuple(lead)
    cdt = _PRECISIONS["ds" if step == "ds" else "hi"][0]
    bmat = bstack.reshape(lead + (d, r, n * r)).to(cdt).contiguous()
    xg, hrow = _grid_pair(xstack, hstack)
    if step == "odim":
        return OrthoPrep(bmat, _per_level(lead, xg), _per_level(lead, hrow))
    cmat = _unfold_cores(cstack.to(torch.float64)).to(cdt).contiguous()
    return FactorPrep(bmat, cmat, _per_level(lead, xg),
                      _per_level(lead, hrow),
                      _per_level(lead, xstack.to(torch.float64)),
                      _per_level(lead, hstack), step)


def _prep_gramb(cstack, xstack, stable) -> GramBPrep:
    """Backward preparation for 'gs': the Gram pass in f64, its fields
    and the cores cast to f32."""
    pstack, hstack = _prepare_scan(cstack.to(torch.float64),
                                   xstack.to(torch.float64), stable=stable)
    *lead, d, r, _, n = pstack.shape
    lead = tuple(lead)
    xg, hrow = _grid_pair(xstack, hstack)
    return GramBPrep(
        pstack.reshape(lead + (d, r * r, n)).to(torch.float32).contiguous(),
        _unfold_cores(cstack.to(torch.float32)).contiguous(),
        _per_level(lead, xg), _per_level(lead, hrow))


def _prep_gram(cstack, xstack, precision, stable) -> GramPrep:
    """Backward preparation for 'f64', 'f32' and 'mixed': the whole
    pass runs in the contraction dtype, the grids and spacings are then
    carried in the CDF dtype (as the JAX package does)."""
    cdt, pdt, _ = _PRECISIONS[precision]
    cs = cstack.to(cdt)
    pstack, hstack = _prepare_scan(cs, xstack.to(cdt), stable=stable)
    *lead, d, r, n, _ = cs.shape
    lead = tuple(lead)
    return GramPrep(pstack.reshape(lead + (d, r * r, n)).contiguous(),
                    _unfold_cores(cs).contiguous(),
                    _per_level(lead, xstack.to(pdt)),
                    _per_level(lead, hstack.to(pdt)))


def _prep_lin(cstack, xstack, precision) -> LinPrep:
    """Backward preparation of mode 'lin' (one TT) in the contraction
    dtype of ``precision``'s row of _LIN_DTYPES."""
    cdt, pdt = _LIN_DTYPES[precision]
    cs = cstack.to(cdt)
    pstack, hstack = _prepare_scan_lin(cs, xstack)
    return LinPrep(pstack.contiguous(), _unfold_cores(cs).contiguous(),
                   xstack.to(pdt), hstack.to(pdt))


def _prep(cstack, xstack, precision: str = "hi", stable: bool = True,
          hi_step: str = "dim", mode: str = "sqr"):
    """Backward preparation: everything the forward pass needs except
    the seeds; the type of the result (and a FactorPrep's ``step``)
    names the forward pass.  cstack may carry a leading level dimension
    (not in mode 'lin'); every tensor field then carries it too
    (``prep_level`` picks one)."""
    check_precision(precision, hi_step)
    if mode == "lin":
        return _prep_lin(cstack, xstack, precision)
    family = _family(precision)
    if family == "gram":
        return _prep_gram(cstack, xstack, precision, stable)
    if family == "gramb":
        return _prep_gramb(cstack, xstack, stable)
    if family == "ds":
        return _prep_factor(cstack, xstack, "ds")
    return _prep_factor(cstack, xstack,
                        "hid" if precision == "hid" else hi_step)


def _cdf_invert_serve(mode, fk, xp, h32, qp):
    """Two-sided CDF inversion with f32 rows and f64 restricted to the
    per-row bracket scalars (the in-loop CDF of ``hi_step="pair"``).

    The two-sided scheme sums the CDF from the near side, so the
    rounding floor of a bracket value is eps_f32 times the mass on the
    near side of the bracket.  fk (M, n) f32 unnormalised, xp (n,) f64
    grid, h32 (n-1,) f32 spacings, qp (M,) f64 seeds (points in 'rt'
    mode).  The bracket targets are q * tot and (1 - q) * tot formed in
    f64 and rounded to f32.  Returns (out, dlf, la, lb, i0) with f64
    scalars."""
    with span("ttirt.cdf"):
        n = fk.shape[1]
        f64 = torch.float64
        fk, ck, cr = cdf_sums32(fk, h32)
        tot = ck[:, -1].to(f64)
        if mode == "rt":
            x32 = xp.to(torch.float32)
            i0 = torch.sum(x32[None, :] < qp.to(torch.float32)[:, None],
                           dim=1) - 1
        else:
            right = qp > 0.5
            qt = qp * tot
            ut = (1.0 - qp) * tot
            i0l = torch.sum(ck < qt.to(torch.float32)[:, None], dim=1) - 1
            i0r = torch.sum(cr > ut.to(torch.float32)[:, None], dim=1) - 1
            i0 = torch.where(right, i0r, i0l)
        i0 = torch.clamp(i0, 0, n - 2)
        i1 = i0 + 1

        def read64(rows, idx):
            return torch.gather(rows, 1, idx[:, None])[:, 0].to(f64)

        c1 = read64(ck, i0)
        cr2 = read64(cr, i1)
        f1 = read64(fk, i0)
        f2 = read64(fk, i1)
        x1, x2 = xp[i0], xp[i1]
        if mode == "rt":
            xk = qp
            yk = x2 - xk
            aq = 0.5 * (f2 - f1) / (x2 - x1)
            cl_ = aq * (xk - x1) ** 2 + f1 * (xk - x1) + c1
            cr_ = tot - (f2 * yk - aq * yk * yk + cr2)
            out = torch.where(cl_ > 0.5 * tot, cr_, cl_) / tot
        else:
            xl_ = _invert_quadratic(f1, f2, c1, qt, x1, x2)
            xr_ = -_invert_quadratic(f2, f1, cr2, ut, -x2, -x1)
            xk = torch.where(right, xr_, xl_)
            out = xk
        la = (x2 - xk) / (x2 - x1)
        lb = (xk - x1) / (x2 - x1)
        dlf = torch.log(f1 * la + f2 * lb) - torch.log(tot)
        return out, dlf, la, lb, i0


def _serve_solve(mode, out9, qp):
    """f64 epilogue: the within-cell quadratic inversion (or, in 'rt'
    mode, the CDF evaluation) and the per-dim log-density from the nine
    bracket scalars.  Returns (out, dlf, la, lb), all f64: la and lb are
    the weights of the bracket's two nodes at the sample."""
    with span("ttirt.epilogue"):
        f64 = torch.float64
        c1 = out9[:, 0].to(f64)
        cr2 = out9[:, 1].to(f64)
        f1 = out9[:, 2].to(f64)
        f2 = out9[:, 3].to(f64)
        x1 = out9[:, 4].to(f64) + out9[:, 5].to(f64)
        x2 = out9[:, 6].to(f64) + out9[:, 7].to(f64)
        tot = out9[:, 8].to(f64)
        if mode == "rt":
            xk = qp
            yk = x2 - xk
            aq = 0.5 * (f2 - f1) / (x2 - x1)
            cl_ = aq * (xk - x1) ** 2 + f1 * (xk - x1) + c1
            cr_ = tot - (f2 * yk - aq * yk * yk + cr2)
            out = torch.where(cl_ > 0.5 * tot, cr_, cl_) / tot
        else:
            # the selector must equal the kernel's f32 bracket choice at
            # rounding-boundary seeds (qp in (0.5, 0.5 + 2^-25) rounds to
            # f32 0.5): derive it from the same f32 value
            right = qp.to(torch.float32) > 0.5
            ta = torch.where(right, (1.0 - qp) * tot, qp * tot)
            fa = torch.where(right, f2, f1)
            fb = torch.where(right, f1, f2)
            ca = torch.where(right, cr2, c1)
            ua = torch.where(right, -x2, x1)
            ub = torch.where(right, -x1, x2)
            xs_ = _invert_quadratic(fa, fb, ca, ta, ua, ub)
            xk = torch.where(right, -xs_, xs_)
            out = xk
        inv21 = 1.0 / (x2 - x1)
        la = (x2 - xk) * inv21
        lb = (xk - x1) * inv21
        dlf = torch.log((f1 * la + f2 * lb) / tot)
        return out, dlf, la, lb


def _fwd_serveb(mode, q, d, r, step_k):
    """The batched-epilogue forward pass over one block of rows:
    ``step_k(k, carry, qp32_k, um32_k) -> (carry, out9)`` runs once per
    dimension on an f32 carry (M, r) that starts at e_0, then one
    batched f64 epilogue turns the (d, M, 9) bracket scalars into
    samples and log-densities."""
    mb = q.shape[0]
    q64 = q.to(torch.float64).T.contiguous()               # (d, mb)
    qp32 = q64.to(torch.float32)
    um32 = (1.0 - q64).to(torch.float32)
    carry = torch.zeros((mb, r), dtype=torch.float32, device=q.device)
    carry[:, 0] = 1.0
    outs9 = torch.empty((d, mb, 9), dtype=torch.float32, device=q.device)
    for k in range(d):
        carry, outs9[k] = step_k(k, carry, qp32[k], um32[k])
    out, dlf, _, _ = _serve_solve(mode, outs9.reshape(d * mb, 9),
                                  q64.reshape(d * mb))
    lf = torch.sum(dlf.reshape(d, mb), dim=0)
    return out.reshape(d, mb).T, lf


def _kmode(mode):
    return "rt" if mode == "rt" else "irt"


def _fwd_dim(mode, prep: FactorPrep, q, step=None):
    """'hi' at hi_step="dim": one ``dim_step`` per dimension.  ``step``
    defaults to the device's choice (ops/kernel_plan.py)."""
    step = step if step is not None else kernel_plan.dim_step
    d, r = prep.bmat.shape[:2]
    return _fwd_serveb(mode, q, d, r, lambda k, phi, qk, uk: step(
        phi, qk, uk, prep.bmat[k], prep.cmat[k], prep.hrow[k], prep.xg[k],
        mode=_kmode(mode)))


def _fwd_ortho(mode, prep: OrthoPrep, q, step=None):
    """'hi' at hi_step="odim": one ``odim_step`` per dimension on the
    orthonormal cores; the carry is psi_k = phi_k L_k."""
    step = step if step is not None else kernel_plan.odim_step
    d, r = prep.qmat.shape[:2]
    return _fwd_serveb(mode, q, d, r, lambda k, psi, qk, uk: step(
        psi, qk, uk, prep.qmat[k], prep.hrow[k], prep.xg[k],
        mode=_kmode(mode)))


def _fwd_gramb(mode, prep: GramBPrep, q, step=None):
    """'gs': per dimension the Gram conditional clamped at 0, the f32
    CDF rows of 'hi' in plain PyTorch, and the prefix update; then the
    batched f64 epilogue.  ``step`` is the pair (gram_conditional,
    condition_update)."""
    gram, update = (step if step is not None
                    else kernel_plan.gram_step(prep.pmat.dtype))
    d, rr, _ = prep.pmat.shape

    def step_k(k, phi, qk, uk):
        fk = torch.clamp(gram(phi, prep.pmat[k]), min=0.0)
        with span("ttirt.cdf"):
            out9, i0, la = cdf_rows32(_kmode(mode), fk, prep.xg[k, 0],
                                      prep.xg[k, 1], prep.hrow[k], qk, uk)
        return update(phi, i0.to(torch.int32), la, 1.0 - la,
                      prep.cmat[k]), out9

    return _fwd_serveb(mode, q, d, int(round(rr ** 0.5)), step_k)


def _fwd_split(mode, prep: FactorPrep, q, step=None):
    """The split factor-form forward passes over one block of rows: a
    first kernel, the CDF inversion with f64 scalars, and
    ``condition_update``, per dimension, with the log-density carried
    through the loop.  By ``prep.step``:
      "bracket"  ``cdf_bracket_factor`` -> f64 ``_serve_solve``;
      "pair"     ``factor_conditional`` -> ``_cdf_invert_serve``;
      "hid"      ``factor_conditional`` -> ``_cdf_invert`` in f64;
      "ds"       as "hid" on an f64 carry and f64 operands.
    ``step`` is the pair (first kernel, condition_update) and defaults
    to the choice of ops/kernel_plan.py."""
    d, r = prep.bmat.shape[:2]
    cdt = prep.bmat.dtype
    mb = q.shape[0]
    q64 = q.to(torch.float64).T.contiguous()               # (d, mb)
    if step is not None:
        first, update = step
    elif prep.step == "bracket":
        first, update = (kernel_plan.cdf_bracket_factor,
                         kernel_plan.condition_update)
    else:
        first, update = kernel_plan.factor_step(cdt)
    phi = torch.zeros((mb, r), dtype=cdt, device=q.device)
    phi[:, 0] = 1.0
    lf = torch.zeros((mb,), dtype=torch.float64, device=q.device)
    outs = torch.empty((d, mb), dtype=torch.float64, device=q.device)
    for k in range(d):
        if prep.step == "bracket":
            out9, i0 = first(phi, q64[k].to(torch.float32), prep.bmat[k],
                             prep.hrow[k], prep.xg[k], mode=_kmode(mode))
            outs[k], dlf, la, lb = _serve_solve(mode, out9, q64[k])
        elif prep.step == "pair":
            fk = first(phi, prep.bmat[k])
            outs[k], dlf, la, lb, i0 = _cdf_invert_serve(
                mode, fk, prep.xs[k], prep.hrow[k], q64[k])
        else:
            fk = first(phi, prep.bmat[k])
            outs[k], dlf, la, lb, i0 = _cdf_invert(
                mode, fk.to(torch.float64), prep.xs[k], prep.hs[k], q64[k])
        lf = lf + dlf
        phi = update(phi, i0.to(torch.int32), la.to(cdt), lb.to(cdt),
                     prep.cmat[k])
    return outs.T, lf


def lin_conditional(phi, pmat):
    """Mode 'lin''s conditional fk = |phi P_k| (M, n), a plain product
    in full f32 or f64 (the JAX package has no kernel for it)."""
    with full_f32_matmul():
        return torch.abs(torch.matmul(phi, pmat))


def _fwd_gram(mode, prep, q, step=None):
    """Gram-family forward pass over one block of rows (a GramPrep, or a
    LinPrep in mode 'lin').  Per dimension: the conditional,
    the CDF inversion in the CDF dtype (at 'mixed' on fk clamped at 0, as
    the JAX package does before its f64 CDF; at 'f32' fk may come out
    slightly negative by cancellation and is left so), and the prefix
    update.  ``step`` is the triple (conditional, cdf_invert,
    condition_update) and defaults to the choice of ops/kernel_plan.py,
    with ``lin_conditional`` for a LinPrep; the CDF (as
    ``kernel_plan.cdf_invert``) writes each dimension's samples into
    ``outs`` and adds its log-density into ``lf`` in place.  Samples and
    log-density come back in the CDF dtype."""
    d, n = prep.pmat.shape[0], prep.pmat.shape[2]
    r = int(round(prep.cmat.shape[2] ** 0.5))
    cdt, pdt = prep.pmat.dtype, prep.xs.dtype
    mixed = cdt != pdt
    mb = q.shape[0]
    qs = q.to(pdt).T.contiguous()                          # (d, mb)
    if step is not None:
        gram, cdf, update = step
    else:
        gram, update = kernel_plan.gram_step(cdt)
        cdf = kernel_plan.cdf_invert
        if isinstance(prep, LinPrep):
            gram = lin_conditional
    phi = torch.zeros((mb, r), dtype=cdt, device=q.device)
    phi[:, 0] = 1.0
    lf = torch.zeros((mb,), dtype=pdt, device=q.device)
    outs = torch.empty((d, mb), dtype=pdt, device=q.device)
    for k in range(d):
        fk = gram(phi, prep.pmat[k])
        if mixed:
            fk = torch.clamp(fk, min=0.0)
        la, lb, i0 = cdf(mode, fk.to(pdt), prep.xs[k], prep.hs[k], qs[k],
                         outs[k], lf)
        phi = update(phi, i0.to(torch.int32), la.to(cdt), lb.to(cdt),
                     prep.cmat[k])
    return outs.T, lf


def _fwd(mode, prep, q, step=None):
    """Forward pass over one block of rows; the prep's type (and a
    FactorPrep's ``step``) names it.  Returns (samples (M, d), lf (M,)).
    ``step`` replaces the kernel-plan choice of every per-dimension
    function (in the Gram family the conditional, the CDF and the
    update); the chip smoke test passes the plain versions to compare on
    the card."""
    with span("ttirt.block"):
        if isinstance(prep, (GramPrep, LinPrep)):
            return _fwd_gram(mode, prep, q, step)
        if isinstance(prep, GramBPrep):
            return _fwd_gramb(mode, prep, q, step)
        if isinstance(prep, OrthoPrep):
            return _fwd_ortho(mode, prep, q, step)
        if prep.step == "dim":
            return _fwd_dim(mode, prep, q, step)
        return _fwd_split(mode, prep, q, step)


def fwd_blocked(mode, prep, q, block: int):
    """Block loop over the forward pass: rows are zero-padded to a whole
    number of blocks when there is more than one."""
    m = q.shape[0]
    nb = _num_blocks(m, block)
    if nb <= 1:
        return _fwd(mode, prep, q)
    padded = _pad_rows(q, nb * block)
    xs_parts, lf_parts = [], []
    for b in range(nb):
        xb, lb = _fwd(mode, prep, padded[b * block:(b + 1) * block])
        xs_parts.append(xb)
        lf_parts.append(lb)
    return (torch.cat(xs_parts, dim=0)[:m], torch.cat(lf_parts, dim=0)[:m])


def _irt_scan_one(mode, cstack, xstack, q, precision="f64", stable=False,
                  hi_step="dim"):
    """One-shot transform of a single block of rows (for tests)."""
    return _fwd(mode, _prep(cstack, xstack, precision, stable, hi_step,
                            mode=mode), q)


def irt_scan(mode, cstack, xstack, q, block, precision="f64",
             hi_step="dim"):
    """Blocked scan transform, mode in {'sqr', 'rt', 'lin'}: the
    backward preparation runs once (QR-stabilised for the Gram family),
    then the forward pass runs block by block.  ``hi_step`` names the
    algorithm of the 'hi' step (module docstring; not used by 'lin')."""
    if mode not in ("sqr", "rt", "lin"):
        raise ValueError(f"unknown mode {mode!r}")
    prep = _prep(cstack, xstack, precision, stable=True, hi_step=hi_step,
                 mode=mode)
    return fwd_blocked(mode, prep, q, block)


def resolved_serve_modes(precision: str = "hi", hi_step: str = "dim",
                         device="cuda") -> dict:
    """What is in force for a serve at ``precision`` / ``hi_step`` on
    ``device``, so that a record can carry it (counterpart of the JAX
    package's ``resolved_serve_modes``; the port has no environment
    knobs, so everything here follows from the arguments)."""
    check_precision(precision, hi_step)
    cdt, pdt, family = _PRECISIONS[precision]
    dev = torch.device(device)
    return {
        "precision": precision,
        "hi_step": hi_step if precision == "hi" else None,
        "family": family,
        "contraction_dtype": str(cdt).replace("torch.", ""),
        "cdf_dtype": str(pdt).replace("torch.", ""),
        "epilogue": "f64",
        "tnormal": "erf",
        "kernels": (dev.type == "cuda"
                    and precision not in ("f64", "ds")),
        "backend": "torch",
        "device": dev.type,
    }
