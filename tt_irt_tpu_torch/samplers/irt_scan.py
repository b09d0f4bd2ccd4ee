"""Rank-padded scan path of the IRT/RT transforms (counterpart of
``tt_irt_tpu/samplers/irt_scan.py``): precisions 'f64', 'f32', 'mixed'
(Gram form) and 'hi' (factor form), modes 'sqr' and 'rt'.

All TT ranks are zero-padded to the maximum rank so every dimension has
the same shape (exact: every contraction is linear in the padded
entries).

* Gram family ('f64'/'f32'/'mixed').  The backward pass
  (``_prepare_scan``) emits the semi-marginal fields P_k, with the QR
  carry (``stable=True``, the default of every entry point) or the Gram
  carry.  The forward pass runs, per dimension, the conditional
  fk = (phi x phi) P_k, the two-sided CDF inversion ``_cdf_invert`` in
  the CDF dtype, and the prefix update.  At 'f32'/'mixed' the two
  contractions are the CUDA kernels of ops/step.py on the card and their
  plain versions on the CPU; at 'f64' they are plain PyTorch on either
  device (the kernels are f32), which makes 'f64' the oracle of the rest.
  'mixed' is f32 contractions with the CDF in native f64.
* 'hi'.  ``_prepare_scan_factor`` carries the suffix Gram in f64 and
  emits the factors B_k = C_k L_k; the forward pass runs one ``dim_step``
  per dimension, collecting nine bracket scalars per row, and one batched
  f64 epilogue (``_serve_solve``) turns them into samples and
  log-densities.

Which of a kernel and its plain version runs is decided in
ops/kernel_plan.py alone.

TPU workarounds of the JAX module that are not ported: the bf16
K-packing of the big matmuls, the double-single epilogue and CDF rows
(``_cdf_invert_fast``), and 0/1 structure matmuls in place of cumsums and
gathers.  FP64 is native on the card, so those parts are plain f64.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import kernel_plan
from ..ops.rowmath import cumsum_rows, full_f32_matmul
from ..ops.rowmath import invert_quadratic as _invert_quadratic
from ..ops.tt import TT
from .irt import _grid_spacings, _num_blocks, _pad_rows

__all__ = ["stack_padded", "can_use_scan", "FactorPrep", "GramPrep",
           "fwd_blocked", "irt_scan"]

# name -> (contraction dtype, CDF dtype, family), as the JAX package's
# table; the families of 'hid', 'ds' and 'gs' are not ported yet.
_PRECISIONS = {
    "f64": (torch.float64, torch.float64, "gram"),
    "f32": (torch.float32, torch.float32, "gram"),
    "mixed": (torch.float32, torch.float64, "gram"),
    "hi": (torch.float32, torch.float64, "factor"),
    "hid": (torch.float32, torch.float64, "factor"),
    "ds": (torch.float32, torch.float64, "ds"),
    "gs": (torch.float32, torch.float64, "gramb"),
}
PRECISIONS = tuple(_PRECISIONS)
PORTED_PRECISIONS = ("f64", "f32", "mixed", "hi")


def check_precision(precision) -> None:
    """Raise for precision modes that the port does not run yet."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    if precision not in PORTED_PRECISIONS:
        raise NotImplementedError(
            f"precision {precision!r} is not ported to PyTorch yet; only "
            f"{PORTED_PRECISIONS} run (see ROADMAP.md)")


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


def _trapz_w2(hstack):
    """Composite trapezoid weights from the spacing rows."""
    return 0.5 * torch.cat([hstack[:, 1:2],
                            hstack[:, 1:-1] + hstack[:, 2:],
                            hstack[:, -1:]], dim=1)


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
                rnew = torch.linalg.qr(mat, mode="r").R.transpose(-1, -2)
                carry = rnew / amax(rnew)
            else:
                t = torch.einsum("...anc,...cd->...and", core, carry)
                pk = torch.einsum("...and,...bnd->...abn", t, core)
                gnew = torch.einsum("...abn,n->...ab", pk, w2[k])
                gnew = 0.5 * (gnew + gnew.transpose(-1, -2))
                carry = gnew / amax(gnew)
            out[k] = pk
    return torch.stack(out, dim=-4), hstack


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


def _prepare_scan_factor(cstack, xstack):
    """Backward semi-marginalisation in factor form, f64 throughout.

    cstack (..., d, r, n, r) — any leading batch dims (levels) — and
    xstack (d, n).  Carries the suffix Gram G_k (renormalised by its
    max) and emits B_k = C_k L_k with G_k = L_k L_k^T.  Returns
    (bstack (..., d, r, n, r), hstack (d, n))."""
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
        out[k] = b
    return torch.stack(out, dim=-4), hstack


class FactorPrep(NamedTuple):
    """Per-dimension operands of the 'hi' forward pass (one TT)."""

    bmat: torch.Tensor    # (d, r, n*r) f32, B_k unfolded
    cmat: torch.Tensor    # (d, n, r*r) f32, C_k unfolded
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


def prep_level(prep, j: int):
    """Level j of a prep whose fields carry a leading level axis."""
    return type(prep)(*(t[j].contiguous() for t in prep))


def _prep_factor(cstack, xstack) -> FactorPrep:
    """Backward preparation for precision 'hi'."""
    bstack, hstack = _prepare_scan_factor(cstack, xstack)
    *lead, d, r, n, _ = bstack.shape
    lead = tuple(lead)
    bmat = bstack.reshape(lead + (d, r, n * r))
    cmat = cstack.to(torch.float64).transpose(-3, -2).reshape(
        lead + (d, n, r * r))
    xs = xstack.to(torch.float64)
    x32 = xs.to(torch.float32)
    xlo = (xs - x32.to(torch.float64)).to(torch.float32)
    xg = torch.stack([x32, xlo], dim=1)
    hrow = hstack.to(torch.float32)[:, 1:]

    def per_level(t):
        return t.expand(lead + tuple(t.shape)).contiguous()

    return FactorPrep(bmat.to(torch.float32).contiguous(),
                      cmat.to(torch.float32).contiguous(),
                      per_level(xg), per_level(hrow))


def _prep_gram(cstack, xstack, precision, stable) -> GramPrep:
    """Backward preparation for 'f64', 'f32' and 'mixed': the whole
    pass runs in the contraction dtype, the grids and spacings are then
    carried in the CDF dtype (as the JAX package does)."""
    cdt, pdt, _ = _PRECISIONS[precision]
    cs = cstack.to(cdt)
    pstack, hstack = _prepare_scan(cs, xstack.to(cdt), stable=stable)
    *lead, d, r, n, _ = cs.shape
    lead = tuple(lead)

    def per_level(t):
        return t.expand(lead + tuple(t.shape)).contiguous()

    return GramPrep(pstack.reshape(lead + (d, r * r, n)).contiguous(),
                    cs.transpose(-3, -2).reshape(
                        lead + (d, n, r * r)).contiguous(),
                    per_level(xstack.to(pdt)), per_level(hstack.to(pdt)))


def _prep(cstack, xstack, precision: str = "hi", stable: bool = True):
    """Backward preparation: everything the forward pass needs except
    the seeds.  cstack may carry a leading level dimension; every field
    then carries it too (``prep_level`` picks one)."""
    check_precision(precision)
    if _family(precision) == "gram":
        return _prep_gram(cstack, xstack, precision, stable)
    return _prep_factor(cstack, xstack)


def _cdf_invert(mode, fk, xp, h, qp):
    """CDF build, bracket and in-cell quadratic solve in fk's dtype.

    TWO-SIDED: seeds past the median invert against the right-tail mass
    (a reversed cumsum of only-small terms), so the perturbation stays at
    eps * (local tail mass) in both tails.  fk (M, n) unnormalised,
    xp (n,) grid, h (n,) spacings with h[0] = 0, qp (M,) seeds (x values
    in 'rt' mode).  Returns (out, dlf, la, lb, i0)."""
    n = fk.shape[-1]
    dc = 0.5 * (fk[:, :-1] + fk[:, 1:]) * h[1:]
    total = torch.sum(dc, dim=-1, keepdim=True)
    # degenerate rows (no mass) fall back to the uniform density
    bad = total <= 0.0
    dc = torch.where(bad, (xp[1:] - xp[:-1]).expand_as(dc), dc)
    fk = torch.where(bad, torch.ones_like(fk), fk)
    total = torch.sum(dc, dim=-1, keepdim=True)
    dc = dc / total
    fk = fk / total
    zero = torch.zeros((fk.shape[0], 1), dtype=fk.dtype, device=fk.device)
    ck = torch.cat([zero, cumsum_rows(dc)], dim=1)
    cr = torch.cat([torch.flip(cumsum_rows(torch.flip(dc, [1])), [1]),
                    zero], dim=1)
    if mode == "rt":
        i0 = torch.sum(xp[None, :] < qp[:, None], dim=1) - 1
    else:
        right = qp > 0.5
        i0l = torch.sum(ck < qp[:, None], dim=1) - 1
        i0r = torch.sum(cr > (1.0 - qp)[:, None], dim=1) - 1
        i0 = torch.where(right, i0r, i0l)
    i0 = torch.clamp(i0, 0, n - 2)
    i1 = i0 + 1

    def read(rows, idx):
        return torch.gather(rows, 1, idx[:, None])[:, 0]

    c1 = read(ck, i0)
    cr2 = read(cr, i1)
    f1 = read(fk, i0)
    f2 = read(fk, i1)
    x1, x2 = xp[i0], xp[i1]
    if mode == "rt":
        xk = qp
        aq = 0.5 * (f2 - f1) / (x2 - x1)
        cl_ = aq * (xk - x1) ** 2 + f1 * (xk - x1) + c1
        yk = x2 - xk
        cr_ = 1.0 - (f2 * yk - aq * yk * yk + cr2)
        out = torch.where(cl_ > 0.5, cr_, cl_)
    else:
        xl_ = _invert_quadratic(f1, f2, c1, qp, x1, x2)
        xr_ = -_invert_quadratic(f2, f1, cr2, 1.0 - qp, -x2, -x1)
        xk = torch.where(right, xr_, xl_)
        out = xk
    la = (x2 - xk) / (x2 - x1)
    lb = (xk - x1) / (x2 - x1)
    dlf = torch.log(f1 * la + f2 * lb)
    return out, dlf, la, lb, i0


def _serve_solve(mode, out9, qp):
    """f64 epilogue: the within-cell quadratic inversion (or, in 'rt'
    mode, the CDF evaluation) and the per-dim log-density from the nine
    bracket scalars.  Returns (out, dlf), both f64."""
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
    return out, dlf


def _fwd_factor(mode, prep: FactorPrep, q, step=None):
    """'hi' forward pass over one block of rows: d dimension steps,
    then one batched f64 epilogue.  ``step`` defaults to the device's
    choice (ops/kernel_plan.py)."""
    d = prep.bmat.shape[0]
    r = prep.bmat.shape[1]
    mb = q.shape[0]
    q64 = q.to(torch.float64).T.contiguous()               # (d, mb)
    qp32 = q64.to(torch.float32)
    um32 = (1.0 - q64).to(torch.float32)
    phi = torch.zeros((mb, r), dtype=torch.float32, device=q.device)
    phi[:, 0] = 1.0
    if step is None:
        step = kernel_plan.dim_step
    kmode = "rt" if mode == "rt" else "irt"
    outs9 = torch.empty((d, mb, 9), dtype=torch.float32, device=q.device)
    for k in range(d):
        phi, outs9[k] = step(phi, qp32[k], um32[k], prep.bmat[k],
                             prep.cmat[k], prep.hrow[k], prep.xg[k],
                             mode=kmode)
    out, dlf = _serve_solve(mode, outs9.reshape(d * mb, 9),
                            q64.reshape(d * mb))
    lf = torch.sum(dlf.reshape(d, mb), dim=0)
    return out.reshape(d, mb).T, lf


def _fwd_gram(mode, prep: GramPrep, q, step=None):
    """Gram-family forward pass over one block of rows.  Per dimension:
    the conditional, ``_cdf_invert`` in the CDF dtype (at 'mixed' on fk
    clamped at 0, as the JAX package does before its f64 CDF; at 'f32'
    fk may come out slightly negative by cancellation and is left so),
    and the prefix update.  ``step`` is the pair (gram_conditional,
    condition_update) and defaults to the choice of ops/kernel_plan.py.
    Samples and log-density come back in the CDF dtype."""
    d, rr, n = prep.pmat.shape
    r = int(round(rr ** 0.5))
    cdt, pdt = prep.pmat.dtype, prep.xs.dtype
    mixed = cdt != pdt
    mb = q.shape[0]
    qs = q.to(pdt).T.contiguous()                          # (d, mb)
    gram, update = (step if step is not None
                    else kernel_plan.gram_step(cdt))
    phi = torch.zeros((mb, r), dtype=cdt, device=q.device)
    phi[:, 0] = 1.0
    lf = torch.zeros((mb,), dtype=pdt, device=q.device)
    outs = torch.empty((d, mb), dtype=pdt, device=q.device)
    for k in range(d):
        fk = gram(phi, prep.pmat[k])
        if mixed:
            fk = torch.clamp(fk, min=0.0)
        outs[k], dlf, la, lb, i0 = _cdf_invert(
            mode, fk.to(pdt), prep.xs[k], prep.hs[k], qs[k])
        lf = lf + dlf
        phi = update(phi, i0.to(torch.int32), la.to(cdt), lb.to(cdt),
                     prep.cmat[k])
    return outs.T, lf


def _fwd(mode, prep, q, step=None):
    """Forward pass over one block of rows for either family.  Returns
    (samples (M, d), lf (M,)).  ``step`` replaces the kernel-plan choice
    of the per-dimension functions; the chip smoke test passes the plain
    versions to compare on the card."""
    if isinstance(prep, GramPrep):
        return _fwd_gram(mode, prep, q, step)
    return _fwd_factor(mode, prep, q, step)


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


def _irt_scan_one(mode, cstack, xstack, q, precision="f64", stable=False):
    """One-shot transform of a single block of rows (for tests)."""
    return _fwd(mode, _prep(cstack, xstack, precision, stable), q)


def irt_scan(mode, cstack, xstack, q, block, precision="f64"):
    """Blocked scan transform, mode in {'sqr', 'rt'}: the backward
    preparation runs once (QR-stabilised for the Gram family), then the
    forward pass runs block by block."""
    if mode not in ("sqr", "rt"):
        raise NotImplementedError(
            f"mode {mode!r} is not ported to PyTorch yet (see ROADMAP.md)")
    prep = _prep(cstack, xstack, precision, stable=True)
    return fwd_blocked(mode, prep, q, block)
