"""AMEn-enriched maxvol TT-cross interpolation (counterpart of
``tt_irt_tpu/constructors/amen_cross.py``).

Re-design of the reference's amen_cross_s (matlab/constructors/
amen_cross_s.m; algorithmic sources: Dolgov & Savostyanov SISC 36 (2014)
A2248; Dolgov, Khoromskij, Litvinenko, Matthies SIAM JUQ 3 (2015) 1109).

Split of the work:

* the sweep is sequential, data-dependent control flow (rank
  adaptation, pivot selection); it runs on the host over numpy state,
  as in the JAX package: QR / maxvol / localcross on (r*n x r) matrices
  are microseconds of host work, and the same numpy sweep in both
  packages gives the same cores on the same function values;
* every function-evaluation batch (the cost of the method: O(nswp d n
  r^2) evaluations, each possibly an ODE solve) is one vectorized call.
  A torch function receives it as a tensor on the cross's device
  (``torch_fun``); its output comes back to the host for the sweep;
* both input modes of the reference are kept: ``ifun(ind)`` over
  integer grid multi-indices (0-based) and ``ffun(x)`` elementwise over
  other TT tensors (amen_cross_s.m:14-20), plus the min/max statistics
  ('sr','lr','sm','lm','si','li').

Sweeps in alternating directions are realized by *reversing* the virtual
tensor between sweeps (cores transposed, index sets flipped), so a single
forward-sweep implementation serves both directions.

The JAX package's jit wrapping of the function and its power-of-two
padding of probe batches exist because XLA compiles per batch shape;
the port calls the function on each batch as it is.
"""

from __future__ import annotations

import contextlib
import functools
import math
import time as _time
from typing import NamedTuple

import numpy as np
import torch

from ..ops.maxvol import localcross, maxvol, trunc_svd
from ..ops.tt import TT
from ..parallel.mesh import sharded_batch_fn
from ..utils.device import resolve_device

__all__ = ["amen_cross_s", "CrossResult"]


class _Prof:
    """Stage-time accumulator for the sweep (enabled by ``profile=``).

    Stages are *disjoint* code regions, so sum(stages) ~ wall time minus
    untimed glue."""

    __slots__ = ("store",)

    def __init__(self, store: dict):
        self.store = store

    @contextlib.contextmanager
    def __call__(self, key: str):
        t0 = _time.perf_counter()
        try:
            yield
        finally:
            self.store[key] = (self.store.get(key, 0.0)
                               + _time.perf_counter() - t0)


class _NullProf:
    __slots__ = ()
    _null = contextlib.nullcontext()

    def __call__(self, key: str):
        return self._null


def _as_values(out) -> np.ndarray:
    """User-function output on the host as f64, or c128 when the target
    is complex-valued (the reference's cross inherits complex support
    from MATLAB; its si/li stats exist for that case).  A torch tensor,
    on any device, is copied to the host first (a forced sync)."""
    if torch.is_tensor(out):
        out = out.detach().cpu().numpy()
    out = np.asarray(out)
    # copy=False: the device->host copy above already made a fresh
    # buffer in the common case
    return out.astype(np.complex128 if np.iscomplexobj(out)
                      else np.float64, copy=False)


class _FunCall:
    """One user function and the kind of array each probe batch is
    handed to it as: a numpy array (``torch_fun`` False, as in the JAX
    package), or a torch tensor on ``device`` (True)."""

    __slots__ = ("f", "device", "torch")

    def __init__(self, f, torch_fun: bool, device):
        self.f = f
        self.device = device
        self.torch = bool(torch_fun)

    def __call__(self, arr: np.ndarray):
        if self.torch:
            return self.f(torch.from_numpy(np.ascontiguousarray(arr)).to(
                self.device))
        return self.f(arr)


def _tt_to_host(t: TT) -> list:
    return [c.detach().cpu().numpy() for c in t.cores]


class CrossResult(NamedTuple):
    tt: TT
    statvals: np.ndarray | None
    statind: np.ndarray | None
    indices: list | None          # nested left index sets (final sweep)
    evalcnt: tuple                # (index evals, elementwise evals)


# ---------------------------------------------------------------------------
# Layout helpers: all merged axes are little-endian (leftmost fastest),
# matching the index merge of the reference (amen_cross_s.m:763-786).
# ---------------------------------------------------------------------------

def _fold_left(mat, r1, n):
    return np.reshape(mat, (r1, n, -1), order="F")


def _merge_full(jl, n, jr, reverse=False):
    """Row-major enumeration of (left, mode, right) with left fastest:
    row = a + rl*(im + n*c).  Returns (rl*n*rr, d) actual index rows.

    ``reverse`` writes the columns in reversed order (backward-sweep
    actual orientation) in the same single pass instead of a strided
    flip afterwards.  Index dtype is int32: mode sizes are far below 2^31
    and the probe batches are copied to the device."""
    rl = jl.shape[0] if jl is not None and jl.size else 1
    rr = jr.shape[0] if jr is not None and jr.size else 1
    kl = 0 if jl is None else jl.shape[1]
    kr = 0 if jr is None else jr.shape[1]
    m = rl * n * rr
    k = kl + 1 + kr
    out = np.empty((m, k), dtype=np.int32)
    # Single-pass broadcast writes into the (rr, n, rl, cols) view of
    # the row enumeration a + rl*(im + n*c), without the intermediate
    # copies of a tile/repeat formulation.
    o3 = out.reshape(rr, n, rl, k)
    sl_l = slice(k - kl, k) if reverse else slice(0, kl)
    sl_r = slice(0, kr) if reverse else slice(kl + 1, k)
    i_m = kr if reverse else kl
    if kl:
        jlw = jl[:, ::-1] if reverse else jl
        o3[:, :, :, sl_l] = jlw[None, None, :, :]
    o3[:, :, :, i_m] = np.arange(n, dtype=np.int32)[None, :, None]
    if kr:
        jrw = jr[:, ::-1] if reverse else jr
        o3[:, :, :, sl_r] = jrw[:, None, None, :]
    return out


# ---------------------------------------------------------------------------
# Interface matrices for the elementwise-function mode
# ---------------------------------------------------------------------------

def _interfaces_indep_right(xcores_list, ind):
    """Right interface chains of each TT in ``xcores_list`` at independent
    multi-indices ``ind[:, i:]`` (ind is (nq, d)).  Returns list over bonds
    i=0..d of lists over tensors: (rx_i, nq) arrays for interior bonds and
    (rx_d, 1) at the right boundary (the right index set is empty there,
    matching YX{d+1}=eye of amen_cross_s.m:207)."""
    d = len(xcores_list[0])
    nx = len(xcores_list)
    nq = ind.shape[0]
    out = [[None] * nx for _ in range(d + 1)]
    for j in range(nx):
        out[d][j] = np.ones((1, 1))
        carry = np.ones((1, nq))               # per-sample chain
        for i in range(d - 1, -1, -1):
            core = xcores_list[j][i]           # (r1, n, r2)
            g = core[:, ind[:, i], :]          # (r1, nq, r2)
            carry = np.einsum("aqb,bq->aq", g, carry)
            out[i][j] = carry
    return out


def _interface_nested_left(yx_l, xcores_i, ind_rows):
    """One nested step of the left interfaces: new (rnew, rx_{i+1}) from
    (r_prev, rx_i) chains, gathering merged rows (left fastest)."""
    out = []
    for j in range(len(xcores_i)):
        core = xcores_i[j]                     # (rx1, n, rx2)
        t = np.einsum("pa,anb->pnb", yx_l[j], core)   # (r_prev, n, rx2)
        rp, n, rx2 = t.shape
        t = np.reshape(t, (rp * n, rx2), order="F")   # row = p + rp*im
        out.append(t[ind_rows])
    return out


def _eval_x_at(yx_l, yx_r, xcores_i):
    """Values of each TT x_j on the merged (left, mode, right) grid:
    returns (rl*n*rr, nx) with little-endian row ordering."""
    cols = []
    for j in range(len(xcores_i)):
        core = xcores_i[j]
        t = np.einsum("pa,anb->pnb", yx_l[j], core)    # (rl, n, rx2)
        v = np.einsum("pnb,bq->pnq", t, yx_r[j])       # (rl, n, rr)
        cols.append(np.reshape(v, (-1,), order="F"))
    return np.stack(cols, axis=1)


# ---------------------------------------------------------------------------
# State reversal between sweeps
# ---------------------------------------------------------------------------

def _rev_cores(cores):
    """Reverse the virtual tensor: cores in reverse order with bond axes
    swapped.  A trailing block axis (4-dim cores) stays in place."""
    out = []
    for c in reversed(cores):
        if c is None:
            out.append(None)
        elif c.ndim == 4:
            out.append(np.transpose(c, (2, 1, 0, 3)))
        else:
            out.append(np.transpose(c, (2, 1, 0)))
    return out


def _rev_sets(left_sets, right_sets):
    """Swap left/right nested index sets, flipping column order so that
    columns always follow the *virtual* dim order."""
    d = len(left_sets) - 1
    new_left = [None] * (d + 1)
    new_right = [None] * (d + 1)
    for i in range(d + 1):
        js = right_sets[d - i]
        new_left[i] = None if js is None else js[:, ::-1]
        jl = left_sets[d - i]
        new_right[i] = None if jl is None else jl[:, ::-1]
    return new_left, new_right


def _rev_interfaces(lfs, rfs):
    d = len(lfs) - 1
    new_l = [None] * (d + 1)
    new_r = [None] * (d + 1)
    for i in range(d + 1):
        if rfs[d - i] is not None:
            new_l[i] = [m.T for m in rfs[d - i]]
        if lfs[d - i] is not None:
            new_r[i] = [m.T for m in lfs[d - i]]
    return new_l, new_r


def _rev_mats(lm, rm):
    d = len(lm) - 1
    nl = [None if rm[d - i] is None else rm[d - i].T for i in range(d + 1)]
    nr = [None if lm[d - i] is None else lm[d - i].T for i in range(d + 1)]
    return nl, nr


# ---------------------------------------------------------------------------
# The cross
# ---------------------------------------------------------------------------

def amen_cross_s(inp, fun, tol, *, y0=4, nswp=20, stop_sweep=0, kickrank=4,
                 verb=0, vec=True, tol_exit=None, exitdir=0, dir=1,
                 auxinp=None, auxfun=None, stats=(), seed=0,
                 rmax=None, mesh=None, torch_fun=False,
                 trunc="svd", profile=None, device="cuda") -> CrossResult:
    """Block TT-cross with AMEn residual enrichment and maxvol pivoting.

    Args:
      inp: either a sequence of mode sizes ``n`` (then ``fun(ind)`` maps
        0-based integer multi-indices (M, d) -> (M,) values), or a list of
        TT tensors (then ``fun(x)`` maps their stacked elementwise values
        (M, nx) -> (M,)).
      fun: the target function (vectorized unless ``vec=False``); a numpy
        or a torch function (``torch_fun``).  It may return (M, b)
        values: a block cross, whose b columns land in a boundary rank.
      tol: localcross truncation tolerance (0 -> plain QR truncation).
      y0: initial guess — int (that many random warm-up indices), an
        (M, d) 0-based index array, or a TT tensor.
      kickrank: enrichment rank (int), or a fraction of the solution rank.
      tol_exit: sweep-convergence threshold (defaults to ``tol``).
      exitdir: +1/-1 to require exit after a forward/backward sweep.
      stats: iterable from {'sr','lr','sm','lm','si','li'} — min/max value
        tracking of the *sampled exact* function (amen_cross_s.m:51-56).
      rmax: optional hard rank cap.
      mesh: optional ``parallel.sample_mesh`` — every probe batch is
        evaluated with its sample axis sharded over the mesh
        (``sharded_batch_fn``): each shard is handed to ``fun`` as a
        torch tensor on its device (as ``torch_fun=True`` does), so
        ``fun`` must be vectorized (``vec=False`` raises).  A rowwise
        ``fun`` gives the single-device build (``torch_fun=True``) bit
        for bit.
      torch_fun: how each probe batch is handed to ``fun``: True, a
        torch tensor on ``device`` (int32 indices, or the stacked f64
        values); False (default), a numpy array.  Outputs on any device
        come back to the host for the sweep.
      trunc: block truncation, 'svd' (QR + small SVD) or 'cross'
        (full-pivot localcross, the reference's choice).
      profile: optional dict — filled with disjoint per-stage wall
        times ('eval_fun': the function on its batch, the copies to and
        from the device included; 'eval_merge': the host merge of the
        index sets; 'qrmaxvol', 'truncate', 'enrich', 'dx', 'push',
        'index', 'zupdate', 'reverse').
      device: where a torch ``fun`` gets its batches and where the result
        TT is put (default "cuda").

    Returns CrossResult(tt, statvals, statind, indices, evalcnt).
    """
    dev = resolve_device(device)
    prof = _Prof(profile) if profile is not None else _NullProf()
    rng = np.random.default_rng(seed)
    tol_exit = tol if tol_exit is None else tol_exit

    # ---- input modes ----
    ifun = ffun = None
    xtts = None
    if isinstance(inp, (list, tuple)) and len(inp) and isinstance(inp[0], TT):
        xtts = list(inp)
        ffun = fun
    else:
        n_modes = np.asarray(inp, dtype=np.int64).reshape(-1)
        ifun = fun
    if auxinp is not None and auxfun is not None:
        if isinstance(auxinp, (list, tuple)) and isinstance(auxinp[0], TT):
            if ffun is not None:
                raise ValueError("elementwise fun given twice")
            xtts, ffun = list(auxinp), auxfun
        else:
            if ifun is not None:
                raise ValueError("index fun given twice")
            n_modes, ifun = np.asarray(auxinp, np.int64).reshape(-1), auxfun

    if xtts is not None:
        n_modes = np.asarray(xtts[0].n, dtype=np.int64)
        xcores = [_tt_to_host(t) for t in xtts]
        for t in xtts:
            if t.cores[0].shape[0] != 1 or t.cores[-1].shape[2] != 1:
                raise NotImplementedError(
                    "elementwise-mode TTs must have unit boundary ranks")
    else:
        xcores = None

    d = int(n_modes.shape[0])
    n = [int(v) for v in n_modes]
    tol_local = tol / math.sqrt(d)
    soughts = [s.lower() for s in stats]
    # Block truncation backend: 'svd' (QR + small SVD, rank-optimal at
    # the same tolerance) or 'cross' (greedy full-pivot localcross, the
    # reference's truncate_block choice, amen_cross_s.m:594).  Stat
    # tracking ('sr'/'lr'/...) forces the full-pivot backend: its greedy
    # pivots probe the value-extreme entries the min/max statistics are
    # computed from, which an SVD/leverage basis has no reason to visit.
    _trunc = localcross if (trunc == "cross" or soughts) else trunc_svd

    if not callable(vec) and not vec:
        if mesh is not None:
            raise ValueError("mesh sharding requires a vectorized fun; "
                             "vec=False given")
        base_ifun, base_ffun = ifun, ffun
        if base_ifun is not None:
            ifun = lambda J: np.stack([_as_values(  # noqa: E731
                base_ifun(J[k:k + 1])).reshape(-1)[0]
                for k in range(J.shape[0])])
        if base_ffun is not None:
            ffun = lambda V: np.stack([_as_values(  # noqa: E731
                base_ffun(V[k:k + 1])).reshape(-1)[0]
                for k in range(V.shape[0])])
    wrap = (functools.partial(_FunCall, torch_fun=torch_fun, device=dev)
            if mesh is None else functools.partial(sharded_batch_fn, mesh))
    if ifun is not None:
        ifun = wrap(ifun)
    if ffun is not None:
        ffun = wrap(ffun)

    evalcnt = [0, 0]

    def evaluate(jl, jr, yx_l, yx_r, i):
        """fun at the merged (left, mode, right) grid -> (m, b) values
        (b > 1 = block/vector-valued cross, amen_cross_s.m:426-428: the
        block index ends up in a boundary rank of the result)."""
        rl = 1 if jl is None or not jl.size else jl.shape[0]
        rr = 1 if jr is None or not jr.size else jr.shape[0]
        m = rl * n[i] * rr
        vals = None
        if ifun is not None:
            with prof("eval_merge"):
                j_actual = _merge_full(jl, n[i], jr, reverse=(orient < 0))
            with prof("eval_fun"):
                vals = _as_values(ifun(j_actual)).reshape(m, -1)
            evalcnt[0] += m
        if ffun is not None:
            with prof("eval_merge"):
                fx = _eval_x_at(yx_l[i], yx_r[i + 1], xcur_i(i))
            with prof("eval_fun"):
                fv = _as_values(ffun(fx)).reshape(m, -1)
            evalcnt[1] += m
            vals = fv if vals is None else vals + fv
        return vals

    # ---- initial index sets (right-nested, ready for a forward sweep) ----
    orient = 1 if dir >= 0 else -1
    ycores: list = [None] * d
    jy_l: list = [None] * (d + 1)
    jy_r: list = [None] * (d + 1)
    yx_l: list = [None] * (d + 1)
    yx_r: list = [None] * (d + 1)
    jy_l[0] = np.zeros((1, 0), np.int64)
    jy_r[d] = np.zeros((1, 0), np.int64)

    def xcur_i(i):
        """Cores of all elementwise-input TTs at (virtual) dim i."""
        return [t[i] for t in xcur]

    xcur = xcores
    if orient < 0 and xcur is not None:
        xcur = [_rev_cores(t) for t in xcur]
    n_virt = n if orient > 0 else n[::-1]
    n = n_virt

    if isinstance(y0, TT):
        ry = [1] * (d + 1)
        yc = _tt_to_host(y0)
        if orient < 0:
            yc = _rev_cores(yc)
        # Right-to-left per-core QR + maxvol warm-up.  Deliberately NOT
        # carrying the bond factor: a chain-exact nested maxvol of the
        # (low-numerical-rank) initial guess clusters the interpolation
        # points on the guess's own structure and starves single-sweep
        # kickrank=0 crosses of diversity on *changed* targets — DIRT
        # level builds measurably degrade (predator-prey N/ESS 2 -> 400
        # in A/B runs).  Per-core indices are exact enough to warm-start
        # (cross-from-own-TT still reconstructs to ~1e-3) while staying
        # spread out; the first computing sweep re-evaluates everything.
        for i in range(d - 1, 0, -1):
            r1, nn, r2 = yc[i].shape
            mat = np.reshape(np.transpose(yc[i], (1, 2, 0)),
                             (nn * r2, r1), order="F")
            q, _ = np.linalg.qr(mat)
            ind = maxvol(q)
            rnew = q.shape[1]
            jr = jy_r[i + 1] if jy_r[i + 1] is not None else \
                np.zeros((1, 0), np.int64)
            merged = np.concatenate(
                [np.tile(np.arange(nn, dtype=np.int64)[:, None],
                         (max(jr.shape[0], 1), 1)),
                 np.repeat(jr, nn, axis=0)], axis=1)
            jy_r[i] = merged[ind]
            ry[i] = rnew
            yc[i] = np.transpose(
                np.reshape(q[:, :rnew], (nn, r2, rnew), order="F"),
                (2, 0, 1))
        # normalize to the sweep's internal 4-dim (trailing block) layout
        ycores = [c[..., None] for c in yc]
    else:
        if np.isscalar(y0):
            nq = int(y0)
            ind = np.stack([rng.integers(0, nk, nq) for nk in n], axis=1)
        else:
            ind = np.asarray(y0, dtype=np.int64)
            if orient < 0:
                ind = ind[:, ::-1]
            nq = ind.shape[0]
        for i in range(1, d):
            jy_r[i] = ind[:, i:]
        ry = [1] + [nq] * (d - 1) + [1]

    if xcur is not None:
        if isinstance(y0, TT):
            raise NotImplementedError(
                "TT initial guess with elementwise input: pass index "
                "array or integer y0 instead")
        rights = _interfaces_indep_right(xcur, ind)
        for i in range(d + 1):
            yx_r[i] = rights[i]
        yx_l[0] = [np.ones((1, t[0].shape[0])) for t in xcur]
    if yx_l[0] is None and xcur is not None:
        yx_l[0] = [np.ones((1, t[0].shape[0])) for t in xcur]

    # ---- residual (AMEn) state ----
    use_kick = (np.ndim(kickrank) == 0 and kickrank) or np.any(kickrank)
    kick_is_frac = (np.isscalar(kickrank)
                    and not float(kickrank).is_integer())

    def _kick_rank(ry_next):
        if kick_is_frac:
            return max(1, int(math.ceil(kickrank * ry_next)))
        return int(kickrank)

    jz_l: list = [None] * (d + 1)
    jz_r: list = [None] * (d + 1)
    zx_l: list = [None] * (d + 1)
    zx_r: list = [None] * (d + 1)
    zy_l: list = [None] * (d + 1)
    zy_r: list = [None] * (d + 1)
    rz = [1] * (d + 1)
    if use_kick:
        rz0 = _kick_rank(max(ry))
        indz = np.stack([rng.integers(0, nk, rz0) for nk in n], axis=1)
        jz_l[0] = np.zeros((1, 0), np.int64)
        jz_r[d] = np.zeros((1, 0), np.int64)
        for i in range(1, d):
            jz_r[i] = indz[:, i:]
        rz = [1] + [rz0] * (d - 1) + [1]
        zy_l[0] = np.ones((1, 1))
        zy_r[d] = np.ones((1, 1))
        for i in range(1, d):
            zy_r[i] = rng.standard_normal((ry[i], rz[i]))
        if xcur is not None:
            zrights = _interfaces_indep_right(xcur, indz)
            for i in range(d + 1):
                zx_r[i] = zrights[i]
            zx_l[0] = [np.ones((1, t[0].shape[0])) for t in xcur]

    # ---- sweep loop ----
    # b = block size (vector-valued fun, amen_cross_s.m:426-428,575-579):
    # discovered at the first evaluation; the block axis rides on the
    # active core as a trailing dim, is mixed into the bond factor at
    # every truncation, and lands in the final core's boundary rank.
    b = 1
    statvals = statind = None
    swp = 1
    last_swp = 0
    max_dx = 0.0
    done = False
    while swp <= nswp and not done:
        max_dx = 0.0
        for i in range(d):
            if i == 0 and swp > 1 and ycores[0] is not None and \
                    ycores[0].shape[:3] == (ry[0], n[0], ry[1]):
                # The terminal core of the previous sweep is exact — reuse
                # it instead of re-evaluating (amen_cross_s.m:406-411).
                cry = np.reshape(ycores[0], (-1, b), order="F")
            else:
                cry = evaluate(jy_l[i], jy_r[i + 1], yx_l, yx_r, i)
            m = ry[i] * n[i] * ry[i + 1]
            if swp == 1 and i == 0:
                b = cry.shape[1]
            if cry.shape[0] != m or cry.shape[1] != b:
                raise ValueError(
                    f"function returned {cry.shape} values, expected "
                    f"({m}, {b})")
            if statvals is None:
                statvals = np.full((len(soughts), b), np.nan,
                                   dtype=cry.dtype)
                statind = np.zeros((len(soughts), d, b), np.int64)

            # statistics tracking on exact sampled values (per block col)
            if soughts:
                j_virtual = _merge_full(jy_l[i], n[i], jy_r[i + 1])
                j_actual = j_virtual[:, ::-1] if orient < 0 else j_virtual
                for si, s in enumerate(soughts):
                    key = {"lm": np.abs, "sm": np.abs, "lr": np.real,
                           "sr": np.real, "li": np.imag, "si": np.imag}[s]
                    vals = key(cry)                       # (m, b)
                    picks = (np.argmax(vals, axis=0)
                             if s in ("lm", "lr", "li")
                             else np.argmin(vals, axis=0))
                    for col in range(b):
                        pick = int(picks[col])
                        cur = statvals[si, col]
                        better = (np.isnan(cur)
                                  or (s in ("lm", "lr", "li")
                                      and vals[pick, col] > key(cur))
                                  or (s in ("sm", "sr", "si")
                                      and vals[pick, col] < key(cur)))
                        if better:
                            statvals[si, col] = cry[pick, col]
                            statind[si, :, col] = j_actual[pick]

            with prof("dx"):
                old = ycores[i]
                if old is not None and old.size == m * b:
                    denom = np.max(np.abs(cry))
                    dx = np.max(np.abs(cry.ravel(order="F")
                                       - old.ravel(order="F"))) \
                        / (denom if denom > 0 else 1.0)
                else:
                    dx = 1.0
                max_dx = max(max_dx, dx)
                core = np.reshape(cry, (ry[i], n[i], ry[i + 1], b),
                                  order="F")
                ycores[i] = core

            if i == d - 1:
                break

            # --- truncation of the current block ---
            # unfold (r1*n, r2*b): the block axis joins the bond being
            # truncated, exactly as truncate_block (amen_cross_s.m:588-611)
            with prof("truncate"):
                mat = np.reshape(core, (ry[i] * n[i], ry[i + 1] * b),
                                 order="F")
                if tol_local > 0:
                    u, v = _trunc(mat, tol_local, rmax=rmax)
                else:
                    u, v = np.linalg.qr(mat)
                if rmax is not None and u.shape[1] > rmax:
                    u, v = u[:, :rmax], v[:rmax]
                y_trunc = np.reshape(u @ v, (ry[i], n[i], ry[i + 1], b),
                                     order="F")

            # --- AMEn enrichment ---
            crs = None
            if use_kick:
                # candidate: truncated solution projected on right residual
                rzr = jz_r[i + 1].shape[0]
                with prof("enrich"):
                    crs_full = np.einsum("ancb,cz->anzb", y_trunc,
                                         zy_r[i + 1])
                crzex = evaluate(jy_l[i], jz_r[i + 1], yx_l, zx_r, i)
                with prof("enrich"):
                    crzex = np.reshape(crzex, (ry[i], n[i], rzr, b),
                                       order="F")
                    crs = np.reshape(crzex - crs_full,
                                     (ry[i] * n[i], rzr * b), order="F")
                    crs = _truncres(crs, _kick_rank(ry[i + 1]), tol_local,
                                    rng, expand=False, trunc=_trunc)

            # --- enrich, QR, maxvol, interface update ---
            with prof("qrmaxvol"):
                if crs is None:
                    q, rv = u, v          # u already has orthonormal cols
                else:
                    q, rq = np.linalg.qr(np.concatenate([u, crs], axis=1))
                    rv = rq[:, :u.shape[1]] @ v           # (rnew, r2*b)
                ind = maxvol(q)
                yy = q[ind]
                try:
                    qn = np.linalg.solve(yy.T, q.T).T     # q @ inv(yy)
                except np.linalg.LinAlgError:
                    # degenerate block (e.g. the function underflowed to 0
                    # on this probe set): least-squares interpolation keeps
                    # the sweep alive (cf. the reference's zero-residual
                    # reinit, amen_cross_s.m:890-894)
                    qn = q @ np.linalg.pinv(yy)
                rnew = q.shape[1]
                ycores[i] = _fold_left(qn, ry[i], n[i])[..., None]
                rv = yy @ rv                              # (rnew, r2*b)
            r2_old = ry[i + 1]
            ry[i + 1] = rnew
            # push non-orth factor into the next (stale) core if it
            # exists, transporting the block axis with it
            # (amen_cross_s.m:598-611: rv (rnew, r2*b) -> (b*rnew, r2))
            with prof("push"):
                if ycores[i + 1] is not None:
                    rvb = np.reshape(rv, (rnew * r2_old, b), order="F")
                    rvb = np.reshape(rvb.T, (b * rnew, r2_old), order="F")
                    nxt = ycores[i + 1]                   # (r2, n2, r3, bn)
                    n2, r3 = nxt.shape[1], nxt.shape[2]
                    nxt2 = np.reshape(nxt[..., 0], (r2_old, n2 * r3),
                                      order="F")
                    t = rvb @ nxt2                        # (b*rnew, n2*r3)
                    t = np.reshape(t, (b, rnew * n2 * r3), order="F")
                    ycores[i + 1] = np.reshape(t.T, (rnew, n2, r3, b),
                                               order="F")
            with prof("index"):
                jy_l[i + 1] = _merge_full(jy_l[i], n[i],
                                          np.zeros((1, 0), np.int64))[ind]
                if xcur is not None:
                    yx_l[i + 1] = _interface_nested_left(
                        yx_l[i], xcur_i(i), ind)

            # --- residual update ---
            if use_kick:
                rzl = jz_l[i].shape[0]
                rzr = jz_r[i + 1].shape[0]
                crzz = evaluate(jz_l[i], jz_r[i + 1], zx_l, zx_r, i)
                with prof("zupdate"):
                    crzz = np.reshape(crzz, (rzl, n[i], rzr, b), order="F")
                    proj = np.einsum("za,ancb,cw->znwb", zy_l[i], y_trunc,
                                     zy_r[i + 1])
                    crz = np.reshape(crzz - proj,
                                     (rzl * n[i], rzr * b), order="F")
                    crz = _truncres(crz, _kick_rank(ry[i + 1]), tol_local,
                                    rng, expand=True, trunc=_trunc)
                    indz = maxvol(crz)
                    rz[i + 1] = len(indz)
                    jz_l[i + 1] = _merge_full(jz_l[i], n[i],
                                              np.zeros((1, 0),
                                                       np.int64))[indz]
                    if xcur is not None:
                        zx_l[i + 1] = _interface_nested_left(
                            zx_l[i], xcur_i(i), indz)
                    tzy = np.einsum("za,anb->znb", zy_l[i],
                                    ycores[i][..., 0])
                    tzy = np.reshape(tzy, (rz[i] * n[i], rnew), order="F")
                    zy_l[i + 1] = tzy[indz]

        if verb > 0:
            print(f"=amen_cross= swp={swp} (orient {orient:+d}), "
                  f"max_dx={max_dx:.3e}, max_rank={max(ry)}, "
                  f"evals={tuple(evalcnt)}")
        if max_dx < tol_exit:
            last_swp += 1
        if (last_swp > stop_sweep or swp >= nswp) and \
                (exitdir == 0 or orient == exitdir):
            done = True
            break

        # reverse everything for the next sweep
        with prof("reverse"):
            ycores = _rev_cores(ycores)
            if xcur is not None:
                xcur = [_rev_cores(t) for t in xcur]
            jy_l, jy_r = _rev_sets(jy_l, jy_r)
            jz_l, jz_r = _rev_sets(jz_l, jz_r)
            yx_l, yx_r = _rev_interfaces(yx_l, yx_r)
            zx_l, zx_r = _rev_interfaces(zx_l, zx_r)
            zy_l, zy_r = _rev_mats(zy_l, zy_r)
        ry = ry[::-1]
        rz = rz[::-1]
        n = n[::-1]
        orient = -orient
        swp += 1

    # collapse the internal 4-dim layout: all swept cores carry a trailing
    # block axis of 1; the terminal core carries the b block columns in
    # its (virtual right) boundary rank (amen_cross_s.m:575-579)
    final = [c[..., 0] for c in ycores[:-1]]
    last = ycores[-1]                              # (r, n, 1, b)
    final.append(np.reshape(last, (last.shape[0], last.shape[1], -1),
                            order="F"))
    ycores = final

    # restore original orientation (a backward exit sweep leaves the
    # block in the LEFT boundary rank of the first core, matching the
    # reference's dir<0 output, amen_cross_s.m:576-578)
    if orient < 0:
        ycores = _rev_cores(ycores)
        jy_l, jy_r = _rev_sets(jy_l, jy_r)
        n = n[::-1]
        orient = 1

    tt = TT([torch.tensor(np.ascontiguousarray(c), device=dev)
             for c in ycores])
    sv = None
    si_ = None
    if soughts and statvals is not None:
        sv = statvals[:, 0] if b == 1 else statvals
        si_ = statind[:, :, 0] if b == 1 else statind
    return CrossResult(tt, sv, si_, jy_l, (evalcnt[0], evalcnt[1]))


def _truncres(crz, new_rank, tol_local, rng, expand, trunc=localcross):
    """Truncate/expand a residual block (amen_cross_s.m:878-911)."""
    nrm = np.linalg.norm(crz)
    if nrm == 0.0:
        crz = rng.standard_normal(crz.shape)
    else:
        crz = crz / nrm
    if crz.shape[1] > new_rank:
        u, _ = trunc(crz, tol_local)
        crz = u[:, :min(u.shape[1], new_rank)]
    elif expand and crz.shape[1] < new_rank:
        pad = rng.standard_normal((crz.shape[0], new_rank - crz.shape[1]))
        crz, _ = np.linalg.qr(np.concatenate([crz, pad], axis=1))
    return crz
