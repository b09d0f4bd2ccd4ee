"""Tensor-train container and algebra (counterpart of
``tt_irt_tpu/ops/tt.py``).

A TT is a tuple of cores with shapes ``(r_{k-1}, n_k, r_k)``; boundary
ranks may exceed 1 (block tensors carry the block index in a boundary
rank).  The factorisations (QR and SVD of ``tt_from_dense``,
``tt_orthogonalize``, ``tt_round``, ``tt_permute``) run through
``torch.linalg`` in f64 on the TT's device and return cores in the
input's dtype; the JAX package runs them in host LAPACK.  QR and SVD
sign and gauge choices differ between LAPACK builds, so two packages'
results agree as tensors (``tt_full``, ``tt_dot``), not core by core;
``_chop_rank`` reads the singular values on the host, so equal singular
values give equal ranks.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from ..utils.device import resolve_device

__all__ = [
    "TT", "tt_full", "tt_from_dense", "tt_dot", "tt_norm", "tt_scale",
    "tt_add", "tt_hadamard", "tt_orthogonalize", "tt_round", "tt_rand",
    "tt_ones", "tt_meshgrid", "tkron", "tt_sum_modes", "tt_mean_field",
    "tt_reverse", "tt_partial_eval", "tt_permute", "tt_sum_many",
    "tt_eval_indices",
]


class TT:
    """Tensor train: tuple of torch cores ``(r_{k-1}, n_k, r_k)``."""

    __slots__ = ("cores",)

    def __init__(self, cores: Sequence[torch.Tensor]):
        self.cores = tuple(cores)

    @property
    def d(self) -> int:
        return len(self.cores)

    @property
    def n(self) -> tuple:
        return tuple(c.shape[1] for c in self.cores)

    @property
    def ranks(self) -> tuple:
        return (self.cores[0].shape[0],) + tuple(c.shape[2]
                                                 for c in self.cores)

    @property
    def dtype(self) -> torch.dtype:
        return self.cores[0].dtype

    @property
    def device(self) -> torch.device:
        return self.cores[0].device

    def to(self, device) -> "TT":
        return TT([c.to(device) for c in self.cores])

    def __repr__(self):
        return f"TT(d={self.d}, n={self.n}, ranks={self.ranks})"

    def __add__(self, other):
        return tt_add(self, other)

    def __mul__(self, alpha):
        return tt_scale(self, alpha)

    __rmul__ = __mul__

    def __neg__(self):
        return tt_scale(self, -1.0)

    def __sub__(self, other):
        return tt_add(self, tt_scale(other, -1.0))


def _f64(cores):
    return [c.to(torch.float64) for c in cores]


def _as(cores, like: TT) -> TT:
    return TT([c.to(like.dtype) for c in cores])


# ---- dense conversions ----

def tt_full(t: TT) -> torch.Tensor:
    """Contract a TT to a dense tensor of shape ``n`` (boundary ranks
    kept as leading/trailing axes where > 1)."""
    r0 = t.cores[0].shape[0]
    out = t.cores[0].reshape(r0 * t.cores[0].shape[1], -1)
    for c in t.cores[1:]:
        r1, n, r2 = c.shape
        out = (out @ c.reshape(r1, n * r2)).reshape(-1, r2)
    rd = t.cores[-1].shape[2]
    shape = t.n
    if r0 > 1:
        shape = (r0,) + shape
    if rd > 1:
        shape = shape + (rd,)
    return out.reshape(shape)


def _chop_rank(s, delta, rmax) -> int:
    """Smallest r whose truncated tail energy is <= delta (at least 1,
    at most rmax); s is read on the host."""
    s = (s.detach().cpu().numpy() if torch.is_tensor(s)
         else np.asarray(s))
    tails = np.sqrt(np.cumsum(s[::-1] ** 2))[::-1]  # tails[r] = ||s[r:]||
    keep = np.nonzero(tails > float(delta))[0]
    r = max(int(keep[-1]) + 1 if keep.size else 1, 1)
    if rmax is not None:
        r = min(r, int(rmax))
    return r


def tt_from_dense(a, eps: float = 0.0, rmax: int | None = None,
                  device="cuda") -> TT:
    """TT-SVD of a dense tensor or array (sequential truncated SVDs in
    f64) on ``device`` (default "cuda")."""
    a = torch.as_tensor(a, device=resolve_device(device))
    dtype = a.dtype
    a = a.to(torch.float64)
    n = tuple(a.shape)
    d = len(n)
    delta = eps / math.sqrt(max(d - 1, 1)) * float(torch.linalg.norm(
        a.reshape(-1)))
    cores = []
    r_prev = 1
    rest = a.reshape(n[0], -1)
    for k in range(d - 1):
        u, s, vt = torch.linalg.svd(rest, full_matrices=False)
        r = _chop_rank(s, delta, rmax)
        cores.append(u[:, :r].reshape(r_prev, n[k], r))
        r_prev = r
        rest = (s[:r, None] * vt[:r, :]).reshape(r_prev * n[k + 1], -1)
    cores.append(rest.reshape(r_prev, n[d - 1], 1))
    return TT([c.to(dtype) for c in cores])


# ---- algebra ----

def tt_dot(a: TT, b: TT) -> torch.Tensor:
    """Inner product <a, b> over the full grid (conjugate on ``a``)."""
    ra, rb = a.cores[0].shape[0], b.cores[0].shape[0]
    if ra != rb:
        raise ValueError("left boundary ranks must match")
    g = torch.eye(ra, dtype=a.dtype, device=a.device)
    for ca, cb in zip(a.cores, b.cores):
        g = torch.einsum("ab,aic,bid->cd", g, ca.conj(), cb)
    return g.squeeze()


def tt_norm(a: TT) -> torch.Tensor:
    return torch.sqrt(torch.abs(tt_dot(a, a)))


def tt_scale(a: TT, alpha) -> TT:
    cores = list(a.cores)
    cores[0] = cores[0] * alpha
    return TT(cores)


def tt_add(a: TT, b: TT) -> TT:
    """TT sum by block-diagonal core concatenation."""
    if a.n != b.n:
        raise ValueError(f"mode mismatch {a.n} vs {b.n}")
    d = a.d
    if d == 1:
        return TT([a.cores[0] + b.cores[0]])
    cores = []
    for k in range(d):
        ca, cb = a.cores[k], b.cores[k]
        ra1, n, ra2 = ca.shape
        rb1, _, rb2 = cb.shape
        if k == 0:
            if ra1 != rb1:
                raise ValueError("left boundary ranks must match")
            c = torch.cat([ca, cb], dim=2)
        elif k == d - 1:
            if ra2 != rb2:
                raise ValueError("right boundary ranks must match")
            c = torch.cat([ca, cb], dim=0)
        else:
            c = ca.new_zeros((ra1 + rb1, n, ra2 + rb2))
            c[:ra1, :, :ra2] = ca
            c[ra1:, :, ra2:] = cb
        cores.append(c)
    return TT(cores)


def tt_hadamard(a: TT, b: TT) -> TT:
    """Elementwise product: ranks multiply."""
    if a.n != b.n:
        raise ValueError("mode mismatch")
    cores = []
    for ca, cb in zip(a.cores, b.cores):
        c = torch.einsum("aib,cid->acibd", ca, cb)
        cores.append(c.reshape(ca.shape[0] * cb.shape[0], ca.shape[1],
                               ca.shape[2] * cb.shape[2]))
    return TT(cores)


def _orthogonalize64(cores, left: bool):
    """QR sweep over f64 cores (list, modified in place)."""
    d = len(cores)
    if left:
        for k in range(d - 1):
            r1, n, r2 = cores[k].shape
            q, rmat = torch.linalg.qr(cores[k].reshape(r1 * n, r2))
            cores[k] = q.reshape(r1, n, q.shape[1])
            cores[k + 1] = torch.einsum("ab,bic->aic", rmat, cores[k + 1])
    else:
        for k in range(d - 1, 0, -1):
            r1, n, r2 = cores[k].shape
            q, rmat = torch.linalg.qr(cores[k].reshape(r1, n * r2).T)
            cores[k] = q.T.reshape(q.shape[1], n, r2)
            cores[k - 1] = torch.einsum("aib,cb->aic", cores[k - 1], rmat)
    return cores


def tt_orthogonalize(a: TT, left: bool = True) -> TT:
    """QR-orthogonalise every core but the last (left=True) or the
    first."""
    return _as(_orthogonalize64(_f64(a.cores), left), a)


def tt_round(a: TT, eps: float = 0.0, rmax=None) -> TT:
    """TT rounding: right-orthogonalise, then left-to-right truncated
    SVDs to relative accuracy ``eps``.  ``rmax`` is a scalar or a
    per-bond sequence (d+1 entries, or the d-1 interior ones).  The
    log-norm is then spread evenly over the cores (a unit-product
    rescaling, an exact TT identity), so that no core carries the whole
    norm: on the sqrt-ratio levels of lz40n33 the last core would hold
    5e21, whose square overflows f32 in the reduced-precision samplers."""
    d = a.d
    if d == 1:
        return TT(list(a.cores))
    cores = _orthogonalize64(_f64(a.cores), left=False)
    nrm = float(torch.linalg.norm(cores[0].reshape(-1)))
    delta = float(eps) / math.sqrt(max(d - 1, 1)) * nrm
    if rmax is None or np.isscalar(rmax):
        rmax_vec = [rmax] * (d + 1)
    else:
        rmax_vec = list(rmax)
        if len(rmax_vec) == d - 1:
            rmax_vec = [None] + rmax_vec + [None]
    for k in range(d - 1):
        r1, n, r2 = cores[k].shape
        u, s, vt = torch.linalg.svd(cores[k].reshape(r1 * n, r2),
                                    full_matrices=False)
        r = _chop_rank(s, delta, rmax_vec[k + 1])
        cores[k] = u[:, :r].reshape(r1, n, r)
        cores[k + 1] = torch.einsum("ab,bic->aic", s[:r, None] * vt[:r, :],
                                    cores[k + 1])
    logn = np.array([math.log(max(float(torch.linalg.norm(c.reshape(-1))),
                                  1e-300)) for c in cores])
    shift = logn.mean() - logn
    shift -= shift.mean()
    return _as([c * math.exp(s) for c, s in zip(cores, shift)], a)


# ---- constructors ----

def _modes(n, d):
    return ([int(n)] * int(d) if np.isscalar(n) else [int(x) for x in n])


def tt_rand(n, d: int | None = None, r=2, generator=None,
            dtype=torch.float64, device="cuda") -> TT:
    """Random TT with mode sizes ``n`` and interior rank ``r`` (or a
    rank vector of d+1 entries), standard normal cores drawn from
    ``generator`` (on ``device``, default "cuda")."""
    device = resolve_device(device)
    n = _modes(n, d)
    d = len(n)
    ranks = ([1] + [int(r)] * (d - 1) + [1] if np.isscalar(r)
             else [int(x) for x in r])
    return TT([torch.randn((ranks[k], n[k], ranks[k + 1]),
                           generator=generator, dtype=dtype, device=device)
               for k in range(d)])


def tt_ones(n, d: int | None = None, dtype=torch.float64,
            device="cuda") -> TT:
    device = resolve_device(device)
    return TT([torch.ones((1, nk, 1), dtype=dtype, device=device)
               for nk in _modes(n, d)])


def tt_meshgrid(grids) -> list:
    """d rank-1 TTs; the i-th equals coordinate x_i on the product
    grid."""
    grids = [torch.as_tensor(g).reshape(-1) for g in grids]
    d = len(grids)
    return [TT([g.reshape(1, -1, 1) if k == i else
                torch.ones((1, g.shape[0], 1), dtype=grids[i].dtype,
                           device=g.device)
                for k, g in enumerate(grids)]) for i in range(d)]


def tkron(a: TT, b: TT) -> TT:
    """Mode concatenation: a's dimensions, then b's."""
    if a.cores[-1].shape[2] != 1 or b.cores[0].shape[0] != 1:
        raise ValueError("tkron requires unit inner boundary ranks")
    return TT(list(a.cores) + list(b.cores))


# ---- contractions ----

def tt_sum_modes(a: TT, weights: Sequence):
    """Contract the per-mode weight vectors (entries of ``weights`` that
    are not None) out of the TT; the remaining modes stay a TT.  A
    tensor when every mode is contracted."""
    if len(weights) != a.d:
        raise ValueError("need one weight (or None) per mode")
    cores = []
    carry = None
    for k in range(a.d):
        c = a.cores[k]
        if carry is not None:
            c = torch.einsum("ab,bic->aic", carry, c)
            carry = None
        w = weights[k]
        if w is None:
            cores.append(c)
        else:
            w = torch.as_tensor(w, dtype=c.dtype, device=c.device)
            carry = torch.einsum("aic,i->ac", c, w.reshape(-1))
    if carry is not None:
        if not cores:
            return carry.squeeze()
        cores.append(torch.einsum("aib,bc->aic", cores.pop(), carry))
    return TT(cores)


def tt_mean_field(a: TT, dim: int) -> torch.Tensor:
    """1-D marginal along ``dim``: every other mode summed."""
    weights = [torch.ones((nk,), dtype=a.dtype, device=a.device)
               for nk in a.n]
    weights[dim] = None
    return tt_full(tt_sum_modes(a, weights)).squeeze()


def tt_reverse(a: TT) -> TT:
    """The dimension order reversed (cores reversed, rank axes
    swapped)."""
    return TT([c.permute(2, 1, 0) for c in reversed(a.cores)])


def tt_partial_eval(a: TT, grids, dims, values):
    """Fix the coordinates ``dims`` at ``values`` (clipped to the grid)
    by linear interpolation of their cores, and contract the resulting
    matrices into the neighbouring kept cores.  Returns (sub_tt,
    sub_grids) over the remaining dimensions in their order; with every
    dimension fixed, a one-mode TT of size 1 holding the scalar."""
    d = a.d
    dims = [int(k) for k in dims]
    if len(set(dims)) != len(dims) or not all(0 <= k < d for k in dims):
        raise ValueError(f"dims must be distinct in 0..{d-1}: {dims}")
    if torch.is_tensor(values):
        values = values.detach().cpu().numpy()
    vals = {k: float(v) for k, v in zip(dims, np.asarray(values).ravel())}
    if len(vals) != len(dims):
        raise ValueError("one value per fixed dim required")

    def sub_mat(k):
        g = torch.as_tensor(grids[k]).reshape(-1).cpu().numpy()
        x = min(max(vals[k], float(g[0])), float(g[-1]))
        i0 = int(np.clip(np.searchsorted(g, x, side="right") - 1,
                         0, len(g) - 2))
        w = (x - g[i0]) / (g[i0 + 1] - g[i0])
        c = a.cores[k]
        return (1.0 - w) * c[:, i0, :] + w * c[:, i0 + 1, :]

    out_cores, out_grids = [], []
    pending = None
    for k in range(d):
        if k in vals:
            m = sub_mat(k)
            pending = m if pending is None else pending @ m
            continue
        c = a.cores[k]
        if pending is not None:
            c = torch.einsum("ab,bnc->anc", pending, c)
            pending = None
        out_cores.append(c)
        out_grids.append(grids[k])
    if pending is not None:
        if out_cores:
            out_cores[-1] = torch.einsum("anb,bc->anc", out_cores[-1],
                                         pending)
        else:
            out_cores = [pending.reshape(pending.shape[0], 1,
                                         pending.shape[1])]
            out_grids = [torch.zeros(1, dtype=a.dtype)]
    return TT(out_cores), out_grids


def tt_permute(a: TT, perm, eps: float = 0.0, rmax: int | None = None) -> TT:
    """Reorder the dimensions: result(i_{perm[0]}, ..., i_{perm[d-1]}).

    Adjacent transpositions by merged supercores re-split through
    truncated SVDs, in serpentine sweeps, each after a right
    orthogonalisation so that every local truncation is its global error
    contribution: total error <= eps |A| (eps / sqrt(#swaps) a swap);
    ``rmax`` caps every bond."""
    d = a.d
    perm = [int(p) for p in perm]
    if sorted(perm) != list(range(d)):
        raise ValueError(f"perm must be a permutation of 0..{d-1}: {perm}")
    if perm == list(range(d)):
        return TT(list(a.cores))
    want_pos = [0] * d
    for i, p in enumerate(perm):
        want_pos[p] = i
    order = list(range(d))
    nswaps = sum(1 for i in range(d) for j in range(i + 1, d)
                 if want_pos[order[i]] > want_pos[order[j]])
    cores = _f64(a.cores)
    delta = float(eps) * float(tt_norm(TT(cores))) / math.sqrt(
        max(nswaps, 1))
    while True:
        cores = _orthogonalize64(cores, left=False)
        swapped = False
        for k in range(d - 1):
            if want_pos[order[k]] <= want_pos[order[k + 1]]:
                if swapped or k == 0:
                    r1, n, r2 = cores[k].shape
                    q, rmat = torch.linalg.qr(cores[k].reshape(r1 * n, r2))
                    cores[k] = q.reshape(r1, n, q.shape[1])
                    cores[k + 1] = torch.einsum("ab,bic->aic", rmat,
                                                cores[k + 1])
                continue
            r1, n1, _ = cores[k].shape
            _, n2, r3 = cores[k + 1].shape
            sc = torch.einsum("aib,bjc->ajic", cores[k], cores[k + 1])
            u, s, vt = torch.linalg.svd(sc.reshape(r1 * n2, n1 * r3),
                                        full_matrices=False)
            r = _chop_rank(s, delta, rmax)
            cores[k] = u[:, :r].reshape(r1, n2, r)
            cores[k + 1] = (s[:r, None] * vt[:r, :]).reshape(r, n1, r3)
            order[k], order[k + 1] = order[k + 1], order[k]
            swapped = True
        if not swapped:
            break
    return _as(cores, a)


def tt_sum_many(tts: Sequence[TT], weights=None, eps: float = 1e-10,
                rmax: int | None = None) -> TT:
    """Rounded weighted sum of several TTs: a tree of block-diagonal adds
    with a rounding after each."""
    if weights is None:
        weights = [1.0] * len(tts)
    items = [tt_scale(t, w) for t, w in zip(tts, weights)]
    while len(items) > 1:
        nxt = [tt_round(tt_add(items[i], items[i + 1]), eps, rmax)
               for i in range(0, len(items) - 1, 2)]
        if len(items) % 2:
            nxt.append(items[-1])
        items = nxt
    return items[0]


def tt_eval_indices(t: TT, ind) -> torch.Tensor:
    """The TT at M multi-indices (M, d) -> (M,) values, or (M, b) for a
    right boundary rank b > 1."""
    ind = torch.as_tensor(ind, device=t.device).long()
    prefix = torch.ones((ind.shape[0], t.cores[0].shape[0]), dtype=t.dtype,
                        device=t.device)
    for k in range(t.d):
        prefix = torch.einsum("ma,amb->mb", prefix,
                              t.cores[k][:, ind[:, k], :])
    return prefix[:, 0] if prefix.shape[1] == 1 else prefix
