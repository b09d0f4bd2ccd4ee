"""Pivot-selection routines of the cross constructors (counterpart of
``tt_irt_tpu/ops/maxvol.py``, kept line for line so that both packages
pick the same pivots on the same arrays): ``maxvol``, ``maxvol_rect``,
``trunc_svd`` and ``localcross``.

These are sequential pivoting algorithms on small matrices (rows <=
r*n, a few hundred; columns <= the largest rank, tens of them).  They
run on the host in numpy/LAPACK, inside the host-driven sweeps of the
constructors: a data-dependent pivot loop on a 50x13 matrix would be a
chain of tiny device launches.  The batched work (the function
evaluations of each probe batch) runs on the device.
"""

from __future__ import annotations

import numpy as np

try:
    from scipy.linalg import lu_factor as _lu_factor
except Exception:  # pragma: no cover — scipy is optional
    _lu_factor = None

__all__ = ["maxvol", "maxvol_rect", "localcross", "trunc_svd"]


def _as_floating(a) -> np.ndarray:
    """f64 for real input, c128 preserved for complex input (the
    reference's pivot kernels inherit complex support from MATLAB;
    tracemult.c:29-42 carries complex through the samplers' primitive)."""
    a = np.asarray(a)
    return a.astype(np.complex128 if np.iscomplexobj(a) else np.float64)


def maxvol(a, tol: float = 1.05, max_iters: int = 200) -> np.ndarray:
    """Quasi-maximum-volume square submatrix row selection.

    For a tall n x r matrix (n >= r) returns r row indices such that the
    submatrix A[ind] has locally maximal |det|.  Classic Goreinov et al.
    swap algorithm: start from LU pivot rows, then swap while any element
    of A @ inv(A[ind]) exceeds ``tol`` in modulus.
    """
    a = _as_floating(a)
    n, r = a.shape
    if n <= r:
        return np.arange(n)
    # Initial rows from Gaussian elimination with row pivoting on `a`
    p = _lu_row_pivots(a)
    ind = p[:r].copy()
    sub = a[ind]
    # b = a @ inv(sub) as one GEMM (the r x r inverse is trivial; the
    # transposed triangular-solve formulation was ~4x slower at the
    # cross's (r*n, r) shapes on one core)
    try:
        b = a @ np.linalg.inv(sub)
    except np.linalg.LinAlgError:
        sub = sub + 1e-14 * np.eye(r)
        b = a @ np.linalg.inv(sub)
    absb = np.empty(b.shape, dtype=np.float64)
    for _ in range(max_iters):
        np.abs(b, out=absb) if not np.iscomplexobj(b) else \
            np.copyto(absb, np.abs(b))
        flat = np.argmax(absb)
        i, j = np.unravel_index(flat, b.shape)
        if absb[i, j] <= tol:
            break
        # Swap row ind[j] -> i ; rank-1 update of b
        bj = b[:, j].copy()
        bi = b[i, :].copy()
        bi[j] -= 1.0
        b -= np.outer(bj, bi) / b[i, j]  # complex-safe: plain products
        ind[j] = i
    return np.sort(ind)


def _lu_row_pivots(a: np.ndarray) -> np.ndarray:
    """Row ordering from Gaussian elimination with row pivoting on a tall
    matrix (returns permutation of all n rows; first r are the pivots).

    One LAPACK getrf call when scipy is present (the Python elimination
    loop was ~20% of the d=50 header cross build); the loop stays as the
    no-scipy fallback."""
    n, r = a.shape
    if _lu_factor is not None:
        _, piv = _lu_factor(a.copy(), check_finite=False)
        perm = np.arange(n)
        for k, p in enumerate(piv[:r]):   # LAPACK ipiv -> permutation
            if p != k:
                perm[k], perm[p] = perm[p], perm[k]
        return perm
    a = a.copy()
    perm = np.arange(n)
    for k in range(r):
        p = k + int(np.argmax(np.abs(a[k:, k])))
        if p != k:
            a[[k, p]] = a[[p, k]]
            perm[[k, p]] = perm[[p, k]]
        piv = a[k, k]
        if piv == 0.0:
            continue
        a[k + 1:, k] /= piv
        a[k + 1:, k + 1:] -= np.outer(a[k + 1:, k], a[k, k + 1:])
    return perm


def maxvol_rect(a, kmax: int | None = None, tol: float = 1.10) -> np.ndarray:
    """Greedy rectangular maxvol: extend the square maxvol set with extra
    rows of largest residual leverage, up to ``kmax`` rows total."""
    a = _as_floating(a)
    n, r = a.shape
    ind = list(maxvol(a, tol=min(tol, 1.05)))
    if kmax is None or kmax <= r or n <= r:
        return np.asarray(ind)
    kmax = min(kmax, n)
    sub = a[ind]
    b = np.linalg.solve(sub.conj().T @ sub + 1e-14 * np.eye(r),
                        sub.conj().T @ a.T).T
    lev = np.sum(np.abs(b) ** 2, axis=1)
    lev[ind] = -np.inf
    while len(ind) < kmax:
        i = int(np.argmax(lev))
        if lev[i] <= tol - 1.0:
            break
        ind.append(i)
        lev[i] = -np.inf
    return np.sort(np.asarray(ind))


def trunc_svd(y, tol: float, rmax: int | None = None):
    """Rank-revealing truncation ``y ~= u @ v`` via QR + small SVD.

    Same contract as :func:`localcross` (u orthonormal), but one LAPACK
    QR of the tall matrix plus an SVD of the small R factor instead of
    the greedy full-pivot Python loop — 6x faster at the cross's block
    shapes on one core, and rank-optimal at the same tolerance (the
    discarded tail has Frobenius norm <= tol * ||y||_F).
    """
    y = _as_floating(y)
    m, n = y.shape
    if m >= n:
        q, r = np.linalg.qr(y)
        u2, s, vt = np.linalg.svd(r, full_matrices=False)
    else:
        q = None
        u2, s, vt = np.linalg.svd(y, full_matrices=False)
    if s[0] == 0.0:
        u = np.zeros((m, 1), dtype=y.dtype)
        u[0, 0] = 1.0
        return u, np.zeros((1, n), dtype=y.dtype)
    if tol > 0:
        tails = np.sqrt(np.cumsum(s[::-1] ** 2))[::-1]  # ||s[r:]||
        keep = tails > tol * np.linalg.norm(s)
        r_ = max(1, int(np.count_nonzero(keep)))
    else:
        r_ = len(s)
    if rmax is not None:
        r_ = min(r_, rmax)
    u = u2[:, :r_] if q is None else q @ u2[:, :r_]
    v = s[:r_, None] * vt[:r_]
    return u, v


def localcross(y, tol: float, rmax: int | None = None):
    """Full-pivot truncated cross (LU) factorization ``y ~= u @ v``.

    Mirrors TT-Toolbox ``localcross`` as used by the reference's block
    truncation (amen_cross_s.m:594) and residual truncation (:904): greedy
    full pivoting on the residual until the pivot drops below
    ``tol * |pivot_1|``, then QR-orthogonalization of the left factor.

    Returns (u, v) with u (m x r) having orthonormal columns.
    """
    y = _as_floating(y)
    m, n = y.shape
    if rmax is None:
        rmax = min(m, n)
    res = y.copy()
    us, vs = [], []
    pivot0 = None
    for _ in range(rmax):
        flat = np.argmax(np.abs(res))
        i, j = np.unravel_index(flat, res.shape)
        piv = res[i, j]
        if piv == 0.0:
            break
        if pivot0 is None:
            pivot0 = abs(piv)
        elif abs(piv) <= tol * pivot0:
            break
        u = res[:, j] / piv
        v = res[i, :].copy()
        res = res - np.outer(u, v)
        us.append(u)
        vs.append(v)
    if not us:
        # Degenerate all-zero input: return rank-1 zeros
        u = np.zeros((m, 1), dtype=y.dtype)
        u[0, 0] = 1.0
        return u, np.zeros((1, n), dtype=y.dtype)
    u = np.stack(us, axis=1)
    v = np.stack(vs, axis=0)
    q, rmat = np.linalg.qr(u)
    return q, rmat @ v
