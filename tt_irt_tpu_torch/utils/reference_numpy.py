"""Pure-numpy f64 reference of the squared-IRT transform.

The port's own copy of the JAX package's numpy oracle
(``tt_irt_tpu/utils/reference_numpy.py``), kept here because importing
it from there would import jax.  It is an independent, host-side f64
implementation of the same math: backward QR semi-marginalization (the
reference's tt_irt_sqr.m:63-80 carry) and the forward
dimension-by-dimension CDF inversion (tt_irt_sqr.m:96-207) with the
citardauq-stable quadratic root.  It shares no code with the torch
samplers, which is what makes it a second oracle for them (the card
tests, which cannot import the JAX package, use it so).
"""

from __future__ import annotations

import numpy as np

__all__ = ["irt_sqr_numpy"]


def _trapz_w2(h):
    return 0.5 * np.concatenate([h[1:2], h[1:-1] + h[2:], h[-1:]])


def irt_sqr_numpy(grids, cores, q):
    """f64 SIRT: seeds (M, d) in [0,1] -> (samples, log-density).

    grids: list of d 1-D grid vectors (with boundary points).
    cores: list of d TT cores (r1, n, r2) of the sqrt-density.
    """
    cores = [np.asarray(c, np.float64) for c in cores]
    grids = [np.asarray(g, np.float64).reshape(-1) for g in grids]
    q = np.asarray(q, np.float64)
    d = len(cores)
    m = q.shape[0]

    # Backward: thin-R carry by QR of the weight-scaled suffix cores.
    ps = [None] * d
    rfac = np.eye(cores[-1].shape[2])
    for k in range(d - 1, -1, -1):
        core = cores[k]
        r1, n, _ = core.shape
        h = np.concatenate([[0.0], np.diff(grids[k])])
        w2 = _trapz_w2(h)
        b = np.einsum("anb,bc->anc", core, rfac)
        ps[k] = np.einsum("anc,bnc->abn", b, b)        # (r1, r1, n)
        if k > 0:
            mat = (b * np.sqrt(w2)[None, :, None]).reshape(r1, -1).T
            rfac = np.linalg.qr(mat, mode="r").T
            rfac = rfac / max(np.abs(rfac).max(), 1e-300)

    # Forward: per-dim conditional CDF inversion.
    phi = np.zeros((m, cores[0].shape[0]))
    phi[:, 0] = 1.0
    xq = np.empty((m, d))
    lf = np.zeros(m)
    for k in range(d):
        x = grids[k]
        n = x.shape[0]
        h = np.concatenate([[0.0], np.diff(x)])
        t = np.einsum("mi,ijn->mjn", phi, ps[k])
        fk = np.einsum("mj,mjn->mn", phi, t)           # (M, n), >= 0
        dc = 0.5 * (fk[:, :-1] + fk[:, 1:]) * h[1:]
        total = dc.sum(axis=1, keepdims=True)
        bad = total[:, 0] <= 0.0
        if bad.any():
            dc[bad] = h[1:][None, :]
            fk[bad] = 1.0
            total = dc.sum(axis=1, keepdims=True)
        dc /= total
        fk = fk / total
        ck = np.concatenate([np.zeros((m, 1)), np.cumsum(dc, axis=1)],
                            axis=1)
        qk = q[:, k]
        i0 = np.clip((ck < qk[:, None]).sum(axis=1) - 1, 0, n - 2)
        rows = np.arange(m)
        c1 = ck[rows, i0]
        f1 = fk[rows, i0]
        f2 = fk[rows, i0 + 1]
        x1 = x[i0]
        x2 = x[i0 + 1]
        # citardauq root (matches _invert_quadratic, samplers/irt.py)
        aq = 0.5 * (f2 - f1) / (x2 - x1)
        t2 = qk - c1
        den = f1 + np.sqrt(np.maximum(f1 * f1 + 4.0 * aq * t2, 0.0))
        xk = np.where(den <= 0.0, x1,
                      x1 + 2.0 * t2 / np.where(den <= 0.0, 1.0, den))
        xk = np.clip(xk, x1, x2)
        xq[:, k] = xk
        la = (x2 - xk) / (x2 - x1)
        lb = (xk - x1) / (x2 - x1)
        lf += np.log(f1 * la + f2 * lb)
        if k < d - 1:
            core = cores[k]
            g = (core[:, i0, :] * la[None, :, None]
                 + core[:, i0 + 1, :] * lb[None, :, None])
            phi = np.einsum("mi,imj->mj", phi, g)
            phi /= np.maximum(np.abs(phi).max(axis=1, keepdims=True),
                              1e-300)
    return xq, lf
