"""ALS-Cross for parameter-dependent linear systems (counterpart of
``tt_irt_tpu/constructors/als_cross.py``; re-design of
matlab/constructors/als_cross_parametric.m).

A TT solver for A(y) u(y) = f(y) where the operator depends (nearly)
linearly on a coefficient given as a block TT.  The spatial block is
solved by a user callback (``assem_solve_fun``); the sweep (QR,
``maxvol``, ``localcross`` truncation, residual bookkeeping) is the JAX
package's host numpy, so both packages take the same steps on the same
arrays.  The work that scales with the problem runs in f64 on the
device: the batched reduced solves (the reference's
solve_blockdiag_mex.c, one ``torch.linalg.solve`` over the batch), the
Galerkin reductions of the parametric blocks (project_blockdiag_mex.c,
one einsum) and those of the spatial block against the callback's
operators (kept on the device as one (r, Na, Na) tensor).
"""

from __future__ import annotations

import math
import time as _time
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..ops.maxvol import localcross, maxvol
from ..ops.tt import TT
from ..utils.device import resolve_device

__all__ = ["als_cross_parametric", "AlsCrossResult",
           "solve_blockdiag", "project_blockdiag"]


def _dev(a, device):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64,
                           device=device)


def solve_blockdiag(uau, crc, crf, device="cuda"):
    """Batched reduced solves: for each column j solve
    (sum_c UAU[:,:,c] * crc[c,j]) x_j = crf[:,j], on ``device``.

    uau: (ru, ru, rc); crc: (rc, m); crf: (ru, m) (numpy).  Returns the
    solutions (ru, m) as numpy (solve_blockdiag_mex.c:66-69's dgesv
    loop as one batched solve)."""
    dev = resolve_device(device)
    mats = torch.einsum("abc,cj->jab", _dev(uau, dev), _dev(crc, dev))
    rhs = _dev(crf, dev).T.unsqueeze(-1)
    return torch.linalg.solve(mats, rhs)[:, :, 0].T.cpu().numpy()


def project_blockdiag(uau, core, cru, device="cuda"):
    """Galerkin reduction
    UAU'[x,y,d] = sum_n cru[:,n,x]^T (sum_c UAU[:,:,c] core[c,n,d]) cru[:,n,y]
    on ``device`` (project_blockdiag_mex.c:91-115 as one einsum); numpy
    in and out."""
    dev = resolve_device(device)
    cru_t = _dev(cru, dev)
    out = torch.einsum("anx,abc,cnd,bny->xyd", cru_t, _dev(uau, dev),
                       _dev(core, dev), cru_t)
    return out.cpu().numpy()


def _operators(a0s, device) -> torch.Tensor:
    """The callback's spatial operators as one (r, Na, Na) f64 tensor on
    the device: a list or array of numpy matrices, or a tensor."""
    if torch.is_tensor(a0s):
        return a0s.to(device=device, dtype=torch.float64)
    return _dev(np.stack([np.asarray(a) for a in a0s], axis=0), device)


def _sandwich(left, amat, right) -> np.ndarray:
    """stack_c(left^T A_c right) on the device -> numpy (rl, rr, rc)."""
    t = torch.matmul(amat, right)                  # (rc, Na, rr)
    return torch.matmul(left.T, t).permute(1, 2, 0).cpu().numpy()


class AlsCrossResult(NamedTuple):
    u: TT                 # solution (on the device): spatial block first
    time_extern: tuple    # (solve seconds, projection seconds)
    funevals: int         # number of deterministic solves


def als_cross_parametric(coeff: TT, assem_solve_fun: Callable, tol: float,
                         *, nswp: int = 5, kickrank: int = 10,
                         random_init: int = 0, funarg: str = "values",
                         pua=None, verb: int = 0, seed: int = 0,
                         device="cuda") -> AlsCrossResult:
    """Solve a parametric linear system in TT via ALS-Cross.

    Args:
      coeff: block TT of coefficients (on any device; the sweep reads it
        on the host): left boundary rank Mc enumerates
        coefficient components, first core is the spatial block with Nxc
        dofs, remaining d cores are the parametric directions.
      assem_solve_fun: callback; for funarg='values' it receives
        Ci (Mc, Nxc, r) coefficient snapshots and returns (U, A, F) on
        the first call: U (Nxu, r) solutions, A the r (Nxa, Nxa)
        operators at the snapshots (a list of numpy arrays, or one
        (r, Nxa, Nxa) array or tensor), F (Nxa, r) right-hand sides;
        just U on later calls (reference als_cross_parametric.m:203-213).  For funarg='indices' it
        receives an (r, d) integer matrix of parametric grid indices.
      tol: truncation/stopping tolerance.
      pua: optional (Nxa, Nxu) projector when solution and operator live
        on different dof sets.
      random_init: if > 0, start from that many random parametric
        indices instead of the coefficient's maxvol indices.
      device: where the reduced solves and Galerkin projections run
        (default "cuda").
    Returns AlsCrossResult(u on ``device``, (solve seconds, projection
    seconds), number of spatial solves).
    """
    dev = resolve_device(device)
    if random_init and funarg == "indices":
        raise NotImplementedError(
            "random_init with funarg='indices' is inconsistent: the "
            "spatial solve takes the maxvol index set whose size is the "
            "coefficient rank, not random_init (the reference has the "
            "same size clash, als_cross_parametric.m:132-151,196)")
    rng = np.random.default_rng(seed)
    cores = [c.detach().cpu().numpy() if torch.is_tensor(c)
             else np.asarray(c) for c in coeff.cores]
    c0 = cores[0]                       # (Mc, Nxc, rc1)
    mc, nxc, _ = c0.shape
    pcores = cores[1:]                  # parametric cores
    d = len(pcores)
    ny = [c.shape[1] for c in pcores]
    rc = [c.shape[0] for c in pcores] + [pcores[-1].shape[2]]
    if rc[-1] != 1:
        raise ValueError("coefficient must have unit right boundary rank")
    tol_local = tol / math.sqrt(max(d, 1))

    # ------------------------------------------------------------------
    # Right-to-left: orthogonalize + maxvol the coefficient, build the
    # initial interpolation state (als_cross_parametric.m:113-167).
    # ------------------------------------------------------------------
    uc = [None] * (d + 1)   # right cross samples of C at U-indices
    uc[d] = np.ones((1, 1))
    ru = [None] * (d + 1)
    ru[d] = 1
    ju = [None] * (d + 1)   # global right index sets (for funarg=indices)
    ju[d] = np.zeros((1, 0), np.int64)
    zc = [None] * (d + 1)
    zu = [None] * (d + 1)
    zz_r = [None] * (d + 1)
    rz = [max(1, int(round(kickrank * r / max(rc)))) for r in rc]
    rz[d] = 1
    use_kick = kickrank > 0
    zc[d] = np.ones((1, 1))
    zu[d] = np.ones((1, 1))
    xi = np.ones((1, max(random_init, 1)))

    v = np.ones((1, 1))
    for i in range(d - 1, -1, -1):
        # fold the previous bond factor: exactness relation is
        # old_core_mat = v @ new_core, so core_i <- core_i x_right v
        core = np.einsum("anb,bc->anc", pcores[i], v)
        r1, n, r2 = core.shape
        mat = np.reshape(core, (r1, n * r2), order="F").T   # (n*r2, r1)
        q, rmat = np.linalg.qr(mat)
        ind = maxvol(q)
        qq = q[ind]
        core_new = np.linalg.solve(qq.T, q.T)               # (r', n*r2)
        rnew = core_new.shape[0]
        pcores[i] = np.reshape(core_new, (rnew, n, r2), order="F")
        v = rmat.T @ qq.T                                   # (rc_i_old, r')
        rc[i] = rnew
        # merged right index rows: (mode fastest, then right set)
        jr = ju[i + 1]
        merged = np.concatenate(
            [np.tile(np.arange(n, dtype=np.int64)[:, None],
                     (max(jr.shape[0], 1), 1)),
             np.repeat(jr, n, axis=0)], axis=1)
        ju[i] = merged[ind]
        if random_init and i > 0:
            rind = rng.integers(0, n, random_init)
            gath = pcores[i][:, rind, :]                    # (r', ri, r2)
            xi = np.einsum("arb,br->ar", gath, xi)
            uc[i] = xi
            ru[i] = random_init
        else:
            uc[i] = np.eye(rc[i])
            ru[i] = rc[i]
            xi = np.ones((rc[i], max(random_init, 1))) if random_init \
                else xi
        if use_kick:
            crz = rng.standard_normal((ny[i] * rz[i + 1], rz[i]))
            crz, _ = np.linalg.qr(crz)
            rz[i] = crz.shape[1]
            zind = maxvol(crz)
            t = np.reshape(
                np.reshape(pcores[i], (rc[i] * ny[i], r2), order="F")
                @ zc[i + 1], (rc[i], ny[i] * rz[i + 1]), order="F")
            zc[i] = t[:, zind]
            if random_init and i > 0:
                # random-start solution bond (size random_init) has no
                # coefficient-maxvol identification, so the residual's
                # right solution-interface proxy is a random orthonormal
                # projection; the sweeps replace it with the true
                # interfaces (the reference crashes on this combination
                # - a shape clash at als_cross_parametric.m:384 - so
                # this init is an extension, not a translation)
                zu[i] = np.linalg.qr(rng.standard_normal(
                    (max(ru[i], rz[i]), rz[i])))[0][:ru[i], :]
            else:
                zu[i] = zc[i].copy()
            zz_r[i] = zind
    c0 = np.einsum("mxc,bc->mxb", c0, v.T)  # fold v: (Mc, Nxc, rc1)

    ucores = [None] * d
    u0 = None
    uau = [None] * (d + 1)
    uf = [None] * (d + 1)
    a0s = None                          # (rc1, Nxa, Nxa) on the device
    f0 = None
    nxa = None
    nxu = None
    time_extern = [0.0, 0.0]
    funevals = 0

    # ------------------------------------------------------------------
    # Sweeps
    # ------------------------------------------------------------------
    i = 0
    direction = 1
    swp = 1
    max_dx = 0.0
    while swp <= nswp:
        if i == 0:
            # ---------------- spatial block ----------------
            uprev = u0
            if funarg == "indices":
                ci = ju[0]
            else:
                ci = np.einsum("mxc,cr->mxr", c0, uc[0])
            t0 = _time.perf_counter()
            if swp == 1:
                u0, a0s, f0 = assem_solve_fun(ci)
                u0 = np.asarray(u0)
                a0s = _operators(a0s, dev)
                f0 = np.asarray(f0)
                nxa = a0s.shape[1]
            else:
                u0 = np.asarray(assem_solve_fun(ci))
            time_extern[0] += _time.perf_counter() - t0
            funevals += ru[0]
            nxu = u0.shape[0]
            if nxu != nxa and pua is None:
                raise ValueError("dof mismatch between u and A and no "
                                 "Pua projector given")
            dx = 1.0
            if uprev is not None and uprev.shape == u0.shape:
                dx = np.linalg.norm(u0 - uprev) / np.linalg.norm(u0)
            max_dx = max(max_dx, dx)
            if verb:
                rmax_cur = max(r for r in ru if r is not None)
                print(f"=als_cross= spatial swp={swp}, "
                      f"max_dx={max_dx:.3e}, max_rank={rmax_cur}")
            if max_dx < tol or swp > nswp:
                break
            max_dx = 0.0
            # truncate spatial block
            u0, vmat = localcross(u0, tol_local)
            ru[0] = u0.shape[1]
            if use_kick:
                # spatial residual & enrichment (reference :247-279)
                cru = u0 @ vmat @ zu[0]
                if nxa != nxu:
                    cru = pua @ cru
                z0 = torch.einsum("cab,cj,bj->aj", a0s, _dev(zc[0], dev),
                                  _dev(cru, dev)).cpu().numpy() \
                    - f0 @ zc[0]
                z0, _ = np.linalg.qr(z0)
                rz[0] = z0.shape[1]
                if nxa != nxu:
                    cat = np.concatenate([u0, pua.T @ z0], axis=1)
                else:
                    cat = np.concatenate([u0, z0], axis=1)
                u0, vq = np.linalg.qr(cat)
                vmat = vq[:, :ru[0]] @ vmat
                ru[0] = u0.shape[1]
            if ucores[0] is not None:
                ucores[0] = np.einsum("ab,bnc->anc", vmat, ucores[0])
            # Galerkin projections (reference :284-305)
            t0 = _time.perf_counter()
            up = pua @ u0 if nxa != nxu else u0
            up_t = _dev(up, dev)
            uau[0] = _sandwich(up_t, a0s, up_t)         # (ru0, ru0, rc1)
            uf[0] = up.T @ f0                            # (ru0, rc1)
            time_extern[1] += _time.perf_counter() - t0
            if use_kick:
                zu[0] = _sandwich(_dev(z0, dev), a0s, up_t)
                zc[0] = z0.T @ f0                        # (rz0, rc1)
        else:
            # ---------------- parametric block i (1-based: pcores[i-1]) --
            k = i - 1
            core = pcores[k]
            r1, n, r2 = core.shape
            crc = np.reshape(
                np.reshape(core, (r1 * n, r2), order="F") @ uc[i],
                (r1, n * ru[i]), order="F")
            uaui = uau[i - 1]                            # (ru, ru, rc)
            ufi = uf[i - 1]                              # (ru, rc)
            crf = ufi @ crc                              # (ru, n*ru2)
            cru = solve_blockdiag(uaui, crc, crf, dev)   # (ru, n*ru2)
            cru = np.reshape(cru, (ru[i - 1], n, ru[i]), order="F")
            dx = 1.0
            if ucores[k] is not None and ucores[k].shape == cru.shape:
                nrm = np.linalg.norm(cru)
                dx = np.linalg.norm(cru - ucores[k]) / (nrm if nrm else 1.0)
            max_dx = max(max_dx, dx)
            ucores[k] = cru
            if k < d - 1 and direction > 0:
                # ---- forward truncation + enrichment + projections ----
                mat = np.reshape(cru, (ru[i - 1] * n, ru[i]), order="F")
                uorth, vmat = localcross(mat, tol_local)
                if use_kick:
                    crcz = np.reshape(
                        np.reshape(core, (r1 * n, r2), order="F") @ zc[i],
                        (r1, n * rz[i]), order="F")
                    upz = np.reshape(uorth @ vmat @ zu[i],
                                     (ru[i - 1], n * rz[i]), order="F")
                    az = np.einsum("abc,cj->jab", uaui, crcz)
                    crs = np.einsum("jab,bj->aj", az, upz) - ufi @ crcz
                    crs = np.reshape(crs, (ru[i - 1] * n, rz[i]),
                                     order="F")
                    cat = np.concatenate([uorth, crs], axis=1)
                    uorth, vq = np.linalg.qr(cat)
                    vmat = vq[:, :vmat.shape[0]] @ vmat
                    # residual itself
                    azz = np.einsum("zac,cj->jza",
                                    np.reshape(zu[i - 1],
                                               (rz[i - 1], ru[i - 1], -1),
                                               order="F"), crcz)
                    crz = np.einsum("jza,aj->zj", azz, upz) \
                        - zc[i - 1] @ crcz
                    crz = np.reshape(crz, (rz[i - 1] * n, rz[i]),
                                     order="F")
                    crz, _ = np.linalg.qr(crz)
                    rz[i] = crz.shape[1]
                if ucores[k + 1] is not None:
                    ucores[k + 1] = np.einsum("ab,bnc->anc", vmat,
                                              ucores[k + 1])
                ru[i] = uorth.shape[1]
                cru3 = np.reshape(uorth, (ru[i - 1], n, ru[i]), order="F")
                ucores[k] = cru3
                t0 = _time.perf_counter()
                uau[i] = project_blockdiag(uaui, core, cru3, dev)
                uf[i] = np.einsum("ac,cnd,anx->xd", ufi, core, cru3)
                time_extern[1] += _time.perf_counter() - t0
                if use_kick:
                    crz3 = np.reshape(crz, (rz[i - 1], n, rz[i]),
                                      order="F")
                    zui = zu[i - 1]                       # (rz1, ru1, rc1)
                    zu[i] = np.einsum("znw,zac,cnd,anx->wxd",
                                      crz3, zui, core, cru3)
                    zc[i] = np.einsum("zc,cnd,znw->wd", zc[i - 1], core,
                                      crz3)
            elif direction < 0:
                # ---- backward: truncate from the left, enrich rows with
                # the residual, re-select interpolation indices
                # (reference :515-613) ----
                mat = np.reshape(cru, (ru[i - 1], n * ru[i]), order="F")
                vmat, crumat = localcross(mat, tol_local)
                # localcross returns orthonormal-left; transpose roles:
                # we want mat ~= vmat @ crumat with crumat to be index-
                # normalized below, so any factorization works.
                if use_kick:
                    crcu = np.reshape(
                        np.reshape(core, (r1 * n, r2), order="F") @ uc[i],
                        (r1, n * ru[i]), order="F")
                    upz = np.reshape(vmat @ crumat,
                                     (ru[i - 1], n * ru[i]), order="F")
                    zui = zu[i - 1]                       # (rz1, ru1, rc1)
                    az = np.einsum("zac,cj->jza", zui, crcu)
                    crz_en = np.einsum("jza,aj->zj", az, upz) \
                        - zc[i - 1] @ crcu                # (rz1, n*ru2)
                    crumat = np.concatenate([crumat, crz_en], axis=0)
                    vmat = np.concatenate(
                        [vmat, np.zeros((vmat.shape[0],
                                         crz_en.shape[0]))], axis=1)
                # orthogonalize rows of crumat, maxvol, interpolation-
                # normalize: crumat ~= (rows) -> q.T; ind in merged
                # (mode, right) space
                q, rmat = np.linalg.qr(crumat.T)          # q: (n*ru2, r'')
                ind = maxvol(q)
                qq = q[ind]                               # (r'', r'')
                new_core = np.linalg.solve(qq.T, q.T)     # (r'', n*ru2)
                vmat = vmat @ rmat.T @ qq.T               # (ru1_old, r'')
                rnew = new_core.shape[0]
                ucores[k] = np.reshape(new_core, (rnew, n, ru[i]),
                                       order="F")
                # push the non-orth factor into the left neighbor
                if k > 0:
                    if ucores[k - 1] is not None:
                        ucores[k - 1] = np.einsum(
                            "anb,bc->anc", ucores[k - 1], vmat)
                else:
                    u0 = u0 @ vmat
                ru[i - 1] = rnew
                # right index set + coefficient samples at the new indices
                jr = ju[i]
                merged = np.concatenate(
                    [np.tile(np.arange(n, dtype=np.int64)[:, None],
                             (max(jr.shape[0], 1), 1)),
                     np.repeat(jr, n, axis=0)], axis=1)
                ju[i - 1] = merged[ind]
                t = np.reshape(
                    np.reshape(core, (r1 * n, r2), order="F") @ uc[i],
                    (r1, n * ru[i]), order="F")
                uc[i - 1] = t[:, ind]
                if use_kick:
                    # residual at z-indices (right side)
                    crcz = np.reshape(
                        np.reshape(core, (r1 * n, r2), order="F") @ zc[i],
                        (r1, n * rz[i]), order="F")
                    upz2 = np.reshape(vmat @ new_core,
                                      (vmat.shape[0], n, ru[i]),
                                      order="F")
                    upz2 = np.reshape(
                        np.einsum("anb,bz->anz", upz2, zu[i]),
                        (vmat.shape[0], n * rz[i]), order="F")
                    zui = zu[i - 1]
                    az = np.einsum("zac,cj->jza", zui, crcz)
                    crz = np.einsum("jza,aj->zj", az, upz2) \
                        - zc[i - 1] @ crcz                # (rz1, n*rz2)
                    qz, _ = np.linalg.qr(
                        np.reshape(crz, (rz[i - 1], n * rz[i]),
                                   order="F").T)
                    rz[i - 1] = qz.shape[1]
                    zind = maxvol(qz)
                    tz = np.reshape(
                        np.reshape(core, (r1 * n, r2), order="F")
                        @ zc[i], (r1, n * rz[i]), order="F")
                    zc[i - 1] = tz[:, zind]
                    tu = np.reshape(
                        np.reshape(ucores[k],
                                   (rnew * n, ru[i]), order="F")
                        @ zu[i], (rnew, n * rz[i]), order="F")
                    zu[i - 1] = tu[:, zind]
            if verb > 1:
                print(f"=als_cross= swp={swp}({direction:+d}) i={i} "
                      f"dx={dx:.3e} ranks=({ru[i - 1]},{ru[i]})")
        i += direction
        if direction > 0 and i == d + 1 and swp == nswp:
            break
        if direction > 0 and i == d and swp < nswp:
            direction = -1
            swp += 1
            max_dx = 0.0
        if i == 0 and direction < 0:
            direction = 1
            swp += 1

    # assemble the solution TT
    u0_3 = np.reshape(u0, (1, nxu, ru[0]))
    all_cores = [_dev(c, dev) for c in [u0_3] + ucores]
    return AlsCrossResult(TT(all_cores), tuple(time_extern), funevals)
