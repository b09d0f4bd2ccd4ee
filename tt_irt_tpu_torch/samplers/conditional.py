"""Exact conditional sampling through the triangular transport structure
(counterpart of ``tt_irt_tpu/samplers/conditional.py``).

The (S)IRT map is lower-triangular (Knothe--Rosenblatt): output
coordinate k depends only on seed coordinates 1..k, and the DIRT stack's
composition with diagonal reference maps stays triangular.  So

    z_{k+1:d} | z_{1:k} = x  is sampled by
      (1) q_fix = T^{-1}_{1:k}(x), the partial forward Rosenblatt map,
      (2) z = T([q_fix, q_rest]) with fresh seeds q_rest,

and the log conditional density is the full log-density minus the log
marginal of the conditioned block, both of which the samplers return.

Everything here composes ported functions: ``tt_partial_eval`` with
``tt_irt_sqr`` or ``tt_irt_lin`` (one conditioning point), ``tt_rt_sqr``
with ``tt_irt_sqr`` (a conditioning row per seed), ``tt_dirt_inverse``
with ``tt_dirt_sample`` and ``dirt_permute`` (a DIRT stack).  The kernels
run wherever those functions run them, for the precision asked.  The
conditioned columns are pinned out of place (a concatenation and a
column gather), so the result stays differentiable.
"""

from __future__ import annotations

import torch

from ..ops.tt import TT, tt_partial_eval
from ..utils.device import resolve_device
from .dirt import DIRT, dirt_permute, tt_dirt_inverse, tt_dirt_sample
from .irt import tt_irt_lin, tt_irt_sqr, tt_rt_sqr

__all__ = ["tt_irt_cond", "tt_dirt_cond_sample"]


def _rows(a, dev) -> torch.Tensor:
    """``a`` as a 2-D f64 tensor on ``dev`` (one row for a vector)."""
    return torch.atleast_2d(torch.as_tensor(a, dtype=torch.float64,
                                            device=dev))


def _broadcast_fix(xfix, m: int) -> torch.Tensor:
    """The conditioning rows (M, k): one row broadcast to every seed, or
    one row a seed; ValueError otherwise."""
    if xfix.shape[0] == 1 and m > 1:
        xfix = xfix.expand(m, xfix.shape[1])
    if xfix.shape[0] != m:
        raise ValueError(
            f"xfix has {xfix.shape[0]} rows, seeds have {m}; pass one "
            "conditioning row (broadcast) or one per seed row")
    return xfix


def _perm_for(cond_dims, d: int):
    """(perm, inv): the conditioned dims first, then the rest in order,
    and its inverse; ValueError unless the dims are distinct in 0..d-1."""
    cond_dims = [int(c) for c in cond_dims]
    if len(set(cond_dims)) != len(cond_dims) or not all(
            0 <= c < d for c in cond_dims):
        raise ValueError(f"cond_dims must be distinct dims in 0..{d-1}: "
                         f"{cond_dims}")
    rest = [i for i in range(d) if i not in set(cond_dims)]
    perm = cond_dims + rest
    inv = [0] * d
    for i, p in enumerate(perm):
        inv[p] = i
    return perm, inv


def _check_cover(k: int, q_rest, d: int) -> None:
    if k + q_rest.shape[1] != d:
        raise ValueError(
            f"xfix ({k} cols) + q_rest ({q_rest.shape[1]} cols) must "
            f"cover all {d} dimensions")


def tt_irt_cond(grid, f: TT, xfix, q_rest, cond_dims=None,
                mode: str = "sqr", **kwargs):
    """Sample the conditional z_rest | z_cond = xfix from a sqrt-density
    TT (or a density TT in mode 'lin').

    * One conditioning point (xfix a single row): the fixed coordinates
      are substituted into the cores by linear interpolation
      (``tt_partial_eval``, rank-preserving, any ``cond_dims`` subset)
      and the (d-k)-dimensional TT left is sampled by ``tt_irt_sqr`` or
      ``tt_irt_lin``.
    * One conditioning row per seed: the conditioned block goes through
      the forward Rosenblatt map (``tt_rt_sqr``) and [q_fix, q_rest]
      through ``tt_irt_sqr``; prefix conditioning and mode 'sqr' only.

    Args:
      grid: the d grid vectors (as in tt_irt_sqr).
      f: TT of sqrt(PDF) ('sqr') or of the PDF ('lin').
      xfix: (k,) one conditioning point, or (M, k) one per seed row.
      q_rest: (M, d-k) uniform seeds of the other coordinates, in the
        original order.
      cond_dims: which coordinates xfix fixes (default: the first k).
      mode: 'sqr' (default) or 'lin' (single-point form only).
      kwargs: forwarded to the samplers (block, precision, hi_step,
        device).

    Returns:
      (z, lfcond): samples (M, d) whose conditioned columns equal xfix,
      and the log conditional density log p(z_rest | z_cond) (M,).
    """
    dev = resolve_device(kwargs.get("device", "cuda"))
    q_rest = _rows(q_rest, dev)
    xarr = _rows(xfix, dev)
    single_point = xarr.shape[0] == 1
    if (cond_dims is not None and not single_point
            and sorted(int(c) for c in cond_dims)
            != list(range(len(list(cond_dims))))):
        raise ValueError(
            "per-seed xfix supports prefix conditioning only; for an "
            "arbitrary subset pass ONE conditioning row, or tt_permute "
            "the TT so the subset leads")
    if single_point:
        if len(grid) != f.d:
            raise ValueError("conditioning requires grid as a list of d "
                             "grid vectors")
        dims = (list(range(xarr.shape[1])) if cond_dims is None
                else [int(c) for c in cond_dims])
        if len(dims) != xarr.shape[1]:
            raise ValueError(f"xfix has {xarr.shape[1]} values for "
                             f"{len(dims)} conditioned dims")
        _check_cover(len(dims), q_rest, f.d)
        f_sub, grids_sub = tt_partial_eval(f, grid, dims, xarr[0])
        sampler = {"sqr": tt_irt_sqr, "lin": tt_irt_lin}[mode]
        z_rest, lfcond = sampler(grids_sub, f_sub, q_rest, **kwargs)
        m = q_rest.shape[0]
        rest = [i for i in range(f.d) if i not in set(dims)]
        both = torch.cat([z_rest, xarr[:, :].to(z_rest.dtype).expand(
            m, len(dims))], dim=1)
        col = {c: j for j, c in enumerate(rest + dims)}
        order = torch.tensor([col[i] for i in range(f.d)], device=dev)
        return both[:, order], lfcond
    if mode != "sqr":
        raise ValueError("per-seed conditioning rows require mode='sqr' "
                         "(no forward transform exists for the lin map)")
    m = q_rest.shape[0]
    xfix = _broadcast_fix(xarr, m)
    k = xfix.shape[1]
    _check_cover(k, q_rest, f.d)
    q_fix, lf_marg = tt_rt_sqr(grid, f, xfix, **kwargs)
    z, lf_full = tt_irt_sqr(grid, f, torch.cat([q_fix, q_rest], dim=1),
                            **kwargs)
    # the round trip gives xfix back to rounding error; pin it exactly
    z = torch.cat([xfix.to(z.dtype), z[:, k:]], dim=1)
    return z, lf_full - lf_marg


def tt_dirt_cond_sample(dirt: DIRT, xfix, q_rest, logpostfun=None,
                        precision=None, cond_dims=None,
                        perm_eps: float = 1e-12, hi_step: str = "dim",
                        device="cuda"):
    """Sample the conditional z_rest | z_cond = xfix from a DIRT
    pushforward.

    Args:
      dirt: a spline DIRT stack (the partial inverse is
        ``tt_dirt_inverse``, which refuses other interpolations).
      xfix: (k,) or (M, k) values of the first k coordinates, or of
        ``cond_dims`` if given (the stack is relabelled by
        ``dirt_permute`` with truncation ``perm_eps`` a TT, and the
        output columns come back in the original order; ``logpostfun``
        still gets original-order samples).  Reordering a TT can grow
        its ranks.
      q_rest: (M, d-k) reference-space seeds of the other coordinates
        (whatever ``dirt.reference`` is, e.g. from ``randref``).
      logpostfun: optional exact joint log-density, evaluated at z.
      precision, hi_step: forwarded to ``tt_dirt_sample``; the inverse
        runs at f64, as in the JAX package.
      device: where the stack is served (default "cuda").

    Returns:
      (z, lfcond) or (z, lfcond, logpostfun(z)).
    """
    if cond_dims is not None:
        perm, inv = _perm_for(cond_dims, dirt.d)
        inv_t = torch.tensor(inv, device=resolve_device(device))
        lpperm = (None if logpostfun is None
                  else (lambda zp: logpostfun(zp[:, inv_t])))
        out = tt_dirt_cond_sample(dirt_permute(dirt, perm, perm_eps), xfix,
                                  q_rest, logpostfun=lpperm,
                                  precision=precision, hi_step=hi_step,
                                  device=device)
        return (out[0][:, inv_t],) + out[1:]
    dev = resolve_device(device)
    q_rest = _rows(q_rest, dev)
    m = q_rest.shape[0]
    xfix = _broadcast_fix(_rows(xfix, dev), m)
    k = xfix.shape[1]
    _check_cover(k, q_rest, dirt.d)
    q_fix, lf_marg = tt_dirt_inverse(dirt, xfix, device=dev)
    out = tt_dirt_sample(dirt, torch.cat([q_fix, q_rest], dim=1),
                         logpostfun=logpostfun, precision=precision,
                         hi_step=hi_step, device=dev)
    z = torch.cat([xfix.to(out[0].dtype), out[0][:, k:]], dim=1)
    lfcond = out[1] - lf_marg
    return (z, lfcond) + tuple(out[2:])
