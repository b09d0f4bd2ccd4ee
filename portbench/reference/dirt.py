"""Plain PyTorch reference of a DIRT stack's pushforward: seeds of the
truncated-normal reference -> samples and the log-density of the map.

Written from the method (Cui & Dolgov, "Deep composition of
tensor-trains using squared inverse Rosenblatt transports"; the MATLAB
TT-IRT tt_irt_sqr.m and tt_dirt_sample.m), independent of the program
under test.  Each level is a squared TT on a grid with linear
interpolation: the backward pass carries the thin R factor of a QR of
the weight-scaled suffix (tt_irt_sqr.m:63-80); the forward pass inverts
each one-dimensional conditional CDF of piecewise-linear density within
its cell by the citardauq-stable quadratic root (tt_irt_sqr.m:96-207).
The single-level arithmetic is a frozen copy of the numpy oracle that
ships with the port (``utils/reference_numpy.irt_sqr_numpy``), moved to
torch so that it runs on either device, in blocks of rows.

``Precision`` names the dtypes of the three parts: the backward pass,
the contractions of the forward pass, and the CDF with the log-density;
the reference runs all three in float64, a control in a lower one.
"""

from __future__ import annotations

import json
import math
from typing import NamedTuple

import numpy as np
import torch


class Precision(NamedTuple):
    prep: torch.dtype = torch.float64
    contract: torch.dtype = torch.float64
    cdf: torch.dtype = torch.float64
    tf32: bool = False


F64 = Precision()


def precision_from(spec: dict) -> Precision:
    """A Precision from a configuration's {"prep", "contract", "cdf",
    "tf32"} (dtype names)."""
    return Precision(getattr(torch, spec["prep"]),
                     getattr(torch, spec["contract"]),
                     getattr(torch, spec["cdf"]), bool(spec.get("tf32")))


class Stack(NamedTuple):
    """A DIRT stack as numpy arrays: level-0 cores and grids, and each
    upper level's cores over the shared upper grids."""

    f0: list
    x0: list
    levels: list
    x: list
    sigma: float | None


def load_stack(path: str) -> Stack:
    """Read a checkpoint (``path`` + ``.npz`` / ``.json``) into numpy."""
    with open(path + ".json") as fh:
        head = json.load(fh)
    d = head["d"]
    with np.load(path + ".npz") as data:
        f0 = [data[f"f0_{i}"] for i in range(d)]
        x0 = [data[f"x0_{i}"].reshape(-1) for i in range(d)]
        levels = [[data[f"lvl{j}_{i}"] for i in range(dl)]
                  for j, dl in enumerate(head["level_dims"])]
        x = [data[f"x_{i}"].reshape(-1) for i in range(head["n_x"])]
    return Stack(f0, x0, levels, x, sigma_of(head["reference"]))


def sigma_of(reference: str) -> float | None:
    """Half-width of the truncated-normal reference ('n3' -> 3), or
    None for the uniform one (tt_dirt_approx.m's 'reference' option)."""
    s = str(reference).strip().lower()
    if s.startswith("u"):
        return None
    digits = "".join(ch for ch in s if ch.isdigit() or ch == ".")
    return float(digits) if digits else 4.0


def _cdf_factor(sigma: float) -> float:
    return 0.5 / math.erf(sigma / math.sqrt(2.0))


def tnormal_to_uniform(z, sigma):
    """The truncated normal on (-sigma, sigma) -> [0, 1] by its CDF."""
    return torch.special.erf(z / math.sqrt(2.0)) * _cdf_factor(sigma) + 0.5


def uniform_to_tnormal(u, sigma):
    """[0, 1] -> the truncated normal on (-sigma, sigma)."""
    return (torch.special.erfinv((u - 0.5) / _cdf_factor(sigma))
            * math.sqrt(2.0))


def tnormal_logdensity(z, sigma):
    """Log-density of the truncated normal reference at the rows z."""
    c = _cdf_factor(sigma)
    return (-0.5 * torch.sum(z * z, dim=-1)
            + 0.5 * z.shape[-1] * math.log(2.0 * c * c / math.pi))


class Level(NamedTuple):
    """One level prepared: per dimension the semi-marginal fields
    P_k (r, r*n), the core C_k (r, n*r'), the grid and its spacings."""

    fields: list
    cores: list
    grids: list
    widths: list


def prepare_level(cores, grids, prec: Precision = F64,
                  device="cpu") -> Level:
    """The backward pass of one level in ``prec.prep``."""
    dt = prec.prep
    cores = [torch.as_tensor(np.asarray(c), dtype=dt, device=device)
             for c in cores]
    grids = [torch.as_tensor(np.asarray(g), dtype=torch.float64,
                             device=device) for g in grids]
    d = len(cores)
    fields = [None] * d
    rfac = torch.eye(cores[-1].shape[2], dtype=dt, device=device)
    with _tf32(prec.tf32):
        for k in range(d - 1, -1, -1):
            core = cores[k]
            r1, n, _ = core.shape
            h = torch.diff(grids[k]).to(dt)
            w2 = 0.5 * torch.cat([h[:1], h[:-1] + h[1:], h[-1:]])
            b = torch.einsum("anb,bc->anc", core, rfac)
            fields[k] = torch.einsum("anc,bnc->abn", b, b).reshape(
                r1, r1 * n)
            if k > 0:
                mat = (b * torch.sqrt(w2)[None, :, None]).reshape(r1, -1).T
                rfac = torch.linalg.qr(mat, mode="r").R.T
                rfac = rfac / torch.clamp(rfac.abs().max(), min=1e-300)
    return Level([f.to(prec.contract) for f in fields],
                 [c.reshape(c.shape[0], -1).to(prec.contract) for c in cores],
                 [g.to(prec.cdf) for g in grids],
                 [torch.diff(g).to(prec.cdf) for g in grids])


def push_level(level: Level, q, prec: Precision = F64):
    """The forward pass of one level: seeds q (M, d) in [0, 1] ->
    (x (M, d), log-density (M,)), both float64."""
    m, d = q.shape
    cdt = prec.cdf
    q = q.to(cdt)
    phi = torch.zeros((m, 1), dtype=prec.contract, device=q.device)
    phi[:, 0] = 1.0
    xq = torch.empty((m, d), dtype=cdt, device=q.device)
    lf = torch.zeros((m,), dtype=cdt, device=q.device)
    rows = torch.arange(m, device=q.device)
    with _tf32(prec.tf32):
        for k in range(d):
            x, h = level.grids[k], level.widths[k]
            r1 = phi.shape[1]
            n = x.shape[0]
            t = (phi @ level.fields[k]).reshape(m, r1, n)
            fk = torch.einsum("mj,mjn->mn", phi, t).to(cdt)
            dc = 0.5 * (fk[:, :-1] + fk[:, 1:]) * h
            total = dc.sum(dim=1, keepdim=True)
            bad = total <= 0.0
            dc = torch.where(bad, h.expand_as(dc), dc)
            fk = torch.where(bad, torch.ones_like(fk), fk)
            total = dc.sum(dim=1, keepdim=True)
            dc = dc / total
            fk = fk / total
            ck = torch.cat([torch.zeros_like(total), torch.cumsum(dc, 1)], 1)
            qk = q[:, k]
            i0 = torch.clamp((ck < qk[:, None]).sum(dim=1) - 1, 0, n - 2)
            c1 = ck[rows, i0]
            f1 = fk[rows, i0]
            f2 = fk[rows, i0 + 1]
            x1 = x[i0]
            x2 = x[i0 + 1]
            aq = 0.5 * (f2 - f1) / (x2 - x1)
            t2 = qk - c1
            den = f1 + torch.sqrt(torch.clamp(f1 * f1 + 4.0 * aq * t2,
                                              min=0.0))
            safe = torch.where(den <= 0.0, torch.ones_like(den), den)
            xk = torch.where(den <= 0.0, x1, x1 + 2.0 * t2 / safe)
            xk = torch.minimum(torch.maximum(xk, x1), x2)
            xq[:, k] = xk
            la = (x2 - xk) / (x2 - x1)
            lb = (xk - x1) / (x2 - x1)
            lf = lf + torch.log(f1 * la + f2 * lb)
            if k < d - 1:
                core = level.cores[k]
                r2 = core.shape[1] // n
                a = (phi @ core).reshape(m, n, r2)
                phi = (la[:, None].to(prec.contract) * a[rows, i0]
                       + lb[:, None].to(prec.contract) * a[rows, i0 + 1])
                phi = phi / torch.clamp(phi.abs().amax(dim=1, keepdim=True),
                                        min=1e-30)
    return xq.to(torch.float64), lf.to(torch.float64)


class Pushforward:
    """The reference map of a whole stack: levels L..1 on the upper
    grids, each between the truncated-normal reference and [0, 1], then
    level 0 (tt_dirt_sample.m)."""

    def __init__(self, stack: Stack, prec: Precision = F64, device="cpu"):
        self.prec = prec
        self.sigma = stack.sigma
        self.upper = [prepare_level(c, stack.x, prec, device)
                      for c in stack.levels]
        self.level0 = prepare_level(stack.f0, stack.x0, prec, device)

    def __call__(self, q, block: int = 1 << 14):
        """Seeds q (M, d) -> (z (M, d), lfapp (M,)), float64, in blocks
        of ``block`` rows."""
        zs, ls = [], []
        for s in range(0, q.shape[0], block):
            z, lf = self._push(q[s:s + block].to(torch.float64))
            zs.append(z)
            ls.append(lf)
        return torch.cat(zs), torch.cat(ls)

    def _push(self, z):
        sigma = self.sigma
        lf = torch.zeros(z.shape[0], dtype=torch.float64, device=z.device)
        for level in reversed(self.upper):
            if sigma is not None:
                z = tnormal_to_uniform(z, sigma)
            z, dlf = push_level(level, z, self.prec)
            lf = lf + dlf
            if sigma is not None:
                lf = lf - tnormal_logdensity(z, sigma)
        if sigma is not None:
            z = tnormal_to_uniform(z, sigma)
        z, dlf = push_level(self.level0, z, self.prec)
        return z, lf + dlf


class _tf32:
    """Allow TF32 in the card's float32 matrix products inside the
    block (the control's lower precision), and forbid it otherwise."""

    def __init__(self, on: bool):
        self.on = on

    def __enter__(self):
        self.before = (torch.backends.cuda.matmul.allow_tf32,
                       torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = self.on
        torch.backends.cudnn.allow_tf32 = self.on

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.before
