"""The Gram family's CDF step (tt_irt_tpu_torch/ops/cdf.py) on the CPU:
its plain version against the function it was moved from, the forward
pass's ``step`` naming the CDF beside the two contractions, and every
precision's serve against the forward pass it replaced.  The kernel
itself is held against the plain version on the card
(tests/test_torch_cuda.py, with ``cdf_rows`` and ``assert_as_accurate``
from here)."""

import os

import numpy as np
import pytest
import torch

from tt_irt_tpu_torch.ops.cdf import cdf_invert_ref
from tt_irt_tpu_torch.ops.rowmath import cumsum_rows, invert_quadratic
from tt_irt_tpu_torch.samplers import irt_scan

DATA = os.path.join(os.path.dirname(__file__), "..", "examples", "data")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread a process, so that parallel test workers do
    not oversubscribe the cores; the caller's setting comes back."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def frozen_cdf_invert(mode, fk, xp, h, qp):
    """``samplers/irt_scan.py::_cdf_invert`` as it stood before it moved
    to ops/cdf.py, line for line (without its span)."""
    n = fk.shape[-1]
    dc = 0.5 * (fk[:, :-1] + fk[:, 1:]) * h[1:]
    total = torch.sum(dc, dim=-1, keepdim=True)
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
        xl_ = invert_quadratic(f1, f2, c1, qp, x1, x2)
        xr_ = -invert_quadratic(f2, f1, cr2, 1.0 - qp, -x2, -x1)
        xk = torch.where(right, xr_, xl_)
        out = xk
    la = (x2 - xk) / (x2 - x1)
    lb = (xk - x1) / (x2 - x1)
    dlf = torch.log(f1 * la + f2 * lb)
    return out, dlf, la, lb, i0


def same(a, b):
    """Equal entries, NaN where the other is NaN."""
    return (torch.equal(torch.isnan(a), torch.isnan(b))
            and torch.equal(torch.nan_to_num(a, nan=7.0),
                            torch.nan_to_num(b, nan=7.0)))


def assert_as_accurate(got, want, w64):
    """The bracket of ``got`` (a kernel's (out, dlf, la, lb, i0)) agrees
    with the plain f32 version's ``want`` and its f64 run ``w64`` on 97%
    of the rows; on those rows, where all three are finite, each of the
    sample, dlf, la and lb is as close to the f64 run as the plain f32
    version is: at most twice its 99th percentile of |error| plus 1e-6,
    three times its 99.9th and four times its largest (the few rows at
    the far end, where a cell's conditioning magnifies the rounding of
    either version, as chip_smoke.py's ``_gate2x`` bounds the largest
    error of the other kernels).  Both versions round each row's total
    in their own order, so neither is the more accurate row by row."""
    agree = (got[4] == want[4]) & (want[4] == w64[4])
    assert float(agree.double().mean()) >= 0.97
    for g, w, r in zip(got[:4], want[:4], w64[:4]):
        rows = agree & torch.isfinite(g) & torch.isfinite(w)
        rows &= torch.isfinite(r)
        err_k = (g.double() - r)[rows].abs()
        err_p = (w.double() - r)[rows].abs()
        for level, factor in ((0.99, 2.0), (0.999, 3.0), (1.0, 4.0)):
            ek = float(torch.quantile(err_k, level))
            ep = float(torch.quantile(err_p, level))
            assert ek <= factor * ep + 1e-6, (level, ek, ep)


def cdf_rows(m, n, seed, dtype, exact=False):
    """(fk, xp, h, qp): rows of a conditional with the step's edge cases
    and its seeds' edges.  Rows 0-3 have no mass (zeros, negative, a
    negative total with positive nodes, a zero total from cancelling
    nodes), rows 4-11 carry slightly negative nodes beside their mass
    (ck not monotone); seeds include 0, 0.5, the next f32 above 0.5 and
    1.  With ``exact`` the nodes are small dyadic numbers on a dyadic
    grid whose width is a power of two, and each row's last node is
    chosen so that its mass is one too: then every quotient by the total
    and every running sum is exact in f32, and no order of summation
    rounds."""
    rng = np.random.default_rng(seed)
    if exact:
        h = np.full(n - 1, 0.25)
        h[-1] = 2.0 ** np.ceil(np.log2(0.25 * (n - 1))) - 0.25 * (n - 2)
        x = np.concatenate([[0.0], np.cumsum(h)]) - 0.125 * n
        f = rng.integers(0, 16, (m, n)).astype(np.float64)
        f[4:12, ::3] = -1.0
        mass = np.sum(0.5 * (f[:, :-1] + f[:, 1:]) * h, axis=1)
        mass = np.where(mass > 0.0, mass, 1.0)
        f[:, -1] += 2.0 * (2.0 ** np.ceil(np.log2(mass)) - mass) / h[-1]
    else:
        x = np.sort(rng.uniform(-2.0, 2.0, n))
        x[0], x[-1] = -2.0, 2.0
        f = rng.uniform(0.0, 1.0, (m, n)) ** 3
        f[4:12, ::3] = -1e-3 * rng.uniform(size=f[4:12, ::3].shape)
    f[0] = 0.0
    f[1] = -1.0
    f[2] = 1.0
    f[2, n // 2] = -4.0 * n
    f[3] = 0.0
    f[3, :2] = [1.0, -1.0]
    h = np.concatenate([[0.0], np.diff(x)])
    q = rng.uniform(size=m)
    q[:8] = [0.0, 0.5, np.nextafter(np.float32(0.5), np.float32(1.0)), 1.0,
             0.5, 1.0, 0.0, 0.25]
    q[12:16] = [0.0, 0.5, np.nextafter(np.float32(0.5), np.float32(1.0)), 1.0]
    t = [torch.tensor(a, dtype=dtype) for a in (f, x, h, q)]
    return tuple(t)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mode", ["sqr", "rt", "lin"])
def test_cdf_invert_ref_is_the_moved_function(mode, dtype):
    """ops/cdf.py's plain version equals the function it was moved from
    (``samplers/irt_scan.py::_cdf_invert``, frozen above) bit for bit,
    on rows without mass, rows with slightly negative nodes and seeds at
    0, 0.5, just above 0.5 and 1; irt_scan keeps the name bound to it."""
    assert irt_scan._cdf_invert is cdf_invert_ref
    fk, xp, h, qp = cdf_rows(300, 17, 0, dtype)
    if mode == "rt":
        qp = xp[0] + qp * (xp[-1] - xp[0])
    got = cdf_invert_ref(mode, fk, xp, h, qp)
    want = frozen_cdf_invert(mode, fk, xp, h, qp)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and same(g, w)


@pytest.fixture(scope="module")
def lz10():
    import tt_irt_tpu_torch as tp

    dirt = tp.load_dirt(os.path.join(DATA, "lz10_ck"), device="cpu")
    q = torch.rand((64, dirt.d), dtype=torch.float64,
                   generator=torch.Generator().manual_seed(0)) * 0.8 + 0.1
    return dirt, q


@pytest.mark.parametrize("mode", ["sqr", "rt", "lin"])
def test_fwd_gram_step_names_the_cdf_too(lz10, mode):
    """A ``step`` handed to ``_fwd`` names all three per-dimension
    functions of the Gram family, the CDF among them: the plain triple
    gives the default CPU forward pass of lz10_ck's level 0 bit for bit
    (mode 'rt' on the samples of mode 'sqr'), and the CDF it names runs
    once a dimension, so that no part of a "plain" pass is left to the
    device's choice."""
    from tt_irt_tpu_torch.ops.cdf import cdf_invert_into_ref
    from tt_irt_tpu_torch.ops.step import (condition_update_ref,
                                           gram_conditional_ref)
    from tt_irt_tpu_torch.samplers.irt import _canon_grid

    dirt, q = lz10
    gs, f0 = _canon_grid(dirt.x0, dirt.f0)
    cs, xs = irt_scan.stack_padded(f0, gs)
    prep = irt_scan._prep(cs, xs, "f32",
                          mode="lin" if mode == "lin" else "sqr")
    if mode == "rt":
        q = irt_scan._fwd("sqr", prep, q)[0].double()
    calls = []

    def cdf(*args):
        calls.append(args[0])
        return cdf_invert_into_ref(*args)

    conditional = (irt_scan.lin_conditional if mode == "lin"
                   else gram_conditional_ref)
    x, lf = irt_scan._fwd(mode, prep, q,
                          step=(conditional, cdf, condition_update_ref))
    x0, lf0 = irt_scan._fwd(mode, prep, q)
    assert calls == [mode] * dirt.d
    assert torch.equal(x, x0) and same(lf, lf0)


def frozen_fwd_gram(mode, prep, q, step=None):
    """``samplers/irt_scan.py::_fwd_gram`` as it stood before the CDF
    went through ``kernel_plan.cdf_invert``, line for line, on the
    frozen CDF."""
    from tt_irt_tpu_torch.ops import kernel_plan

    d = prep.pmat.shape[0]
    r = int(round(prep.cmat.shape[2] ** 0.5))
    cdt, pdt = prep.pmat.dtype, prep.xs.dtype
    mixed = cdt != pdt
    mb = q.shape[0]
    qs = q.to(pdt).T.contiguous()
    if step is not None:
        gram, update = step
    else:
        gram, update = kernel_plan.gram_step(cdt)
        if isinstance(prep, irt_scan.LinPrep):
            gram = irt_scan.lin_conditional
    phi = torch.zeros((mb, r), dtype=cdt, device=q.device)
    phi[:, 0] = 1.0
    lf = torch.zeros((mb,), dtype=pdt, device=q.device)
    outs = torch.empty((d, mb), dtype=pdt, device=q.device)
    for k in range(d):
        fk = gram(phi, prep.pmat[k])
        if mixed:
            fk = torch.clamp(fk, min=0.0)
        outs[k], dlf, la, lb, i0 = frozen_cdf_invert(
            mode, fk.to(pdt), prep.xs[k], prep.hs[k], qs[k])
        lf = lf + dlf
        phi = update(phi, i0.to(torch.int32), la.to(cdt), lb.to(cdt),
                     prep.cmat[k])
    return outs.T, lf


@pytest.mark.parametrize("precision", list(irt_scan.PRECISIONS))
def test_lz10_serve_on_cpu_is_the_previous_forward_pass(monkeypatch, lz10,
                                                        precision):
    """Every precision's CPU serve of lz10_ck (DirtSampler, and an
    IrtSampler of its level 0 in modes 'sqr' and 'lin') equals, bit for
    bit, the serve through the forward pass and CDF that
    ``kernel_plan.cdf_invert`` replaced (frozen above)."""
    import tt_irt_tpu_torch as tp

    dirt, q = lz10

    def serve():
        out = [tp.DirtSampler(dirt, precision=precision, device="cpu")(q)]
        for mode in ("sqr", "lin"):
            out.append(tp.IrtSampler(dirt.x0, dirt.f0, precision=precision,
                                     block=32, device="cpu", mode=mode)(q))
        return out

    now = serve()
    monkeypatch.setattr(irt_scan, "_fwd_gram", frozen_fwd_gram)
    monkeypatch.setattr(irt_scan, "_cdf_invert", frozen_cdf_invert)
    before = serve()
    for (z, lf), (z0, lf0) in zip(now, before):
        assert torch.equal(z, z0) and torch.equal(lf, lf0)
