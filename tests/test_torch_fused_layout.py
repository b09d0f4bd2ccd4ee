"""The whole-transform kernel's host-side layout and its CDF order, on
the CPU (the kernel itself runs only on the card):

- pack_fused (ops/fused_irt.py), the operand the kernel stages one
  dimension at a time, maps back to build_fused_data's p2, coreu, x and h
  exactly, at the default odd core stride and at stride r*r;
- a PyTorch model of the kernel's CDF order (the total summed as the Gram
  loop produces the nodes, the count and the readout as joint passes
  over a thread's rows, the no-mass rows by a select) gives the same
  bracket, c1 and total as the three sequential passes of the
  one-row-a-thread kernel bit for bit, including the clip cases i0 = 0
  and i0 = n-2, negative fk and rows with no mass."""

import numpy as np
import pytest
import torch

import tt_irt_tpu_torch as tp
from tt_irt_tpu_torch.ops.fused_irt import fused_layout, pack_fused


def _tt(d, n, r, seed):
    """A positive random TT (softplus of random features), numpy-made."""
    rng = np.random.default_rng(seed)
    x = np.linspace(-1.0, 1.0, n)
    feats = np.stack([np.ones_like(x), np.sin(np.pi * x), np.cos(np.pi * x)])
    cores = []
    for k in range(d):
        r1 = 1 if k == 0 else r
        r2 = 1 if k == d - 1 else r
        w = rng.standard_normal((r1, 3, r2)) / np.sqrt(3 * r1)
        cores.append(torch.from_numpy(
            np.log1p(np.exp(np.einsum("afb,fn->anb", w, feats)))))
    return tp.TT(cores), [torch.linspace(-2.0, 2.0, n,
                                         dtype=torch.float64)] * d


@pytest.mark.parametrize("n,r", [(9, 5), (17, 13), (9, 8), (5, 16)])
@pytest.mark.parametrize("odd", [True, False])
def test_pack_fused_maps_back_to_the_operands(n, r, odd):
    """Every float of each dimension's block is the operand it stands
    for, and the padding is zero."""
    data = tp.build_fused_data(*_tt(4, n, r, n + r))
    p2, coreu, x, h = data["p2"], data["coreu"], data["x"], data["h"]
    d, rr = p2.shape[0], r * r
    cstride = None if odd else rr
    rj, cs, block = fused_layout(n, r, cstride)
    assert rj % 4 == 0 and rj - 4 < r <= rj and block % 4 == 0
    assert cs == (rr | 1 if odd else rr)
    pack = pack_fused(p2, coreu, x, h, cstride)
    assert pack.shape == (d, block) and pack.dtype == torch.float32
    np_ = n * r * rj
    pn = pack[:, :np_].reshape(d, n, r, rj)
    assert torch.equal(pn[..., :r].permute(0, 2, 3, 1).reshape(d, rr, n), p2)
    assert not bool(pn[..., r:].any())
    cn = pack[:, np_:np_ + n * cs].reshape(d, n, cs)
    assert torch.equal(cn[..., :rr], coreu)
    assert not bool(cn[..., rr:].any())
    o = np_ + n * cs
    assert torch.equal(pack[:, o:o + n], x)
    assert torch.equal(pack[:, o + n:o + 2 * n - 1], h)
    assert not bool(pack[:, o + 2 * n - 1:].any())


def _cell(a, b, h):
    """0.5 (a + b) h in f32, each operation rounded (no contraction)."""
    return (torch.tensor(0.5, dtype=torch.float32) * (a + b)) * h


def _three_pass(fk, xs, hs, q):
    """The one-row-a-thread kernel: total, count, readout, each its own
    sequential pass over the cells."""
    n = fk.shape[1]
    total = torch.zeros(fk.shape[0], dtype=torch.float32)
    for c in range(n - 1):
        total = total + _cell(fk[:, c], fk[:, c + 1], hs[c])
    bad = total <= 0.0
    x0 = xs[0]
    total = torch.where(bad, xs[n - 1] - x0, total)
    target = q * total
    cnt = torch.zeros(fk.shape[0], dtype=torch.int64)
    c = torch.zeros_like(total)
    for j in range(n):
        cnt += torch.where(bad, (xs[j] - x0) < target, c < target).long()
        if j < n - 1:
            c = c + _cell(fk[:, j], fk[:, j + 1], hs[j])
    i0 = torch.clamp(cnt - 1, 0, n - 2)
    cv = torch.zeros_like(total)
    for k in range(fk.shape[0]):
        if bad[k]:
            cv[k] = xs[i0[k]] - x0
        else:
            for j in range(int(i0[k])):
                cv[k] = cv[k] + _cell(fk[k, j], fk[k, j + 1], hs[j])
    return i0, cv / total, total


def _kernel_order(fk, xs, hs, q, rows=4):
    """The shipped kernel's order: the total as the nodes arrive (the
    Gram loop), then per group of `rows` rows a joint counting pass with
    the no-mass rows selected, and a joint readout to the group's
    largest bracket, each row adding only below its own."""
    m, n = fk.shape
    tot = torch.zeros(m, dtype=torch.float32)
    for x in range(1, n):
        tot = tot + _cell(fk[:, x - 1], fk[:, x], hs[x - 1])
    i0s, c1s, totals = [], [], []
    for g in range(0, m, rows):
        f = fk[g:g + rows]
        bad = tot[g:g + rows] <= 0.0
        x0 = xs[0]
        total = torch.where(bad, xs[n - 1] - x0, tot[g:g + rows])
        target = q[g:g + rows] * total
        c = torch.zeros_like(total)
        cnt = torch.zeros(f.shape[0], dtype=torch.int64)
        for j in range(n):
            cnt += (torch.where(bad, xs[j] - x0, c) < target).long()
            if j < n - 1:
                c = c + _cell(f[:, j], f[:, j + 1], hs[j])
        i0 = torch.clamp(cnt - 1, 0, n - 2)
        c = torch.zeros_like(total)
        for j in range(int(i0.max())):
            c = torch.where(j < i0, c + _cell(f[:, j], f[:, j + 1], hs[j]), c)
        cv = torch.where(bad, xs[i0] - x0, c)
        i0s.append(i0)
        c1s.append(cv / total)
        totals.append(total)
    return torch.cat(i0s), torch.cat(c1s), torch.cat(totals)


@pytest.mark.parametrize("n", [2, 9, 17])
def test_kernel_cdf_order_matches_three_passes(n):
    """Rows with noisy positive, partly negative and all-zero fk, seeds
    0, 1 and uniform: (i0, c1, total) equal bit for bit, and both clip
    cases occur."""
    rng = np.random.default_rng(n)
    m = 256
    x = np.sort(rng.uniform(-2.0, 2.0, n)).astype(np.float32)
    x[0], x[-1] = -2.0, 2.0
    xs = torch.from_numpy(x)
    hs = xs[1:] - xs[:-1]
    fk = rng.uniform(0.0, 1.0, (m, n)).astype(np.float32)
    fk[32:64] -= 0.6                   # cells of both signs
    fk[64:80] = 0.0                    # no mass: the uniform fix
    fk[80:96] = -fk[80:96]             # negative total: the uniform fix
    fk[96:112] *= 1e-30                # subnormal cells
    q = rng.uniform(size=m).astype(np.float32)
    q[::7], q[3::7] = 0.0, 1.0
    fk, q = torch.from_numpy(fk), torch.from_numpy(q)
    i0a, c1a, ta = _three_pass(fk, xs, hs, q)
    i0b, c1b, tb = _kernel_order(fk, xs, hs, q)
    assert torch.equal(i0a, i0b)
    assert torch.equal(ta, tb)
    assert torch.equal(c1a.view(torch.int32), c1b.view(torch.int32))
    assert bool((i0a == 0).any()) and bool((i0a == n - 2).any())
