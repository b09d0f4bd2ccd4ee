"""The design of the port's odim_step kernel against the JAX package's
Pallas odim_step, on the CPU.  The kernel (csrc/tc_dim.cuh) runs
dim_step's first pass with the orthonormal factor Q as the factor, then
a second pass over Q's own node blocks S_x = Q[:, x*r:(x+1)*r], staged
where dim_step stages its core slices: v[i0] = psi S_i0 and v[i0+1], one
f32 chain each, read out as la v[i0] + (1 - la) v[i0+1].  Modelled in
plain PyTorch (dim_step's plain version with bmat = Q and cmat = the
slices for the first pass, ``slices_readout`` for the second), it must
give the Pallas kernel's psi' and out9 (run in interpret mode, as the
JAX package's tests run it) within the bars of
tests/test_torch_factor_kernels.py: psi' to 2e-5 in 'irt' mode and 1e-6
in 'rt' mode, out9 to 1e-6 of each column's scale, and equal brackets
except on rows whose f32 target sits within 4 ulp of the CDF at a node.
dim_step's own second pass over the same slices (interpolate la S_i0 +
(1 - la) S_i0+1 first, then one chain) meets both bars on the small TT
and the 'irt' bar on lz40n33_ck, but misses the 'rt' one there (printed:
2.3e-6), which is why the kernel reads out two chains.  The operands are a level prepared by the port
itself: a small random TT made with numpy, and the last level of
lz40n33_ck."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tt_irt_tpu.ops.pallas_odim import odim_step as jax_odim_step
from tt_irt_tpu_torch.ops.dim_step import dim_step_ref
from tt_irt_tpu_torch.ops.odim_step import odim_step_ref
from tt_irt_tpu_torch.ops.rowmath import cdf_rows32
from tt_irt_tpu_torch.ops.step import factor_conditional_ref

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "examples", "data")
ROWS = 512


def q_slices(qmat):
    """(n, r*r) node slices of a factor (r, n*r): row x is Q[:, x*r:(x+1)*r]
    flattened row-major, the layout of dim_step's cmat."""
    r = qmat.shape[0]
    n = qmat.shape[1] // r
    return qmat.reshape(r, n, r).permute(1, 0, 2).reshape(n, r * r)


def _fma_chain(psi, s):
    """psi (M, r) times one (r, r) slice a row, s (M, r, r), as the kernel
    forms it: for each j one f32 FMA chain over i in order, each fma an
    exact f64 product and sum rounded once to f32."""
    p, s = psi.double(), s.double()
    v = torch.zeros(psi.shape, dtype=torch.float32)
    for i in range(psi.shape[1]):
        v = (p[:, i, None] * s[:, i, :] + v.double()).float()
    return v


def slices_readout(psi, qp32, um32, qmat, hrow, xg, mode="irt"):
    """odim_step's second pass in plain PyTorch: the bracket and cell
    weight of the first pass (dim_step's, with bmat = Q), then
    (la v[i0] + (1 - la) v[i0+1]) / max|.| with v[x] = psi S_x one FMA
    chain over i each, from Q's node slices."""
    m, r = psi.shape
    n = xg.shape[1]
    fk = factor_conditional_ref(psi, qmat)
    _, i0, la = cdf_rows32(mode, fk, xg[0], xg[1], hrow, qp32, um32)
    s = q_slices(qmat).reshape(n, r, r)
    va, vb = _fma_chain(psi, s[i0]), _fma_chain(psi, s[i0 + 1])
    out = la[:, None] * va + (1.0 - la)[:, None] * vb
    return out / torch.clamp(out.abs().amax(1, keepdim=True), min=1e-30)


def _small_tt_level():
    """The orthonormal-core prep of a random positive TT (d=4, n=17,
    ranks 5) on the grid [-2, 2], made with numpy."""
    import tt_irt_tpu_torch as tp
    from tt_irt_tpu_torch.samplers.irt import _canon_grid
    from tt_irt_tpu_torch.samplers.irt_scan import _prep, stack_padded

    rng = np.random.default_rng(5)
    d, n, r = 4, 17, 5
    cores = [np.abs(rng.standard_normal((1 if k == 0 else r, n,
                                         1 if k == d - 1 else r))) + 0.05
             for k in range(d)]
    tt = tp.tt_from_numpy(cores, device="cpu")
    grids = [torch.linspace(-2.0, 2.0, n, dtype=torch.float64)] * d
    gs, ttc = _canon_grid(grids, tt)
    cs, xs = stack_padded(ttc, gs)
    return _prep(cs, xs, "hi", hi_step="odim")


def _lz40_level():
    """The orthonormal-core prep of lz40n33_ck's last level, as
    DirtSampler prepares it at hi_step="odim"."""
    import tt_irt_tpu_torch as tp
    from tt_irt_tpu_torch.samplers.dirt import _prepare_level_preps

    dirt = tp.load_dirt(os.path.join(DATA, "lz40n33_ck"), device="cpu")
    return _prepare_level_preps(dirt, "hi", "odim")[-1]


LEVELS = {"small_tt": (_small_tt_level, 2), "lz40n33": (_lz40_level, 20)}


def _operands(source, mode):
    """Dimension k of the level: the carry psi that ROWS uniform seeds
    reach there through odim_step's plain version, the seed (in 'rt'
    mode a point of the grid's range, two of them on nodes), its f32
    complement, Q, its spacings and grid."""
    make, k = LEVELS[source]
    prep = make()
    d, r = prep.qmat.shape[:2]
    rng = np.random.default_rng(k)
    q = torch.from_numpy(rng.uniform(size=(d, ROWS)))
    psi = torch.zeros((ROWS, r), dtype=torch.float32)
    psi[:, 0] = 1.0
    for j in range(k):
        psi, _ = odim_step_ref(psi, q[j].float(), (1.0 - q[j]).float(),
                               prep.qmat[j], prep.hrow[j], prep.xg[j])
    xg = prep.xg[k]
    qp32 = q[k].float()
    if mode == "rt":
        lo, hi = float(xg[0, 0]), float(xg[0, -1])
        qp32 = torch.from_numpy(rng.uniform(lo, hi, ROWS)).float()
        qp32[:2] = xg[0, 3:5]
    return (psi, qp32, (1.0 - q[k]).float(), prep.qmat[k], prep.hrow[k], xg)


def _near_a_node(psi, qp32, um32, qmat, hrow):
    """Rows whose f32 target, from the left (seed <= 0.5) or from the
    right, sits within 4 ulp of the total of the two-sided CDF at a
    node."""
    fk = factor_conditional_ref(psi, qmat).double()
    dc = 0.5 * (fk[:, :-1] + fk[:, 1:]) * hrow.double()
    zero = torch.zeros((fk.shape[0], 1), dtype=torch.float64)
    ck = torch.cat([zero, torch.cumsum(dc, 1)], 1)
    cr = torch.cat([torch.flip(torch.cumsum(torch.flip(dc, [1]), 1), [1]),
                    zero], 1)
    tot = ck[:, -1:]
    tol = 4 * 1.2e-7 * tot
    left = (ck - qp32.double()[:, None] * tot).abs() <= tol
    right = (cr - um32.double()[:, None] * tot).abs() <= tol
    return (left | right).any(1)


@pytest.mark.parametrize("mode", ["irt", "rt"])
@pytest.mark.parametrize("source", ["small_tt", "lz40n33"])
def test_dim_step_on_q_slices_matches_pallas_odim(source, mode):
    ops = _operands(source, mode)
    psi, qp32, um32, qmat, hrow, xg = ops
    pd, ot = dim_step_ref(psi, qp32, um32, qmat, q_slices(qmat), hrow, xg,
                          mode=mode)
    pt = slices_readout(*ops, mode=mode)
    pj, oj = jax_odim_step(*(jnp.asarray(t.numpy()) for t in (
        psi, qp32, um32, qmat)), jnp.asarray(hrow.numpy()[None, :]),
        jnp.asarray(xg.numpy()), mode=mode)
    pt, pd, ot = pt.numpy(), pd.numpy(), ot.numpy()
    pj, oj = np.asarray(pj), np.asarray(oj)
    same = ot[:, 4] == oj[:, 4]
    if mode == "rt":
        assert same.all()
    else:
        near = _near_a_node(psi, qp32, um32, qmat, hrow).numpy()
        assert np.all(same | near), np.flatnonzero(~(same | near))
        assert np.mean(same) > 0.99
    scale = np.max(np.abs(oj), axis=0) + 1e-30
    assert np.max((np.abs(ot - oj) / scale)[same]) < 1e-6
    err = np.max(np.abs(pt - pj)[same])
    err_d = np.max(np.abs(pd - pj)[same])
    print(f"{source} {mode}: psi' vs Pallas odim: two chains over Q's "
          f"slices {err:.3g}, interpolated slices (dim_step's) {err_d:.3g}")
    assert err < (1e-6 if mode == "rt" else 2e-5)
    if mode == "irt" or source == "small_tt":
        assert err_d < (1e-6 if mode == "rt" else 2e-5)
    # and against the port's own odim_step_ref: the same out9 bit for bit
    # (the same conditional and CDF), psi' within the same bar
    po, oo = odim_step_ref(*ops, mode=mode)
    np.testing.assert_array_equal(ot, oo.numpy())
    assert np.max(np.abs(pt - po.numpy())) < (1e-6 if mode == "rt"
                                              else 2e-5)


def test_q_slices_layout():
    """Row x of the slices is node x's (r, r) block of Q, row-major, so
    that psi S_x is the conditional matrix's row x: psi Q[:, x*r:(x+1)*r]."""
    rng = np.random.default_rng(0)
    r, n = 3, 4
    qmat = torch.from_numpy(rng.standard_normal((r, n * r)))
    s = q_slices(qmat).reshape(n, r, r)
    psi = torch.from_numpy(rng.standard_normal((2, r)))
    v = (psi @ qmat).reshape(2, n, r)
    for x in range(n):
        assert torch.equal(s[x], qmat[:, x * r:(x + 1) * r])
        assert torch.allclose(psi @ s[x], v[:, x], rtol=1e-14, atol=0)
