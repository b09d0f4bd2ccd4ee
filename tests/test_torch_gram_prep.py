"""The port's Gram-form backward pass (irt_scan._prepare_scan, both
carries) against the JAX package on the same numpy-made cores."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tt_irt_tpu.samplers import irt_scan as jscan
from tt_irt_tpu_torch.samplers import irt_scan as tscan


def _stack(d, n, r, seed, positive=False):
    """A rank-padded core stack (d, r, n, r) with boundary ranks 1."""
    rng = np.random.default_rng(seed)
    cs = np.zeros((d, r, n, r))
    for k in range(d):
        r1 = 1 if k == 0 else r
        r2 = 1 if k == d - 1 else r
        c = rng.standard_normal((r1, n, r2))
        cs[k, :r1, :, :r2] = np.abs(c) + 0.1 if positive else c
    return cs


def _levels():
    """A random level (d=6, n=17, r=5) and a rank-1 level padded to rank
    5 (exact-zero columns in the QR's matrix), on one grid."""
    d, n, r = 6, 17, 5
    full = _stack(d, n, r, 1)
    rank1 = np.zeros((d, r, n, r))
    rank1[:, :1, :, :1] = _stack(d, n, 1, 2, positive=True)
    return np.stack([full, rank1]), np.stack([np.linspace(-3.0, 3.0, n)] * d)


@pytest.mark.parametrize("stable", [False, True])
def test_prepare_scan_f64_matches_jax(stable):
    """Both carries in f64, two levels prepared as one batch: P agrees
    with JAX's per-level _prepare_scan to 1e-12 of its largest entry per
    dimension (same f64 formulas; einsum order and LAPACK QR vs JAX's
    differ, and P = b b^T does not see the sign of R's rows)."""
    stacks, xs = _levels()
    pt, ht = tscan._prepare_scan(torch.from_numpy(stacks),
                                 torch.from_numpy(xs), stable=stable)
    assert pt.shape == stacks.shape[:2] + (5, 5, 17)
    for lvl, cs in enumerate(stacks):
        pj, hj = jscan._prepare_scan(jnp.asarray(cs), jnp.asarray(xs),
                                     stable=stable)
        pj = np.asarray(pj)
        assert np.all(np.isfinite(pt[lvl].numpy()))
        scale = np.max(np.abs(pj), axis=(1, 2, 3), keepdims=True)
        assert np.max(np.abs(pt[lvl].numpy() - pj) / scale) < 1e-12, lvl
        np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))


def test_prepare_scan_f32_qr_matches_jax():
    """The QR carry in f32.  An f32 QR of the (n r + r, r) matrix rounds
    differently in LAPACK (torch) and in JAX's own; P = b b^T sees the
    rounding, not the signs.  Bar: 5e-6 of each dimension's largest
    entry.  Measured here 2.6e-7 between the packages, and 1.9e-7 /
    3.5e-7 from each to the f64 prep: both sit at the f32 floor."""
    stacks, xs = _levels()
    s32 = stacks.astype(np.float32)
    x32 = xs.astype(np.float32)
    pt, _ = tscan._prepare_scan(torch.from_numpy(s32), torch.from_numpy(x32),
                                stable=True)
    assert pt.dtype == torch.float32
    for lvl in range(2):
        pj, _ = jscan._prepare_scan(jnp.asarray(s32[lvl]), jnp.asarray(x32),
                                    stable=True)
        pj = np.asarray(pj)
        scale = np.max(np.abs(pj), axis=(1, 2, 3), keepdims=True)
        assert np.max(np.abs(pt[lvl].numpy() - pj) / scale) < 5e-6, lvl


@pytest.mark.parametrize("precision", ["f64", "f32", "mixed"])
def test_gram_prep_layout_and_dtypes(precision):
    """GramPrep carries pmat/cmat in the contraction dtype and the grid
    and spacings in the CDF dtype, laid out as the JAX package's fused
    Gram prep (pmat (d, r*r, n), cmat (d, n, r*r))."""
    stacks, xs = _levels()
    cdt, pdt, _ = tscan._PRECISIONS[precision]
    prep = tscan._prep(torch.from_numpy(stacks), torch.from_numpy(xs),
                       precision)
    assert isinstance(prep, tscan.GramPrep)
    assert prep.pmat.shape == (2, 6, 25, 17) and prep.pmat.dtype == cdt
    assert prep.cmat.shape == (2, 6, 17, 25) and prep.cmat.dtype == cdt
    assert prep.xs.shape == (2, 6, 17) and prep.xs.dtype == pdt
    assert prep.hs.shape == (2, 6, 17) and prep.hs.dtype == pdt
    one = tscan.prep_level(prep, 0)
    jp = jscan._prep("sqr", jnp.asarray(stacks[0]), jnp.asarray(xs),
                     precision, True, fused=True)
    tol = 1e-12 if precision == "f64" else 5e-6
    for mine, theirs in zip(one, jp):
        theirs = np.asarray(theirs)
        assert mine.shape == theirs.shape
        scale = max(np.max(np.abs(theirs)), 1e-30)
        assert np.max(np.abs(mine.numpy() - theirs)) / scale < tol
