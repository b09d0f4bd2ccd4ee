"""The port's orthonormal-core backward preparation
(tt_irt_tpu_torch/samplers/irt_scan.py::_prepare_scan_factor(ortho=True))
against the JAX package's, and its own invariants."""

import jax.numpy as jnp
import numpy as np
import torch

from tt_irt_tpu.ops.tt import TT as JTT
from tt_irt_tpu.samplers import irt_scan as jscan
from tt_irt_tpu_torch.samplers import irt_scan as tscan

D, N, R = 6, 17, 5


def _cores(d, n, r, seed):
    """Random TT cores (boundary ranks 1), made with numpy."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1 if k == 0 else r, n,
                                 1 if k == d - 1 else r)) for k in range(d)]


def _two_levels():
    """A bucket of two levels: a random rank-5 TT and a positive rank-1
    TT zero-padded to rank 5 (zero Gram lanes that need the jitter)."""
    x = np.linspace(-3.0, 3.0, N)
    full = _cores(D, N, R, 1)
    rank1 = [np.abs(c) + 0.1 for c in _cores(D, N, 1, 2)]
    stacks = []
    for cores in (full, rank1):
        cs, _ = jscan.stack_padded(JTT([jnp.asarray(c) for c in cores]),
                                   [jnp.asarray(x)] * D)
        stacks.append(np.asarray(cs))
    pad1 = np.zeros((D, R, N, R))
    pad1[:, :1, :, :1] = stacks[1]
    stacks[1] = pad1
    return stacks, np.stack([x] * D)


def test_ortho_prep_matches_jax():
    """Both levels prepared together against JAX's per-level
    _prepare_scan_factor(ortho=True): Q agrees to 1e-10 of each
    dimension's largest |Q| (both f64; two LAPACKs' Cholesky and
    triangular solves differ at 1e-13 or so, times the condition of the
    suffix Gram)."""
    stacks, xs = _two_levels()
    qt, ht = tscan._prepare_scan_factor(torch.from_numpy(np.stack(stacks)),
                                        torch.from_numpy(xs), ortho=True)
    for lvl, cs in enumerate(stacks):
        qj, hj = jscan._prepare_scan_factor(jnp.asarray(cs), jnp.asarray(xs),
                                            ortho=True)
        qj = np.asarray(qj)
        q = qt[lvl].numpy()
        assert np.all(np.isfinite(q))
        scale = np.max(np.abs(qj), axis=(1, 2, 3), keepdims=True)
        err = np.max(np.abs(q - qj) / scale)
        assert err < 1e-10, (lvl, err)
        np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))


def test_ortho_prep_is_weighted_orthonormal_and_padding_stays_zero():
    """sum_x w2[x] Q_k(x) Q_k(x)^T is a multiple of the identity on the
    true-rank lanes (the multiple is the Gram's renormalisation, which
    cancels in the normalised CDF) to 1e-10; the rank-padded rows of Q
    are exact zeros, on the padded level and in dimension 0 of both."""
    stacks, xs = _two_levels()
    qt, ht = tscan._prepare_scan_factor(torch.from_numpy(np.stack(stacks)),
                                        torch.from_numpy(xs), ortho=True)
    w2 = tscan._trapz_w2(ht).numpy()
    for lvl, true_rank in ((0, R), (1, 1)):
        for k in range(D):
            q = qt[lvl, k].numpy()                         # (r, n, r)
            rk = 1 if k == 0 else true_rank
            assert np.all(q[rk:] == 0.0), (lvl, k)
            s = np.einsum("anc,bnc,n->ab", q, q, w2[k])[:rk, :rk]
            s = s / s[0, 0]
            assert np.max(np.abs(s - np.eye(rk))) < 1e-10, (lvl, k)


def test_ortho_prep_jitter_tier_is_per_level():
    """A level that needs a larger jitter tier must not change its
    bucket-mates: each level of the batch equals the level prepared
    alone, and _chol_jittered picks the tier per batch entry."""
    stacks, xs = _two_levels()
    both, _ = tscan._prepare_scan_factor(torch.from_numpy(np.stack(stacks)),
                                         torch.from_numpy(xs), ortho=True)
    for lvl, cs in enumerate(stacks):
        alone, _ = tscan._prepare_scan_factor(torch.from_numpy(cs.copy()),
                                              torch.from_numpy(xs),
                                              ortho=True)
        assert float((both[lvl] - alone).abs().max()) < 1e-13
    # a Gram whose 1e-14 tier fails (a negative eigenvalue of -1e-12)
    # beside a well-conditioned one
    v = np.linalg.qr(np.random.default_rng(0).standard_normal((R, R)))[0]
    bad = (v * np.array([1.0, 0.5, 0.2, 0.1, -1e-12])) @ v.T
    good = np.eye(R)
    lf = tscan._chol_jittered(torch.from_numpy(np.stack([bad, good])))
    assert bool(torch.isfinite(lf).all())
    alone = tscan._chol_jittered(torch.from_numpy(good))
    assert torch.equal(lf[1], alone)
    assert abs(float(lf[1, 0, 0]) - np.sqrt(1.0 + 1e-14)) < 1e-15


def test_ortho_prep_tuple_shapes():
    """_prep(..., 'hi', hi_step='odim') returns an OrthoPrep whose fields
    carry the level axis; prep_level picks one level."""
    stacks, xs = _two_levels()
    prep = tscan._prep(torch.from_numpy(np.stack(stacks)),
                       torch.from_numpy(xs), "hi", hi_step="odim")
    assert isinstance(prep, tscan.OrthoPrep)
    assert prep.qmat.shape == (2, D, R, N * R)
    assert prep.qmat.dtype == torch.float32
    assert prep.xg.shape == (2, D, 2, N) and prep.hrow.shape == (2, D, N - 1)
    one = tscan.prep_level(prep, 1)
    assert isinstance(one, tscan.OrthoPrep) and one.qmat.shape == (D, R, N * R)
    fac = tscan.prep_level(tscan._prep(torch.from_numpy(np.stack(stacks)),
                                       torch.from_numpy(xs), "hi",
                                       hi_step="pair"), 0)
    assert fac.step == "pair" and fac.xs.dtype == torch.float64
    assert fac.hs.shape == (D, N) and float(fac.hs[:, 0].abs().max()) == 0.0
