"""The port's TT algebra (tt_irt_tpu_torch/ops/tt.py) against the JAX
package's on the same numpy cores.  QR and SVD gauges differ between
LAPACK builds, so TTs are compared through tt_full (dense, 1e-12 relative
to the largest entry unless stated) and ranks, never core by core."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tt_irt_tpu.ops.tt as jt
import tt_irt_tpu_torch as tp
from tt_irt_tpu_torch.ops import tt as pt

TOL = 1e-12


def _cores(seed, d=4, n=(4, 6, 5, 7), r=3, left=1, right=1):
    """Random cores with mode sizes n[:d], interior rank r and the given
    boundary ranks."""
    rng = np.random.default_rng(seed)
    ranks = [left] + [r] * (d - 1) + [right]
    return [rng.standard_normal((ranks[k], n[k], ranks[k + 1]))
            for k in range(d)]


def _both(cores):
    return (jt.TT([jnp.asarray(c) for c in cores]),
            tp.TT([torch.from_numpy(c.copy()) for c in cores]))


def _close(a_t, a_j, tol=TOL):
    a = a_t.numpy() if torch.is_tensor(a_t) else np.asarray(a_t)
    b = np.asarray(a_j)
    assert a.shape == b.shape
    scale = max(float(np.abs(b).max()), 1e-300)
    assert float(np.abs(a - b).max()) <= tol * scale


@pytest.mark.parametrize("left,right", [(1, 1), (2, 1), (1, 3)])
def test_full_dot_norm_scale(left, right):
    """tt_full, tt_dot, tt_norm and tt_scale, boundary ranks included."""
    j, t = _both(_cores(1, left=left, right=right))
    _close(pt.tt_full(t), jt.tt_full(j))
    j2, t2 = _both(_cores(2, left=left, right=right))
    _close(pt.tt_dot(t, t2), jt.tt_dot(j, j2))
    _close(pt.tt_norm(t), jt.tt_norm(j))
    _close(pt.tt_full(pt.tt_scale(t, -2.5)), jt.tt_full(jt.tt_scale(j, -2.5)))
    _close(pt.tt_full(-t), jt.tt_full(-j))


def test_add_sub_hadamard():
    j1, t1 = _both(_cores(3))
    j2, t2 = _both(_cores(4, r=2))
    for tt_, jj in ((pt.tt_add(t1, t2), jt.tt_add(j1, j2)),
                    (t1 - t2, j1 - j2),
                    (pt.tt_hadamard(t1, t2), jt.tt_hadamard(j1, j2))):
        assert tt_.ranks == jj.ranks
        _close(pt.tt_full(tt_), jt.tt_full(jj))
    one_t = tp.TT([t1.cores[0]])
    one_j = jt.TT([j1.cores[0]])
    _close(pt.tt_full(one_t + one_t), jt.tt_full(one_j + one_j))


@pytest.mark.parametrize("left", [True, False])
def test_orthogonalize(left):
    """Same tensor, and the swept cores orthonormal."""
    j, t = _both(_cores(5))
    o = pt.tt_orthogonalize(t, left=left)
    _close(pt.tt_full(o), jt.tt_full(jt.tt_orthogonalize(j, left=left)))
    cores = o.cores[:-1] if left else o.cores[1:]
    for c in cores:
        r1, n, r2 = c.shape
        m = c.reshape(r1 * n, r2) if left else c.reshape(r1, n * r2).T
        assert torch.allclose(m.T @ m, torch.eye(m.shape[1],
                                                 dtype=m.dtype), atol=1e-12)


def test_chop_rank_matches_on_the_same_singular_values():
    s = np.array([3.0, 1.0, 0.5, 1e-3, 1e-8, 0.0])
    for delta in (0.0, 1e-9, 1e-3, 2e-3, 0.6, 10.0):
        for rmax in (None, 2):
            assert (pt._chop_rank(torch.from_numpy(s), delta, rmax)
                    == jt._chop_rank(s, delta, rmax))


@pytest.mark.parametrize("eps,rmax", [(0.0, None), (1e-10, None), (0.3, None),
                                      (0.0, 2), (0.0, [2, 3, 1])])
def test_from_dense(eps, rmax):
    """TT-SVD: the same ranks, and the same tensor (1e-12, or the
    truncation's own error where it truncates)."""
    a = pt.tt_full(tp.TT([torch.from_numpy(c) for c in _cores(6)]))
    r = rmax[1] if isinstance(rmax, list) else rmax
    tj = jt.tt_from_dense(a.numpy(), eps, r)
    tt_ = pt.tt_from_dense(a, eps, r, device="cpu")
    assert tt_.ranks == tj.ranks
    _close(pt.tt_full(tt_), jt.tt_full(tj), 1e-10)


@pytest.mark.parametrize("eps,rmax", [(1e-10, None), (1e-2, None),
                                      (0.2, None), (0.0, 2), (0.0, [3, 2, 2])])
def test_round(eps, rmax):
    """tt_round of a + a (rank 6, exact rank 3) and of a noisy TT: the
    same per-bond ranks as JAX's and the same tensor; each core holds a
    comparable share of the norm (the log-norm equilibration)."""
    j, t = _both(_cores(7))
    jn, tn = _both(_cores(8, r=2))
    jj = jt.tt_add(jt.tt_add(j, j), jt.tt_scale(jn, 1e-3))
    tt_ = pt.tt_add(pt.tt_add(t, t), pt.tt_scale(tn, 1e-3))
    rj = jt.tt_round(jj, eps, rmax)
    rt = pt.tt_round(tt_, eps, rmax)
    assert rt.ranks == rj.ranks
    _close(pt.tt_full(rt), jt.tt_full(rj), 1e-10)
    logn = [float(torch.log(torch.linalg.norm(c))) for c in rt.cores]
    logj = [float(np.log(np.linalg.norm(np.asarray(c)))) for c in rj.cores]
    assert np.allclose(logn, logj, atol=1e-8)


def test_round_keeps_dtype_and_one_core():
    t = tp.TT([torch.from_numpy(c).float() for c in _cores(9)])
    assert pt.tt_round(t, 1e-3).dtype == torch.float32
    one = tp.TT([t.cores[0]])
    assert pt.tt_round(one, 0.5).cores[0] is one.cores[0]


def test_rand_ones_meshgrid_tkron():
    g = torch.Generator().manual_seed(3)
    t = pt.tt_rand([4, 5, 6], r=3, generator=g, device="cpu")
    assert t.ranks == jt.tt_rand([4, 5, 6], r=3).ranks
    again = pt.tt_rand([4, 5, 6], r=3, device="cpu",
                       generator=torch.Generator().manual_seed(3))
    assert all(torch.equal(a, b) for a, b in zip(t.cores, again.cores))
    assert pt.tt_rand(5, d=3, r=[1, 2, 4, 1],
                      device="cpu").ranks == (1, 2, 4, 1)
    _close(pt.tt_full(pt.tt_ones([3, 4, 2], device="cpu")),
           jt.tt_full(jt.tt_ones([3, 4, 2])))
    grids = [np.linspace(-1, 1, n) for n in (3, 4, 5)]
    for mt, mj in zip(pt.tt_meshgrid([torch.from_numpy(x) for x in grids]),
                      jt.tt_meshgrid([jnp.asarray(x) for x in grids])):
        _close(pt.tt_full(mt), jt.tt_full(mj))
    j1, t1 = _both(_cores(10, d=2))
    j2, t2 = _both(_cores(11, d=3))
    _close(pt.tt_full(pt.tkron(t1, t2)), jt.tt_full(jt.tkron(j1, j2)))
    with pytest.raises(ValueError):
        pt.tkron(tp.TT(_both(_cores(12, right=2))[1].cores), t2)


@pytest.mark.parametrize("mask", [(0, 1, 0, 1), (1, 0, 0, 0), (1, 1, 1, 1),
                                  (0, 0, 1, 1)])
def test_sum_modes_mean_field(mask):
    """Contract the modes flagged 1 with random weights."""
    j, t = _both(_cores(13))
    rng = np.random.default_rng(1)
    ws = [rng.uniform(size=n) if m else None for n, m in zip(t.n, mask)]
    out_t = pt.tt_sum_modes(t, [None if w is None else torch.from_numpy(w)
                                for w in ws])
    out_j = jt.tt_sum_modes(j, [None if w is None else jnp.asarray(w)
                                for w in ws])
    if all(mask):
        _close(out_t, out_j)
    else:
        _close(pt.tt_full(out_t), jt.tt_full(out_j))
    for dim in range(t.d):
        _close(pt.tt_mean_field(t, dim), jt.tt_mean_field(j, dim))


def test_reverse_and_eval_indices():
    j, t = _both(_cores(14, right=2))
    _close(pt.tt_full(pt.tt_reverse(t)), jt.tt_full(jt.tt_reverse(j)))
    rng = np.random.default_rng(2)
    ind = np.stack([rng.integers(0, n, 50) for n in t.n], axis=1)
    _close(pt.tt_eval_indices(t, torch.from_numpy(ind)),
           jt.tt_eval_indices(j, jnp.asarray(ind)))
    j1, t1 = _both(_cores(15))
    _close(pt.tt_eval_indices(t1, torch.from_numpy(ind)),
           jt.tt_eval_indices(j1, jnp.asarray(ind)))


@pytest.mark.parametrize("dims,values", [([1], [0.3]), ([0, 3], [-0.2, 0.9]),
                                         ([3], [2.0]),
                                         ([0, 1, 2, 3], [0.1, 0.2, 0.3, 0.4])])
def test_partial_eval(dims, values):
    j, t = _both(_cores(16))
    grids = [np.linspace(-1, 1, n) for n in t.n]
    st, gt = pt.tt_partial_eval(t, [torch.from_numpy(g) for g in grids],
                                dims, values)
    sj, gj = jt.tt_partial_eval(j, grids, dims, values)
    assert st.n == sj.n and len(gt) == len(gj)
    _close(pt.tt_full(st), jt.tt_full(sj))


@pytest.mark.parametrize("perm,eps", [([1, 0, 2, 3], 0.0), ([3, 2, 1, 0], 0.0),
                                      ([2, 0, 3, 1], 1e-12),
                                      ([3, 1, 0, 2], 1e-2)])
def test_permute(perm, eps):
    """The same ranks as JAX's, and the same permuted tensor; without
    truncation, the dense transpose."""
    j, t = _both(_cores(17))
    pj = jt.tt_permute(j, perm, eps)
    pt_ = pt.tt_permute(t, perm, eps)
    assert pt_.ranks == pj.ranks
    _close(pt.tt_full(pt_), jt.tt_full(pj), 1e-10)
    if eps == 0.0:
        _close(pt.tt_full(pt_), np.transpose(np.asarray(jt.tt_full(j)), perm),
               1e-10)


def test_sum_many():
    pairs = [_both(_cores(20 + k, r=2)) for k in range(5)]
    w = [0.5, -1.0, 2.0, 0.25, 1.5]
    sj = jt.tt_sum_many([p[0] for p in pairs], w, eps=1e-12)
    st = pt.tt_sum_many([p[1] for p in pairs], w, eps=1e-12)
    assert st.ranks == sj.ranks
    _close(pt.tt_full(st), jt.tt_full(sj), 1e-10)


def test_constructors_default_to_the_card(monkeypatch):
    """tt_from_dense, tt_rand and tt_ones build on the card by default:
    without one they raise rather than fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: pt.tt_from_dense(np.ones((2, 3))),
                 lambda: pt.tt_rand([2, 3]), lambda: pt.tt_ones([2, 3])):
        with pytest.raises(RuntimeError, match="not available"):
            call()
