"""The port's TT-cross constructors (amen_cross_s, greedy_cross) against
the JAX package's.

With a numpy function both packages run the same numpy sweep on the same
values, so cores, nested index sets, statistics and evaluation counts
must be equal bit for bit.  A torch function is held against the exact
function with the JAX tests' own error bars (two implementations of one
density differ in the last bits, and pivoting turns that into different,
equally valid, interpolants)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tt_irt_tpu_torch as tp
from tt_irt_tpu import TT as JTT
from tt_irt_tpu import amen_cross_s as j_amen
from tt_irt_tpu import tt_meshgrid as j_meshgrid
from tt_irt_tpu.constructors.amen_cross import _merge_full as j_merge_full
from tt_irt_tpu.constructors.greedy_cross import greedy_cross as j_greedy
from tt_irt_tpu_torch.constructors.amen_cross import _merge_full


def _grid_fun(grids, body):
    def fun(ind):
        ind = np.asarray(ind)
        x = np.stack([grids[k][ind[:, k]] for k in range(len(grids))], 1)
        return body(x)
    return fun


def _case(name):
    """(inputs for JAX, inputs for the port, numpy fun, keywords)."""
    rng = np.random.default_rng(1234)
    if name == "separable":
        n = [8, 9, 7]
        vecs = [rng.random(nk) + 0.5 for nk in n]

        def fun(ind):
            ind = np.asarray(ind)
            return (vecs[0][ind[:, 0]] * vecs[1][ind[:, 1]]
                    * vecs[2][ind[:, 2]])
        return n, n, fun, dict(tol=1e-10, nswp=6, kickrank=2)
    if name == "inverse_norm_d20":
        def fun(ind):
            ind = np.asarray(ind) + 1.0
            return 1.0 / np.sqrt(np.sum(ind ** 2, axis=1))
        return [32] * 20, [32] * 20, fun, dict(tol=1e-6, nswp=12,
                                               kickrank=4)
    if name in ("elementwise", "elementwise_block"):
        grids = [np.linspace(0.1, 1.0, 9) for _ in range(4)]
        xj = j_meshgrid([jnp.asarray(g) for g in grids])
        xt = tp.tt_meshgrid([torch.from_numpy(g) for g in grids])
        if name == "elementwise":
            def fun(v):
                return np.exp(-np.sum(np.asarray(v) ** 2, axis=1))
            return xj, xt, fun, dict(tol=1e-8, nswp=8, kickrank=3)

        def fun(v):
            s = np.asarray(v).sum(axis=1)
            return np.stack([np.exp(-s * s), np.sin(s), 1.0 / (1.0 + s)], 1)
        return xj, xt, fun, dict(tol=1e-10, tol_exit=1e-8, nswp=8,
                                 kickrank=3, seed=2)
    if name == "aux_elementwise":
        # an index function plus an elementwise function of meshgrid TTs
        # (auxinp/auxfun): the cross of their sum
        grids = [np.linspace(0.1, 1.0, 7) for _ in range(3)]

        def fun(ind):
            return 0.1 * np.asarray(ind).sum(axis=1)

        def auxfun(v):
            return np.exp(-np.sum(np.asarray(v) ** 2, axis=1))
        return [7] * 3, [7] * 3, fun, dict(
            tol=1e-10, nswp=6, kickrank=2,
            aux=(j_meshgrid([jnp.asarray(g) for g in grids]),
                 tp.tt_meshgrid([torch.from_numpy(g) for g in grids]),
                 auxfun))
    if name == "stats":
        grids = [np.linspace(-1, 2, 12) for _ in range(3)]
        return [12] * 3, [12] * 3, _grid_fun(grids, lambda x: x.sum(1)), \
            dict(tol=1e-10, nswp=6, stats=("lr", "sr", "lm", "sm"))
    if name == "tt_initial_guess":
        def fun(ind):
            ind = np.asarray(ind)
            return (np.cos(0.3 * ind[:, 0]) * np.exp(-0.1 * ind[:, 1])
                    + 0.5 * np.sin(0.2 * ind[:, 2]))
        cores = [rng.standard_normal((r1, 10, r2))
                 for r1, r2 in ((1, 3), (3, 3), (3, 1))]
        return [10] * 3, [10] * 3, fun, dict(
            tol=1e-9, nswp=8, kickrank=3,
            y0=(JTT([jnp.asarray(c) for c in cores]),
                tp.tt_from_numpy(cores, device="cpu")))
    if name == "kickrank_zero":
        vecs = [rng.random(9) + 0.5 for _ in range(3)]

        def fun(ind):
            ind = np.asarray(ind)
            return (vecs[0][ind[:, 0]] * vecs[1][ind[:, 1]]
                    * vecs[2][ind[:, 2]] + 0.1 * vecs[0][ind[:, 2]])
        return [9] * 3, [9] * 3, fun, dict(tol=0.0, y0=6, kickrank=0,
                                           nswp=4)
    if name == "index_y0":
        y0 = rng.integers(0, 9, (5, 4))
        grids = [np.linspace(-1, 1, 9) for _ in range(4)]
        return [9] * 4, [9] * 4, _grid_fun(
            grids, lambda x: np.exp(-(x ** 2).sum(1))), dict(
                tol=1e-10, y0=y0, kickrank=0.5, nswp=5, rmax=7)
    if name == "vec_false":
        def fun(ind):
            ind = np.asarray(ind).reshape(-1)
            return float(ind[0]) + 10.0 * float(ind[1]) + 1.0
        return [6, 6], [6, 6], fun, dict(tol=1e-12, vec=False, nswp=4,
                                         kickrank=2)
    if name in ("block_right", "block_left"):
        grids = [np.linspace(-1, 1, 9) for _ in range(5)]

        def body(x):
            s = x.sum(axis=1)
            return np.stack([np.exp(-0.5 * s * s), np.sin(s),
                             1.0 / (6.0 + s)], axis=1)
        return [9] * 5, [9] * 5, _grid_fun(grids, body), dict(
            tol=1e-10, tol_exit=1e-8, y0=4, kickrank=2, nswp=8, seed=1,
            exitdir=1 if name == "block_right" else -1)
    if name == "complex":
        w = np.linspace(0.3, 1.1, 4)

        def fun(ind):
            ind = np.asarray(ind)
            return (1.0 + 0.1 * np.sum(ind, axis=1)) * np.exp(1j * (ind @ w))
        return [9] * 4, [9] * 4, fun, dict(tol=1e-8, nswp=8, kickrank=3,
                                           stats=["li", "si"])
    if name == "dir_backward":
        grids = [np.linspace(0, 1, 8) for _ in range(4)]
        return [8] * 4, [8] * 4, _grid_fun(
            grids, lambda x: np.exp(-x.sum(1)) + x[:, 0] * x[:, 3]), dict(
                tol=1e-10, nswp=6, dir=-1, seed=2, kickrank=2)
    if name == "trunc_cross":
        grids = [np.linspace(-1, 1, 10) for _ in range(5)]
        return [10] * 5, [10] * 5, _grid_fun(
            grids, lambda x: 1.0 / (2.0 + (x ** 2).sum(1))), dict(
                tol=1e-7, nswp=6, trunc="cross", kickrank=3,
                stop_sweep=1)
    raise KeyError(name)


CASES = ["separable", "inverse_norm_d20", "elementwise", "elementwise_block",
         "aux_elementwise", "stats", "tt_initial_guess", "kickrank_zero", "index_y0",
         "vec_false", "block_right", "block_left", "complex",
         "dir_backward", "trunc_cross"]


def _equal(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


def _same_result(rj, rt):
    assert rt.evalcnt == rj.evalcnt
    assert len(rt.tt.cores) == len(rj.tt.cores)
    for cj, ct in zip(rj.tt.cores, rt.tt.cores):
        assert ct.device.type == "cpu"
        _equal(np.asarray(cj), ct.numpy())
    _equal(rj.statvals, rt.statvals)
    _equal(rj.statind, rt.statind)
    assert len(rj.indices) == len(rt.indices)
    for a, b in zip(rj.indices, rt.indices):
        _equal(a, b)


@pytest.mark.parametrize("name", CASES)
def test_amen_cross_bit_for_bit_with_numpy_fun(name):
    inp_j, inp_t, fun, kw = _case(name)
    tol = kw.pop("tol")
    y0 = kw.pop("y0", 4)
    y0j, y0t = y0 if isinstance(y0, tuple) else (y0, y0)
    auxj = auxt = {}
    if "aux" in kw:
        xj, xt, auxfun = kw.pop("aux")
        auxj, auxt = (dict(auxinp=xj, auxfun=auxfun),
                      dict(auxinp=xt, auxfun=auxfun))
    prof = {}
    rj = j_amen(inp_j, fun, tol, y0=y0j, **auxj, **kw)
    rt = tp.amen_cross_s(inp_t, fun, tol, y0=y0t, device="cpu",
                         profile=prof, **auxt, **kw)
    elementwise = bool(auxt) or isinstance(inp_t[0], tp.TT)
    assert (rt.evalcnt[1] > 0) == elementwise
    _same_result(rj, rt)
    assert prof["eval_fun"] > 0 and prof["qrmaxvol"] > 0


def test_headline_cross_bit_for_bit_with_numpy_fun():
    """bench.py::_cross_bench's configuration (d=50, n=192,
    (sum (i+1)^2)^-1/2, tol 1e-4, kickrank 4, stop_sweep 1, seed 0), the
    cross of chip_smoke.py phase 17, with a numpy function: the port's
    cross is the JAX package's bit for bit.  Phase 17 holds the card's
    cross to the port's with this function on the card's host, so to
    the JAX package's there.  One BLAS thread: the sweep's QR results,
    and with them the pivots, depend on the thread count
    (tests/bits_witness.py)."""
    from threadpoolctl import threadpool_limits

    def fun(ind):
        x = np.asarray(ind).astype(np.float64) + 1.0
        return np.sqrt(1.0 / np.sum(x * x, axis=1))

    kw = dict(kickrank=4, seed=0, stop_sweep=1)
    with threadpool_limits(1):
        rj = j_amen([192] * 50, fun, 1e-4, **kw)
        rt = tp.amen_cross_s([192] * 50, fun, 1e-4, device="cpu", **kw)
    _same_result(rj, rt)
    assert rt.evalcnt[0] > 10_000_000 and max(rt.tt.ranks) == 16


@pytest.mark.parametrize("cache", [True, False])
def test_greedy_cross_bit_for_bit_with_numpy_fun(cache):
    grids = [np.linspace(-1, 1, 9) for _ in range(4)]
    fun = _grid_fun(grids, lambda x: np.exp(-0.5 * x.sum(1) ** 2)
                    + 0.3 * np.cos(2 * x.sum(1)))
    kw = dict(nswp=30, tol_exit=1e-7, seed=1, cache=cache)
    _same_result(j_greedy([9] * 4, fun, 1e-8, **kw),
                 tp.greedy_cross([9] * 4, fun, 1e-8, device="cpu", **kw))


def test_torch_funs_meet_the_jax_tests_bars():
    """Torch functions get tensors (int32 indices, f64 values) on the
    cross's device; the results meet the JAX tests' bars against the
    exact function."""
    seen = []

    def inv_norm(ind):
        seen.append((type(ind), ind.dtype))
        return torch.rsqrt(((ind.to(torch.float64) + 1.0) ** 2).sum(1))

    d, n = 20, 32
    res = tp.amen_cross_s([n] * d, inv_norm, 1e-6, nswp=12, kickrank=4,
                          torch_fun=True, device="cpu")
    assert seen[-1] == (torch.Tensor, torch.int32)
    probe = np.random.default_rng(0).integers(0, n, size=(200, d))
    approx = tp.tt_eval_indices(res.tt, torch.from_numpy(probe)).numpy()
    exact = 1.0 / np.sqrt(np.sum((probe + 1.0) ** 2, axis=1))
    assert np.max(np.abs(approx - exact) / exact) < 1e-4

    grids = [np.linspace(0.1, 1.0, 9) for _ in range(4)]
    xs = tp.tt_meshgrid([torch.from_numpy(g) for g in grids])
    res = tp.amen_cross_s(xs, lambda v: torch.stack(
        [torch.exp(-(v * v).sum(1)), torch.sin(v.sum(1))], 1), 1e-10,
        tol_exit=1e-8, nswp=8, kickrank=3, seed=2, device="cpu",
        torch_fun=True, exitdir=1)
    mesh = np.meshgrid(*grids, indexing="ij")
    full = tp.tt_full(res.tt).numpy()
    np.testing.assert_allclose(full[..., 0],
                               np.exp(-sum(m ** 2 for m in mesh)), atol=1e-7)
    np.testing.assert_allclose(full[..., 1], np.sin(sum(mesh)), atol=1e-7)

    g = [np.linspace(-1, 1, 9)] * 4
    gt = torch.from_numpy(g[0])
    res = tp.greedy_cross([9] * 4, lambda ind: torch.exp(
        -0.5 * gt[ind].sum(1) ** 2) + 0.3 * torch.cos(2 * gt[ind].sum(1)),
        1e-8, nswp=30, tol_exit=1e-7, seed=1, torch_fun=True, device="cpu")
    exact = _grid_fun(g, lambda x: np.exp(-0.5 * x.sum(1) ** 2)
                      + 0.3 * np.cos(2 * x.sum(1)))(
        np.indices((9,) * 4).reshape(4, -1).T).reshape((9,) * 4)
    full = tp.tt_full(res.tt).numpy()
    assert np.max(np.abs(full - exact)) / np.max(np.abs(exact)) < 1e-6


def test_cross_device_and_mesh_rules(monkeypatch):
    """The constructors default to the card (no card: they raise, no CPU
    fallback).  mesh= takes a parallel.sample_mesh: an object that is not
    one raises, and so does a non-vectorized fun with a mesh, as in the
    JAX package; a mesh build runs, and equals the single-device build
    with torch batches bit for bit (tests/test_torch_parallel.py holds
    the sharded builds to the JAX package's)."""
    from tt_irt_tpu_torch.parallel import sample_mesh

    fun = _grid_fun([np.linspace(0, 1, 5)] * 3, lambda x: x.sum(1) + 1.0)
    with pytest.raises(TypeError, match="not a sample mesh"):
        tp.amen_cross_s([5] * 3, fun, 1e-8, mesh=object(), device="cpu")
    with pytest.raises(TypeError, match="not a sample mesh"):
        tp.greedy_cross([5] * 3, fun, 1e-8, mesh=object(), device="cpu")
    mesh = sample_mesh(devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="vectorized"):
        tp.amen_cross_s([5] * 3, fun, 1e-8, vec=False, mesh=mesh,
                        device="cpu")
    for cross in (tp.amen_cross_s, tp.greedy_cross):
        one = cross([5] * 3, fun, 1e-8, torch_fun=True, device="cpu")
        sh = cross([5] * 3, fun, 1e-8, mesh=mesh, device="cpu")
        assert sh.evalcnt == one.evalcnt
        for a, b in zip(sh.tt.cores, one.tt.cores):
            assert torch.equal(a, b)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tp.amen_cross_s([5] * 3, fun, 1e-8),
                 lambda: tp.greedy_cross([5] * 3, fun, 1e-8)):
        with pytest.raises(RuntimeError, match="not available"):
            call()


def test_merge_full_matches_tile_repeat_oracle():
    """_merge_full's single-pass writes reproduce the tile/repeat
    little-endian enumeration (and the JAX package's rows) exactly, in
    both column orders."""
    rng = np.random.default_rng(0)
    for rl, n, rr, kl, kr in [(3, 5, 2, 2, 4), (1, 4, 6, 0, 3),
                              (5, 7, 1, 2, 0), (1, 3, 1, 0, 0),
                              (4, 2, 4, 1, 1)]:
        jl = (rng.integers(0, 9, (rl, kl)) if kl
              else np.zeros((rl, 0), np.int64))
        jr = (rng.integers(0, 9, (rr, kr)) if kr
              else np.zeros((rr, 0), np.int64))
        out = _merge_full(jl, n, jr)
        ref = np.empty((rl * n * rr, kl + 1 + kr), np.int64)
        if kl:
            ref[:, :kl] = np.tile(jl, (n * rr, 1))
        ref[:, kl] = np.tile(np.repeat(np.arange(n, dtype=np.int64), rl), rr)
        if kr:
            ref[:, kl + 1:] = np.repeat(jr, rl * n, axis=0)
        np.testing.assert_array_equal(out, ref)
        np.testing.assert_array_equal(_merge_full(jl, n, jr, reverse=True),
                                      ref[:, ::-1])
        np.testing.assert_array_equal(out, j_merge_full(jl, n, jr))
