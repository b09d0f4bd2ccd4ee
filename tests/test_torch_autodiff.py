"""Gradients through the port's transforms at 'f64', against finite
differences and against the JAX package's jax.grad on the same cores and
seeds (tests/test_autodiff.py's problem: d=4, n=9, ranks 1-3-2-3-1, so
the scan path pads ranks and the QR of the stable backward pass sees
exact-zero columns; its 1e-14 I rows keep the backward finite).

Covers tt_irt_sqr (scan, Gram and unrolled paths), its seeds, tt_rt_sqr,
and tt_dirt_sample / tt_dirt_inverse on a two-level DIRT."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tt_irt_tpu as ti
import tt_irt_tpu_torch as tp
from tt_irt_tpu_torch.samplers.irt_scan import _fwd, _prep, stack_padded

D, N = 4, 9
RANKS = [1, 3, 2, 3, 1]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread a process, so that parallel test workers do
    not oversubscribe the cores; the caller's setting comes back."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    grid = np.linspace(-1.0, 1.0, N)
    cores = [rng.standard_normal((RANKS[k], N, RANKS[k + 1]))
             for k in range(D)]
    q = rng.uniform(0.05, 0.95, size=(32, D))
    return grid, cores, q


def _leaves(cores):
    return [torch.tensor(c, requires_grad=True) for c in cores]


def _grids(grid):
    return [torch.from_numpy(grid)] * D


def _loss(grid, q, cores, **kw):
    z, lf = tp.tt_irt_sqr(_grids(grid), tp.TT(cores), q, device="cpu", **kw)
    return torch.sum(z ** 2) + 1e-3 * torch.sum(lf)


def _grad(loss_fn, cores):
    leaves = _leaves(cores)
    return [g.numpy() for g in torch.autograd.grad(loss_fn(leaves), leaves)]


def _jax_grad(grid, q, cores, fn=ti.tt_irt_sqr):
    def loss(cl):
        z, lf = fn([jnp.asarray(grid)] * D, ti.TT(cl), jnp.asarray(q))
        return jnp.sum(z ** 2) + 1e-3 * jnp.sum(lf)

    return [np.asarray(g) for g in
            jax.jit(jax.grad(loss))([jnp.asarray(c) for c in cores])]


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def test_core_grad_matches_finite_differences_and_jax(problem):
    grid, cores, q = problem
    qt = torch.from_numpy(q)
    g = _grad(lambda cl: _loss(grid, qt, cl), cores)
    assert all(np.isfinite(gi).all() for gi in g)
    eps = 1e-6
    for ci, idx in [(0, (0, 2, 1)), (2, (1, 4, 1))]:
        cp = [torch.from_numpy(c.copy()) for c in cores]
        cm = [torch.from_numpy(c.copy()) for c in cores]
        cp[ci][idx] += eps
        cm[ci][idx] -= eps
        fd = float(_loss(grid, qt, cp) - _loss(grid, qt, cm)) / (2 * eps)
        assert abs(fd - g[ci][idx]) <= 1e-4 * max(abs(fd), 1.0)
    for a, b in zip(g, _jax_grad(grid, q, cores)):
        assert _rel(a, b) < 1e-8


def test_grad_agrees_across_paths(problem):
    """The scan path (public), the Gram form without QR and the unrolled
    general path give the same core gradient within 1e-6 of its scale."""
    grid, cores, q = problem
    qt = torch.from_numpy(q)
    g_pub = _grad(lambda cl: _loss(grid, qt, cl), cores)

    def loss_gram(cl):
        cstack, xstack = stack_padded(tp.TT(cl), _grids(grid))
        z, lf = _fwd("sqr", _prep(cstack, xstack, "f64", stable=False), qt)
        return torch.sum(z ** 2) + 1e-3 * torch.sum(lf)

    for other in (_grad(loss_gram, cores),
                  _grad(lambda cl: _loss(grid, qt, cl, use_scan=False),
                        cores)):
        for a, b in zip(g_pub, other):
            assert np.isfinite(b).all()
            assert np.max(np.abs(a - b)) <= 1e-6 * (np.max(np.abs(a))
                                                    + 1e-30)


def test_seed_grad_matches_finite_differences_and_jax(problem):
    grid, cores, q = problem
    tt = tp.tt_from_numpy(cores, "cpu")

    def loss(qq):
        return torch.sum(tp.tt_irt_sqr(_grids(grid), tt, qq,
                                       device="cpu")[0] ** 2)

    qt = torch.tensor(q, requires_grad=True)
    gq = torch.autograd.grad(loss(qt), qt)[0].numpy()
    assert np.isfinite(gq).all()
    eps = 1e-7
    e = np.zeros_like(q)
    e[3, 1] = 1.0
    fd = float(loss(torch.from_numpy(q + eps * e))
               - loss(torch.from_numpy(q - eps * e))) / (2 * eps)
    assert abs(fd - gq[3, 1]) <= 1e-3 * max(abs(fd), 1.0)
    gj = jax.jit(jax.grad(lambda qq: jnp.sum(ti.tt_irt_sqr(
        [jnp.asarray(grid)] * D, ti.TT([jnp.asarray(c) for c in cores]),
        qq)[0] ** 2)))(jnp.asarray(q))
    assert _rel(gq, np.asarray(gj)) < 1e-8


def test_rt_sqr_core_grad_matches_jax(problem):
    grid, cores, q = problem
    x, _ = tp.tt_irt_sqr(_grids(grid), tp.tt_from_numpy(cores, "cpu"),
                         torch.from_numpy(q), device="cpu")
    xs = x.numpy()
    g = _grad(lambda cl: (lambda u, lf: torch.sum(u ** 2)
                          + 1e-3 * torch.sum(lf))(*tp.tt_rt_sqr(
                              _grids(grid), tp.TT(cl), x, device="cpu")),
              cores)
    for a, b in zip(g, _jax_grad(grid, xs, cores, ti.tt_rt_sqr)):
        assert np.isfinite(a).all()
        assert _rel(a, b) < 1e-8


def _dirt_arrays():
    """A two-level spline DIRT of random positive cores (d=3, n=9,
    ranks 1-3-2-1 and 1-2-3-1) on the reference 'n3'."""
    rng = np.random.default_rng(1)
    grid = np.linspace(-3.0, 3.0, 9)
    ranks = ([1, 3, 2, 1], [1, 2, 3, 1])
    levels = [[rng.uniform(0.2, 1.0, (r[k], 9, r[k + 1])) for k in range(3)]
              for r in ranks]
    q = rng.uniform(0.05, 0.95, size=(24, 3))
    return grid, levels, q


def test_dirt_sample_and_inverse_grad_match_jax():
    """Gradients of tt_dirt_sample and tt_dirt_inverse at 'f64' in every
    core of both levels, finite and within 1e-8 relative of jax.grad."""
    grid, levels, q = _dirt_arrays()
    sigma = tp.reference_sigma("n3")
    qn = np.asarray(tp.uniform_to_tnormal(torch.from_numpy(q), sigma))

    def port_stack(f0, f1):
        return tp.DIRT(tp.TT(f0), [tp.TT(f1)], [torch.from_numpy(grid)] * 3,
                       [torch.from_numpy(grid)] * 3,
                       torch.tensor([0.5, 1.0]), reference="n3")

    def jax_stack(f0, f1):
        return ti.DIRT(ti.TT(f0), [ti.TT(f1)], [jnp.asarray(grid)] * 3,
                       [jnp.asarray(grid)] * 3, jnp.asarray([0.5, 1.0]),
                       reference="n3")

    flat = levels[0] + levels[1]
    z, _ = tp.tt_dirt_sample(port_stack(*[[torch.from_numpy(c) for c in lv]
                                          for lv in levels]),
                             torch.from_numpy(qn), precision="f64",
                             device="cpu")
    zs = z.numpy()
    for which, pts in (("sample", qn), ("inverse", zs)):
        def port_loss(cl):
            st = port_stack(cl[:3], cl[3:])
            fn = tp.tt_dirt_sample if which == "sample" else \
                tp.tt_dirt_inverse
            kw = {"precision": "f64"} if which == "sample" else {}
            a, lf = fn(st, torch.from_numpy(pts), device="cpu", **kw)
            return torch.sum(a ** 2) + 1e-3 * torch.sum(lf)

        def jax_loss(cl):
            st = jax_stack(cl[:3], cl[3:])
            if which == "sample":
                a, lf = ti.tt_dirt_sample(st, jnp.asarray(pts),
                                          precision="f64")
            else:
                a, lf = ti.tt_dirt_inverse(st, jnp.asarray(pts))
            return jnp.sum(a ** 2) + 1e-3 * jnp.sum(lf)

        g = _grad(port_loss, flat)
        gj = jax.jit(jax.grad(jax_loss))([jnp.asarray(c) for c in flat])
        for a, b in zip(g, gj):
            assert np.isfinite(a).all(), which
            assert _rel(a, np.asarray(b)) < 1e-8, which
