"""The port's inverse-diffusion model (models/diffusion.py) against the
JAX package's at meshlevel 0: the numpy fields bit for bit, the FEM
pieces and the exact likelihood within 1e-12 relative, and
tests/test_als_cross.py's constant-coefficient and manufactured-solution
tests."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tt_irt_tpu.models import diffusion as jdf
from tt_irt_tpu_torch.models import diffusion as tdf

REL = 1e-12


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread a process: the module's tensors are small and
    its operations many, so parallel test workers of eight threads each
    would oversubscribe the cores.  The caller's setting comes back
    afterwards."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def probs():
    return (jdf.DiffusionProblem(meshlevel=0, tol_kle=3e-2),
            tdf.DiffusionProblem(meshlevel=0, tol_kle=3e-2, device="cpu"))


def _close(got, ref, rel=REL):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    err = np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-300)
    assert err < rel, err


def test_numpy_fields_equal_jax(probs):
    pj, pt = probs
    assert (pt.n, pt.h, pt.kle_dim) == (pj.n, pj.h, pj.kle_dim)
    for name in ("p1", "bound", "bound_left", "interior", "lam", "phi",
                 "phil"):
        np.testing.assert_array_equal(getattr(pt, name), getattr(pj, name))
    for a, b in zip(pt.mass1, pj.mass1):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(pt.wg.numpy(), np.asarray(pj.wg))
    np.testing.assert_array_equal(pt.wm.numpy(), np.asarray(pj.wm))
    np.testing.assert_array_equal(pt.pua(), pj.pua())
    np.testing.assert_array_equal(tdf.lgwt(7, -1.5, 2.0)[0],
                                  jdf.lgwt(7, -1.5, 2.0)[0])


def _fields(prob, m, seed):
    y = np.random.default_rng(seed).uniform(-np.sqrt(3), np.sqrt(3),
                                            (m, prob.kle_dim))
    return y, np.exp(np.sqrt(prob.sigma) * (y @ prob.phil.T))


def test_fem_pieces_match_jax(probs):
    """assemble_matrix (batched), solve_one, observe and exit_flux."""
    pj, pt = probs
    _, cn = _fields(pj, 3, 0)
    n = pj.n
    aj = np.stack([np.asarray(jdf.assemble_matrix(
        jnp.asarray(c.reshape(n, n)), pj.wg, pj.wm)) for c in cn])
    at = tdf.assemble_matrix(torch.from_numpy(cn.reshape(3, n, n)), pt.wg,
                             pt.wm)
    _close(at, aj)
    for c in cn:
        uj = np.asarray(pj.solve_one(jnp.asarray(c)))
        ut = pt.solve_one(c)
        _close(ut, uj)
        _close(pt.observe(ut), pj.observe(jnp.asarray(uj)))
        _close(pt.exit_flux(torch.from_numpy(c), ut).reshape(()),
               pj.exit_flux(jnp.asarray(c), jnp.asarray(uj)))
    # batched observations and fluxes equal the per-field ones
    ub = torch.stack([pt.solve_one(c) for c in cn])
    _close(pt.observe(ub), np.stack([pt.observe(u).numpy() for u in ub]))
    _close(pt.exit_flux(torch.from_numpy(cn), ub),
           np.stack([pt.exit_flux(torch.from_numpy(c), u).numpy()
                     for c, u in zip(cn, ub)]))


def test_likelihood_matches_jax(probs):
    """likelihood_fn over 100 rows in blocks of 32 (the last one short):
    [logL, flux, flux > 1.5] within 1e-12 relative per column."""
    pj, pt = probs
    y, _ = _fields(pj, 100, 1)
    q_obs = np.random.default_rng(2).normal(0.5, 0.1, pj.m0 ** 2)
    oj = np.asarray(pj.likelihood_fn(q_obs, block=32)(jnp.asarray(y)))
    ot = pt.likelihood_fn(q_obs, block=32)(torch.from_numpy(y))
    assert ot.shape == (100, 3) and ot.dtype == torch.float64
    for c in range(3):
        _close(ot[:, c], oj[:, c])


def test_assem_solve_fun_matches_jax(probs):
    """The ALS-Cross callback in values and indices modes: U, A and F
    within 1e-12 relative of the JAX package's (A comes back as one
    tensor on the device; later calls return U alone)."""
    pj, pt = probs
    _, cn = _fields(pj, 5, 3)
    ci = cn.T[None]                                  # (1, Nxc, r)
    uj, aj, fj = pj.assem_solve_fun()(ci)
    fn = pt.assem_solve_fun()
    ut, at, ft = fn(ci)
    _close(ut, uj)
    _close(at, np.stack(aj))
    _close(ft, fj)
    _close(fn(ci), uj)
    ygrids = [jdf.lgwt(4, -np.sqrt(3), np.sqrt(3))[0]] * pj.kle_dim
    ind = np.random.default_rng(4).integers(0, 4, (6, pj.kle_dim))
    uj = pj.assem_solve_fun(ygrids=ygrids)(ind)[0]
    _close(pt.assem_solve_fun(ygrids=ygrids)(ind)[0], uj)


def test_fem_constant_coefficient_exact():
    """tests/test_als_cross.py: with a = 1 the DN solution is u = 1 - x
    exactly and the exit flux is 1."""
    prob = tdf.DiffusionProblem(meshlevel=0, device="cpu")
    ones = torch.ones((prob.n * prob.n,), dtype=torch.float64)
    u = prob.solve_one(ones)
    expect = (1.0 - prob.p1)[:, None] * np.ones((1, prob.n))
    np.testing.assert_allclose(u.numpy().reshape(prob.n, prob.n), expect,
                               atol=1e-10)
    np.testing.assert_allclose(float(prob.exit_flux(ones, u)), 1.0,
                               atol=1e-10)


def test_fem_mms_quadratic():
    """tests/test_als_cross.py: the meshlevel-0 and meshlevel-1 solutions
    of the first KLE mode agree on the coarse nodes within 5e-3."""
    p0 = tdf.DiffusionProblem(meshlevel=0, device="cpu")
    p1 = tdf.DiffusionProblem(meshlevel=1, device="cpu")
    y = np.zeros(p0.kle_dim)
    y[0] = 1.0
    c0 = np.exp(np.sqrt(p0.sigma) * (p0.phil @ y))
    y1 = np.concatenate([y, np.zeros(max(p1.kle_dim - y.shape[0], 0))])
    c1 = np.exp(np.sqrt(p1.sigma) * (p1.phil @ y1[:p1.kle_dim]))
    u0 = p0.solve_one(c0).numpy().reshape(p0.n, p0.n)
    u1 = p1.solve_one(c1).numpy().reshape(p1.n, p1.n)
    assert np.max(np.abs(u1[::2, ::2] - u0)) < 5e-3


def test_log_coefficient_and_cross_equal_jax_bit_for_bit():
    """At meshlevel 1 (KLE d=8), phase 24's settings: the log-coefficient
    TT equals the JAX example's ``tt_sum_many`` of the same rank-one terms
    bit for bit, and so does the coefficient cross on it with the
    example's numpy exp (ny 7, rpi 8, three sweeps, kickrank 2).  That
    cross is unconverged at these settings, so a change in the last bits
    of the log-coefficient moves it, and every surrogate built on it."""
    import tt_irt_tpu as ti
    import tt_irt_tpu_torch as tp
    from tt_irt_tpu.ops.tt import TT, tt_sum_many

    tol = 7.6742e-03 * 4.0 ** -2
    pj = jdf.DiffusionProblem(meshlevel=1, tol_kle=3 * tol)
    pt = tdf.DiffusionProblem(meshlevel=1, tol_kle=3 * tol, device="cpu")
    ygrids = pt.gauss_grids(7)
    terms = []
    for i in range(pj.kle_dim):
        cores = [jnp.asarray((pj.phil[:, i] * np.sqrt(pj.sigma))
                             [None, :, None])]
        for j, g in enumerate(ygrids):
            cores.append(jnp.asarray(g)[None, :, None] if j == i
                         else jnp.ones((1, len(g), 1)))
        terms.append(TT(cores))
    la_j = tt_sum_many(terms, eps=1e-12)
    la_t = pt.log_coefficient_tt(ygrids)
    for a, b in zip(la_j.cores, la_t.cores):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    args = (min(tol, 1e-4) * 0.1,)
    kw = dict(y0=8, nswp=3, kickrank=2)
    cj = ti.amen_cross_s([la_j], lambda v: np.exp(np.asarray(v)[:, 0]),
                         *args, **kw).tt
    ct = tp.amen_cross_s([la_t], lambda v: np.exp(v[:, 0]), *args,
                         device="cpu", **kw).tt
    assert tuple(cj.ranks) == tuple(ct.ranks)
    for a, b in zip(cj.cores, ct.cores):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
