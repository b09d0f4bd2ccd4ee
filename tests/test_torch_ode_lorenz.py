"""The port's ODE integrators (fixed-step observed, adaptive
Dormand-Prince) and the full Lorenz problem against the JAX package on
the same numpy states."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tt_irt_tpu.models.lorenz as jl
import tt_irt_tpu.models.ode as jo
import tt_irt_tpu_torch as tp
import tt_irt_tpu_torch.models.ode as to


def _states(m=64, d=8, seed=0):
    return 1.0 + 0.5 * np.random.default_rng(seed).standard_normal((m, d))


def _lorenz_j(t, x):
    return jl.lorenz_rhs(t, x)


def _decay_j(t, y):
    """A time-dependent, stiffening right-hand side."""
    return -(1.0 + 5.0 * t) * y + jnp.sin(3.0 * t)


def _decay_t(t, y):
    return -(1.0 + 5.0 * t) * y + torch.sin(3.0 * t)


def test_dopri5_step_and_pair():
    """One fixed step and one embedded pair: equal to 1e-14."""
    y = _states()
    a = to.dopri5_step(tp.lorenz_rhs, torch.from_numpy(y), 0.0, 0.01)
    b = jo.dopri5_step(_lorenz_j, jnp.asarray(y), 0.0, 0.01)
    assert np.max(np.abs(a.numpy() - np.asarray(b))) < 1e-14
    y5, err = to._dp45_pair(tp.lorenz_rhs, torch.from_numpy(y), 0.0, 0.02)
    y5j, errj = jo._dp45_pair(_lorenz_j, jnp.asarray(y), 0.0, 0.02)
    assert np.max(np.abs(y5.numpy() - np.asarray(y5j))) < 1e-14
    assert np.max(np.abs(err.numpy() - np.asarray(errj))) < 1e-14


@pytest.mark.parametrize("method", ["dopri5", "rk4"])
def test_integrate_observed(method):
    """States at four observation times, (T, M, n): 1e-12."""
    y = _states()
    times = np.array([0.0, 0.03, 0.05, 0.1])
    a = tp.integrate_observed(tp.lorenz_rhs, torch.from_numpy(y),
                              torch.from_numpy(times), 5, method)
    b = jo.integrate_observed(_lorenz_j, jnp.asarray(y), jnp.asarray(times),
                              5, method)
    assert a.shape == (4, 64, 8)
    assert np.max(np.abs(a.numpy() - np.asarray(b))) < 1e-12


@pytest.mark.parametrize("rhs,rtol", [("lorenz", 1e-6), ("lorenz", 1e-9),
                                      ("decay", 1e-6)])
def test_integrate_adaptive_takes_the_same_steps(rhs, rtol):
    """The host loop keeps the JAX while_loop's step-size control: the
    same accepted-and-rejected step counts per row and the same number
    of iterations; states equal to 1e-12 (the Lorenz rows scattered to
    need different step counts)."""
    y = _states(seed=1) * np.linspace(0.5, 3.0, 64)[:, None]
    ft, fj, t1 = ((tp.lorenz_rhs, _lorenz_j, 0.3) if rhs == "lorenz"
                  else (_decay_t, _decay_j, 2.0))
    a, sa = to.integrate_adaptive(ft, torch.from_numpy(y), 0.0, t1,
                                  rtol=rtol, return_stats=True)
    b, sb = jo.integrate_adaptive(fj, jnp.asarray(y), 0.0, t1, rtol=rtol,
                                  return_stats=True)
    assert np.array_equal(sa["nsteps"].numpy(), np.asarray(sb["nsteps"]))
    assert sa["iters"] == int(sb["iters"])
    assert np.max(np.abs(a.numpy() - np.asarray(b))) < 1e-12
    assert np.allclose(sa["t"].numpy(), t1)


def test_integrate_observed_adaptive():
    y = _states(seed=2)
    times = [0.0, 0.04, 0.1]
    a = tp.integrate_observed_adaptive(tp.lorenz_rhs, torch.from_numpy(y),
                                       times, rtol=1e-8)
    b = jo.integrate_observed_adaptive(_lorenz_j, jnp.asarray(y),
                                       jnp.asarray(times), rtol=1e-8)
    assert a.shape == (3, 64, 8)
    assert np.max(np.abs(a.numpy() - np.asarray(b))) < 1e-12


@pytest.mark.parametrize("adaptive", [False, True])
def test_lorenz_problem_matches_jax(adaptive):
    """LorenzProblem(d=10, n=9, a=4, adaptive): the same synthesized
    truth, the same data to 1e-14 (one fixed-step integration each),
    grids, log-likelihood (fixed or adaptive), log-posterior and
    tempered log-ratio (1e-10 relative)."""
    kw = dict(d=10, n=9, a=4.0, seed=3, adaptive=adaptive)
    pt_, pj = tp.LorenzProblem(**kw), jl.LorenzProblem(**kw)
    assert np.max(np.abs(pt_.data - pj.data)) < 1e-14
    assert np.array_equal(pt_.x0true, pj.x0true)
    assert np.array_equal(pt_.beta, pj.beta)
    for gt, gj in zip(pt_.grids(), pj.grids()):
        assert np.array_equal(gt, gj) and gt.shape == (9,)
    x = np.asarray(pt_.x0true)[None, :] + 0.3 * np.random.default_rng(
        4).standard_normal((32, 10))
    a = pt_.log_posterior_fn()(torch.from_numpy(x)).numpy()
    b = np.asarray(pj.log_posterior_fn()(jnp.asarray(x)))
    assert np.max(np.abs(a - b)) < 1e-10 * np.max(np.abs(b))
    a = pt_.tempered_logratio_fn()(torch.from_numpy(x), 0.01, 0.1).numpy()
    b = np.asarray(pj.tempered_logratio_fn()(jnp.asarray(x), 0.01, 0.1))
    assert np.max(np.abs(a - b)) < 1e-10 * np.max(np.abs(b))
    lt = tp.lorenz_ll(torch.from_numpy(x), torch.from_numpy(pt_.data), 0.1,
                      adaptive=adaptive, rtol=1e-8)
    lj = jl.lorenz_ll(jnp.asarray(x), jnp.asarray(pj.data), 0.1,
                      adaptive=adaptive, rtol=1e-8)
    assert np.max(np.abs(lt.numpy() - np.asarray(lj))) < 1e-10 * np.max(
        np.abs(np.asarray(lj)))
