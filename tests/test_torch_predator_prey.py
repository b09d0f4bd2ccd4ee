"""The port's predator-prey model (models/predator_prey.py) against the
JAX package's: the right-hand side and the log-likelihood (fixed-step
and adaptive) within 1e-10, the paper's observations equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tt_irt_tpu.models import predator_prey as jpp
from tt_irt_tpu_torch.models import predator_prey as tpp


@pytest.fixture(scope="module")
def problems():
    return (jpp.PredatorPreyProblem(seed=0, steps_per_interval=16),
            tpp.PredatorPreyProblem(seed=0, steps_per_interval=16))


def _points(m=8, seed=3):
    rng = np.random.default_rng(seed)
    return np.clip(1.0 + 0.15 * rng.standard_normal((m, 8)), 0.6, 1.6)


def test_pp_rhs_matches_jax():
    rng = np.random.default_rng(1)
    params = np.array([50.0, 5.0, 0.6, 100.0, 1.2, 25.0, 0.5, 0.3]) * \
        rng.uniform(0.7, 1.3, (16, 8))
    y = rng.uniform(1.0, 80.0, (16, 2))
    a = np.asarray(jpp.pp_rhs(0.0, jnp.asarray(y), jnp.asarray(params)))
    b = tpp.pp_rhs(0.0, torch.from_numpy(y), torch.from_numpy(params))
    np.testing.assert_allclose(b.numpy(), a, rtol=1e-12, atol=1e-10)


def test_problem_data_and_paper_observables(problems):
    pj, pt = problems
    np.testing.assert_allclose(pt.data, pj.data, rtol=0, atol=1e-10)
    np.testing.assert_array_equal(tpp.paper_observables(),
                                  jpp.paper_observables())
    a = jpp.PredatorPreyProblem(use_paper_data=True)
    b = tpp.PredatorPreyProblem(use_paper_data=True)
    np.testing.assert_array_equal(b.data, a.data)
    assert b.d == 8 and len(b.grids()) == 8
    np.testing.assert_array_equal(b.grids()[0], a.grids()[0])


@pytest.mark.parametrize("adaptive", [False, True])
def test_pp_loglikelihood_matches_jax(problems, adaptive):
    pj, pt = problems
    x = _points()
    ind = np.asarray(pj.ind)
    a = np.asarray(jpp.pp_loglikelihood(
        jnp.asarray(x), jnp.asarray(pj.data), jnp.asarray(pj.obs_times),
        pj.sigma_n, jnp.asarray(pj.xtrue), ind, 16, adaptive=adaptive))
    b = tpp.pp_loglikelihood(torch.from_numpy(x), pt.data, pt.obs_times,
                             pt.sigma_n, pt.xtrue, pt.ind, 16,
                             adaptive=adaptive)
    assert b.dtype == torch.float64 and b.shape == (8,)
    np.testing.assert_allclose(b.numpy(), a, rtol=1e-12, atol=1e-10)


def test_log_posterior_and_tempered_ratio(problems):
    pj, pt = problems
    x = _points(6, seed=5)
    a = np.asarray(pj.log_posterior_fn()(jnp.asarray(x)))
    b = pt.log_posterior_fn()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(b, a, rtol=1e-12, atol=1e-10)
    ra = np.asarray(pj.tempered_logratio_fn()(jnp.asarray(x), 0.01, 0.1))
    rb = pt.tempered_logratio_fn()(torch.from_numpy(x), 0.01, 0.1).numpy()
    np.testing.assert_allclose(rb, ra, rtol=1e-12, atol=1e-10)
    # the normalized truth is the likelihood's peak over these points
    ones = pt.log_posterior_fn()(torch.ones((1, 8), dtype=torch.float64))
    assert float(ones[0]) >= float(b.max()) - 1e-9
