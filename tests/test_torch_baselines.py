"""The port's DRAM and SVN baselines (samplers/dram.py, samplers/svn.py)
held to tests/test_baselines.py's four statistical bars on the same
targets.  A torch.Generator replaces the JAX key, so the DRAM chains are
compared by those bars, not number for number.  SVN draws nothing, so
its particles and gradient norm are also held to the JAX package's on
the same x0, within 1e-8."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tt_irt_tpu.samplers.svn import svn as jax_svn
from tt_irt_tpu_torch.samplers.dram import dram
from tt_irt_tpu_torch.samplers.svn import svn


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread a process, so that parallel test workers do
    not oversubscribe the cores; the caller's setting comes back."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_dram_gaussian_moments():
    cov = np.array([[1.0, 0.6], [0.6, 1.5]])
    prec = torch.from_numpy(np.linalg.inv(cov))
    mu = torch.tensor([1.0, -2.0], dtype=torch.float64)

    def lp(x):
        dx = x - mu
        return -0.5 * torch.einsum("md,de,me->m", dx, prec, dx)

    res = dram(lp, torch.zeros((8, 2)), 4000, burnin=1000, device="cpu",
               generator=torch.Generator().manual_seed(0))
    samples = res.chain.reshape(-1, 2).numpy()
    assert res.chain.shape == (3000, 8, 2)
    assert 0.1 < float(res.accept_rate) < 0.9
    np.testing.assert_allclose(samples.mean(axis=0), mu.numpy(), atol=0.15)
    np.testing.assert_allclose(np.cov(samples.T), cov, atol=0.35)


def test_dram_bounds_respected():
    def lp(x):
        return -0.5 * torch.sum(x * x, dim=1)

    res = dram(lp, torch.zeros((4, 2)) + 0.5, 1000, device="cpu",
               generator=torch.Generator().manual_seed(1),
               bounds=(np.array([0.0, 0.0]), np.array([1.0, 1.0])))
    c = res.chain.numpy()
    assert c.min() >= 0.0 and c.max() <= 1.0


def test_svn_gaussian_collapse():
    cov = np.array([[1.0, 0.5], [0.5, 2.0]])
    prec = torch.from_numpy(np.linalg.inv(cov))

    def nlp(x):
        return 0.5 * x @ prec @ x

    x0 = np.random.default_rng(0).standard_normal((64, 2)) * 3.0
    res = svn(nlp, x0, steps=40, step_size=0.7, device="cpu")
    p = res.particles.numpy()
    assert np.all(np.isfinite(p)) and np.isfinite(float(res.grad_norm))
    np.testing.assert_allclose(p.mean(axis=0), [0, 0], atol=0.3)
    assert np.all(np.abs(np.cov(p.T) - cov) < 0.8)


def test_svn_gershgorin_spd_mode():
    prec = np.array([[2.0, 0.6], [0.6, 1.0]])
    prec_t = torch.from_numpy(prec)

    def nlp(xi):
        return 0.5 * xi @ prec_t @ xi

    x0 = np.random.default_rng(0).standard_normal((64, 2)) * 2.0 + 1.0
    res = svn(nlp, x0, steps=60, step_size=0.7, spd_mode="gershgorin",
              device="cpu")
    p = res.particles.numpy()
    np.testing.assert_allclose(np.cov(p.T), np.linalg.inv(prec), atol=0.35)
    np.testing.assert_allclose(p.mean(axis=0), 0.0, atol=0.25)
    with pytest.raises(ValueError):
        svn(nlp, x0, steps=1, spd_mode="nope", device="cpu")


def _gauss(xp):
    prec = np.linalg.inv(np.array([[1.0, 0.5], [0.5, 2.0]]))
    if xp is torch:
        prec = torch.from_numpy(prec)
    return lambda x: 0.5 * x @ prec @ x


def _banana(xp):
    # non-quadratic: each particle's Hessian differs, so the kernel's
    # k^2-weighted Hessian sum is exercised beside its grad-k term
    def nlp(x):
        return 0.5 * x[0] ** 2 + 2.0 * (x[1] - 0.5 * x[0] ** 2) ** 2 \
            + 0.25 * xp.sum(x ** 4)
    return nlp


@pytest.mark.parametrize("spd_mode", ["eigh", "gershgorin"])
@pytest.mark.parametrize("target", ["gauss", "banana"])
def test_svn_matches_jax_package(target, spd_mode):
    """40 SVN steps from one x0 in the port and in the JAX package: the
    particles and the gradient norm agree within 1e-8.  The banana
    target runs with the trust region and the box clip active."""
    make = {"gauss": _gauss, "banana": _banana}[target]
    x0 = np.random.default_rng(0).standard_normal((32, 2)) * 2.0
    kw = dict(steps=40, step_size=0.7, spd_mode=spd_mode)
    if target == "banana":
        kw.update(max_step=0.3, bounds=(np.array([-2.0, -1.0]),
                                        np.array([2.0, 2.5])))
    ref = jax_svn(make(jnp), jnp.asarray(x0), **kw)
    res = svn(make(torch), x0, device="cpu", **kw)
    np.testing.assert_allclose(res.particles.numpy(),
                               np.asarray(ref.particles), rtol=0, atol=1e-8)
    np.testing.assert_allclose(float(res.grad_norm), float(ref.grad_norm),
                               rtol=1e-8, atol=1e-12)
    if target == "banana":
        # the clip and the trust region moved particles: not a no-op run
        assert np.abs(res.particles.numpy() - x0).max() > 0.3
