"""The port's one-call front end (api.py) on tests/test_api.py's banded
Gaussian (d=6, n=17, tol 1e-6).  The qmc=True single-level path against
the JAX package on the same lattice: both crosses first reach the same
ranks (a torch logpost may differ from the JAX one in the last bit, and
the cross's pivots follow the last bits), then the samples and weights
agree within 10x the JAX package's own spread under one ulp of logpost,
and the port's sampler on the JAX package's TT within 1e-8.  The
pseudo-random paths ('mcmc', the two-level DIRT) are held to
tests/test_api.py's bars, since a torch.Generator does not give the JAX
keys' numbers."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tt_irt_tpu as ti
import tt_irt_tpu_torch as tp

GRIDS = [np.linspace(-4, 4, 17)] * 6


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread a process, so that parallel test workers do
    not oversubscribe the cores; the caller's setting comes back."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def lp(x):
    return -0.5 * (jnp.sum(x * x, axis=1)
                   + 0.8 * jnp.sum(x[:, :-1] * x[:, 1:], axis=1))


def lp_torch(x):
    return -0.5 * (torch.sum(x * x, dim=1)
                   + 0.8 * torch.sum(x[:, :-1] * x[:, 1:], dim=1))


def test_single_level_mcmc():
    res = tp.sample_posterior(lp_torch, GRIDS, 4096, tol=1e-6, seed=0,
                              device="cpu")
    assert res.samples.shape == (4096, 6)
    assert res.weights is None and res.num_rejects is not None
    assert res.ess_inv < 1.05 and res.hellinger < 0.1
    assert isinstance(res.transport, tp.TT) and res.evalcnt.sum() > 0
    cov = np.linalg.inv(np.eye(6) + 0.4 * (np.eye(6, k=1) + np.eye(6, k=-1)))
    emp = np.cov(res.samples.numpy().T)
    assert np.abs(emp - cov).max() < 0.1
    assert "N/ESS" in repr(res)


def test_qmc_iw_matches_jax():
    """Same ranks as the JAX package's run; the
    port's sampler on the JAX package's own TT gives its samples within
    1e-8; the port's whole pipeline is within 10x the JAX package's own
    spread under one ulp of logpost.  That spread is real: at tol 1e-6
    the cross moves its TT by about 1e-8 relative under one ulp of its
    function (5.5e-8 in samples), and torch's exp differs from XLA's in
    the last bit (with the JAX function itself, on one thread, the
    port's cross is the JAX package's bit for bit:
    tests/test_torch_cross.py)."""
    rj = ti.sample_posterior(lp, GRIDS, 2048, tol=1e-6, qmc=True, seed=1)
    rt = tp.sample_posterior(lp_torch, GRIDS, 2048, tol=1e-6, qmc=True,
                             seed=1, device="cpu")
    assert rt.weights is not None and rt.num_rejects is None
    np.testing.assert_allclose(rt.weights.sum(), 1.0, rtol=1e-12)
    assert list(rt.transport.ranks) == list(rj.transport.ranks)
    assert int(rt.evalcnt.sum()) > 0
    zj = np.asarray(rj.samples)
    tj = tp.tt_from_numpy([np.asarray(c) for c in rj.transport.cores], "cpu")
    q = torch.from_numpy(tp.qmcnodes(6, 11, seed=1))
    z_on_jax_tt, _ = tp.tt_irt_sqr(GRIDS, tj, q, device="cpu")
    assert float(np.max(np.abs(z_on_jax_tt.numpy() - zj))) < 1e-8
    ru = ti.sample_posterior(lambda x: lp(x) * (1.0 + 2.0 ** -52), GRIDS,
                             2048, tol=1e-6, qmc=True, seed=1)
    for port, ref, ulp in ((rt.samples.numpy(), zj, ru.samples),
                           (rt.weights, rj.weights, ru.weights)):
        spread = float(np.max(np.abs(np.asarray(ulp) - ref)))
        err = float(np.max(np.abs(port - ref)))
        assert err <= 10.0 * spread + 1e-12, (err, spread)
    assert abs(rt.ess_inv - rj.ess_inv) < 1e-6


def test_dirt_mode_and_refusal():
    res = tp.sample_posterior(
        lp_torch, GRIDS, 2048, beta=[0.3, 1.0], seed=2, reference="n3",
        dirt_kwargs=dict(stoptol=0.2, nswp=2, kickrank=1, testsamples=0),
        device="cpu")
    assert isinstance(res.transport, tp.DIRT)
    assert res.ess_inv < 1.1
    assert res.samples.shape == (2048, 6) and res.num_rejects is not None
    with pytest.raises(ValueError):
        tp.sample_posterior(lp_torch, GRIDS, 64, debias="nope", device="cpu")
