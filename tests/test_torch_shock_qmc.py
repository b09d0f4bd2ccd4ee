"""The port's QMC nodes (samplers/qmc.py) and shock-absorber model
(models/shock_absorber.py) against the JAX package's: nodes bit for bit,
densities and quantiles within 1e-12, and the TT-MH pipeline from one
cross TT within 1e-10."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tt_irt_tpu as ti
import tt_irt_tpu_torch as tp
from tt_irt_tpu.models import shock_absorber as jsa
from tt_irt_tpu.samplers import qmc as jqmc
from tt_irt_tpu_torch.models import shock_absorber as tsa
from tt_irt_tpu_torch.samplers import qmc as tqmc


@pytest.mark.parametrize("m,d", [(2, 3), (8, 5), (11, 8)])
def test_cbc_lattice_bit_for_bit(m, d):
    assert tqmc.cbc_lattice(m, d) == jqmc.cbc_lattice(m, d)
    assert tqmc.cbc_lattice(m, d, 1.5) == jqmc.cbc_lattice(m, d, 1.5)


@pytest.mark.parametrize("method", ["sobol", "lattice", "korobov"])
def test_qmcnodes_bit_for_bit(method):
    for d, log2n, seed in ((8, 10, 7), (3, 6, 0)):
        a = jqmc.qmcnodes(d, log2n, seed=seed, method=method)
        b = tp.qmcnodes(d, log2n, seed=seed, method=method)
        assert a.dtype == b.dtype and a.shape == b.shape == (1 << log2n, d)
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="unknown QMC"):
        tp.qmcnodes(2, 3, method="halton")


@pytest.fixture(scope="module")
def shock():
    """Both packages' models on the paper covariates, and one cross TT:
    the density on the grid as a numpy function (the port's model on the
    CPU, numpy in and out), crossed by both packages (bit for bit, so the
    TT-MH below starts from one TT)."""
    cj = jsa.ShockConfig(d=6, n=17, x=jsa.paper_covariates())
    ct = tsa.ShockConfig(d=6, n=17, x=tsa.paper_covariates())
    np.testing.assert_array_equal(ct.x, cj.x)
    lpt = ct.log_posterior_fn()
    grids = cj.grids()

    def cross_fun(ind):
        ind = np.asarray(ind)
        theta = np.stack([grids[k][ind[:, k]] for k in range(8)], axis=1)
        return torch.exp(lpt(torch.from_numpy(theta))).numpy()

    kw = dict(tol_exit=0.05, y0=8, kickrank=2, nswp=20, seed=0)
    rj = ti.amen_cross_s([17] * 8, cross_fun, 0.0, **kw)
    rt = tp.amen_cross_s([17] * 8, cross_fun, 0.0, device="cpu", **kw)
    assert rt.evalcnt == rj.evalcnt
    for a, b in zip(rj.tt.cores, rt.tt.cores):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    return cj, ct, grids, rj.tt, rt.tt


def test_shock_log_posterior_and_quantiles(shock):
    cj, ct, grids, _, _ = shock
    rng = np.random.default_rng(3)
    theta = np.stack([rng.uniform(g[0], g[-1], 256) for g in grids], 1)
    theta[:, -1] = rng.uniform(0.5, 12.0, 256)
    a = np.asarray(cj.log_posterior_fn()(jnp.asarray(theta)))
    b = ct.log_posterior_fn()(torch.from_numpy(theta)).numpy()
    np.testing.assert_allclose(b, a, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(
        tsa.log_posterior(torch.from_numpy(theta), ct).numpy(), a,
        rtol=1e-12, atol=1e-12)
    z = theta.copy()
    z[:, 0] = rng.normal(np.log(30796.0), 0.2, 256)
    z[:, 1:7] = rng.normal(0.0, 0.1, (256, 6))
    z[:, -1] = rng.uniform(1.5, 5.0, 256)
    w = rng.uniform(0.1, 2.0, 256)
    xp = rng.normal(0.0, 0.3, 6)
    for kw in ({}, {"is_weight": w}, {"x_pred": xp, "q": 0.1}):
        qa = jsa.quantile_qoi(jnp.asarray(z), **{
            k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
            for k, v in kw.items()})
        qb = tsa.quantile_qoi(torch.from_numpy(z), **kw)
        for x, y in zip(qa, qb):
            np.testing.assert_allclose(float(y), float(x), rtol=1e-12)


def test_ttmh_from_one_tt(shock):
    """tt_irt_lin at 2^10 seeds, the exact density, MH on the same
    uniforms and the quantiles: within 1e-10 of the JAX package."""
    cj, ct, grids, ttj, ttt = shock
    m = 1 << 10
    rng = np.random.default_rng(42)
    z = rng.uniform(size=(m, 8))
    u = rng.uniform(size=m - 1)
    yj, lfj = ti.tt_irt_lin(grids, ttj, jnp.asarray(z))
    yt, lft = tp.tt_irt_lin(grids, ttt, torch.from_numpy(z),
                            precision="f64", device="cpu")
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(lft.numpy(), np.asarray(lfj), rtol=0,
                               atol=1e-10)
    lej = cj.log_posterior_fn()(yj)
    let = ct.log_posterior_fn()(yt)
    np.testing.assert_allclose(let.numpy(), np.asarray(lej), rtol=0,
                               atol=1e-10)
    mj = ti.mcmc_prune(yj, lej, lfj, u=jnp.asarray(u))
    mt = tp.mcmc_prune(yt, let, lft, u=torch.from_numpy(u))
    assert mt.num_rejects == int(mj.num_rejects)
    np.testing.assert_allclose(mt.y.numpy(), np.asarray(mj.y), rtol=0,
                               atol=1e-10)
    qa = jsa.quantile_qoi(mj.y)
    qb = tsa.quantile_qoi(mt.y)
    for x, y in zip(qa, qb):
        np.testing.assert_allclose(float(y), float(x), rtol=1e-10)
    tau_j = np.asarray(ti.iact(np.asarray(mj.y)))
    tau_t = np.asarray(tp.iact(mt.y))
    np.testing.assert_allclose(tau_t, tau_j, rtol=1e-10)


def test_port_ttmh_meets_the_jax_tests_bars(shock):
    """The port's own cross, on a torch density, feeds TT-MH and QMC-IW
    that meet tests/test_shock_absorber.py's bars (at 2^14 seeds)."""
    _, ct, grids, _, _ = shock
    lp = ct.log_posterior_fn()
    gmat = torch.from_numpy(np.stack(grids, axis=1))

    def cross_fun(ind):
        return torch.exp(lp(torch.gather(gmat, 0, ind.long())))

    res = tp.amen_cross_s([17] * 8, cross_fun, 0.0, tol_exit=0.05, y0=8,
                          kickrank=2, seed=0, torch_fun=True, device="cpu")
    assert max(res.tt.ranks) <= 60
    gen = torch.Generator().manual_seed(42)
    m = 1 << 14
    z = torch.rand((m, 8), generator=gen, dtype=torch.float64)
    y, lfapp = tp.tt_irt_lin(grids, res.tt, z, device="cpu")
    mh = tp.mcmc_prune(y, lp(y), lfapp, generator=gen)
    assert mh.num_rejects / m < 0.40
    q_mh, q_mh_n = tsa.quantile_qoi(mh.y)
    yq, lfq = tp.tt_irt_lin(grids, res.tt, tp.qmcnodes(8, 14, seed=7),
                            device="cpu")
    lq = lp(yq)
    q_iw, q_iw_n = tsa.quantile_qoi(yq, is_weight=torch.exp(lq - lfq))
    assert float(tp.essinv(lq, lfq)) < 3.0
    assert float(np.mean(tp.iact(mh.y))) < 6.0
    assert abs(float(q_mh) - float(q_iw)) / float(q_iw) < 0.05
    assert abs(float(q_mh_n) - float(q_iw_n)) / float(q_iw_n) < 0.05
    assert 5e3 < float(q_mh) < 5e4
