"""The port's debiasing (iw_prune, tt_irt_debias) and diagnostics
(hellinger, iact, tt_marginals) against the JAX package on identical
arrays."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tt_irt_tpu as ti
import tt_irt_tpu_torch as tp

from test_torch_precisions import _pair, stress_cores


def _pairs(m=2000, seed=0):
    """Log-density pairs of a proposal that misses the target a little."""
    rng = np.random.default_rng(seed)
    lfapp = rng.normal(size=m)
    lfex = lfapp + 0.3 * rng.normal(size=m) - 2.0
    return lfex, lfapp


@pytest.mark.parametrize("cols", [0, 3])
def test_iw_prune_matches_jax(cols):
    """1-D lfex and (M, R+1) lfex (log-density in column 0, quantities
    of interest beside it): every field within 1e-12 relative."""
    lfex, lfapp = _pairs()
    if cols:
        rng = np.random.default_rng(1)
        lfex = np.concatenate([lfex[:, None], rng.normal(size=(2000, cols))],
                              axis=1)
    rj = ti.iw_prune(jnp.asarray(lfex), jnp.asarray(lfapp))
    rt = tp.iw_prune(torch.from_numpy(lfex), torch.from_numpy(lfapp))
    assert isinstance(rt, tp.IWResult)
    for a, b in zip(rt, rj):
        b = np.asarray(b)
        assert a.shape == b.shape
        assert np.max(np.abs(a.numpy() - b)) <= 1e-12 * max(
            np.max(np.abs(b)), 1.0)


@pytest.mark.parametrize("seed", [0, 1])
def test_hellinger_and_essinv_match_jax(seed):
    lfex, lfapp = _pairs(seed=seed)
    for ft, fj in ((tp.hellinger, ti.hellinger), (tp.essinv, ti.essinv)):
        a = float(ft(torch.from_numpy(lfex), torch.from_numpy(lfapp)))
        b = float(fj(jnp.asarray(lfex), jnp.asarray(lfapp)))
        assert abs(a - b) <= 1e-12 * abs(b)


def _ar1(n, k, phi, seed):
    rng = np.random.default_rng(seed)
    x = np.zeros((n, k))
    e = rng.normal(size=(n, k))
    for i in range(1, n):
        x[i] = phi * x[i - 1] + e[i]
    return x


@pytest.mark.parametrize("return_error", [False, True])
def test_iact_matches_jax(return_error):
    """(N,) and (N, k) chains (AR(1) at 0.0, 0.5, 0.9 and a constant
    column), with and without Wolff's error: equal to 1e-12."""
    x = _ar1(4000, 3, 0.0, 2)
    x[:, 1] = _ar1(4000, 1, 0.5, 3)[:, 0]
    x[:, 2] = _ar1(4000, 1, 0.9, 4)[:, 0]
    x = np.concatenate([x, np.ones((4000, 1))], axis=1)
    for arr in (x, x[:, 2]):
        a = tp.iact(torch.from_numpy(arr), return_error=return_error)
        b = ti.iact(arr, return_error=return_error)
        assert np.allclose(np.asarray(a), np.asarray(b), rtol=1e-12,
                           atol=0.0)
    tau = tp.iact(x)
    assert tau[0] < 1.5 and 2.0 < tau[1] < 4.5 and tau[2] > 10.0
    assert tau[3] == 1.0


@pytest.mark.parametrize("pair", [(0, 1), (3, 1), (0, 4)])
def test_tt_marginals_match_jax(pair):
    cores, x = stress_cores(d=5, n=7, rank=3, seed=4)
    jtt, _, ttt, _ = _pair(cores, x)
    m1t, m2t = tp.tt_marginals(ttt, pair)
    m1j, m2j = ti.tt_marginals(jtt, pair)
    for a, b in zip(m1t + [m2t], m1j + [m2j]):
        assert a.shape == b.shape
        assert np.max(np.abs(a - b)) <= 1e-12 * np.max(np.abs(b))


def _log_gauss(x, lib):
    return -0.5 * lib.sum((x - 0.2) ** 2 / 0.5, axis=1) if lib is jnp else \
        -0.5 * torch.sum((x - 0.2) ** 2 / 0.5, dim=1)


@pytest.fixture(scope="module")
def debias_case():
    cores, x = stress_cores(d=4, n=9, rank=3, seed=6)
    q = np.random.default_rng(3).uniform(size=(600, 4))
    return _pair(cores, x) + (q,)


def test_tt_irt_debias_iw_matches_jax(debias_case):
    """correction='iw' from an (M, d) seed array: samples, lFapp, the
    weighted lFex and the three figures equal to JAX's (1e-12; both
    f64, tt_irt_lin on the scan path), the timings present."""
    jtt, jg, ttt, tg, q = debias_case
    rj = ti.tt_irt_debias(jnp.asarray(q), lambda y: _log_gauss(y, jnp),
                          jtt, jg, correction="iw")
    rt = tp.tt_irt_debias(torch.from_numpy(q), lambda y: _log_gauss(y, torch),
                          ttt, tg, correction="iw", device="cpu")
    assert set(rt) == set(rj)
    for key in ("y", "lFex", "lFapp", "bias", "max_ratio", "err1"):
        b = np.asarray(rj[key])
        assert np.max(np.abs(np.asarray(rt[key]) - b)) <= 1e-12 * max(
            np.max(np.abs(b)), 1.0), key
    assert rt["time_invcdf"] > 0.0 and rt["time_eval"] > 0.0


def test_tt_irt_debias_mcmc_structure(debias_case):
    """correction='mcmc' (mcmc_prune is held against JAX with shared
    uniforms elsewhere): the JAX dict's keys; every pruned row is a
    proposal; the rejection count matches the accepted mask; an integer
    m draws seeds from the generator, reproducibly."""
    jtt, jg, ttt, tg, q = debias_case
    rj = ti.tt_irt_debias(jnp.asarray(q), lambda y: _log_gauss(y, jnp),
                          jtt, jg, correction="mcmc")
    g = torch.Generator().manual_seed(5)
    rt = tp.tt_irt_debias(torch.from_numpy(q), lambda y: _log_gauss(y, torch),
                          ttt, tg, correction="mcmc", generator=g,
                          device="cpu")
    assert set(rt) == set(rj)
    y, _ = tp.tt_irt_lin(tg, ttt, torch.from_numpy(q), device="cpu")
    acc = rt["accepted"]
    assert bool(acc[0]) and rt["bias"] == int((~acc[1:]).sum())
    assert torch.equal(rt["y"][acc], y[acc])
    assert bool(torch.isin(rt["y"][:, 0], y[:, 0]).all())
    assert 0 < rt["bias"] < q.shape[0] - 1
    draws = [tp.tt_irt_debias(64, lambda y: _log_gauss(y, torch), ttt, tg,
                              correction="iw", device="cpu",
                              generator=torch.Generator().manual_seed(9))
             for _ in range(2)]
    assert draws[0]["y"].shape == (64, 4)
    assert torch.equal(draws[0]["y"], draws[1]["y"])
    with pytest.raises(ValueError):
        tp.tt_irt_debias(64, lambda y: _log_gauss(y, torch), ttt, tg,
                         device="cpu")
