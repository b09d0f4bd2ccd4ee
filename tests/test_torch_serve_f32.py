"""The slice as a whole at the Gram-family precisions: the port's
DirtSampler on the shipped Lorenz checkpoints below d=40 against the JAX
DirtSampler, on the same truncated-normal seeds."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tt_irt_tpu as ti
import tt_irt_tpu_torch as tp
from tt_irt_tpu.models import lorenz as jlz
from tt_irt_tpu.utils.checkpoint import load_dirt as jax_load

DATA = os.path.join(os.path.dirname(__file__), "..", "examples", "data")
ROWS = 1024


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread a process, so that parallel test workers do
    not oversubscribe the cores; the caller's setting comes back."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module", params=["lz10_ck", "lz20_ck"])
def served(request):
    """One checkpoint served by both packages at 'auto' and by JAX at
    'f64', on 1024 seeds."""
    name = request.param
    path = os.path.join(DATA, name)
    jd = jax_load(path)
    u = np.random.default_rng(0).uniform(size=(ROWS, jd.d))
    q = np.asarray(ti.randref("n3", jnp.asarray(u)))
    js = ti.DirtSampler(jd, precision="auto")
    zj, lj = js(jnp.asarray(q))
    z64, l64 = ti.DirtSampler(jd, precision="f64")(jnp.asarray(q))
    ps = tp.DirtSampler(tp.load_dirt(path, device="cpu"), precision="auto",
                        device="cpu")
    zt, lt = ps(torch.from_numpy(q.copy()))
    return dict(name=name, d=jd.d, q=q, js=js, ps=ps,
                jax=(np.asarray(zj, np.float64), np.asarray(lj, np.float64)),
                f64=(np.asarray(z64), np.asarray(l64)),
                port=(zt.numpy().astype(np.float64),
                      lt.numpy().astype(np.float64)))


def test_auto_resolves_to_f32(served):
    """serve_precision picks 'f32' below d=40 in both packages, and the
    port returns f32 samples with an f64 log-density, as JAX does."""
    assert served["js"].precision == "f32"
    assert served["ps"].precision == "f32"
    assert served["port"][0].shape == (ROWS, served["d"])
    assert np.all(np.isfinite(served["port"][0]))
    assert np.all(np.isfinite(served["port"][1]))


def test_auto_matches_jax(served):
    """Port 'f32' vs JAX 'f32' through 13 transforms: 5e-4 on samples,
    the bar tests/test_dirt.py states for 'f32' against f64, and 5e-3 on
    lfapp (the f32 bar of tests/test_precision.py).  Measured: 5.8e-5 /
    1.7e-4 on lz10_ck and 5.1e-5 / 1.9e-4 on lz20_ck; each package sits
    4.2e-4 to 4.8e-4 (samples) and 3.0e-3 to 3.4e-3 (lfapp) from the
    JAX f64 serve, so the port must also be no further from f64 than
    1.5x the JAX 'f32' serve."""
    (zt, lt), (zj, lj), (z64, l64) = (served["port"], served["jax"],
                                      served["f64"])
    assert np.max(np.abs(zt - zj)) < 5e-4
    assert np.max(np.abs(lt - lj)) < 5e-3
    assert np.max(np.abs(zt - z64)) < 1.5 * np.max(np.abs(zj - z64))
    assert np.max(np.abs(lt - l64)) < 1.5 * np.max(np.abs(lj - l64))


def test_n_over_ess_matches_jax(served):
    """N/ESS against the exact Lorenz posterior on those rows, each
    package with its own sampler and posterior: equal to 1e-3 relative,
    and under the serve gate 1.95."""
    d = served["d"]
    data = np.load(os.path.join(DATA, f"lz{d}_data.npy"))
    x0base = np.load(os.path.join(DATA, f"lz{d}_x0base.npy"))
    lpj = jlz.LorenzProblem(d=d, n=17, x0true=x0base,
                            data=data).log_posterior_fn()
    lpt = tp.LorenzProblem(d=d, x0true=x0base, data=data).log_posterior_fn()
    zj, lj = served["jax"]
    zt, lt = served["port"]
    ej = float(ti.essinv(lpj(jnp.asarray(zj)), jnp.asarray(lj)))
    et = float(tp.essinv(lpt(torch.from_numpy(zt)), torch.from_numpy(lt)))
    assert 1.0 <= et < 1.95
    assert abs(et - ej) / ej < 1e-3, (et, ej)


def test_f64_matches_jax_f64_lz10():
    """Port 'f64' vs JAX 'f64' on lz10_ck: 1e-9 on samples and lfapp
    (measured 3e-14 / 4e-14: the same f64 formulas end to end)."""
    path = os.path.join(DATA, "lz10_ck")
    jd = jax_load(path)
    u = np.random.default_rng(1).uniform(size=(ROWS, jd.d))
    q = np.asarray(ti.randref("n3", jnp.asarray(u)))
    z64, l64 = ti.DirtSampler(jd, precision="f64")(jnp.asarray(q))
    ps = tp.DirtSampler(tp.load_dirt(path, device="cpu"), precision="f64",
                        device="cpu")
    zt, lt = ps(torch.from_numpy(q.copy()))
    assert zt.dtype == torch.float64
    assert np.max(np.abs(zt.numpy() - np.asarray(z64))) < 1e-9
    assert np.max(np.abs(lt.numpy() - np.asarray(l64))) < 1e-9


def test_mixed_closer_to_f64_than_f32_lz10():
    """'mixed' (f64 CDF) through the whole stack: within 5e-5 of the JAX
    f64 serve in samples, the 'mixed' bar of tests/test_dirt.py."""
    path = os.path.join(DATA, "lz10_ck")
    jd = jax_load(path)
    u = np.random.default_rng(2).uniform(size=(256, jd.d))
    q = np.asarray(ti.randref("n3", jnp.asarray(u)))
    z64, _ = ti.DirtSampler(jd, precision="f64")(jnp.asarray(q))
    ps = tp.DirtSampler(tp.load_dirt(path, device="cpu"), precision="mixed",
                        device="cpu")
    zt, lt = ps(torch.from_numpy(q.copy()))
    assert np.max(np.abs(zt.numpy() - np.asarray(z64))) < 5e-5
    assert bool(torch.isfinite(lt).all())
