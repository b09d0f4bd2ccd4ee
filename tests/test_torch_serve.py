"""The port's 'hi' serve path against the JAX package: the single-TT
transform (IrtSampler vs tt_irt_sqr / tt_rt_sqr) and the whole slice
(DirtSampler on the shipped Lorenz checkpoints)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tt_irt_tpu as ti
import tt_irt_tpu_torch as tp
from tt_irt_tpu.utils.checkpoint import load_dirt as jax_load

DATA = os.path.join(os.path.dirname(__file__), "..", "examples", "data")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread a process, so that parallel test workers do
    not oversubscribe the cores; the caller's setting comes back."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _mk_cores(d=6, n=17, r=5, seed=11):
    """Gaussian-bump TT cores on [-2, 2], as the JAX kernel tests build
    them (tests/test_fused_step.py::_mk_tt), made with numpy."""
    rng = np.random.default_rng(seed)
    x = np.linspace(-2, 2, n)
    cores = []
    for k in range(d):
        r1 = 1 if k == 0 else r
        r2 = 1 if k == d - 1 else r
        c = np.exp(-((x[None, :, None] - 0.3) ** 2)
                   / (2 * rng.uniform(0.1, 0.5, (r1, 1, r2)) ** 2)) \
            * rng.uniform(0.2, 1, (r1, 1, r2))
        cores.append(np.broadcast_to(c, (r1, n, r2)).copy())
    return cores, x


def test_irt_sampler_matches_jax_hi():
    """IrtSampler 'sqr' and 'rt' against JAX tt_irt_sqr / tt_rt_sqr at
    precision 'hi' (default environment: the XLA serveb scan and the
    double-single epilogue).  Bars as the JAX package's own kernel-vs-
    XLA test (test_dim_kernel_matches_xla_serveb): samples 1e-6,
    log-density 1e-5 — two f32 row pipelines with different summation
    orders; rt(irt(q)) returns q to 1e-5."""
    cores, x = _mk_cores()
    d = len(cores)
    q = np.random.default_rng(13).uniform(size=(512, d))
    jtt = ti.TT([jnp.asarray(c) for c in cores])
    grids = [jnp.asarray(x)] * d
    xj, lj = ti.tt_irt_sqr(grids, jtt, jnp.asarray(q), precision="hi")
    qj, lrj = ti.tt_rt_sqr(grids, jtt, xj, precision="hi")
    ttt = tp.TT([torch.from_numpy(c) for c in cores])
    tgrids = [torch.from_numpy(x)] * d
    fwd = tp.IrtSampler(tgrids, ttt, "sqr", precision="hi", device="cpu")
    inv = tp.IrtSampler(tgrids, ttt, "rt", precision="hi", device="cpu")
    xt, lt = fwd(torch.from_numpy(q))
    qt, lrt = inv(torch.from_numpy(np.array(xj)))
    assert np.max(np.abs(xt.numpy() - np.asarray(xj))) < 1e-6
    assert np.max(np.abs(lt.numpy() - np.asarray(lj))) < 1e-5
    assert np.max(np.abs(qt.numpy() - np.asarray(qj))) < 1e-6
    assert np.max(np.abs(lrt.numpy() - np.asarray(lrj))) < 1e-5
    qb, _ = inv(xt)
    assert float((qb - torch.from_numpy(q)).abs().max()) < 1e-5


def test_irt_sampler_blocks_and_shared_grid():
    """Blocked forward (rows padded to whole blocks) equals one block,
    and a shared grid vector equals the per-dim list."""
    cores, x = _mk_cores(d=4, n=9, r=3, seed=2)
    ttt = tp.TT([torch.from_numpy(c) for c in cores])
    q = torch.from_numpy(np.random.default_rng(1).uniform(size=(300, 4)))
    one = tp.IrtSampler([torch.from_numpy(x)] * 4, ttt, precision="hi",
                        device="cpu")(q)
    blk = tp.IrtSampler(torch.from_numpy(x), ttt, precision="hi",
                        block=128, device="cpu")(q)
    for a, b in zip(one, blk):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) < 1e-12


@pytest.mark.parametrize("precision", ["hid", "ds", "gs"])
def test_factor_family_precisions_serve_lz10(precision):
    """DirtSampler at 'hid', 'ds' and 'gs' on lz10_ck (12 tempered levels
    plus level 0), 256 seeds, against the port's 'f64' serve: samples
    1e-5, lfapp 1e-4."""
    stack = tp.load_dirt(os.path.join(DATA, "lz10_ck"), device="cpu")
    g = torch.Generator().manual_seed(3)
    q = tp.randref(stack.reference, g, (256, stack.d))
    z64, l64 = tp.DirtSampler(stack, precision="f64", device="cpu")(q)
    sampler = tp.DirtSampler(stack, precision=precision, device="cpu")
    assert sampler.precision == precision and sampler.hi_step == "dim"
    z, lf = sampler(q)
    assert float((z - z64).abs().max()) < 1e-5
    assert float((lf - l64).abs().max()) < 1e-4


def test_resolved_serve_modes():
    """The record of what is in force names the step, the dtypes, the
    erf reference map and whether kernels carry the path."""
    from tt_irt_tpu_torch.samplers.irt_scan import resolved_serve_modes

    hi = resolved_serve_modes("hi", "odim", "cuda")
    assert hi["hi_step"] == "odim" and hi["tnormal"] == "erf"
    assert hi["contraction_dtype"] == "float32" and hi["kernels"]
    assert hi["device"] == "cuda" and hi["epilogue"] == "f64"
    ds = resolved_serve_modes("ds", device="cuda")
    assert ds["hi_step"] is None and not ds["kernels"]
    assert ds["contraction_dtype"] == "float64"
    assert not resolved_serve_modes("hi", device="cpu")["kernels"]
    with pytest.raises(ValueError):
        resolved_serve_modes("f32", "pair")


def _serve_both(name, m, seed):
    path = os.path.join(DATA, name)
    jd = jax_load(path)
    u = np.random.default_rng(seed).uniform(size=(m, jd.d))
    q = np.asarray(ti.randref("n3", jnp.asarray(u)))
    zj, lj = ti.DirtSampler(jd, precision="hi")(jnp.asarray(q))
    ps = tp.DirtSampler(tp.load_dirt(path, device="cpu"), precision="hi",
                        device="cpu")
    zt, lt = ps(torch.from_numpy(np.array(q)))
    return q, np.asarray(zj), np.asarray(lj), zt.numpy(), lt.numpy(), jd


def test_dirt_sampler_matches_jax_lz10():
    """The slice as a whole: the port's DirtSampler('hi') vs the JAX
    DirtSampler('hi') on lz10_ck (12 tempered levels plus level 0) and
    the same 1024 truncated-normal seeds.  Bars: samples 1e-5, lfapp
    1e-4.  Measured maxima on the CPU: samples 9.5e-6, lfapp 6.8e-6.
    Both packages sit equally far from the full-f64 JAX serve (JAX 'hi'
    9.4e-6, port 6.6e-6 in samples): the gap between them is the sum of
    two f32-class errors, not a fault of either."""
    q, zj, lj, zt, lt, jd = _serve_both("lz10_ck", 1024, 0)
    assert zt.shape == zj.shape and np.all(np.isfinite(zt))
    assert np.max(np.abs(zt - zj)) < 1e-5
    assert np.max(np.abs(lt - lj)) < 1e-4
    z64, l64 = ti.DirtSampler(jd, precision="f64")(jnp.asarray(q))
    err_jax = np.max(np.abs(zj - np.asarray(z64)))
    err_port = np.max(np.abs(zt - np.asarray(z64)))
    assert err_port < 1.5 * err_jax


def test_dirt_sampler_matches_jax_lz40n33():
    """The full-width checkpoint (d=40, n=33, r=23, 13 tempered levels
    plus level 0) at 256 rows.  Over 40 dimensions the f32 'hi' chain
    drifts further from f64: the JAX 'hi' serve itself measured 1.6e-5
    in samples and 2.2e-5 in lfapp from the JAX f64 serve at these
    seeds, and the port 1.7e-5 / 2.1e-5.  So the bars are 5e-5 on
    samples and 1e-4 on lfapp (measured port vs JAX: 1.9e-5, 4.0e-5).
    Rare rows differ by more at larger counts (ROADMAP Queue 3); these
    256 seeds are fixed, so the maxima above are what this test sees.
    The port must also be no further from the JAX f64 serve than JAX
    'hi' is (within a factor 1.5)."""
    q, zj, lj, zt, lt, jd = _serve_both("lz40n33_ck", 256, 0)
    assert np.all(np.isfinite(zt)) and np.all(np.isfinite(lt))
    assert np.max(np.abs(zt - zj)) < 5e-5
    assert np.max(np.abs(lt - lj)) < 1e-4
    z64, l64 = ti.DirtSampler(jd, precision="f64")(jnp.asarray(q))
    for port, ref, exact in ((zt, zj, z64), (lt, lj, l64)):
        exact = np.asarray(exact)
        assert np.max(np.abs(port - exact)) < 1.5 * np.max(
            np.abs(ref - exact))


def test_dirt_sampler_n_over_ess_matches_jax_lz40n33():
    """Quality of the served stack: N/ESS against the exact Lorenz
    posterior, port (its own sampler and posterior) vs JAX, on the same
    4096 seeds.  They agree to 1e-3 relative: the per-row f32
    differences of the two 'hi' pipelines barely move the importance
    weights (measured 1.32506 vs 1.32506)."""
    from tt_irt_tpu.models import lorenz as jlz

    data = np.load(os.path.join(DATA, "lz40n33_data.npy"))
    x0base = np.load(os.path.join(DATA, "lz40n33_x0base.npy"))
    q, zj, lj, zt, lt, _ = _serve_both("lz40n33_ck", 4096, 5)
    lpj = jlz.LorenzProblem(d=40, n=33, x0true=x0base,
                            data=data).log_posterior_fn()
    lpt = tp.LorenzProblem(d=40, x0true=x0base,
                           data=data).log_posterior_fn()
    ej = float(ti.essinv(lpj(jnp.asarray(zj)), jnp.asarray(lj)))
    et = float(tp.essinv(lpt(torch.from_numpy(zt)), torch.from_numpy(lt)))
    assert 1.0 <= et < 1.95
    assert abs(et - ej) / ej < 1e-3, (et, ej)
