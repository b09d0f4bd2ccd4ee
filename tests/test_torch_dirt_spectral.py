"""Chebyshev and Fourier DIRT stacks in the port against the JAX
package, at tests/test_fourier.py's settings.

* A stack the JAX package built, carried over by ``dirt_from_numpy``,
  serves in the port (``tt_dirt_sample`` and ``DirtSampler``, equal to
  each other bit for bit) as in the JAX package, within the spectral
  samplers' bars (tests/test_torch_spectral.py).
* The port's own ``tt_dirt_approx(interpolation=...)``: level 0 bit for
  bit with the JAX package's (one numpy density through ``vec="host"``),
  every level's ranks equal, and the JAX tests' N/ESS bars; with one
  sweep and no enrichment, every level TT within 1e-8 of the JAX
  package's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tt_irt_tpu as ti
import tt_irt_tpu_torch as tp
from tt_irt_tpu.ops.tt import tt_full as jtt_full

TIGHT, LOOSE = 1e-10, 1e-6

CONFIGS = {
    # tests/test_fourier.py::test_fourier_dirt_end_to_end
    "fourier": dict(d=3, corr=0.8, beta=[0.1, 0.5, 1.0], tau_bar=2.0,
                    kw=dict(stoptol=0.15, nswp=3, kickrank=2,
                            testsamples=256, seed=1, reference="n4",
                            interpolation="fourier", nq=[16] * 3)),
    # tests/test_fourier.py::test_dirt_chebyshev_interpolation
    "chebyshev": dict(d=4, corr=0.6, beta=[0.1, 0.4, 1.0], tau_bar=1.5,
                      kw=dict(stoptol=0.1, nswp=3, kickrank=2,
                              testsamples=256, seed=6, reference="n3",
                              interpolation="chebyshev")),
}


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


def _grids(d):
    return [np.linspace(-5, 5, 17) for _ in range(d)]


def _logratio_np(corr):
    def f(x, b0, b1):
        x = np.asarray(x)
        quad = np.sum(x * x, 1) + corr * np.sum(x[:, :-1] * x[:, 1:], 1)
        return -0.5 * (b1 - b0) * quad
    return f


def _logratio_t(corr):
    def f(x, b0, b1):
        quad = torch.sum(x * x, 1) + corr * torch.sum(x[:, :-1] * x[:, 1:],
                                                      1)
        return -0.5 * (b1 - b0) * quad
    return f


def _seeds(cfg, m=2048):
    sigma = tp.reference_sigma(cfg["kw"]["reference"])
    u = np.random.default_rng(3).uniform(size=(m, cfg["d"]))
    return tp.uniform_to_tnormal(torch.from_numpy(u), sigma).numpy()


def _carry(dj):
    """The JAX package's stack as the port's, through dirt_from_numpy."""
    def cores(t):
        return [np.asarray(c) for c in t.cores]

    return tp.dirt_from_numpy(
        cores(dj.f0), [cores(f) for f in dj.fs],
        [np.asarray(g) for g in dj.x0], [np.asarray(g) for g in dj.x],
        np.asarray(dj.beta), dj.lfshift, reference=dj.reference,
        interpolation=dj.interpolation, device="cpu")


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def jax_stack(request):
    cfg = CONFIGS[request.param]
    f = _logratio_np(cfg["corr"])
    dj = ti.tt_dirt_approx(_grids(cfg["d"]), f, cfg["beta"], vec="host",
                           **cfg["kw"])
    return request.param, cfg, dj


def test_jax_built_stack_serves_in_the_port(jax_stack):
    """Samples and log-densities within 1e-10 on at least 99% of rows
    and 1e-6 on every row; DirtSampler equal to tt_dirt_sample bit for
    bit; the JAX test's N/ESS bar against the exact density."""
    name, cfg, dj = jax_stack
    td = _carry(dj)
    assert td.interpolation == name and td.nlevels == 2
    q = _seeds(cfg)
    zj, lj = ti.tt_dirt_sample(dj, jnp.asarray(q))
    zj, lj = np.asarray(zj), np.asarray(lj)
    zt, lt = tp.tt_dirt_sample(td, torch.from_numpy(q), device="cpu")
    dz = np.max(np.abs(zt.numpy() - zj), axis=1)
    dl = np.abs(lt.numpy() - lj)
    off = int(np.sum((dz >= TIGHT) | (dl >= TIGHT)))
    print(f"{name}: {off} rows of {q.shape[0]} past {TIGHT:g}; largest "
          f"{dz.max():.3e} in samples, {dl.max():.3e} in log-density")
    assert off <= 0.01 * q.shape[0]
    assert dz.max() < LOOSE and dl.max() < LOOSE
    sampler = tp.DirtSampler(td, device="cpu")
    zs, ls = sampler(torch.from_numpy(q))
    assert torch.equal(zs, zt) and torch.equal(ls, lt)
    lfex = _logratio_t(cfg["corr"])(zt, 0.0, 1.0)
    assert float(tp.essinv(lfex, lt)) < cfg["tau_bar"]


def test_port_build_matches_jax(jax_stack):
    """The port's build at the same settings: level 0 bit for bit, the
    ranks of every level equal, the JAX test's N/ESS bar at 2048 seeds
    (the test samples are drawn by each package's own generator, so the
    upper levels differ beyond their ranks)."""
    name, cfg, dj = jax_stack
    f = _logratio_np(cfg["corr"])
    dt = tp.tt_dirt_approx(_grids(cfg["d"]), f, cfg["beta"], vec="host",
                           device="cpu", **cfg["kw"])
    assert dt.interpolation == name
    for a, b in zip(dj.f0.cores, dt.f0.cores):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert [f_.ranks for f_ in dt.fs] == [f_.ranks for f_ in dj.fs]
    for a, b in zip(dj.x, dt.x):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    q = torch.from_numpy(_seeds(cfg))
    z, lfapp, lfex = tp.tt_dirt_sample(
        dt, q, lambda x: _logratio_t(cfg["corr"])(x, 0.0, 1.0),
        device="cpu")
    tau = float(tp.essinv(lfex, lfapp))
    print(f"{name}: port build N/ESS {tau:.4f} (bar {cfg['tau_bar']})")
    assert tau < cfg["tau_bar"], tau


def test_single_sweep_levels_match_jax(jax_stack):
    """nswp=1, kickrank=0, no test samples: every level TT of the port's
    build within 1e-8 (relative, as full tensors) of the JAX package's."""
    name, cfg, _ = jax_stack
    kw = dict(cfg["kw"], nswp=1, kickrank=0, testsamples=0, y0=4)
    f = _logratio_np(cfg["corr"])
    dj = ti.tt_dirt_approx(_grids(cfg["d"]), f, cfg["beta"], vec="host",
                           **kw)
    dt = tp.tt_dirt_approx(_grids(cfg["d"]), f, cfg["beta"], vec="host",
                           device="cpu", **kw)
    for lj, lt in zip([dj.f0] + list(dj.fs), [dt.f0] + list(dt.fs)):
        a = np.asarray(jtt_full(lj))
        b = tp.tt_full(lt).numpy()
        rel = np.max(np.abs(a - b)) / np.max(np.abs(a))
        assert rel < 1e-8, (name, rel)


def test_fused_refuses_spectral_stacks(jax_stack):
    """use_fused=True on a spectral stack raises (can_fuse says no, as in
    the JAX package)."""
    from tt_irt_tpu.samplers.dirt_scan import can_fuse as jcan
    from tt_irt_tpu_torch.samplers.dirt_scan import can_fuse

    name, cfg, dj = jax_stack
    td = _carry(dj)
    assert can_fuse(td, td.d) is False and jcan(dj, dj.d) is False
    with pytest.raises(ValueError, match="can_fuse"):
        tp.tt_dirt_sample(td, torch.from_numpy(_seeds(cfg, 8)),
                          use_fused=True, device="cpu")
    with pytest.raises(NotImplementedError):
        tp.tt_dirt_inverse(td, torch.zeros((4, td.d), dtype=torch.float64),
                           device="cpu")


def test_sampler_block_reaches_spectral_levels(jax_stack, monkeypatch):
    """DirtSampler(block=...) sets the spectral levels' blocks too, capped
    at the spectral samplers' 2^15 rows; the outputs stay those of the
    default blocks within 1e-12."""
    from tt_irt_tpu_torch.samplers import dirt as tdirt

    name, cfg, dj = jax_stack
    td = _carry(dj)
    fn = "tt_irt_cheb" if name == "chebyshev" else "tt_irt_fourier"
    inner, seen = getattr(tdirt, fn), []

    def spy(*args, block=None, **kw):
        seen.append(block)
        return inner(*args, block=block, **kw)

    monkeypatch.setattr(tdirt, fn, spy)
    q = torch.from_numpy(_seeds(cfg, 1024))
    z0, l0 = tp.DirtSampler(td, device="cpu")(q)
    for block, want in ((256, 256), (1 << 16, 1 << 15)):
        seen.clear()
        z, lf = tp.DirtSampler(td, block=block, device="cpu")(q)
        assert seen == [want] * td.nlevels, (block, seen)
        assert float((z - z0).abs().max()) < 1e-12
        assert float((lf - l0).abs().max()) < 1e-12
