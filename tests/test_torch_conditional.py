"""The port's conditional sampling (samplers/conditional.py) against the
JAX package's on the same inputs, at f64: tests/test_conditional.py's
six cases (the prefix and an arbitrary subset of one conditioning point,
the per-seed round trip, the DIRT prefix and subset forms, mode 'lin'),
each on the JAX package's own cross and DIRT carried across as numpy,
within 1e-10.  The conditioned columns equal xfix exactly and the
refusals are the JAX package's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tt_irt_tpu as ti
import tt_irt_tpu_torch as tp

CORR = 0.4
D = 5
N = 33
A = np.array([0.7, -0.4])
GRIDS = [np.linspace(-5, 5, N)] * D
TOL = 1e-10


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
                   + 2.0 * CORR * jnp.sum(x[:, :-1] * x[:, 1:], axis=1))


def lp_torch(x):
    return -0.5 * (torch.sum(x * x, dim=1)
                   + 2.0 * CORR * torch.sum(x[:, :-1] * x[:, 1:], dim=1))


def _cross(power):
    def fun(ind):
        pts = jnp.stack([jnp.asarray(GRIDS[k])[np.asarray(ind)[:, k]]
                         for k in range(D)], 1)
        return np.asarray(jnp.exp(power * lp(pts)))

    tol = 1e-8 if power == 0.5 else 1e-9
    return ti.amen_cross_s([N] * D, fun, tol, tol_exit=tol).tt


def _port_tt(tt):
    return tp.tt_from_numpy([np.asarray(c) for c in tt.cores], "cpu")


@pytest.fixture(scope="module")
def tts():
    tj = _cross(0.5)
    return tj, _port_tt(tj)


@pytest.fixture(scope="module")
def seeds():
    rng = np.random.default_rng(3)
    return rng.uniform(1e-6, 1 - 1e-6, (1 << 11, D - 2))


@pytest.fixture(scope="module")
def dirts():
    dj = ti.tt_dirt_approx(
        GRIDS, lambda x, b0, b1: (b1 - b0) * lp(x), [0.3, 1.0],
        stoptol=0.1, nswp=3, kickrank=2, testsamples=0, verb=0, seed=2)
    dt = tp.dirt_from_numpy(
        [np.asarray(c) for c in dj.f0.cores],
        [[np.asarray(c) for c in f.cores] for f in dj.fs],
        [np.asarray(g) for g in dj.x0], [np.asarray(g) for g in dj.x],
        np.asarray(dj.beta), dj.lfshift, reference=dj.reference,
        interpolation=dj.interpolation, device="cpu")
    return dj, dt


def _close(port, ref, tol=TOL):
    err = float(np.max(np.abs(port.numpy() - np.asarray(ref))))
    assert err < tol, err


def _pinned(z, cond):
    assert torch.equal(z[:, cond], torch.from_numpy(A).expand(z.shape[0], 2))


def test_tt_irt_cond_prefix_matches_jax(tts, seeds):
    tj, tt = tts
    zj, lj = ti.tt_irt_cond(GRIDS, tj, A, jnp.asarray(seeds))
    z, lf = tp.tt_irt_cond(GRIDS, tt, A, torch.from_numpy(seeds),
                           device="cpu")
    _pinned(z, [0, 1])
    _close(z, zj)
    _close(lf, lj)
    assert float(tp.essinv(lp_torch(z), lf)) < 1.02
    with pytest.raises(ValueError):
        tp.tt_irt_cond(GRIDS, tt, A, seeds[:, :-1], device="cpu")
    with pytest.raises(ValueError):
        tp.tt_irt_cond(GRIDS, tt, np.tile(A, (7, 1)), seeds, device="cpu")


def test_tt_irt_cond_arbitrary_subset_matches_jax(tts, seeds):
    tj, tt = tts
    zj, lj = ti.tt_irt_cond(GRIDS, tj, A, jnp.asarray(seeds),
                            cond_dims=[1, 3])
    z, lf = tp.tt_irt_cond(GRIDS, tt, A, torch.from_numpy(seeds),
                           cond_dims=[1, 3], device="cpu")
    _pinned(z, [1, 3])
    _close(z, zj)
    _close(lf, lj)
    xrows = np.tile(A, (seeds.shape[0], 1)) + 0.01 * np.arange(
        seeds.shape[0])[:, None]
    with pytest.raises(ValueError):
        tp.tt_irt_cond(GRIDS, tt, xrows, seeds, cond_dims=[1, 3],
                       device="cpu")


def test_tt_irt_cond_per_seed_rows_roundtrip_matches_jax(tts):
    """Conditioning on z[:, :2] with the original seeds gives the joint
    transform back (1e-8, the JAX package's bar) and the density split;
    the port's outputs equal the JAX package's within 1e-10."""
    tj, tt = tts
    q = np.random.default_rng(9).uniform(0.01, 0.99, (256, D))
    z_full, lf_full = tp.tt_irt_sqr(GRIDS, tt, torch.from_numpy(q),
                                    device="cpu")
    zj_full, _ = ti.tt_irt_sqr(GRIDS, tj, jnp.asarray(q))
    zj, lj = ti.tt_irt_cond(GRIDS, tj, zj_full[:, :2], jnp.asarray(q[:, 2:]))
    z, lf = tp.tt_irt_cond(GRIDS, tt, z_full[:, :2],
                           torch.from_numpy(q[:, 2:]), device="cpu")
    assert torch.equal(z[:, :2], z_full[:, :2])
    assert float((z - z_full).abs().max()) < 1e-8
    _, lf_marg = tp.tt_irt_sqr(GRIDS, tt, torch.from_numpy(q[:, :2]),
                               device="cpu")
    assert float((lf - (lf_full - lf_marg)).abs().max()) < 1e-8
    _close(z, zj)
    _close(lf, lj)


def test_tt_dirt_cond_sample_prefix_matches_jax(dirts, seeds):
    dj, dt = dirts
    zj, lj, lej = ti.tt_dirt_cond_sample(dj, A, jnp.asarray(seeds),
                                         logpostfun=lp)
    z, lf, le = tp.tt_dirt_cond_sample(dt, A, torch.from_numpy(seeds),
                                       logpostfun=lp_torch, device="cpu")
    _pinned(z, [0, 1])
    _close(z, zj)
    _close(lf, lj)
    _close(le, lej)
    assert float(tp.essinv(lp_torch(z), lf)) < 1.02


def test_tt_dirt_cond_sample_subset_matches_jax(dirts, seeds):
    """dirt_permute relabelling (ranks grow, to about 167); 256 seeds
    (the JAX test takes 1024: the serve of the permuted stack is most of
    this file's time)."""
    dj, dt = dirts
    q = seeds[:256]
    zj, lj = ti.tt_dirt_cond_sample(dj, A, jnp.asarray(q), cond_dims=[1, 3],
                                    perm_eps=1e-6)
    z, lf = tp.tt_dirt_cond_sample(dt, A, torch.from_numpy(q),
                                   cond_dims=[1, 3], perm_eps=1e-6,
                                   device="cpu")
    _pinned(z, [1, 3])
    _close(z, zj)
    _close(lf, lj)
    assert float(tp.essinv(lp_torch(z), lf)) < 1.05


def test_tt_irt_cond_lin_mode_matches_jax():
    fj = _cross(1.0)
    f = _port_tt(fj)
    q = np.random.default_rng(5).uniform(1e-6, 1 - 1e-6, (1 << 11, D - 2))
    zj, lj = ti.tt_irt_cond(GRIDS, fj, A, jnp.asarray(q), cond_dims=[1, 3],
                            mode="lin")
    z, lf = tp.tt_irt_cond(GRIDS, f, A, torch.from_numpy(q),
                           cond_dims=[1, 3], mode="lin", device="cpu")
    _pinned(z, [1, 3])
    _close(z, zj)
    _close(lf, lj)
    assert float(tp.essinv(lp_torch(z), lf)) < 1.02
    with pytest.raises(ValueError):
        tp.tt_irt_cond(GRIDS, f, np.tile(A, (q.shape[0], 1)), q, mode="lin",
                       device="cpu")
