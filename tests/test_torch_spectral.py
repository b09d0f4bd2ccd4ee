"""The port's spectral samplers (samplers/fourier.py, samplers/chebyshev.py)
against the JAX package's on the same TTs and seeds, and their own
exactness, prep-reuse and input rules (those of tests/test_fourier.py).

Agreement bar: 1e-10 in samples and log-density on at least 99% of
rows, 1e-6 on every row; a row between the bars must be a Newton mask
flip (its |residual| within rounding of the tolerance, so one package
stops iterating where the other takes one more step), which is checked
by re-running the row with the tolerance moved by one part in 1e6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tt_irt_tpu as ti
import tt_irt_tpu_torch as tp
from tt_irt_tpu.samplers import chebyshev as jcheb
from tt_irt_tpu.samplers import fourier as jfour
from tt_irt_tpu_torch.samplers import chebyshev as tcheb
from tt_irt_tpu_torch.samplers import fourier as tfour

TIGHT, LOOSE = 1e-10, 1e-6


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


def _fourier_grids(d, n, sigma=4.0):
    h = 2 * sigma / n
    return [np.arange(-n // 2 + 1, n // 2 + 1) * h for _ in range(d)]


def _random_cores(d, n, r, seed):
    """A positive random TT (sqrt-density values), made with numpy."""
    rng = np.random.default_rng(seed)
    return [rng.uniform(0.1, 1.0, (1 if k == 0 else r, n,
                                   1 if k == d - 1 else r))
            for k in range(d)]


def _jtt(cores):
    return ti.TT([jnp.asarray(c) for c in cores])


def _ttt(cores):
    return tp.tt_from_numpy(cores, device="cpu")


def _embed(a):
    """The JAX package's doubled real embedding of a complex (r1, f, rc)
    array: [[Re, Im], [-Im, Re]] over axes 0 and 2."""
    top = np.concatenate([a.real, a.imag], axis=2)
    bot = np.concatenate([-a.imag, a.real], axis=2)
    return np.concatenate([top, bot], axis=0)


def _mask_flip(module, run_row, ref_x, ref_l):
    """True when the row agrees with the reference within TIGHT once
    the Newton tolerance moves by one part in 1e6 either way."""
    tol = module._NEWTON_TOL
    try:
        for f in (1.0 - 1e-6, 1.0 + 1e-6):
            module._NEWTON_TOL = tol * f
            x, lf = run_row()
            if (np.max(np.abs(x - ref_x)) < TIGHT
                    and abs(lf - ref_l) < TIGHT):
                return True
        return False
    finally:
        module._NEWTON_TOL = tol


def _check_parity(xt, lt, xj, lj, run_row):
    """The acceptance rule of the module docstring; returns the number
    of mask-flip rows."""
    dx = np.max(np.abs(xt - xj), axis=1)
    dl = np.abs(lt - lj)
    off = np.nonzero((dx >= TIGHT) | (dl >= TIGHT))[0]
    assert off.size <= 0.01 * xt.shape[0], off.size
    assert float(dx.max()) < LOOSE and float(dl.max()) < LOOSE
    for i in off:
        assert run_row(i, xj[i], lj[i]), f"row {i} is not a mask flip"
    return off.size


@pytest.mark.parametrize("d,r", [(3, 5), (4, 3)])
def test_fourier_precompute_matches_jax(d, r):
    """The prep's arrays (the port's complex ones re-embedded as the JAX
    package's real pairs) within 1e-13; the geometry equal."""
    n = 16
    grids = _fourier_grids(d, n)
    cores = _random_cores(d, n, r, seed=d)
    pj = jfour.fourier_precompute(grids, _jtt(cores))
    pt = tfour.fourier_precompute(grids, _ttt(cores))
    for k in range(d):
        p = pt.dims[k]
        np.testing.assert_allclose(_embed(p.lfine.numpy()),
                                   np.asarray(pj.lfine[k]), rtol=0,
                                   atol=1e-13)
        ck = p.coeffs.numpy()
        np.testing.assert_allclose(np.stack([ck.real, ck.imag], axis=-1),
                                   np.asarray(pj.coeffs[k]), rtol=0,
                                   atol=1e-13)
        assert (p.x0, p.s, p.h, p.nhalf) == (pj.x0[k], pj.s[k], pj.h[k],
                                             pj.nhalf[k])


@pytest.mark.parametrize("d,r", [(3, 5), (4, 3)])
def test_cheb_precompute_matches_jax(d, r):
    n = 17
    grids = [tcheb.lobatto_nodes(n, -3.0, 3.0)] * d
    np.testing.assert_array_equal(grids[0], jcheb.lobatto_nodes(n, -3, 3))
    cores = _random_cores(d, n, r, seed=10 + d)
    pj = jcheb.cheb_precompute(grids, _jtt(cores))
    pt = tcheb.cheb_precompute(grids, _ttt(cores))
    for k in range(d):
        p = pt.dims[k]
        for name in ("lfine", "coeffs", "vinv_f", "bint"):
            np.testing.assert_allclose(getattr(p, name).numpy(),
                                       np.asarray(getattr(pj, name)[k]),
                                       rtol=0, atol=1e-13)
        assert (p.mid, p.half, p.nmode) == (pj.mid[k], pj.half[k],
                                            pj.nmode[k])


@pytest.mark.parametrize("d,r", [(3, 5), (4, 3)])
def test_tt_irt_fourier_matches_jax(d, r):
    """2^10 rows of a random rank-r TT (n=16) in both packages."""
    n = 16
    grids = _fourier_grids(d, n)
    cores = _random_cores(d, n, r, seed=20 + d)
    q = np.random.default_rng(d).uniform(size=(1 << 10, d))
    xj, lj = jfour.tt_irt_fourier(grids, _jtt(cores), jnp.asarray(q))
    xj, lj = np.asarray(xj), np.asarray(lj)
    tt = _ttt(cores)
    xt, lt = tp.tt_irt_fourier(grids, tt, torch.from_numpy(q), device="cpu")
    assert xt.shape == (1 << 10, d) and lt.dtype == torch.float64

    def run_row(i, x_ref, l_ref):
        return _mask_flip(tfour, lambda: tuple(
            a.numpy()[0] for a in tp.tt_irt_fourier(
                grids, tt, torch.from_numpy(q[i:i + 1]), device="cpu")),
            x_ref, l_ref)

    flips = _check_parity(xt.numpy(), lt.numpy(), xj, lj, run_row)
    print(f"Fourier d={d} r={r}: {flips} mask-flip rows of {q.shape[0]}")


@pytest.mark.parametrize("d,r", [(3, 5), (4, 3)])
def test_tt_irt_cheb_matches_jax(d, r):
    n = 17
    grids = [tcheb.lobatto_nodes(n, -3.0, 3.0)] * d
    cores = _random_cores(d, n, r, seed=30 + d)
    q = np.random.default_rng(d + 5).uniform(size=(1 << 10, d))
    xj, lj = jcheb.tt_irt_cheb(grids, _jtt(cores), jnp.asarray(q))
    xj, lj = np.asarray(xj), np.asarray(lj)
    tt = _ttt(cores)
    xt, lt = tp.tt_irt_cheb(grids, tt, torch.from_numpy(q), device="cpu")

    def run_row(i, x_ref, l_ref):
        return _mask_flip(tcheb, lambda: tuple(
            a.numpy()[0] for a in tp.tt_irt_cheb(
                grids, tt, torch.from_numpy(q[i:i + 1]), device="cpu")),
            x_ref, l_ref)

    flips = _check_parity(xt.numpy(), lt.numpy(), xj, lj, run_row)
    print(f"Chebyshev d={d} r={r}: {flips} mask-flip rows of {q.shape[0]}")


def test_spectral_blocks_and_marginals_match_jax():
    """Several blocks (block=300 on 1000 rows, zero-padded) and the
    marginal of the first D < d variables, as in the JAX package."""
    d, n, r = 3, 16, 4
    grids = _fourier_grids(d, n)
    cores = _random_cores(d, n, r, seed=7)
    q = np.random.default_rng(7).uniform(size=(1000, 2))
    xj, lj = jfour.tt_irt_fourier(grids, _jtt(cores), jnp.asarray(q),
                                  block=300)
    xt, lt = tp.tt_irt_fourier(grids, _ttt(cores), torch.from_numpy(q),
                               block=300, device="cpu")
    assert xt.shape == (1000, 2)
    assert np.max(np.abs(xt.numpy() - np.asarray(xj))) < LOOSE
    assert np.max(np.abs(lt.numpy() - np.asarray(lj))) < LOOSE
    xf, lf = tp.tt_irt_fourier(grids, _ttt(cores), torch.from_numpy(q),
                               device="cpu")
    # rows are independent: one block or four give the same rows
    assert torch.max(torch.abs(xf - xt)) < 1e-13


def test_prep_reuse_is_bit_for_bit():
    """A precomputed prep in place of the TT gives the per-call path's
    outputs bit for bit, in both samplers."""
    d, r = 3, 4
    q = torch.from_numpy(np.random.default_rng(3).uniform(size=(256, d)))
    gf = _fourier_grids(d, 16)
    tf_ = _ttt(_random_cores(d, 16, r, seed=3))
    x1, l1 = tp.tt_irt_fourier(gf, tf_, q, device="cpu")
    x2, l2 = tp.tt_irt_fourier(None, tfour.fourier_precompute(gf, tf_), q,
                               device="cpu")
    assert torch.equal(x1, x2) and torch.equal(l1, l2)
    gc = [tcheb.lobatto_nodes(17, -2.0, 2.0)] * d
    tc_ = _ttt(_random_cores(d, 17, r, seed=4))
    x1, l1 = tp.tt_irt_cheb(gc, tc_, q, device="cpu")
    x2, l2 = tp.tt_irt_cheb(None, tcheb.cheb_precompute(gc, tc_), q,
                            device="cpu")
    assert torch.equal(x1, x2) and torch.equal(l1, l2)


def test_fourier_cdf_inversion_accuracy():
    """tests/test_fourier.py's 1-D exactness test: a Gaussian on a fine
    uniform grid inverts to the exact truncated-normal quantile within
    1e-5."""
    from scipy.special import erf, erfinv

    n, sigma = 48, 5.0
    grids = _fourier_grids(1, n, sigma)
    g = np.exp(-0.25 * grids[0] ** 2)
    rng = np.random.default_rng(1234)
    q = rng.random((2048, 1)) * 0.99 + 0.005
    xq, _ = tp.tt_irt_fourier(grids, _ttt([g[None, :, None]]),
                              torch.from_numpy(q), device="cpu")
    cdf_factor = 0.5 / erf(sigma / np.sqrt(2))
    exact = erfinv((q[:, 0] - 0.5) / cdf_factor) * np.sqrt(2)
    assert np.max(np.abs(xq.numpy()[:, 0] - exact)) < 1e-5


def test_chebyshev_sirt_exactness_1d():
    """tests/test_fourier.py's 1-D Chebyshev test: samples within 1e-4 of
    the normal quantile, log-density within 1e-6."""
    from scipy import stats

    x = tcheb.lobatto_nodes(33, -4.0, 4.0)
    vals = np.exp(-x ** 2 / 2.0)
    q = np.linspace(0.001, 0.999, 501)[:, None]
    xs, lf = tp.tt_irt_cheb([x], _ttt([vals[None, :, None]]),
                            torch.from_numpy(q), device="cpu")
    sigma = 1.0 / np.sqrt(2.0)
    exact = stats.norm.ppf(q[:, 0], scale=sigma)
    assert np.max(np.abs(xs.numpy()[:, 0] - exact)) < 1e-4
    lpdf = stats.norm.logpdf(xs.numpy()[:, 0], scale=sigma)
    assert np.max(np.abs(lf.numpy() - lpdf)) < 1e-6


def test_fourier_input_rules():
    """Odd n and a non-uniform grid raise ValueError, as in the JAX
    package; so does a non-Lobatto Chebyshev grid."""
    odd = _ttt(_random_cores(2, 15, 2, seed=1))
    with pytest.raises(ValueError, match="even number"):
        tfour.fourier_precompute([np.linspace(-1, 1, 15)] * 2, odd)
    even = _ttt(_random_cores(2, 16, 2, seed=1))
    bent = np.linspace(-1, 1, 16) ** 3
    with pytest.raises(ValueError, match="not uniform"):
        tp.tt_irt_fourier([bent] * 2, even, torch.rand((4, 2),
                                                       dtype=torch.float64),
                          device="cpu")
    with pytest.raises(ValueError, match="Lobatto"):
        tcheb.cheb_precompute([np.linspace(-1, 1, 16)] * 2, even)


def test_spectral_entry_points_default_to_the_card(monkeypatch):
    """Without a card both samplers raise (no CPU fallback)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tt = _ttt(_random_cores(2, 16, 2, seed=2))
    q = torch.rand((4, 2), dtype=torch.float64)
    with pytest.raises(RuntimeError, match="not available"):
        tp.tt_irt_fourier(_fourier_grids(2, 16), tt, q)
    with pytest.raises(RuntimeError, match="not available"):
        tp.tt_irt_cheb([tcheb.lobatto_nodes(16)] * 2, tt, q)
