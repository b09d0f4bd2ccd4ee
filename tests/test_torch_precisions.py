"""tt_irt_sqr / tt_rt_sqr / IrtSampler of the port at the Gram-family
precisions ('f64', 'f32', 'mixed') and at 'hid', 'gs', 'ds' against the
JAX package and the numpy oracle, on the stress TT of tests/test_precision.py (narrow off-centre
conditionals, tail-heavy seeds), rebuilt here with numpy."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tt_irt_tpu as ti
import tt_irt_tpu_torch as tp
from tt_irt_tpu.utils.reference_numpy import irt_sqr_numpy


def stress_cores(d=40, n=17, rank=7, seed=5):
    """The cores of test_precision.stress_tt, as numpy arrays."""
    rng = np.random.default_rng(seed)
    x = np.linspace(-2.0, 2.0, n)
    cores = []
    for k in range(d):
        r1 = 1 if k == 0 else rank
        r2 = 1 if k == d - 1 else rank
        center = rng.uniform(-1.2, 1.2)
        widths = rng.uniform(0.09, 0.5, size=(r1, r2))
        amp = rng.uniform(0.2, 1.0, size=(r1, r2))
        cores.append(amp[:, None, :] * np.exp(
            -((x[None, :, None] - center) ** 2)
            / (2.0 * widths[:, None, :] ** 2)))
    return cores, x


def tail_seeds(m, d, seed=7):
    """test_precision.tail_seeds: a third of the entries log-uniform
    down to 1e-9 from either end."""
    rng = np.random.default_rng(seed)
    q = rng.uniform(size=(m, d))
    mask = rng.uniform(size=(m, d)) < 0.33
    expo = rng.uniform(1.0, 9.0, size=(m, d))
    tails = 10.0 ** (-expo)
    hi = rng.uniform(size=(m, d)) < 0.5
    tails = np.where(hi, 1.0 - tails, tails)
    return np.where(mask, tails, q)


def _pair(cores, x):
    d = len(cores)
    return (ti.TT([jnp.asarray(c) for c in cores]), [jnp.asarray(x)] * d,
            tp.TT([torch.from_numpy(c.copy()) for c in cores]),
            [torch.from_numpy(x.copy())] * d)


@pytest.fixture(scope="module")
def stress40():
    """The d=40 stress TT in both packages, its seeds (tail-heavy and
    uniform) and the JAX f64 results on each."""
    cores, x = stress_cores()
    jtt, jg, ttt, tg = _pair(cores, x)
    seeds = {"tail": tail_seeds(1024, 40),
             "uniform": np.random.default_rng(11).uniform(size=(1024, 40))}
    f64 = {k: tuple(np.asarray(a) for a in ti.tt_irt_sqr(
        jg, jtt, jnp.asarray(q), precision="f64")) for k, q in seeds.items()}
    return jtt, jg, ttt, tg, seeds, f64


def test_f64_matches_jax_f64(stress40):
    """Port f64 vs JAX f64 on the tail-heavy seeds: 1e-10 (both f64,
    QR carry, same formulas; measured ~1e-13), and rt(irt(q)) returns q
    to 1e-12."""
    jtt, jg, ttt, tg, seeds, f64 = stress40
    q = seeds["tail"]
    xt, lt = tp.tt_irt_sqr(tg, ttt, torch.from_numpy(q), precision="f64",
                           device="cpu")
    assert xt.dtype == torch.float64
    assert np.max(np.abs(xt.numpy() - f64["tail"][0])) < 1e-10
    assert np.max(np.abs(lt.numpy() - f64["tail"][1])) < 1e-10
    qb, lb = tp.tt_rt_sqr(tg, ttt, xt, precision="f64", device="cpu")
    qj, lbj = ti.tt_rt_sqr(jg, jtt, jnp.asarray(f64["tail"][0]),
                           precision="f64")
    assert np.max(np.abs(qb.numpy() - np.asarray(qj))) < 1e-10
    assert np.max(np.abs(lb.numpy() - np.asarray(lbj))) < 1e-10


@pytest.mark.parametrize("precision,xtol,ltol,seedset", [
    ("mixed", 1e-5, 1e-4, "tail"),
    ("f32", 5e-5, 5e-3, "uniform"),
])
def test_reduced_precisions_meet_jax_bars(stress40, precision, xtol, ltol,
                                          seedset):
    """The bars tests/test_precision.py states against the f64 path:
    'mixed' 1e-5 / 1e-4 with deep-tail seeds (the port's 'mixed' is f32
    contractions with the CDF in native f64, not the double-single
    rows), 'f32' 5e-5 / 5e-3 on uniform seeds.  The port must also be no
    further from f64 than 1.5x the JAX package at the same precision,
    plus 1e-7."""
    jtt, jg, ttt, tg, seeds, f64 = stress40
    q = seeds[seedset]
    xr, lr = f64[seedset]
    xt, lt = tp.tt_irt_sqr(tg, ttt, torch.from_numpy(q),
                           precision=precision, device="cpu")
    xj, lj = ti.tt_irt_sqr(jg, jtt, jnp.asarray(q), precision=precision)
    xt, lt = xt.numpy().astype(np.float64), lt.numpy().astype(np.float64)
    dx, dl = np.max(np.abs(xt - xr)), np.max(np.abs(lt - lr))
    jx = np.max(np.abs(np.asarray(xj) - xr))
    jl = np.max(np.abs(np.asarray(lj) - lr))
    print(f"{precision}: port vs f64 {dx:.3g}/{dl:.3g}, JAX vs f64 "
          f"{jx:.3g}/{jl:.3g}, port vs JAX "
          f"{np.max(np.abs(xt - np.asarray(xj))):.3g}/"
          f"{np.max(np.abs(lt - np.asarray(lj))):.3g}")
    assert dx < xtol and dl < ltol
    assert dx < 1.5 * jx + 1e-7 and dl < 1.5 * jl + 1e-7


@pytest.mark.parametrize("precision", ["hid", "gs", "ds"])
def test_factor_family_precisions_meet_jax_bars(stress40, precision):
    """'hid' (factor_conditional, the CDF in native f64, then
    condition_update), 'gs' (Gram conditional on f64-prepared fields, f32
    CDF rows, batched f64 epilogue) and 'ds' (factor form with an f64
    carry) on the tail-heavy seeds: 1e-5 / 1e-4 against the f64 path, the
    bars of tests/test_precision.py, and against the JAX run of the same
    name.  The JAX package carries 'hid' rows and 'ds' operands as
    double-single f32 pairs; the port uses native f64 there, so the port
    must be no further from f64 than 1.5x the JAX package plus 1e-7."""
    jtt, jg, ttt, tg, seeds, f64 = stress40
    q = seeds["tail"]
    xr, lr = f64["tail"]
    xt, lt = tp.tt_irt_sqr(tg, ttt, torch.from_numpy(q),
                           precision=precision, device="cpu")
    assert xt.dtype == torch.float64 and lt.dtype == torch.float64
    xj, lj = ti.tt_irt_sqr(jg, jtt, jnp.asarray(q), precision=precision)
    xt, lt = xt.numpy(), lt.numpy()
    dx, dl = np.max(np.abs(xt - xr)), np.max(np.abs(lt - lr))
    jx = np.max(np.abs(np.asarray(xj) - xr))
    jl = np.max(np.abs(np.asarray(lj) - lr))
    px = np.max(np.abs(xt - np.asarray(xj)))
    pl = np.max(np.abs(lt - np.asarray(lj)))
    print(f"{precision}: port vs f64 {dx:.3g}/{dl:.3g}, JAX vs f64 "
          f"{jx:.3g}/{jl:.3g}, port vs JAX {px:.3g}/{pl:.3g}")
    assert dx < 1e-5 and dl < 1e-4
    assert px < 1e-5 and pl < 1e-4
    assert dx < 1.5 * jx + 1e-7 and dl < 1.5 * jl + 1e-7


@pytest.mark.parametrize("precision,tol", [("f64", 1e-12), ("mixed", 1e-6),
                                           ("f32", 1e-5), ("hid", 1e-6),
                                           ("gs", 1e-5), ("ds", 1e-12)])
def test_rt_inverts_irt(stress40, precision, tol):
    """tt_rt_sqr(tt_irt_sqr(q)) == q on uniform seeds, to the working
    precision of the CDF."""
    _, _, ttt, tg, seeds, _ = stress40
    q = torch.from_numpy(seeds["uniform"][:256])
    x, _ = tp.tt_irt_sqr(tg, ttt, q, precision=precision, device="cpu")
    qb, _ = tp.tt_rt_sqr(tg, ttt, x, precision=precision, device="cpu")
    assert float((qb.double() - q).abs().max()) < tol


@pytest.mark.parametrize("precision", ["f64", "f32", "mixed", "hi", "hid",
                                       "gs", "ds"])
@pytest.mark.parametrize("mode", ["sqr", "rt"])
def test_irt_sampler_equals_functions(precision, mode):
    """IrtSampler (prepare once) returns exactly what tt_irt_sqr /
    tt_rt_sqr return, blocked or not."""
    cores, x = stress_cores(d=6, n=17, rank=4, seed=3)
    _, _, ttt, tg = _pair(cores, x)
    rng = np.random.default_rng(2)
    rows = rng.uniform(size=(300, 6))
    if mode == "rt":
        rows = -2.0 + 4.0 * rows
    rows = torch.from_numpy(rows)
    fn = tp.tt_irt_sqr if mode == "sqr" else tp.tt_rt_sqr
    a = fn(tg, ttt, rows, precision=precision, device="cpu")
    b = tp.IrtSampler(tg, ttt, mode, precision=precision, device="cpu")(rows)
    c = fn(tg, ttt, rows, block=128, precision=precision, device="cpu")
    tol = 1e-12 if precision in ("f64", "ds") else 1e-5
    for u, v, w in zip(a, b, c):
        assert torch.equal(u, v)
        assert u.shape == w.shape
        assert float((u - w).abs().max()) < tol


def test_default_precision_follows_dtype():
    """No precision given: f64 cores run 'f64', f32 cores 'f32', as in
    the JAX package."""
    cores, x = stress_cores(d=4, n=9, rank=3, seed=1)
    _, _, ttt, tg = _pair(cores, x)
    q = torch.from_numpy(np.random.default_rng(0).uniform(size=(32, 4)))
    x64, _ = tp.tt_irt_sqr(tg, ttt, q, device="cpu")
    assert x64.dtype == torch.float64
    t32 = tp.TT([c.float() for c in ttt.cores])
    x32, _ = tp.tt_irt_sqr(tg, t32, q, device="cpu")
    assert x32.dtype == torch.float32
    assert tp.IrtSampler(tg, ttt, device="cpu").precision == "f64"
    assert tp.IrtSampler(tg, t32, device="cpu").precision == "f32"


def test_numpy_oracle_pins_port_f64():
    """The independent numpy oracle (one-sided f64) vs the port's f64 on
    the d=8 stress TT: 1e-7 samples, 1e-6 log-density, the bars of
    test_precision.py::test_numpy_oracle_pins_jax_f64."""
    cores, x = stress_cores(d=8, n=17, rank=5)
    _, _, ttt, tg = _pair(cores, x)
    q = tail_seeds(512, 8)
    xt, lt = tp.tt_irt_sqr(tg, ttt, torch.from_numpy(q), precision="f64",
                           device="cpu")
    xo, lo = irt_sqr_numpy([x] * 8, cores, q)
    assert np.max(np.abs(xt.numpy() - xo)) < 1e-7
    assert np.max(np.abs(lt.numpy() - lo)) < 1e-6


def test_stable_false_matches_jax():
    """The Gram carry (stable=False) through the one-shot transform, f64:
    1e-9 against JAX's _irt_scan_one on the same stack."""
    from tt_irt_tpu.samplers import irt_scan as jscan
    from tt_irt_tpu_torch.samplers import irt_scan as tscan

    cores, x = stress_cores(d=8, n=17, rank=5)
    jtt, jg, ttt, tg = _pair(cores, x)
    q = np.random.default_rng(3).uniform(size=(256, 8))
    cj, xj = jscan.stack_padded(jtt, jg)
    ct, xt = tscan.stack_padded(ttt, tg)
    oj, lj = jscan._irt_scan_one("sqr", cj, xj, jnp.asarray(q),
                                 precision="f64", stable=False)
    ot, lt = tscan._irt_scan_one("sqr", ct, xt, torch.from_numpy(q),
                                 precision="f64", stable=False)
    assert np.max(np.abs(ot.numpy() - np.asarray(oj))) < 1e-9
    assert np.max(np.abs(lt.numpy() - np.asarray(lj))) < 1e-9


def test_non_scan_tt_and_lin_raise():
    """What raised NotImplementedError before the general path and mode
    'lin' were ported now runs and agrees with JAX f64 (1e-12): a
    marginal of the first D < d variables, a TT with non-uniform grid
    sizes, and mode 'lin' on the scan path.  A mode that does not exist
    raises ValueError."""
    cores, x = stress_cores(d=3, n=9, rank=2, seed=1)
    jtt, jg, ttt, tg = _pair(cores, x)
    q = np.random.default_rng(2).uniform(size=(8, 3))
    xt, lt = tp.tt_irt_sqr(tg, ttt, torch.from_numpy(q[:, :2]), device="cpu")
    xj, lj = ti.tt_irt_sqr(jg, jtt, jnp.asarray(q[:, :2]))
    assert np.max(np.abs(xt.numpy() - np.asarray(xj))) < 1e-12
    assert np.max(np.abs(lt.numpy() - np.asarray(lj))) < 1e-12
    odd = [cores[0], cores[1][:, :7, :], cores[2]]
    og = [x, np.linspace(-2.0, 2.0, 7), x]
    xt, lt = tp.tt_irt_sqr([torch.from_numpy(g) for g in og],
                           tp.TT([torch.from_numpy(c.copy()) for c in odd]),
                           torch.from_numpy(q), device="cpu")
    xj, lj = ti.tt_irt_sqr([jnp.asarray(g) for g in og],
                           ti.TT([jnp.asarray(c) for c in odd]),
                           jnp.asarray(q))
    assert np.max(np.abs(xt.numpy() - np.asarray(xj))) < 1e-12
    assert np.max(np.abs(lt.numpy() - np.asarray(lj))) < 1e-12
    cs, xs = tp.samplers.irt_scan.stack_padded(ttt, tg)
    xt, lt = tp.irt_scan("lin", cs, xs, torch.from_numpy(q), 1024, "f64")
    xj, lj = ti.tt_irt_lin(jg, jtt, jnp.asarray(q), precision="f64")
    assert np.max(np.abs(xt.numpy() - np.asarray(xj))) < 1e-12
    assert np.max(np.abs(lt.numpy() - np.asarray(lj))) < 1e-12
    with pytest.raises(ValueError):
        tp.irt_scan("cube", cs, xs, torch.from_numpy(q), 1024, "f64")
