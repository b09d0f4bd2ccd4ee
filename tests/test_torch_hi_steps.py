"""tt_irt_sqr / tt_rt_sqr of the port at every ``hi_step`` of precision
'hi' ("dim", "odim", "bracket", "pair") against the JAX run of the same
variant, against the port's default step, and against 'f64'."""

import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tt_irt_tpu as ti
import tt_irt_tpu_torch as tp
from tt_irt_tpu.samplers import irt_scan as jscan
from tt_irt_tpu_torch.samplers import irt_scan as tscan

from test_torch_precisions import stress_cores, tail_seeds
from test_torch_serve import _mk_cores

HI_STEPS = ["dim", "odim", "bracket", "pair"]
# hi_step -> the `fused` argument of the JAX package's _irt_scan_one
JAX_FUSED = {"dim": 0, "odim": 0, "bracket": 2, "pair": 1}


@contextlib.contextmanager
def jax_ortho(on: bool):
    """TTIRT_HI_ORTHO for the JAX package.  The knob is read when a
    function is traced and is no part of the jit cache key, so the
    caches are cleared on entry and, with the variable restored, on
    exit: no later test traces under a leaked setting."""
    old = os.environ.get("TTIRT_HI_ORTHO")
    if on:
        os.environ["TTIRT_HI_ORTHO"] = "1"
    else:
        os.environ.pop("TTIRT_HI_ORTHO", None)
    jax.clear_caches()
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("TTIRT_HI_ORTHO", None)
        else:
            os.environ["TTIRT_HI_ORTHO"] = old
        jax.clear_caches()


@pytest.fixture(scope="module")
def small():
    """_mk_tt(d=6, n=17, r=5) of the JAX kernel tests in both packages,
    512 uniform seeds, and the port's default-step results."""
    cores, x = _mk_cores(d=6, n=17, r=5, seed=11)
    d = len(cores)
    q = np.random.default_rng(13).uniform(size=(512, d))
    cj, xj = jscan.stack_padded(ti.TT([jnp.asarray(c) for c in cores]),
                                [jnp.asarray(x)] * d)
    ttt = tp.TT([torch.from_numpy(c) for c in cores])
    tg = [torch.from_numpy(x)] * d
    xd, ld = tp.tt_irt_sqr(tg, ttt, torch.from_numpy(q), precision="hi",
                           device="cpu")
    return cj, xj, ttt, tg, q, xd.numpy(), ld.numpy()


def _jax_run(mode, hi_step, cj, xj, rows):
    with jax_ortho(hi_step == "odim"):
        out, lf = jscan._irt_scan_one(mode, cj, xj, jnp.asarray(rows),
                                      precision="hi",
                                      fused=JAX_FUSED[hi_step])
        return np.array(out), np.array(lf)


@pytest.mark.parametrize("hi_step", HI_STEPS)
def test_hi_step_matches_jax_variant(small, hi_step):
    """Port vs the JAX run of the same variant (XLA serveb, the XLA
    ortho scan under TTIRT_HI_ORTHO=1, fused=2, fused=1; Pallas kernels
    in interpret mode), 'sqr' and 'rt': samples 1e-6, log-density 1e-5,
    the bars of tests/test_fused_step.py for two f32 row pipelines with
    different summation orders; rt(irt(q)) returns q to 1e-5."""
    cj, xj, ttt, tg, q, _, _ = small
    xj_, lj = _jax_run("sqr", hi_step, cj, xj, q)
    qj, lrj = _jax_run("rt", hi_step, cj, xj, xj_)
    xt, lt = tp.tt_irt_sqr(tg, ttt, torch.from_numpy(q), precision="hi",
                           device="cpu", hi_step=hi_step)
    qt, lrt = tp.tt_rt_sqr(tg, ttt, torch.from_numpy(xj_), precision="hi",
                           device="cpu", hi_step=hi_step)
    errs = (np.max(np.abs(xt.numpy() - xj_)), np.max(np.abs(lt.numpy() - lj)),
            np.max(np.abs(qt.numpy() - qj)), np.max(np.abs(lrt.numpy() - lrj)))
    print(f"{hi_step}: port vs JAX x {errs[0]:.3g} lf {errs[1]:.3g} "
          f"u {errs[2]:.3g} lu {errs[3]:.3g}")
    assert errs[0] < 1e-6 and errs[1] < 1e-5
    assert errs[2] < 1e-6 and errs[3] < 1e-5
    qb, _ = tp.tt_rt_sqr(tg, ttt, xt, precision="hi", device="cpu",
                         hi_step=hi_step)
    assert float((qb - torch.from_numpy(q)).abs().max()) < 1e-5


@pytest.mark.parametrize("hi_step", HI_STEPS[1:])
def test_hi_step_matches_default_step(small, hi_step):
    """Each variant against the port's "dim": the same transform by
    another f32 algorithm (for "odim" in another carry basis): samples
    1e-5, log-density 1e-4, the bars of
    test_odim_kernel_matches_ortho_and_factor_paths."""
    _, _, ttt, tg, q, xd, ld = small
    xt, lt = tp.tt_irt_sqr(tg, ttt, torch.from_numpy(q), precision="hi",
                           device="cpu", hi_step=hi_step)
    assert np.max(np.abs(xt.numpy() - xd)) < 1e-5
    assert np.max(np.abs(lt.numpy() - ld)) < 1e-4


@pytest.mark.parametrize("hi_step", ["bracket", "pair"])
def test_split_steps_deep_tail_rows(hi_step):
    """The stack and seeds of tests/test_pallas.py::
    test_fused_step_levels_match_hi (d=8, n=17, r=9 on [-6, 6]; rows of
    1e-9 and 1 - 1e-9 stress the two-sided inversion): the split step
    against the JAX XLA 'hi' path, 2e-5 / 2e-4, and the rt roundtrip to
    1e-6."""
    d, n, r = 8, 17, 9
    rng = np.random.default_rng(5)
    x = np.linspace(-6, 6, n)
    cores = []
    for k in range(d):
        r1 = 1 if k == 0 else r
        r2 = 1 if k == d - 1 else r
        c = np.exp(-(x[None, :, None] ** 2) / 14.0) * \
            rng.uniform(0.2, 1.0, (r1, 1, r2))
        cores.append(np.broadcast_to(c, (r1, n, r2)).copy())
    q = np.random.default_rng(0).random((400, d))
    q[0, :] = 1e-9
    q[1, :] = 1.0 - 1e-9
    cj, xj = jscan.stack_padded(ti.TT([jnp.asarray(c) for c in cores]),
                                [jnp.asarray(x)] * d)
    oj, lj = jscan._irt_scan_one("sqr", cj, xj, jnp.asarray(q),
                                 precision="hi", fused=0)
    ct, xt = tscan.stack_padded(tp.TT([torch.from_numpy(c) for c in cores]),
                                [torch.from_numpy(x)] * d)
    ot, lt = tscan._irt_scan_one("sqr", ct, xt, torch.from_numpy(q),
                                 precision="hi", hi_step=hi_step)
    assert np.max(np.abs(ot.numpy() - np.asarray(oj))) < 2e-5
    assert np.max(np.abs(lt.numpy() - np.asarray(lj))) < 2e-4
    qb, _ = tscan._irt_scan_one("rt", ct, xt, ot, precision="hi",
                                hi_step=hi_step)
    assert float((qb - torch.from_numpy(q)).abs().max()) < 1e-6


def test_odim_on_stress_tt_meets_f64_bars():
    """"odim" on the d=40 stress TT with deep-tail seeds against the
    port's 'f64': 1e-5 / 1e-4, the bars of tests/test_precision.py::
    test_hi_ortho_policy_and_parity, and the rt roundtrip to 1e-5.  The
    raw-factor "dim" on the same rows is printed beside it (measured:
    "odim" 2.2e-7 / 4.7e-6 from 'f64', "dim" 6.7e-8 / 4.2e-6)."""
    cores, x = stress_cores()
    ttt = tp.TT([torch.from_numpy(c.copy()) for c in cores])
    tg = [torch.from_numpy(x.copy())] * 40
    q = torch.from_numpy(tail_seeds(1024, 40))
    x64, l64 = tp.tt_irt_sqr(tg, ttt, q, precision="f64", device="cpu")
    xo, lo = tp.tt_irt_sqr(tg, ttt, q, precision="hi", device="cpu",
                           hi_step="odim")
    xd, ld = tp.tt_irt_sqr(tg, ttt, q, precision="hi", device="cpu")
    dx, dl = float((xo - x64).abs().max()), float((lo - l64).abs().max())
    ex, el = float((xd - x64).abs().max()), float((ld - l64).abs().max())
    print(f"odim vs f64 {dx:.3g}/{dl:.3g}; dim vs f64 {ex:.3g}/{el:.3g}")
    assert dx < 1e-5 and dl < 1e-4
    assert ex < 1e-5 and el < 1e-4
    qb, _ = tp.tt_rt_sqr(tg, ttt, xo, precision="hi", device="cpu",
                         hi_step="odim")
    assert float((qb - q).abs().max()) < 1e-5


@pytest.mark.parametrize("entry", ["tt_irt_sqr", "tt_rt_sqr", "IrtSampler",
                                   "irt_scan", "DirtSampler"])
def test_hi_step_is_only_legal_with_hi(entry):
    """A non-default hi_step with another precision, and an unknown
    hi_step, raise ValueError at every entry point that takes it."""
    cores, x = _mk_cores(d=3, n=9, r=2)
    ttt = tp.TT([torch.from_numpy(c) for c in cores])
    tg = [torch.from_numpy(x)] * 3
    q = torch.rand((8, 3), dtype=torch.float64)

    def call(precision, hi_step):
        if entry == "IrtSampler":
            return tp.IrtSampler(tg, ttt, precision=precision, device="cpu",
                                 hi_step=hi_step)
        if entry == "irt_scan":
            cs, xs = tscan.stack_padded(ttt, tg)
            return tp.irt_scan("sqr", cs, xs, q, 1024, precision, hi_step)
        if entry == "DirtSampler":
            data = os.path.join(os.path.dirname(__file__), "..", "examples",
                                "data", "lz10_ck")
            return tp.DirtSampler(tp.load_dirt(data, device="cpu"),
                                  precision=precision, device="cpu",
                                  hi_step=hi_step)
        return getattr(tp, entry)(tg, ttt, q, precision=precision,
                                  device="cpu", hi_step=hi_step)

    for precision in ("f32", "hid", "gs"):
        with pytest.raises(ValueError, match="hi_step"):
            call(precision, "odim")
    with pytest.raises(ValueError, match="hi_step"):
        call("hi", "fused")
    assert call("hi", "pair") is not None
