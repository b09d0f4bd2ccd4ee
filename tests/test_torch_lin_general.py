"""Mode 'lin' on the scan path and the general (unrolled) path of the
port (tt_irt_tpu_torch/samplers/irt.py, irt_scan.py, serve.py) against
the JAX package, on the same numpy cores and seeds."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tt_irt_tpu as ti
import tt_irt_tpu_torch as tp
from tt_irt_tpu_torch.samplers import irt_scan as tscan

from test_torch_precisions import _pair, stress_cores

D, N, R = 6, 9, 4


@pytest.fixture(scope="module")
def lin_case():
    cores, x = stress_cores(d=D, n=N, rank=R, seed=3)
    q = np.random.default_rng(1).uniform(size=(400, D))
    return _pair(cores, x) + (q, cores, x)


# Bars of mode 'lin' against JAX per precision name, (samples,
# log-density).  'f64' is f64 throughout in both packages (measured
# 3e-16 / 3e-15).  'f32' is f32 throughout: two f32 pipelines (measured
# 1.2e-7 / 1.2e-6).  Every other name is f32 contractions with an f64
# CDF; the JAX package's 'mixed' CDF is its compensated f32-row form,
# the port's native f64 (measured 5.3e-8 / 2.4e-7).
LIN_BARS = {"f64": (1e-12, 1e-12), "f32": (1e-6, 1e-5)}


@pytest.mark.parametrize("precision", ["f64", "f32", "mixed", "hi", "hid",
                                       "ds", "gs"])
def test_lin_scan_matches_jax(lin_case, precision):
    """tt_irt_lin, IrtSampler(mode='lin') and irt_scan('lin') at every
    precision name against JAX tt_irt_lin on the scan path; bars in
    LIN_BARS (default 1e-6 / 1e-5)."""
    jtt, jg, ttt, tg, q, _, _ = lin_case
    xj, lj = ti.tt_irt_lin(jg, jtt, jnp.asarray(q), precision=precision)
    xt, lt = tp.tt_irt_lin(tg, ttt, torch.from_numpy(q), precision=precision,
                           device="cpu")
    bx, bl = LIN_BARS.get(precision, (1e-6, 1e-5))
    assert np.max(np.abs(xt.numpy() - np.asarray(xj))) < bx
    assert np.max(np.abs(lt.numpy() - np.asarray(lj))) < bl
    xs, ls = tp.IrtSampler(tg, ttt, "lin", precision=precision,
                           device="cpu")(torch.from_numpy(q))
    assert torch.equal(xs, xt) and torch.equal(ls, lt)
    cs, xst = tscan.stack_padded(ttt, tg)
    xi, li = tp.irt_scan("lin", cs, xst, torch.from_numpy(q), 1024, precision)
    assert torch.equal(xi, xt) and torch.equal(li, lt)


def test_lin_prep_is_the_integral(lin_case):
    """The 'lin' fields: P_0 contracted with the trapezoid weights of
    dimension 0 is the whole integral up to the renormalisations, and
    P_{d-1} is the last core (boundary rank 1)."""
    _, _, ttt, tg, _, _, _ = lin_case
    cs, xs = tscan.stack_padded(ttt, tg)
    prep = tscan._prep(cs, xs, "f64", mode="lin")
    assert isinstance(prep, tscan.LinPrep)
    assert prep.pmat.shape == (D, R, N)
    assert torch.allclose(prep.pmat[-1], cs[-1, :, :, 0])
    assert bool((prep.pmat[0, 0] >= 0).all())
    with pytest.raises(ValueError):
        tp.irt_scan("cube", cs, xs, torch.rand(4, D, dtype=torch.float64),
                    1024)


@pytest.mark.parametrize("mode", ["sqr", "rt", "lin"])
def test_general_path_forced_on_a_scan_tt(lin_case, mode):
    """use_scan=False on a scan-eligible TT: the general path against
    JAX's general path (1e-12; measured 2e-15 / 4e-14) and against the
    port's own scan path (1e-11)."""
    jtt, jg, ttt, tg, q, _, _ = lin_case
    fns = {"sqr": (tp.tt_irt_sqr, ti.tt_irt_sqr),
           "rt": (tp.tt_rt_sqr, ti.tt_rt_sqr),
           "lin": (tp.tt_irt_lin, ti.tt_irt_lin)}[mode]
    if mode == "rt":
        q = np.array(ti.tt_irt_sqr(jg, jtt, jnp.asarray(q))[0])
    xj, lj = fns[1](jg, jtt, jnp.asarray(q), use_scan=False)
    xt, lt = fns[0](tg, ttt, torch.from_numpy(q), use_scan=False,
                    device="cpu")
    assert np.max(np.abs(xt.numpy() - np.asarray(xj))) < 1e-12
    assert np.max(np.abs(lt.numpy() - np.asarray(lj))) < 1e-12
    xs, ls = fns[0](tg, ttt, torch.from_numpy(q), device="cpu")
    assert float((xt - xs).abs().max()) < 1e-11
    assert float((lt - ls).abs().max()) < 1e-11


def _ragged(cores, x):
    cores = [c.copy() for c in cores]
    cores[2] = cores[2][:, :7, :]
    grids = [x] * len(cores)
    grids[2] = np.linspace(-2.0, 2.0, 7)
    return cores, grids


def _left_block(cores, x):
    cores = [c.copy() for c in cores]
    cores[0] = np.concatenate([cores[0], 0.5 * cores[0][:, ::-1, :]], axis=0)
    return cores, [x] * len(cores)


def _right_block(cores, x):
    cores = [c.copy() for c in cores]
    cores[-1] = np.concatenate([cores[-1], cores[-1][:, ::-1, :]], axis=2)
    return cores, [x] * len(cores)


@pytest.mark.parametrize("case", ["ragged", "left_block", "right_block"])
@pytest.mark.parametrize("mode", ["sqr", "lin"])
def test_general_path_non_scan_tts(lin_case, case, mode):
    """TTs the scan path does not take, through tt_irt_sqr / tt_irt_lin
    and IrtSampler: ragged grid sizes, a left boundary rank 2, a right
    boundary rank 2.  Against JAX f64 at 1e-12, and rt(irt(q)) = q
    (1e-10) in 'sqr' mode."""
    _, _, _, _, q, cores, x = lin_case
    cores, grids = {"ragged": _ragged, "left_block": _left_block,
                    "right_block": _right_block}[case](cores, x)
    jtt = ti.TT([jnp.asarray(c) for c in cores])
    ttt = tp.tt_from_numpy(cores, device="cpu")
    assert ttt.ranks == jtt.ranks and ttt.n == jtt.n
    jg = [jnp.asarray(g) for g in grids]
    tg = [torch.from_numpy(g) for g in grids]
    jfn, tfn = ((ti.tt_irt_sqr, tp.tt_irt_sqr) if mode == "sqr"
                else (ti.tt_irt_lin, tp.tt_irt_lin))
    xj, lj = jfn(jg, jtt, jnp.asarray(q))
    xt, lt = tfn(tg, ttt, torch.from_numpy(q), device="cpu")
    assert np.max(np.abs(xt.numpy() - np.asarray(xj))) < 1e-12
    assert np.max(np.abs(lt.numpy() - np.asarray(lj))) < 1e-12
    xs, ls = tp.IrtSampler(tg, ttt, mode, device="cpu")(torch.from_numpy(q))
    assert torch.equal(xs, xt) and torch.equal(ls, lt)
    if mode == "sqr":
        qb, _ = tp.IrtSampler(tg, ttt, "rt", device="cpu")(xt)
        assert float((qb - torch.from_numpy(q)).abs().max()) < 1e-10


@pytest.mark.parametrize("dsample", [1, 3])
def test_general_path_marginal(lin_case, dsample):
    """A marginal of the first D < d variables against JAX (1e-12), and
    blocked (block=128, rows padded) equal to one block."""
    jtt, jg, ttt, tg, q, _, _ = lin_case
    qd = q[:, :dsample]
    xj, lj = ti.tt_irt_sqr(jg, jtt, jnp.asarray(qd))
    xt, lt = tp.tt_irt_sqr(tg, ttt, torch.from_numpy(qd), device="cpu")
    assert xt.shape == (q.shape[0], dsample)
    assert np.max(np.abs(xt.numpy() - np.asarray(xj))) < 1e-12
    assert np.max(np.abs(lt.numpy() - np.asarray(lj))) < 1e-12
    xb, lb = tp.tt_irt_sqr(tg, ttt, torch.from_numpy(qd), block=128,
                           device="cpu")
    assert float((xb - xt).abs().max()) < 1e-13
    assert float((lb - lt).abs().max()) < 1e-13


def test_general_dirt_levels_serve(lin_case):
    """A DIRT whose upper level has a ragged grid size takes the general
    path level by level in DirtSampler and tt_dirt_sample, equal to each
    other and to JAX tt_dirt_sample at f64 (1e-12)."""
    _, _, _, _, q, cores, x = lin_case
    rc, grids = _ragged(cores, x)
    u = np.clip(q[:64], 1e-6, 1 - 1e-6)
    jd = ti.DIRT(ti.TT([jnp.asarray(c) for c in cores]),
                 [ti.TT([jnp.asarray(c) for c in rc])],
                 [jnp.asarray(x)] * D, [jnp.asarray(g) for g in grids],
                 np.array([0.5, 1.0]))
    td = tp.dirt_from_numpy(cores, [rc], [x] * D, grids,
                            np.array([0.5, 1.0]), device="cpu")
    zj, lj = ti.tt_dirt_sample(jd, jnp.asarray(u), precision="f64")
    zs, ls = tp.DirtSampler(td, precision="f64", device="cpu")(
        torch.from_numpy(u))
    zt, lt = tp.tt_dirt_sample(td, torch.from_numpy(u), precision="f64",
                               device="cpu")
    assert torch.equal(zs, zt) and torch.equal(ls, lt)
    assert np.max(np.abs(zt.numpy() - np.asarray(zj))) < 1e-12
    assert np.max(np.abs(lt.numpy() - np.asarray(lj))) < 1e-12


def test_general_dirt_levels_take_the_block(lin_case, monkeypatch):
    """DirtSampler(block=...) reaches the general path of every upper
    level (the blocks it is given are the caller's), and serving in
    blocks of 16 rows gives the unblocked outputs (1e-13)."""
    from tt_irt_tpu_torch.samplers import dirt as tdirt

    _, _, _, _, q, cores, x = lin_case
    rc, grids = _ragged(cores, x)
    u = torch.from_numpy(np.clip(q[:64], 1e-6, 1 - 1e-6))
    td = tp.dirt_from_numpy(cores, [rc], [x] * D, grids,
                            np.array([0.5, 1.0]), device="cpu")
    z0, l0 = tp.DirtSampler(td, precision="f64", device="cpu")(u)
    seen = []
    inner = tdirt.tt_irt_sqr

    def recorded(*args, block=None, **kw):
        seen.append(block)
        return inner(*args, block=block, **kw)

    monkeypatch.setattr(tdirt, "tt_irt_sqr", recorded)
    zb, lb = tp.DirtSampler(td, precision="f64", block=16, device="cpu")(u)
    assert seen == [16] * td.nlevels
    assert float((zb - z0).abs().max()) < 1e-13
    assert float((lb - l0).abs().max()) < 1e-13
