"""The port's functional DIRT API (tt_dirt_sample, tt_dirt_inverse,
dirt_round, dirt_permute) and DirtSampler's ragged_step against the JAX
package on the shipped lz10_ck checkpoint (d=10, 12 tempered levels plus
level 0, n=17, reference 'n3') and the same seeds."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tt_irt_tpu as ti
import tt_irt_tpu_torch as tp
from tt_irt_tpu.ops.tt import tt_round as jax_round
from tt_irt_tpu.utils.checkpoint import load_dirt as jax_load

PATH = os.path.join(os.path.dirname(__file__), "..", "examples", "data",
                    "lz10_ck")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread a process, so that parallel test workers do
    not oversubscribe the cores; the caller's setting comes back."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def lz10():
    jd = jax_load(PATH)
    td = tp.load_dirt(PATH, device="cpu")
    u = np.random.default_rng(7).uniform(size=(256, jd.d))
    q = np.array(ti.randref(jd.reference, jnp.asarray(u)))
    return jd, td, q


def _max(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


def test_dirt_sample_and_inverse_f64_match_jax(lz10):
    """tt_dirt_sample and tt_dirt_inverse at 'f64' against the JAX
    functions (1e-11; measured 1.5e-14 / 4.3e-14 and 9.4e-14 /
    1.8e-13), and the round trip back to the seeds within the JAX
    package's own bar (test_dirt_inverse_roundtrip: 1e-6)."""
    jd, td, q = lz10
    zj, lj = ti.tt_dirt_sample(jd, jnp.asarray(q), precision="f64")
    zt, lt = tp.tt_dirt_sample(td, torch.from_numpy(q), precision="f64",
                               device="cpu")
    assert _max(zt, zj) < 1e-11 and _max(lt, lj) < 1e-11
    qj, lij = ti.tt_dirt_inverse(jd, zj)
    qt, lit = tp.tt_dirt_inverse(td, zt, device="cpu")
    assert _max(qt, qj) < 1e-11 and _max(lit, lij) < 1e-10
    assert _max(qt, q) < 1e-6
    zl, _, le = tp.tt_dirt_sample(td, torch.from_numpy(q), lambda z: z[:, 0],
                                  precision="f64", device="cpu")
    assert torch.equal(zl, zt) and torch.equal(le, zt[:, 0])


@pytest.mark.parametrize("precision", ["hi", "f32"])
def test_dirt_sample_equals_dirt_sampler(lz10, precision):
    """The functional API and the prepared sampler: same preparations,
    same rank buckets, so the same outputs bit for bit."""
    _, td, q = lz10
    qt = torch.from_numpy(q)
    zs, ls = tp.DirtSampler(td, precision=precision, device="cpu")(qt)
    zt, lt = tp.tt_dirt_sample(td, qt, precision=precision, device="cpu")
    assert torch.equal(zs, zt) and torch.equal(ls, lt)


def _crushed(jd, td):
    """lz10_ck with its first upper level rounded to rank 2, so that the
    rank buckets of the ragged steps differ."""
    fj = [jax_round(jd.fs[0], 0.0, rmax=2)] + list(jd.fs[1:])
    ft = [tp.tt_round(td.fs[0], 0.0, rmax=2)] + list(td.fs[1:])
    return (ti.DIRT(jd.f0, fj, jd.x0, jd.x, jd.beta, jd.lfshift,
                    jd.reference, jd.interpolation),
            tp.DIRT(td.f0, ft, td.x0, td.x, td.beta, td.lfshift,
                    td.reference, td.interpolation))


@pytest.mark.parametrize("step", [0, 1, 4])
def test_ragged_step_matches_jax(lz10, step):
    """DirtSampler(precision='hi', ragged_step=step) against the JAX
    DirtSampler with the same step on the crushed stack (as
    tests/test_dirt.py::test_dirt_sampler_ragged_ranks): samples 1e-5,
    lfapp 1e-4 (the bars of the lz10 'hi' comparison,
    tests/test_torch_serve.py); the crushed level's prep carries its own
    bucket rank."""
    jd, td = _crushed(*lz10[:2])
    q = lz10[2]
    zj, lj = ti.DirtSampler(jd, precision="hi", ragged_step=step)(
        jnp.asarray(q))
    sampler = tp.DirtSampler(td, precision="hi", ragged_step=step,
                             device="cpu")
    zt, lt = sampler(torch.from_numpy(q))
    assert _max(zt, zj) < 1e-5 and _max(lt, lj) < 1e-4
    rmax = max(max(f.ranks) for f in td.fs)
    assert sampler._upper[0].bmat.shape[1] == {0: rmax, 1: 2, 4: 4}[step]
    if step == 4:
        zf, lf = tp.tt_dirt_sample(td, torch.from_numpy(q), precision="hi",
                                   device="cpu")
        assert torch.equal(zf, zt) and torch.equal(lf, lt)


def test_dirt_round_matches_jax(lz10):
    """dirt_round(lz10_ck, 1e-2): the same ranks per level as JAX's, and
    both rounded stacks served at 'f64' on the same seeds agree (1e-11;
    measured 1.4e-14 / 5.5e-14)."""
    jd, td, q = lz10
    rj, rt = ti.dirt_round(jd, 1e-2), tp.dirt_round(td, 1e-2)
    assert rt.f0.ranks == rj.f0.ranks
    assert [f.ranks for f in rt.fs] == [f.ranks for f in rj.fs]
    assert (max(max(f.ranks) for f in rt.fs)
            < max(max(f.ranks) for f in td.fs))
    zj, lj = ti.DirtSampler(rj, precision="f64")(jnp.asarray(q))
    zt, lt = tp.DirtSampler(rt, precision="f64", device="cpu")(
        torch.from_numpy(q))
    assert _max(zt, zj) < 1e-11 and _max(lt, lj) < 1e-11


def test_dirt_permute_matches_jax(lz10):
    """dirt_permute swapping the first two coordinates: the same ranks as
    JAX's, the grids permuted, and both stacks served at 'f64' on the
    same seeds agree (1e-10)."""
    jd, td, q = lz10
    perm = [1, 0] + list(range(2, jd.d))
    pj, pt_ = ti.dirt_permute(jd, perm), tp.dirt_permute(td, perm)
    assert [f.ranks for f in pt_.fs] == [f.ranks for f in pj.fs]
    assert pt_.fprev is None
    zj, lj = ti.DirtSampler(pj, precision="f64")(jnp.asarray(q))
    zt, lt = tp.DirtSampler(pt_, precision="f64", device="cpu")(
        torch.from_numpy(q))
    assert _max(zt, zj) < 1e-10 and _max(lt, lj) < 1e-10


def test_what_still_raises(lz10):
    """What the JAX package refuses too: tt_dirt_inverse of a spectral
    stack (NotImplementedError), and the fused whole-stack program where
    can_fuse says no (ValueError); a CUDA device without a card raises."""
    _, td, q = lz10
    z, _ = tp.tt_dirt_sample(td, torch.from_numpy(q), use_fused=True,
                             device="cpu")
    assert z.shape == q.shape
    cheb = tp.DIRT(td.f0, td.fs, td.x0, td.x, td.beta, td.lfshift,
                   td.reference, "chebyshev")
    with pytest.raises(ValueError, match="can_fuse"):
        tp.tt_dirt_sample(cheb, torch.from_numpy(q), use_fused=True,
                          device="cpu")
    with pytest.raises(NotImplementedError):
        tp.tt_dirt_inverse(cheb, torch.from_numpy(q), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tp.tt_dirt_sample(td, torch.from_numpy(q))
