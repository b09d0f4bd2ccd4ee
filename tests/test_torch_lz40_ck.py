"""The shipped lz40_ck checkpoint (d=40, n=17, 11 tempered levels plus
level 0, ranks 15 on levels 0-4 and level 0, 19 on levels 5-10,
reference 'n3') served by the port's DirtSampler against the JAX
package's on the same 512 seeds, at 'f64' and at 'hi' (the precision
DirtSampler('auto') picks at d=40)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tt_irt_tpu as ti
import tt_irt_tpu_torch as tp
from tt_irt_tpu.utils.checkpoint import load_dirt as jax_load

PATH = os.path.join(os.path.dirname(__file__), "..", "examples", "data",
                    "lz40_ck")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread a process, so that parallel test workers do
    not oversubscribe the cores; the caller's setting comes back."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def served():
    """Both packages' 'f64' and 'hi' serves of 512 'n3' seeds."""
    jd = jax_load(PATH)
    td = tp.load_dirt(PATH, device="cpu")
    u = np.random.default_rng(0).uniform(size=(512, jd.d))
    q = np.array(ti.randref("n3", jnp.asarray(u)))
    out = {}
    for prec in ("f64", "hi"):
        out["jax", prec] = tuple(np.asarray(a) for a in ti.DirtSampler(
            jd, precision=prec)(jnp.asarray(q)))
        sampler = tp.DirtSampler(td, precision=prec, device="cpu")
        out["port", prec] = tuple(a.numpy() for a in sampler(
            torch.from_numpy(q)))
        out["sampler", prec] = sampler
    return out


def test_lz40_ck_f64_matches_jax(served):
    """'f64' against JAX 'f64': samples 1e-9, lfapp 1e-8 (measured
    1.4e-11 / 2.5e-10: the two packages' f64 preparations sum in
    different orders)."""
    zj, lj = served["jax", "f64"]
    zt, lt = served["port", "f64"]
    assert zt.shape == (512, 40)
    assert np.max(np.abs(zt - zj)) < 1e-9
    assert np.max(np.abs(lt - lj)) < 1e-8


def test_lz40_ck_hi_matches_jax(served):
    """'hi' against JAX 'hi'.  On this n=17 stack the f32 'hi' chain
    sits at p99 ~1e-3 from f64 in both packages (ROADMAP Queue 3), so
    the bars come from JAX 'hi''s own distance to the JAX f64 serve on
    these seeds: the port's 99th percentile and maximum row error (in
    samples and in lfapp) at most twice JAX's, and the port's row gap to
    JAX 'hi' at the median and the 99th percentile at most twice JAX
    'hi''s distance to f64 there.  The rank buckets are 16 (levels 0-4)
    and 19 (levels 5-10), level 0 at 15, as the JAX package buckets
    them."""
    z64, l64 = served["jax", "f64"]
    zj, lj = served["jax", "hi"]
    zt, lt = served["port", "hi"]
    assert np.all(np.isfinite(zt)) and np.all(np.isfinite(lt))
    for port, ref, exact in ((zt, zj, z64), (lt, lj, l64)):
        ep = np.abs(port - exact).reshape(512, -1).max(1)
        ej = np.abs(ref - exact).reshape(512, -1).max(1)
        assert np.quantile(ep, 0.99) <= 2.0 * np.quantile(ej, 0.99)
        assert ep.max() <= 2.0 * ej.max()
        # the two packages' 'hi' chains against each other: their row
        # gap at the median and the 99th percentile at most twice JAX
        # 'hi''s own distance to f64 there (two chains' independent f32
        # noise; measured 1.4x / 1.6x in samples, 1.4x / 1.5x in lfapp)
        gap = np.abs(port - ref).reshape(512, -1).max(1)
        for qt in (0.5, 0.99):
            assert np.quantile(gap, qt) <= 2.0 * np.quantile(ej, qt)
    sampler = served["sampler", "hi"]
    assert sampler.precision == "hi"
    ranks = [p.bmat.shape[1] for p in sampler._upper]
    assert ranks == [16] * 5 + [19] * 6
    assert sampler._prep0.bmat.shape[1] == 15


def test_lz40_ck_auto_is_hi():
    """DirtSampler('auto') serves d=40 at 'hi'."""
    td = tp.load_dirt(PATH, device="cpu")
    assert tp.serve_precision(td) == "hi"
