"""The port's utilities against the JAX package's: tracemult and
tracemult_gather (1e-12), the numpy oracle's copy (bit for bit); the
torch.profiler trace and the program's ``ttirt.*`` spans in it (their
nesting and counts on every serve path, none outside a capture); and
verify_env on the CPU."""

import json
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tt_irt_tpu.ops.tracemult import tracemult as j_tracemult
from tt_irt_tpu.ops.tracemult import tracemult_gather as j_gather
from tt_irt_tpu.utils.reference_numpy import irt_sqr_numpy as j_irt_numpy
from tt_irt_tpu_torch.ops.tracemult import tracemult, tracemult_gather
from tt_irt_tpu_torch.utils import profiling
from tt_irt_tpu_torch.utils.reference_numpy import irt_sqr_numpy


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread a process, so that parallel test workers do
    not oversubscribe the cores; the caller's setting comes back."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("gather", [False, True])
def test_tracemult_matches_jax(gather):
    rng = np.random.default_rng(0)
    a = rng.standard_normal((40, 3, 5))
    b = rng.standard_normal((7 if gather else 40, 5, 4))
    j = rng.integers(0, 7, 40) if gather else None
    got = tracemult(torch.from_numpy(a), torch.from_numpy(b),
                    None if j is None else torch.from_numpy(j))
    want = np.asarray(j_tracemult(jnp.asarray(a), jnp.asarray(b),
                                  None if j is None else jnp.asarray(j)))
    assert got.shape == (40, 3, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)


def test_tracemult_gather_matches_jax():
    rng = np.random.default_rng(1)
    a = rng.standard_normal((50, 9))
    j = rng.integers(0, 9, 50)
    got = tracemult_gather(torch.from_numpy(a), torch.from_numpy(j))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(j_gather(jnp.asarray(a),
                                                   jnp.asarray(j))),
                               rtol=0, atol=1e-12)


def test_reference_numpy_copy_is_the_jax_modules():
    """The port's copy of the numpy oracle gives the JAX module's output
    bit for bit (rank-3 positive TT, d=4, with the degenerate seeds 0
    and 1)."""
    rng = np.random.default_rng(2)
    d, n, r = 4, 11, 3
    cores = [rng.uniform(0.1, 1.0, (1 if k == 0 else r, n,
                                    1 if k == d - 1 else r))
             for k in range(d)]
    grids = [np.linspace(-1.0, 1.0, n)] * d
    q = rng.random((64, d))
    q[0], q[1] = 0.0, 1.0
    xa, la = irt_sqr_numpy(grids, cores, q)
    xb, lb = j_irt_numpy(grids, cores, q)
    np.testing.assert_array_equal(xa, xb)
    np.testing.assert_array_equal(la, lb)


def test_trace_writes_a_chrome_trace(tmp_path):
    """trace() around a small serve on the CPU writes a Chrome trace
    that names the operators it ran."""
    import tt_irt_tpu_torch as tp

    cores = [torch.rand((1, 9, 2), dtype=torch.float64) + 0.1,
             torch.rand((2, 9, 1), dtype=torch.float64) + 0.1]
    grids = [torch.linspace(-1, 1, 9, dtype=torch.float64)] * 2
    q = torch.rand((64, 2), dtype=torch.float64)
    with profiling.trace(str(tmp_path)) as prof:
        tp.tt_irt_sqr(grids, tp.TT(cores), q, device="cpu")
    path = tmp_path / "trace.json"
    assert path.exists()
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
    assert len(prof.key_averages()) > 0


DATA = os.path.join(os.path.dirname(__file__), "..", "examples", "data")
ROOT = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(scope="module")
def lz10():
    import tt_irt_tpu_torch as tp

    dirt = tp.load_dirt(os.path.join(DATA, "lz10_ck"), device="cpu")
    q = torch.rand((64, dirt.d), dtype=torch.float64,
                   generator=torch.Generator().manual_seed(0)) * 0.8 + 0.1
    return dirt, q


def _traced(tmp_path, fn):
    """fn() inside profiling.trace; returns its result and the program's
    spans in the Chrome trace as (name, start, end) in microseconds."""
    with profiling.trace(str(tmp_path)):
        out = fn()
    with open(tmp_path / "trace.json") as fh:
        events = json.load(fh)["traceEvents"]
    spans = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
             for e in events if e.get("cat") == "user_annotation"
             and e["name"].startswith("ttirt.")]
    return out, spans


def _inside(inner, outers):
    return any(o[1] <= inner[1] and inner[2] <= o[2] for o in outers)


def _named(spans, name):
    return [s for s in spans if s[0] == name]


def test_span_outside_a_capture_is_the_shared_null_context(monkeypatch,
                                                           lz10):
    """With no capture running, span() hands out one shared null context
    and never builds a record_function: a serve and the Lorenz
    densities run with record_function made to raise."""
    import tt_irt_tpu_torch as tp

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) outside a capture")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert profiling.span("ttirt.a") is profiling.span("ttirt.b")
    dirt, q = lz10
    z, lf = tp.DirtSampler(dirt, precision="hi", device="cpu")(q)
    assert torch.all(torch.isfinite(lf))
    lp = tp.LorenzProblem(d=10).log_posterior_fn()(z)
    assert lp.shape == (q.shape[0],)


@pytest.mark.parametrize("hi_step", ["dim", "odim", "bracket"])
def test_serve_spans_nest_sample_block_epilogue(tmp_path, lz10, hi_step):
    """A 'hi' DirtSampler serve on the CPU (the plain steps run the same
    forward passes as the kernels) nests ttirt.sample > ttirt.block >
    ttirt.epilogue: one sample, one block a transform, one epilogue a
    block ("dim", "odim") or a dimension ("bracket"); its outputs equal
    an untraced serve's bit for bit."""
    import tt_irt_tpu_torch as tp

    dirt, q = lz10
    sampler = tp.DirtSampler(dirt, precision="hi", hi_step=hi_step,
                             device="cpu")
    (z, lf), spans = _traced(tmp_path, lambda: sampler(q))
    z0, lf0 = sampler(q)
    assert torch.equal(z, z0) and torch.equal(lf, lf0)
    blocks = dirt.nlevels + 1
    sample = _named(spans, "ttirt.sample")
    block = _named(spans, "ttirt.block")
    epilogue = _named(spans, "ttirt.epilogue")
    assert len(sample) == 1
    assert len(block) == blocks
    assert len(epilogue) == blocks * (dirt.d if hi_step == "bracket" else 1)
    assert all(_inside(b, sample) for b in block)
    assert all(_inside(e, block) for e in epilogue)
    assert not _named(spans, "ttirt.cdf")


@pytest.mark.parametrize("precision,hi_step", [
    ("f32", "dim"), ("gs", "dim"), ("hi", "pair"), ("hid", "dim")])
def test_cdf_spans_once_a_dimension_a_level(tmp_path, lz10, precision,
                                            hi_step):
    """The plain-PyTorch CDF between the kernels (``_cdf_invert`` at
    'f32' and 'hid', ``_cdf_invert_serve`` at "pair", ``cdf_rows32`` at
    'gs') is one ttirt.cdf a dimension of every transform, inside its
    block; outputs equal an untraced serve's bit for bit."""
    import tt_irt_tpu_torch as tp

    dirt, q = lz10
    sampler = tp.DirtSampler(dirt, precision=precision, hi_step=hi_step,
                             device="cpu")
    (z, lf), spans = _traced(tmp_path, lambda: sampler(q))
    z0, lf0 = sampler(q)
    assert torch.equal(z, z0) and torch.equal(lf, lf0)
    block = _named(spans, "ttirt.block")
    cdf = _named(spans, "ttirt.cdf")
    assert len(block) == dirt.nlevels + 1
    assert len(cdf) == len(block) * dirt.d
    assert all(_inside(c, block) for c in cdf)


def test_irt_sampler_spans(tmp_path, lz10):
    """IrtSampler.sample opens ttirt.sample around its blocks."""
    import tt_irt_tpu_torch as tp

    dirt, q = lz10
    sampler = tp.IrtSampler(dirt.x0, dirt.f0, precision="f32", block=32,
                            device="cpu")
    _, spans = _traced(tmp_path, lambda: sampler(q))
    sample = _named(spans, "ttirt.sample")
    block = _named(spans, "ttirt.block")
    assert len(sample) == 1 and len(block) == 2
    assert all(_inside(b, sample) for b in block)


def test_lorenz_problem_spans(tmp_path, lz10):
    """LorenzProblem's log-prior and log-likelihood each open their own
    span, neither inside the other, once a call."""
    import tt_irt_tpu_torch as tp

    _, q = lz10
    lp_fn = tp.LorenzProblem(d=10).log_posterior_fn()
    lp, spans = _traced(tmp_path, lambda: lp_fn(q))
    assert torch.equal(lp, lp_fn(q))
    prior = _named(spans, "ttirt.model.log_prior")
    ll = _named(spans, "ttirt.model.log_likelihood")
    assert len(prior) == 1 and len(ll) == 1
    assert not _inside(prior[0], ll) and not _inside(ll[0], prior)


def test_span_names_are_the_programs_own():
    """Every span the port opens is named ``ttirt.*``: none is one of
    the benchmark harness's layer spans or its ``call.<k>``."""
    from portbench.trace import LAYER_SPANS

    pat = re.compile(r"\bspan\(\s*[\"']([^\"']+)[\"']")
    names = set()
    for base, _, files in os.walk(os.path.join(ROOT, "tt_irt_tpu_torch")):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(base, f)) as fh:
                    names |= set(pat.findall(fh.read()))
    assert names == {"ttirt.sample", "ttirt.block", "ttirt.epilogue",
                     "ttirt.cdf", "ttirt.model.log_prior",
                     "ttirt.model.log_likelihood"}
    for name in names:
        assert name.startswith("ttirt."), name
        assert name not in LAYER_SPANS and not name.startswith("call."), name


def test_verify_env_on_cpu():
    from tt_irt_tpu_torch.utils.verify_env import verify_env

    out = verify_env(verbose=False, device="cpu")
    for key in ("torch", "cuda", "devices", "tt_irt_tpu_torch",
                "smoke_ness", "native", "sobol"):
        assert key in out, key
    assert out["smoke_ness"] < 1.5
    assert out["tt_irt_tpu_torch"] == "0.1.0"
    assert "kernels_built_s" not in out           # no card: nothing built
    assert os.path.exists(os.path.join(os.path.dirname(__file__), "..",
                                       "build", "native", "libttirt.so")) \
        == out["native"]
