"""The port's utilities against the JAX package's: tracemult and
tracemult_gather (1e-12), the numpy oracle's copy (bit for bit), the
Metrics report (equal strings on the same events), the torch.profiler
trace, and verify_env on the CPU."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tt_irt_tpu.ops.tracemult import tracemult as j_tracemult
from tt_irt_tpu.ops.tracemult import tracemult_gather as j_gather
from tt_irt_tpu.utils import profiling as j_profiling
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


def test_metrics_report_matches_jax(monkeypatch):
    """The same timer and counter events give the JAX class's report
    string (the clocks of both modules read the same fake times)."""
    ticks = iter(np.arange(0.0, 100.0, 0.25))
    clock = lambda: float(next(ticks))  # noqa: E731
    reports = []
    for mod in (profiling, j_profiling):
        monkeypatch.setattr(mod.time, "perf_counter", clock)
        m = mod.Metrics()
        with m.timer("cross"):
            pass
        with m.timer("cross"):
            pass
        with m.timer("serve"):
            pass
        m.add("evals", 128)
        m.add("levels")
        reports.append(m.report())
    assert reports[0] == reports[1]
    assert reports[0].splitlines()[0] == "cross  0.500s  x2"


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
