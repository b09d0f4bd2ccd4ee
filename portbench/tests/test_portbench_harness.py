"""CPU tests of the benchmark harness (``python -m pytest
portbench/tests -q``): the window's arithmetic, discovery by name, the
kernels' work counts, the import rule, the reference against the port's
'f64' path, and whole runs on the CPU, sound and with the timed path
broken.  The control's test needs the card and skips without one."""

import ast
import math
import os
import sys
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import check, discover, harness, loop, peaks, run  # noqa: E402
from portbench import trace as tracing  # noqa: E402
from portbench import system as systems  # noqa: E402
from portbench.reference import dirt as ref_dirt  # noqa: E402

BENCH = discover.benchmark()
FORBIDDEN = {"jax", "jaxlib", "flax", "tt_irt_tpu"}


# ---- the window's arithmetic ------------------------------------------

def _window(done):
    return loop.Window([0.0] * len(done), list(done), list(done))


def test_rate_counts_whole_calls_over_their_own_time():
    w = _window([0.3, 0.6, 0.9, 1.2])
    # the call that ended past the nominal second counts, over its time
    assert loop.rate(w, 100) == pytest.approx(400 / 1.2)


def test_a_stall_lowers_the_rate():
    steady = _window([0.3, 0.6, 0.9, 1.2])
    stalled = _window([0.3, 0.6, 1.4, 1.7])
    assert loop.rate(stalled, 100) < loop.rate(steady, 100)


def test_percentile_is_nearest_rank():
    values = list(range(1, 101))
    assert loop.percentile(values, 90) == 90
    assert loop.percentile(values, 100) == 100
    assert loop.percentile([5.0], 90) == 5.0
    assert loop.percentile([3, 1, 2], 50) == 2


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_run_window_keeps_two_in_flight_and_waits_for_every_call():
    """Call k+1 is enqueued before call k is waited on, no call starts
    after the deadline, every started call completes, and latency runs
    from the start of the enqueue to the completion."""
    clock = _Clock()
    order = []

    class Event:
        def __init__(self, k):
            self.k = k

        def synchronize(self):
            order.append(("wait", self.k))
            clock.t += 0.25

    def launch(k):
        order.append(("enqueue", k))
        clock.t += 0.01
        return Event(k)

    w = loop.run_window(launch, 1.0, 2, 100, clock=clock)
    assert order[:4] == [("enqueue", 0), ("enqueue", 1), ("wait", 0),
                         ("enqueue", 2)]
    enq = [k for what, k in order if what == "enqueue"]
    waits = [k for what, k in order if what == "wait"]
    assert waits == enq
    assert all(t < 1.0 for t in w.enqueued)
    assert len(w.observed) == len(enq) and w.observed[-1] >= 1.0
    lat = loop.latencies(w)
    assert all(x > 0 for x in lat)
    assert loop.percentile(lat, 90) == pytest.approx(
        sorted(lat)[math.ceil(0.9 * len(lat)) - 1])


def test_run_window_one_in_flight_waits_before_the_next_call():
    clock = _Clock()
    order = []

    class Event:
        def synchronize(self):
            order.append("wait")
            clock.t += 0.3

    def launch(k):
        order.append("enqueue")
        return Event()

    loop.run_window(launch, 1.0, 1, 100, clock=clock)
    assert order[:4] == ["enqueue", "wait", "enqueue", "wait"]


# ---- the trace ----------------------------------------------------------

def _x(cat, name, ts, dur, tid=1, corr=None):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
          "tid": tid, "pid": 0}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


def test_trace_ties_device_ops_to_calls_and_spans():
    """Two calls; the device runs call 0's two kernels and call 1's one
    with a 5 us gap; a neighbour's kernel launched before the capture
    (no call) lies outside the stretch of call 0 and 1."""
    events = [
        _x("user_annotation", "call.0", 0, 100),
        _x("user_annotation", "serve", 1, 50),
        _x("user_annotation", "check", 60, 10),
        _x("user_annotation", "call.1", 100, 100),
        _x("user_annotation", "serve", 101, 50),
        _x("cuda_runtime", "cudaLaunchKernel", 2, 1, corr=1),
        _x("cuda_runtime", "cudaLaunchKernel", 61, 1, corr=2),
        _x("cuda_runtime", "cudaLaunchKernel", 102, 1, corr=3),
        _x("kernel", "dim_step_kernel<24>", 200, 20, tid=7, corr=1),
        _x("kernel", "index_select", 220, 5, tid=7, corr=2),
        _x("kernel", "dim_step_kernel<24>", 230, 20, tid=7, corr=3),
        _x("kernel", "neighbour", 150, 40, tid=7, corr=99),
    ]
    ops = tracing.device_ops(events)
    by_name = {(o.name, o.call, o.span) for o in ops}
    assert ("dim_step_kernel<24>", 0, "serve") in by_name
    assert ("index_select", 0, "check") in by_name
    assert ("neighbour", None, None) in by_name
    s = tracing.Stretch(ops, range(0, 2))
    assert s.window_s == pytest.approx(50e-6)
    assert s.busy_s == pytest.approx(45e-6)
    assert len(s.in_span("serve")) == 2
    assert len(s.named(r"\bdim_step_kernel\b")) == 2
    b = s.breakdown()
    assert b["device_ops"][0] == ["dim_step_kernel<24>", pytest.approx(40e-6)]
    assert b["idle_gaps"] == [["serve: before dim_step_kernel<24>",
                               pytest.approx(5e-6)]]


# ---- discovery by name -------------------------------------------------

def test_every_name_in_the_benchmark_is_found():
    for cfg in BENCH["configs"]:
        assert discover.config(cfg["name"])["name"] == cfg["name"]
        assert os.path.exists(os.path.join(ROOT, cfg["file"]))
    for cell in BENCH["workloads"]:
        assert cell["name"].split(".")[0] == cell["config"]
        mix = discover.traffic(cell["traffic"])
        assert {"rows", "in_flight", "check_rows_per_call"} <= set(mix)
        e2e = discover.metrics_of(BENCH, cell["name"], "end_to_end")
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2
        assert discover.metrics_of(BENCH, cell["name"], "per_layer")
    for kind in ("end_to_end", "per_layer"):
        for m in BENCH[kind]:
            assert callable(discover.reader(m["name"]))
    for cfg in BENCH["configs"]:
        config = discover.config(cfg["name"])
        for kernel in config["serve"]["kernels"]:
            assert callable(discover.work(kernel))
        assert callable(discover.model(config["problem"]["model"]))
        assert callable(discover.model_reference(config["problem"]["model"]))


def test_an_unknown_model_is_refused():
    with pytest.raises(KeyError, match="models/diffusion.py"):
        discover.model("diffusion")
    with pytest.raises(KeyError, match="reference/diffusion.py"):
        discover.model_reference("diffusion")


def test_per_layer_metrics_move_a_metric_their_cells_report():
    for m in BENCH["per_layer"]:
        for cell in m["workloads"]:
            e2e = {x["name"] for x in
                   discover.metrics_of(BENCH, cell, "end_to_end")}
            assert m["moves"] in e2e, (m["name"], cell)


# ---- the kernels' work -------------------------------------------------

@pytest.mark.parametrize("kernel,shape,bound_ms", [
    # PERF.md's kernel table, column "bound ms: TC" at 2^18 rows
    ("dim_step", (33, 23), 0.0555),
    ("gram_conditional", (17, 19), 0.0195),
    ("condition_update", (17, 19), 0.0128),
])
def test_work_counts_give_the_bounds_of_the_kernel_table(kernel, shape,
                                                         bound_ms):
    work = discover.work(kernel)(1 << 18, *shape)
    assert peaks.least_seconds(work, tc_passes=3) * 1e3 == pytest.approx(
        bound_ms, abs=6e-5)
    assert peaks.least_seconds(work) <= peaks.least_seconds(work, 3)


# ---- the import rule ---------------------------------------------------

def _imports(path):
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _sources(sub=""):
    base = os.path.join(ROOT, "portbench", sub)
    for dirpath, _, files in os.walk(base):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_no_file_imports_jax_or_the_jax_package():
    for path in _sources():
        assert not _imports(path) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        assert "tt_irt_tpu_torch" not in _imports(path), path


def test_loaded_check_compares_top_level_names_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "tt_irt_tpu_torch_fake", sys)
    assert "tt_irt_tpu" not in run.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "tt_irt_tpu.samplers", sys)
    assert run.loaded_forbidden() == ["tt_irt_tpu"]


# ---- the reference against the port -----------------------------------

def test_reference_matches_the_ports_f64_path_on_lz20():
    import tt_irt_tpu_torch as tp

    path = os.path.join(ROOT, "examples", "data", "lz20_ck")
    u = torch.from_numpy(np.random.default_rng(3).uniform(size=(300, 20)))
    q = ref_dirt.uniform_to_tnormal(u, 3.0)
    z, lf = tp.DirtSampler(tp.load_dirt(path, device="cpu"),
                           precision="f64", device="cpu")(q)
    zr, lr = ref_dirt.Pushforward(ref_dirt.load_stack(path))(q)
    assert float((z - zr).abs().max()) < 1e-9
    assert float((lf - lr).abs().max()) < 1e-8


def test_reference_log_posterior_matches_the_ports_lorenz96():
    config = discover.config("lz40n33")
    z = torch.from_numpy(np.random.default_rng(5).normal(
        1.0, 0.5, size=(200, config["d"])))
    ours = discover.model("lorenz96")(ROOT, config, "cpu")(z)
    ref = discover.model_reference("lorenz96")(ROOT, config, "cpu")(z)
    assert float(((ours - ref).abs() / ref.abs().clamp(min=1.0)).max()) < 1e-12


def test_rows_over_count_either_gap_and_non_finite_rows():
    inf = float("inf")
    z_gaps = [0.0, 2e-3, 5e-3, 0.0, inf, 0.0, 0.0, 0.0, 0.0, 0.0]
    lf_gaps = [0.0, 0.0, 0.0, 4e-3, 0.0, 0.0, 0.0, 0.0, 0.0, 3e-3]
    assert check.over_pct(z_gaps, lf_gaps, 3e-3, 3e-3) == pytest.approx(30.0)


# ---- whole runs on the CPU ---------------------------------------------

SMALL = {"rows": 256, "block": None, "check_rows_per_call": 64}


def _cached_program():
    built = {}

    def make(root, config, mix, dev):
        if "call" not in built:
            built["call"] = systems.program(root, config, mix, dev)
        return built["call"]

    return make


@pytest.fixture(scope="module")
def lz20_program():
    return _cached_program()


def _run(workload, make, seconds=1.0, overrides=SMALL):
    return harness.run_cell(workload, 2**31 + 11, seconds, False,
                            time.perf_counter(), device="cpu",
                            overrides=overrides, make_system=make)


def test_a_sound_run_is_correct(lz20_program):
    res = _run("lz20.serve", lz20_program)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {"gram_samples_per_s", "setup_s"}
    assert res["attempted"] >= 1 and res["failed"] == 0


def _broken(program, fault):
    def make(root, config, mix, dev):
        call = program(root, config, mix, dev)

        def broken(q):
            out = dict(call(q))
            z, lf = out["z"].clone(), out["lfapp"].clone()
            half = z.shape[0] // 2
            if fault == "state_unchanged":
                z = q.clone()
            elif fault == "half_left_out":
                z[half:] = 0.0
                lf[half:] = 0.0
            elif fault == "sample_altered":
                z[:, 0] += 1e-2
            elif fault == "density_altered":
                lf += 1e-2
            elif fault == "few_rows_altered":
                z[:z.shape[0] // 200] += 1.0
            elif fault == "few_rows_not_finite":
                lf[:z.shape[0] // 200] = float("nan")
            out.update(z=z, lfapp=lf)
            return out

        return broken

    return make


@pytest.mark.parametrize("fault", ["state_unchanged", "half_left_out",
                                   "sample_altered", "density_altered"])
def test_a_broken_serve_is_not_correct(lz20_program, fault):
    res = _run("lz20.serve", _broken(lz20_program, fault))
    assert not res["correct"], res["checks"]


# every row of a call kept, so that the sample holds the faulty rows
EVERY_ROW = {"rows": 2000, "block": None, "check_rows_per_call": 2000}


@pytest.mark.parametrize("fault", ["few_rows_altered",
                                   "few_rows_not_finite"])
def test_a_fault_on_half_a_percent_of_rows_is_not_correct(lz20_program,
                                                          fault):
    """A fault confined to one tile of 0.5% of the rows passes both
    p99s and fails on the share of rows over their limits."""
    res = _run("lz20.serve", _broken(lz20_program, fault), 0.3, EVERY_ROW)
    checks = res["checks"]
    assert not res["correct"], checks
    assert checks["rows_over_pct"]["value"] > checks["rows_over_pct"][
        "limit"]
    for name in ("z_p99", "lfapp_p99"):
        assert checks[name]["value"] <= checks[name]["limit"], checks


@pytest.fixture(scope="module")
def lz40_program():
    return _cached_program()


WEIGHTED_SMALL = {"rows": 64, "check_rows_per_call": 16}


def test_a_sound_weighted_run_is_correct(lz40_program):
    res = _run("lz40n33.weighted", lz40_program, 0.5, WEIGHTED_SMALL)
    assert res["correct"], res["checks"]
    assert set(res["checks"]) == {"z_p99", "lfapp_p99", "rows_over_pct",
                                  "logpost_max", "logw_max"}


def _weights_over_half(program):
    """iw_prune's normaliser, the mean ratio, taken over half of the
    batch."""
    def make(root, config, mix, dev):
        call = program(root, config, mix, dev)

        def broken(q):
            out = dict(call(q))
            ratio = torch.exp(out["lp"] - out["lfapp"])
            half = ratio.shape[0] // 2
            out["weighted"] = out["lp"] * ratio / ratio[:half].mean()
            return out

        return broken

    return make


def test_weights_over_half_the_batch_are_not_correct(lz40_program):
    res = _run("lz40n33.weighted", _weights_over_half(lz40_program), 0.5,
               WEIGHTED_SMALL)
    assert not res["correct"], res["checks"]
    assert res["checks"]["logw_max"]["value"] > res["checks"]["logw_max"][
        "limit"]


# ---- the control (the card) --------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("the control runs at TF32, which only the card has")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_the_control_is_not_correct(card, workload):
    """The reference at the configuration's lower precision in the
    program's place, at 2^14 rows a call, fails the check."""
    res = harness.run_cell(workload, 2**31 + 3, 2.0, False,
                           time.perf_counter(), device=card,
                           overrides={"rows": 1 << 14, "block": None},
                           make_system=systems.control)
    assert not res["correct"], res["checks"]
