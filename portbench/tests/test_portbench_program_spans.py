"""CPU tests of the program's spans in the harness's capture
(``portbench/program_spans.py``, ``tools/serve_spans.py``): on a
synthetic Chrome trace whose ``ttirt.*`` user annotations nest inside
the harness's spans, with the device's ``gpu_user_annotation`` mirror
of both, every per-layer reader and ``breakdown()`` read the same as
without the program's spans; the shares, the tables and the clock
check give the hand-computed values."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import discover, harness, program_spans  # noqa: E402
from portbench import trace as tracing  # noqa: E402

BENCH = discover.benchmark()
HOST, DEV = 1, 7


def _x(cat, name, ts, dur, tid=HOST, corr=None):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
          "tid": tid, "pid": 0}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


def _launch(ts, corr):
    return _x("cuda_runtime", "cudaLaunchKernel", ts, 0.5, corr=corr)


def _kernel(name, ts, dur, corr):
    return _x("kernel", name, ts, dur, tid=DEV, corr=corr)


def _events(program=True, early=False):
    """Two calls (times in us).  Call 0: a level's glue, a block with a
    kernel, a CDF and an epilogue, the log-prior, the check; call 1: a
    block with a kernel and an epilogue.  The device runs them from 200
    us to 283 us with gaps of 1, 2, 5 and 3 us; a neighbour's kernel
    (no call) ends before.  ``program=False`` drops the ``ttirt.*``
    spans; ``early`` starts call 1's kernel before its launch."""
    host = [
        _x("user_annotation", "call.0", 0, 100),
        _x("user_annotation", "serve", 1, 59),
        _x("user_annotation", "logpost", 61, 19),
        _x("user_annotation", "check", 81, 9),
        _x("user_annotation", "call.1", 100, 100),
        _x("user_annotation", "serve", 101, 59),
    ]
    spans = [
        _x("user_annotation", "ttirt.sample", 2, 57),
        _x("user_annotation", "ttirt.block", 5, 45),
        _x("user_annotation", "ttirt.cdf", 10, 10),
        _x("user_annotation", "ttirt.epilogue", 30, 15),
        _x("user_annotation", "ttirt.model.log_prior", 62, 8),
        _x("user_annotation", "ttirt.sample", 102, 57),
        _x("user_annotation", "ttirt.block", 105, 45),
        _x("user_annotation", "ttirt.epilogue", 130, 15),
    ]
    mirror = [_x("gpu_user_annotation", name, ts, dur, tid=DEV)
              for name, ts, dur in (("serve", 200, 40),
                                    ("ttirt.block", 205, 35),
                                    ("ttirt.epilogue", 232, 8))]
    device = [
        _launch(3, 1), _kernel("glue_elementwise", 200, 4, 1),
        _launch(6, 2), _kernel("dim_step_kernel<24>", 205, 20, 2),
        _launch(11, 3), _kernel("reduce_kernel", 225, 5, 3),
        _launch(31, 4), _kernel("epilogue_elementwise", 232, 8, 4),
        _launch(63, 5), _kernel("copy_kernel", 245, 5, 5),
        _launch(82, 6), _kernel("index_select", 250, 2, 6),
        _launch(106, 7), _kernel("dim_step_kernel<24>", 252, 20, 7),
        _launch(131, 8), _kernel("epilogue_elementwise", 275, 8, 8),
        _kernel("neighbour", 190, 9, 99),
    ]
    if early:
        device[13] = _kernel("dim_step_kernel<24>", 105.5, 20, 7)
    return host + (spans + mirror if program else []) + device


def _stretch(events):
    return tracing.Stretch(tracing.device_ops(events), range(0, 2))


def _run(stretch, config):
    cfg = discover.config(config)
    return harness.Run(stretch=stretch, config=cfg, launch_rows=2**18,
                       steps_per_call=1)


@pytest.mark.parametrize("config", ["lz40n33", "lz20"])
def test_readers_read_the_same_with_and_without_program_spans(config):
    """trace.py's operations, every per-layer reader of the benchmark
    and ``breakdown()`` are the same with the program's spans (and
    their device mirror) in the capture as without."""
    with_spans, without = _events(True), _events(False)
    assert tracing.device_ops(with_spans) == tracing.device_ops(without)
    a, b = _stretch(with_spans), _stretch(without)
    assert a.breakdown() == b.breakdown()
    assert (a.busy_s, a.window_s) == (b.busy_s, b.window_s)
    read = 0
    for m in BENCH["per_layer"]:
        fn = discover.reader(m["name"])
        va, vb = fn(_run(a, config)), fn(_run(b, config))
        assert va == vb, m["name"]
        read += va is not None
    assert read >= 4


def test_the_shares_are_the_hand_computed_ones():
    """Busy 72 us: the epilogue's kernels 16 us, the glue 4 us (inside
    ttirt.sample, outside the block), the CDF 5 us."""
    events = _events()
    s = _stretch(events)
    launched = program_spans.annotate(events)
    assert s.busy_s == pytest.approx(72e-6)
    got = program_spans.shares(launched, s)
    assert got == pytest.approx({
        "epilogue_share_pct.serve": 100 * 16 / 72,
        "glue_share_pct.serve": 100 * 4 / 72,
        "cdf_share_pct.gram": 100 * 5 / 72})


def test_without_program_spans_the_shares_are_none():
    events = _events(program=False)
    s = _stretch(events)
    launched = program_spans.annotate(events)
    assert program_spans.shares(launched, s) == {}
    for inside, outside in program_spans.SHARES.values():
        assert program_spans.share_pct(launched, s, inside, outside) is None


def test_program_spans_at_each_launch_outermost_first():
    launched = program_spans.annotate(_events())
    by_corr = {x.op.name + str(round(x.op.start * 1e6)): x.program
               for x in launched}
    assert by_corr["glue_elementwise200"] == ("ttirt.sample",)
    assert by_corr["reduce_kernel225"] == ("ttirt.sample", "ttirt.block",
                                           "ttirt.cdf")
    assert by_corr["copy_kernel245"] == ("ttirt.model.log_prior",)
    assert by_corr["index_select250"] == ()
    assert by_corr["neighbour190"] == ()


def test_device_and_idle_seconds_by_span():
    """The idle table sums to the stretch's idle time and puts each gap
    down to the spans of the operation that ends it."""
    events = _events()
    s = _stretch(events)
    launched = program_spans.annotate(events)
    dev = program_spans.device_by_span(launched, s)
    assert dev[("serve", "ttirt.epilogue")] == pytest.approx(16e-6)
    assert dev[("serve", "ttirt.block")] == pytest.approx(40e-6)
    assert dev[("check", "-")] == pytest.approx(2e-6)
    assert sum(dev.values()) == pytest.approx(s.busy_s)
    idle = program_spans.idle_by_span(launched, s)
    assert sum(idle.values()) == pytest.approx(s.window_s - s.busy_s)
    assert idle == pytest.approx({("serve", "ttirt.block"): 1e-6,
                                  ("serve", "ttirt.epilogue"): 5e-6,
                                  ("logpost", "ttirt.model.log_prior"):
                                  5e-6})
    lines = program_spans.tables(launched, s)
    assert lines[0] == ("clock: 0 of 8 device operations begin before "
                        "their launch (the earliest by 0.000 us)")
    assert any(line.startswith("  gap 5.0 logpost ttirt.model.log_prior "
                               "copy_kernel") for line in lines)


def test_the_clock_check_counts_an_operation_before_its_launch():
    events = _events(early=True)
    s = _stretch(events)
    launched = program_spans.annotate(events)
    assert program_spans.clock_check(launched, s) == pytest.approx(
        (1, 8, 0.5e-6))
    sound = _events()
    assert program_spans.clock_check(program_spans.annotate(sound),
                                     _stretch(sound)) == (0, 8, 0.0)


def test_the_tool_returns_the_harness_stretch(tmp_path):
    """tools/serve_spans.py's reader hands the harness the stretch that
    ``trace.read_profile`` reads, and keeps the tables of the same
    capture."""
    import json

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import serve_spans

    events = _events()

    class Prof:
        def export_chrome_trace(self, path):
            with open(path, "w") as fh:
                json.dump({"traceEvents": events}, fh)

    out = {}
    got = serve_spans._keeping(out)(Prof(), range(0, 2))
    want = tracing.read_profile(Prof(), range(0, 2))
    assert got.breakdown() == want.breakdown()
    assert (got.busy_s, got.window_s) == (want.busy_s, want.window_s)
    assert out["clock_early"] == 0
    assert set(out["shares"]) == set(program_spans.SHARES)
