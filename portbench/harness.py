"""One run of one cell: set-up, warm-up, the measured window, the
trace of a steady stretch (``trace=True``), the check of the window's
outputs against the reference, and the result line's fields.

The seeds of every call are drawn on the device from ``--seed`` before
the window opens (call k's seeds are the k-th draw of one generator, so
they do not depend on how many calls a run makes), and so are the rows
of each call that the check keeps.  The program gets only the seeds.
"""

from __future__ import annotations

import math
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from . import check, discover, loop
from . import system as systems
from . import trace as tracing
from .reference.dirt import sigma_of, uniform_to_tnormal

WARM_CALLS = 2          # calls past the pipeline's depth in the warm-up
TRACE_SECONDS = 2.0     # the traced stretch: whole calls of about this
TRACE_MIN_CALLS = 3
SEED_SPARE = 1.5        # seeds for this many times the calls expected


class Run:
    """What the metric readers read (``readers.py``)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def log(*parts):
    print(*parts, file=sys.stderr, flush=True)


class _HostEvent:
    """A completion event for a run on the CPU, where work is done when
    the call returns."""

    def synchronize(self):
        pass


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             t_start: float, device="cuda", overrides: dict | None = None,
             make_system=None) -> dict:
    """Run ``workload`` once; returns the result line's fields.
    ``overrides`` replaces fields of the mix (for the calibration and
    tests); ``make_system(root, config, mix, device)`` replaces the
    program (the control, or a planted fault)."""
    bench = discover.benchmark()
    cell = discover.cell(bench, workload)
    config = discover.config(cell["config"])
    mix = dict(discover.traffic(cell["traffic"]))
    mix.update(overrides or {})
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    rows, d, in_flight = mix["rows"], config["d"], mix["in_flight"]
    keep = mix["check_rows_per_call"]

    t_imports = time.perf_counter() - t_start
    call = (make_system or systems.program)(discover.ROOT, config, mix, dev)
    t_built = time.perf_counter() - t_start - t_imports
    sigma = sigma_of(config["reference"])
    gen_q = torch.Generator(device=dev)
    gen_q.manual_seed(seed)
    gen_i = torch.Generator(device=dev)
    gen_i.manual_seed(seed + 1)
    seeds, picks = [], []

    def draw(n_calls):
        while len(seeds) < n_calls:
            u = torch.rand((rows, d), generator=gen_q, dtype=torch.float64,
                           device=dev)
            seeds.append(u if sigma is None else uniform_to_tnormal(u, sigma))
            picks.append(torch.randint(0, rows, (keep,), generator=gen_i,
                                       device=dev))

    kept = {"z": [], "lfapp": []}
    if mix.get("weighted"):
        kept["lp"] = []
    last = {}

    def launch(k):
        with record_function(f"call.{k}"):
            out = call(seeds[k])
            with record_function("check"):
                for name, rows_kept in kept.items():
                    rows_kept.append(out[name].index_select(0, picks[k]))
        last.clear()
        last.update(out)
        if not cuda:
            return _HostEvent()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    # warm-up: the cell's own shapes, the pipeline full
    t_warm = time.perf_counter()
    n_warm = in_flight + WARM_CALLS
    draw(n_warm)
    _sync(cuda)
    anchor = _Anchor(cuda)
    warm = loop.run_window(launch, math.inf, in_flight, n_warm,
                           device_offset=anchor.offset)
    _sync(cuda)
    t_call = ((warm.completed[-1] - warm.completed[in_flight - 1])
              / WARM_CALLS)
    t_seeds = time.perf_counter()
    t_warm = t_seeds - t_warm
    for rows_kept in kept.values():
        rows_kept.clear()
    max_calls = int(SEED_SPARE * seconds / max(t_call, 1e-6)) + 2 * n_warm
    draw(max_calls)
    prof, stretch_calls = None, range(0)
    if trace:
        prof = _warm_profiler(dev)
        first = 2 * in_flight
        stretch_calls = range(first, first + max(
            TRACE_MIN_CALLS, math.ceil(TRACE_SECONDS / max(t_call, 1e-6))))

    def on_launch(k):
        if prof is not None and k == stretch_calls.start:
            prof.start()
        return launch(k)

    def on_done(k):
        if prof is not None and k == stretch_calls.stop - 1:
            prof.stop()

    _sync(cuda)
    anchor = _Anchor(cuda)
    t_open = time.perf_counter()
    window = loop.run_window(on_launch, seconds, in_flight, max_calls,
                             device_offset=anchor.offset, on_done=on_done)
    _sync(cuda)
    n_calls = len(window.observed)
    setup_s = t_open - t_start
    log(f"set-up {setup_s:.3f} s: imports {t_imports:.3f}, checkpoint and "
        f"preparation {t_built:.3f}, warm-up {t_warm:.3f}, seeds "
        f"{t_open - t_seeds:.3f}")
    lat = loop.latencies(window)
    log(f"window: {n_calls} calls of {rows} rows, {in_flight} in flight, "
        f"{window.observed[-1]:.4f} s; rate {loop.rate(window, rows):.1f} "
        f"rows/s; latency p50 "
        f"{loop.percentile(lat, 50):.4f} p90 {loop.percentile(lat, 90):.4f} "
        f"s; warm call {t_call:.4f} s; seeds drawn for {max_calls} calls")
    if cuda:
        print(_smi(), flush=True)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    stretch = None
    if prof is not None and stretch_calls.start < n_calls:
        if stretch_calls.stop > n_calls:
            prof.stop()
            stretch_calls = range(stretch_calls.start, n_calls)
        stretch = tracing.read_profile(prof, stretch_calls)
    elif prof is not None:
        log("trace: the window ended before the traced stretch began")
    prof = None

    run = Run(window=window, rows=rows, setup_s=setup_s, stretch=stretch,
              config=config, traffic=mix,
              launch_rows=min(rows, mix.get("block") or rows),
              steps_per_call=(config["levels"] + 1) * d
              * math.ceil(rows / (mix.get("block") or rows)))
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in discover.metrics_of(bench, workload, kind):
        value = discover.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # the check, with the program's state freed
    sampled = {name: torch.cat(v[:n_calls]) for name, v in kept.items()}
    sampled["q"] = torch.cat([seeds[k].index_select(0, picks[k])
                              for k in range(n_calls)])
    last_out = ({k: last[k] for k in ("z", "lfapp", "lp", "weighted")}
                if mix.get("weighted") else None)
    del call, seeds, kept, last
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    values = check.numbers(discover.ROOT, config, sampled, last_out, dev)
    correct, table = check.verdict(values, config["limits"])
    log(f"check: {sampled['q'].shape[0]} rows of {n_calls} calls against "
        f"the float64 reference in {time.perf_counter() - t_check:.2f} s")

    dev_info = {"platform": "gpu" if cuda else "cpu",
                "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": n_calls, "failed": 0,
              "metrics": metrics, "device": dev_info}
    if stretch is not None:
        dev_info.update(busy_s=stretch.busy_s, window_s=stretch.window_s)
        result["breakdown"] = stretch.breakdown()
    result["checks"] = table
    for name, row in table.items():
        log(f"check {name} {row['value']!r} limit {row['limit']!r}")
    return result


class _Anchor:
    """Seconds from now to an event's completion on the card (an event
    recorded on the idle card now marks the start)."""

    def __init__(self, cuda):
        self.ev0 = None
        if cuda:
            self.ev0 = torch.cuda.Event(enable_timing=True)
            self.ev0.record()

    @property
    def offset(self):
        if self.ev0 is None:
            return None
        return lambda ev: self.ev0.elapsed_time(ev) / 1e3


def _sync(cuda):
    if cuda:
        torch.cuda.synchronize()


def _warm_profiler(dev):
    """A profiler on the host and the card, its first start paid in the
    set-up."""
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if dev.type == "cuda" else [])
    with profile(activities=acts):
        torch.ones(8, device=dev).sum()
        _sync(dev.type == "cuda")
    return profile(activities=acts)


def _smi() -> str:
    """The card's name, clocks, power and temperature, as nvidia-smi
    reads them."""
    fields = ("name,clocks.sm,clocks.mem,power.draw,power.limit,"
              "temperature.gpu")
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as exc:
        out = f"unavailable ({exc})"
    return f"nvidia-smi {fields}: {out}"
