"""Reduction of a ``torch.profiler`` capture of a steady stretch of the
window to what the per-layer metrics read.

Every device operation (kernel, copy, fill) is tied, through the
correlation id of the runtime call that launched it, to the harness's
spans open on the host at that moment: the call it belongs to
("call.<k>") and the innermost layer span ("serve", "logpost", "iw",
"check").  The stretch is the calls the capture holds whole; its
window runs from the first device operation of its first call to the
end of the last operation of its last call.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
from typing import NamedTuple

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
NAME_CHARS = 96
# The harness's own spans around its calls into each layer (system.py);
# spans that the program may open inside them are not layers here.
LAYER_SPANS = ("serve", "logpost", "iw", "check")


class Op(NamedTuple):
    name: str
    start: float          # seconds, on the trace's clock
    end: float
    call: int | None      # the call whose span launched it
    span: str | None      # the innermost layer span at its launch


class Stretch:
    """The device operations of whole calls ``calls`` (a range)."""

    def __init__(self, ops: list, calls: range):
        self.calls = calls
        self.ops = sorted((o for o in ops if o.call in calls),
                          key=lambda o: o.start)
        self.t0 = self.ops[0].start
        self.t1 = max(o.end for o in self.ops)
        self.window_s = self.t1 - self.t0
        inside = sorted((o for o in ops if o.end > self.t0
                         and o.start < self.t1), key=lambda o: o.start)
        self.busy_s, self._gaps = _union(inside, self.t0, self.t1)

    @property
    def n_calls(self) -> int:
        return len(self.calls)

    def named(self, pattern: str) -> list:
        """The stretch's operations whose name matches ``pattern``."""
        rx = re.compile(pattern)
        return [o for o in self.ops if rx.search(o.name)]

    def in_span(self, span: str) -> list:
        return [o for o in self.ops if o.span == span]

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time and the longest
        idle gaps, each labelled by the host's span and the operation
        that ended it."""
        total: dict = {}
        for o in self.ops:
            key = o.name[:NAME_CHARS]
            total[key] = total.get(key, 0.0) + (o.end - o.start)
        ops = sorted(total.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self._gaps, key=lambda g: -g[1])[:top]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in gaps]}


def _union(ops, t0, t1):
    """Busy seconds of ``ops`` (sorted by start) within [t0, t1], and
    the idle gaps as (label, seconds)."""
    busy, gaps = 0.0, []
    cur = t0
    for o in ops:
        start, end = max(o.start, t0), min(o.end, t1)
        if start > cur:
            gaps.append((f"{o.span or 'harness'}: before "
                         f"{o.name[:NAME_CHARS]}", start - cur))
            cur = start
        if end > cur:
            busy += end - cur
            cur = end
    return busy, gaps


def read_profile(prof, calls: range) -> Stretch | None:
    """The stretch of ``calls`` in a finished ``torch.profiler``
    capture (written to a temporary file and read back); None where the
    capture holds no device operation of those calls."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    ops = device_ops(events)
    if not any(o.call in calls for o in ops):
        return None
    return Stretch(ops, calls)


def device_ops(events: list) -> list:
    """The device operations of a chrome trace's events, each tied to
    its call and layer span."""
    spans: dict = {}
    launches: dict = {}
    device = []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat")
        if cat == "user_annotation":
            spans.setdefault(ev.get("tid"), []).append(
                (float(ev["ts"]), float(ev["ts"]) + float(ev.get("dur", 0)),
                 ev["name"]))
        elif cat in _LAUNCH_CATS:
            corr = ev.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = (ev.get("tid"), float(ev["ts"]))
        elif cat in _DEVICE_CATS:
            device.append(ev)
    index = {tid: _SpanIndex(s) for tid, s in spans.items()}
    ops = []
    for ev in device:
        call, span = None, None
        hit = launches.get(ev.get("args", {}).get("correlation"))
        if hit is not None and hit[0] in index:
            call, span = index[hit[0]].at(hit[1])
        start = float(ev["ts"]) * 1e-6
        ops.append(Op(ev["name"], start,
                      start + float(ev.get("dur", 0)) * 1e-6, call, span))
    return ops


class _SpanIndex:
    """Which spans of one host thread hold a moment."""

    def __init__(self, spans):
        self.spans = sorted(spans)
        self.starts = [s[0] for s in self.spans]

    def at(self, t):
        call, layer, layer_start = None, None, None
        for start, end, name in self.spans[:bisect.bisect_right(
                self.starts, t)]:
            if end < t:
                continue
            if name.startswith("call."):
                call = int(name[5:])
            elif name in LAYER_SPANS and (layer_start is None
                                          or start >= layer_start):
                layer, layer_start = name, start
        return call, layer
