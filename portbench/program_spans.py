"""The program's own spans in a ``torch.profiler`` capture of a stretch.

The port opens spans named ``ttirt.*`` around the parts of its serve
path (``tt_irt_tpu_torch/utils/profiling.py``) while a capture runs.
Each device operation is tied, through the correlation id of the runtime
call that launched it, to the program spans open on the launching host
thread at that moment, outermost first.  From that:

* device seconds by the innermost program span ("-" for none) and by the
  harness's layer span (``trace.LAYER_SPANS``) around it;
* idle seconds of the stretch by the spans at the launch of the
  operation that ends each gap;
* the share of the stretch's busy time launched inside one program span
  and outside others (``SHARES``: the f64 epilogue, the level glue, the
  Gram path's PyTorch CDF);
* the clock check: operations that begin on the device before the host
  began the runtime call that launched them, and the largest such lead.
  It reads 0 where the host's spans and the device's operations share
  one clock.

``annotate`` reads the Chrome trace's events in the order that
``trace.device_ops`` reads them and pairs with its operations one by
one; it changes nothing of what ``trace`` reads.
"""

from __future__ import annotations

from typing import NamedTuple

from . import trace as tracing

PREFIX = "ttirt."
NONE = "-"
# metric -> (the span its operations are launched inside, spans they are
# launched outside of)
SHARES = {
    "epilogue_share_pct.serve": ("ttirt.epilogue", ()),
    "glue_share_pct.serve": ("ttirt.sample", ("ttirt.block",)),
    "cdf_share_pct.gram": ("ttirt.cdf", ()),
}


class Launched(NamedTuple):
    op: tracing.Op
    launch: float | None   # host start of the launching call, seconds
    program: tuple         # ttirt.* spans open at the launch, outermost first

    @property
    def innermost(self) -> str:
        return self.program[-1] if self.program else NONE


def annotate(events: list) -> list:
    """``trace.device_ops(events)``, each with its launch time and the
    program spans open at the launch."""
    spans: dict = {}
    launches: dict = {}
    device = []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat")
        if cat == "user_annotation" and ev["name"].startswith(PREFIX):
            t0 = float(ev["ts"])
            spans.setdefault(ev.get("tid"), []).append(
                (t0, t0 + float(ev.get("dur", 0)), ev["name"]))
        elif cat in tracing._LAUNCH_CATS:
            corr = ev.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = (ev.get("tid"), float(ev["ts"]))
        elif cat in tracing._DEVICE_CATS:
            device.append(ev)
    hits = [launches.get(ev.get("args", {}).get("correlation"))
            for ev in device]
    open_at = _open_spans(spans, hits)
    ops = tracing.device_ops(events)
    assert len(ops) == len(device)
    return [Launched(op, None if hit is None else hit[1] * 1e-6,
                     open_at[i])
            for i, (op, hit) in enumerate(zip(ops, hits))]


def _open_spans(spans: dict, hits: list) -> list:
    """For each launch (tid, ts) in ``hits`` (or None), the names of the
    spans of its thread that hold ts, outermost first: one sweep a
    thread over its spans sorted by start, with a stack of open ones."""
    out = [()] * len(hits)
    by_tid: dict = {}
    for i, hit in enumerate(hits):
        if hit is not None and hit[0] in spans:
            by_tid.setdefault(hit[0], []).append((hit[1], i))
    for tid, queries in by_tid.items():
        order = sorted(spans[tid], key=lambda s: (s[0], -s[1]))
        stack, j = [], 0
        for t, i in sorted(queries):
            while j < len(order) and order[j][0] <= t:
                while stack and stack[-1][1] < order[j][0]:
                    stack.pop()
                stack.append(order[j])
                j += 1
            while stack and stack[-1][1] < t:
                stack.pop()
            out[i] = tuple(s[2] for s in stack if s[1] >= t)
    return out


def of_stretch(launched: list, stretch) -> list:
    """The operations of the stretch's calls."""
    return [x for x in launched if x.op.call in stretch.calls]


def clock_check(launched: list, stretch) -> tuple:
    """(operations of the stretch that begin before their launch on the
    host, operations of the stretch tied to a launch, the largest of
    those leads in seconds)."""
    tied = [x for x in of_stretch(launched, stretch) if x.launch is not None]
    leads = [x.launch - x.op.start for x in tied if x.op.start < x.launch]
    return len(leads), len(tied), max(leads, default=0.0)


def device_by_span(launched: list, stretch) -> dict:
    """Device seconds of the stretch's operations by (layer span,
    innermost program span)."""
    total: dict = {}
    for x in of_stretch(launched, stretch):
        key = (x.op.span or "harness", x.innermost)
        total[key] = total.get(key, 0.0) + (x.op.end - x.op.start)
    return total


def gaps(launched: list, stretch) -> list:
    """The stretch's idle gaps as (seconds, the operation that ends the
    gap): the union that ``trace.Stretch`` takes over every operation
    within its window."""
    inside = sorted((x for x in launched if x.op.end > stretch.t0
                     and x.op.start < stretch.t1), key=lambda x: x.op.start)
    out, cur = [], stretch.t0
    for x in inside:
        start, end = max(x.op.start, stretch.t0), min(x.op.end, stretch.t1)
        if start > cur:
            out.append((start - cur, x))
            cur = start
        cur = max(cur, end)
    return out


def idle_by_span(launched: list, stretch) -> dict:
    """Idle seconds of the stretch by (layer span, innermost program
    span) at the launch of the operation that ends each gap."""
    total: dict = {}
    for sec, x in gaps(launched, stretch):
        key = (x.op.span or "harness", x.innermost)
        total[key] = total.get(key, 0.0) + sec
    return total


def share_pct(launched: list, stretch, inside: str, outside=()):
    """Device time of the stretch's operations launched inside the
    program span ``inside`` and outside every span of ``outside``, over
    the stretch's busy time, %; None where no operation of the stretch
    was launched inside a program span."""
    ops = of_stretch(launched, stretch)
    if not any(x.program for x in ops):
        return None
    sec = sum(x.op.end - x.op.start for x in ops if inside in x.program
              and not any(s in x.program for s in outside))
    return 100.0 * sec / stretch.busy_s


def shares(launched: list, stretch) -> dict:
    """Every share of ``SHARES`` (0 where its span never opened); empty
    where no operation of the stretch was launched inside a program
    span."""
    out = {}
    for name, (inside, outside) in SHARES.items():
        value = share_pct(launched, stretch, inside, outside)
        if value is not None:
            out[name] = value
    return out


def tables(launched: list, stretch, top: int = 10) -> list:
    """Lines for standard error: the clock check, device and idle
    seconds by span (a call's share), and the longest gaps."""
    early, tied, lead = clock_check(launched, stretch)
    n = stretch.n_calls
    lines = [f"clock: {early} of {tied} device operations begin before "
             f"their launch (the earliest by {lead * 1e6:.3f} us)",
             f"stretch: {n} calls, busy {stretch.busy_s:.6f} s in "
             f"{stretch.window_s:.6f} s, {stretch.window_s / n:.6f} s a "
             f"call"]
    for title, table in (("device", device_by_span(launched, stretch)),
                         ("idle", idle_by_span(launched, stretch))):
        lines.append(f"{title} seconds by span (layer, innermost program "
                     f"span; a call's seconds, % of the window):")
        for (layer, prog), sec in sorted(table.items(),
                                         key=lambda kv: -kv[1]):
            lines.append(f"  {title} {layer:8s} {prog:28s} {sec / n:.6f} "
                         f"{100.0 * sec / stretch.window_s:.3f}")
    lines.append("longest gaps (us; layer; program spans; the operation "
                 "that ends it):")
    for sec, x in sorted(gaps(launched, stretch), key=lambda g: -g[0])[:top]:
        lines.append(f"  gap {sec * 1e6:.1f} {x.op.span or 'harness'} "
                     f"{' > '.join(x.program) or NONE} "
                     f"{x.op.name[:tracing.NAME_CHARS]}")
    return lines
