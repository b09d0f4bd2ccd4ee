"""What the metric readers under ``metrics/`` share.  Each reader gets
the run (``harness.Run``) and returns a number, or None where it finds
nothing to read; the harness then leaves the metric out of the line."""

from __future__ import annotations

from . import discover, loop, peaks


def rate(run):
    return loop.rate(run.window, run.rows)


def idle_pct(run):
    s = run.stretch
    if s is None:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)


def ops_per_call(run, span: str = "serve"):
    if run.stretch is None:
        return None
    ops = run.stretch.in_span(span)
    return len(ops) / run.stretch.n_calls if ops else None


def span_share_pct(run, span: str):
    """Device time launched inside ``span`` over all device time of the
    stretch."""
    if run.stretch is None:
        return None
    ops = run.stretch.in_span(span)
    if not ops:
        return None
    return 100.0 * sum(o.end - o.start for o in ops) / run.stretch.busy_s


def _launches(run, kernel):
    """The stretch's launches of ``kernel`` when they are the whole
    per-dimension steps the configuration implies (one a dimension of
    every transform of every block), else None."""
    pattern = run.config["serve"]["kernels"].get(kernel)
    if pattern is None or run.stretch is None:
        return None
    ops = run.stretch.named(pattern)
    if not ops or len(ops) != run.stretch.n_calls * run.steps_per_call:
        return None
    return ops


def _work(run, kernel):
    return discover.work(kernel)(run.launch_rows, run.config["n"],
                                 run.config["rank"])


def roofline_pct(run, kernel: str):
    """The least time of ``kernel``'s launches at the card's peaks over
    their time in the trace."""
    ops = _launches(run, kernel)
    if ops is None:
        return None
    least = peaks.least_seconds(_work(run, kernel)) * len(ops)
    return 100.0 * least / sum(o.end - o.start for o in ops)


def step_mfu_pct(run):
    """The least seconds of a call's per-dimension steps' operations at
    the card's peaks over a call's share of the traced window."""
    kernels = run.config["serve"]["kernels"]
    if any(_launches(run, k) is None for k in kernels):
        return None
    least = sum(peaks.compute_seconds(_work(run, k)) for k in kernels)
    per_call = run.stretch.window_s / run.stretch.n_calls
    return 100.0 * least * run.steps_per_call / per_call
