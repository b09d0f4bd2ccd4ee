"""The closed loop that drives a cell, and the arithmetic of its
end-to-end metrics.

One client keeps ``in_flight`` calls on the device: it enqueues call
k+1, then waits on call k's completion event.  It stops enqueueing once
the window's nominal length has passed and waits for every call it
started.  The host reads no result inside the window except through
those events.

* A rate is all rows of every call that completed, over the time from
  the window's first enqueue to the last of those completions.
* A call's latency runs from the moment the host began to enqueue it to
  its completion on the device; the tail is over every call of the
  window.
"""

from __future__ import annotations

import math
import time
from typing import Callable, NamedTuple, Sequence


class Window(NamedTuple):
    """What one window recorded, every time in seconds on the host's
    clock from the window's first enqueue."""

    enqueued: list       # when the host began to enqueue each call
    completed: list      # when each call ended on the device
    observed: list       # when the host saw each call's completion


def run_window(launch: Callable, seconds: float, in_flight: int,
               max_calls: int, clock: Callable = time.perf_counter,
               device_offset: Callable | None = None,
               on_done: Callable | None = None) -> Window:
    """Drive ``launch(k)`` (which enqueues call k and returns its
    completion event, an object with ``synchronize()``) for ``seconds``
    with ``in_flight`` calls outstanding, and at most ``max_calls``
    calls.  ``device_offset(event)`` gives the seconds from the
    window's start to the event's completion on the device (None: the
    host's observation stands in for it); ``on_done(k)`` runs once the
    host has seen call k complete."""
    if in_flight < 1:
        raise ValueError("in_flight must be at least 1")
    enq, done, obs, events = [], [], [], []
    t0 = clock()
    k_next = 0
    k_wait = 0
    while True:
        while (k_next < max_calls and k_next - k_wait < in_flight
               and (k_next == 0 or clock() - t0 < seconds)):
            enq.append(clock() - t0)
            events.append(launch(k_next))
            k_next += 1
        if k_wait == k_next:
            break
        events[k_wait].synchronize()
        obs.append(clock() - t0)
        done.append(obs[-1] if device_offset is None
                    else device_offset(events[k_wait]))
        events[k_wait] = None
        if on_done is not None:
            on_done(k_wait)
        k_wait += 1
    return Window(enq, done, obs)


def rate(window: Window, rows_per_call: int) -> float:
    """Rows a second: every row of every completed call over the time
    from the first enqueue to the last completion the host saw."""
    if not window.observed:
        raise ValueError("no call completed in the window")
    return rows_per_call * len(window.observed) / max(window.observed)


def latencies(window: Window) -> list:
    """Each call's seconds from the start of its enqueue to its
    completion on the device."""
    return [c - e for e, c in zip(window.enqueued, window.completed)]


def percentile(values: Sequence[float], p: float) -> float:
    """The nearest-rank ``p``-th percentile (0 < p <= 100): the smallest
    value with at least p% of the values at or below it."""
    if not values:
        raise ValueError("no values")
    ordered = sorted(values)
    rank = max(1, math.ceil(p / 100.0 * len(ordered)))
    return ordered[rank - 1]
