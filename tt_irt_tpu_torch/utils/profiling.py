"""Structured metrics and profiling helpers.

Counterpart of ``tt_irt_tpu/utils/profiling.py``.  The reference threads
tic/toc wall times and function-eval counters through every phase
(amen_cross_s.m:61-62, als_cross_parametric.m:43-45, IRTstruct.evalcnt);
the constructors return their eval counters already.  This module adds
lightweight timers (``Metrics``, the JAX package's class) and
``trace(logdir)``, a ``torch.profiler`` capture of the host and, where
one is present, the CUDA device, written as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict

import torch

__all__ = ["Metrics", "trace"]


class Metrics:
    """Accumulating wall-clock timers + counters."""

    def __init__(self):
        self.times: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def timer(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.times[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def add(self, name: str, value: int = 1):
        self.counts[name] += value

    def report(self) -> str:
        lines = []
        for k in sorted(set(self.times) | set(self.counts)):
            t = self.times.get(k)
            c = self.counts.get(k)
            parts = [k]
            if t is not None and t > 0:
                parts.append(f"{t:.3f}s")
            if c:
                parts.append(f"x{c}")
            lines.append("  ".join(parts))
        return "\n".join(lines)


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a trace of the block with ``torch.profiler`` (the CPU, and
    CUDA when a card is present) into ``logdir/trace.json``, viewable in
    chrome://tracing or Perfetto.  Yields the profiler, whose
    ``key_averages()`` sums the kernels by name."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
