"""Profiling helpers: named spans inside the serve path, and a
``torch.profiler`` capture that shows them.

Counterpart of ``tt_irt_tpu/utils/profiling.py``, whose ``Metrics``
timers are not ported: on a card they would time the host's enqueue,
not the device.  Instead the serve path opens ``span(name)`` around
its parts, and ``trace(logdir)`` captures the host and, where one is
present, the CUDA device, written as a Chrome trace in which every
device operation can be tied to the spans open at its launch.

The spans of the program, one site each:
  ``ttirt.sample``    the body of ``DirtSampler.sample`` and
                      ``IrtSampler.sample`` (samplers/serve.py);
  ``ttirt.block``     one block's forward pass (``irt_scan._fwd``);
  ``ttirt.epilogue``  the f64 epilogue ``irt_scan._serve_solve``;
  ``ttirt.cdf``       the CDF and inversion between the kernels
                      (ops/cdf.py's ``cdf_invert_ref`` and the launch in
                      ``cdf_invert_cuda``, ``_cdf_invert_serve``,
                      ``cdf_rows32`` in ``_fwd_gramb``);
  ``ttirt.model.log_prior``, ``ttirt.model.log_likelihood``
                      ``LorenzProblem``'s two densities.
"""

from __future__ import annotations

import contextlib
import os

import torch

__all__ = ["span", "trace"]

_NULL = contextlib.nullcontext()


def span(name: str):
    """A named span of the program's host thread: a
    ``torch.profiler.record_function`` while a profiler capture runs,
    else one shared null context (no device work, no synchronisation,
    about 0.1 us).  Spans nest by the host thread's order."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NULL


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a trace of the block with ``torch.profiler`` (the CPU, and
    CUDA when a card is present) into ``logdir/trace.json``, viewable in
    chrome://tracing or Perfetto; the program's ``ttirt.*`` spans are in
    it as user annotations.  Yields the profiler, whose
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
