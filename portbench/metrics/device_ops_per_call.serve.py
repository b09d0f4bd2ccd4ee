"""Device operations a call launched inside the harness's span around
DirtSampler.sample, over the traced calls."""

from portbench import readers


def read(run):
    return readers.ops_per_call(run, "serve")
