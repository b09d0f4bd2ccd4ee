"""Device time of the operations launched inside the harness's span around
the log-posterior, over all device time of the traced stretch."""

from portbench import readers


def read(run):
    return readers.span_share_pct(run, "logpost")
