"""The 90th percentile (nearest rank) of a call's seconds from the start
of its enqueue to its completion on the card, over every call of the
window."""

from portbench import loop


def read(run):
    return loop.percentile(loop.latencies(run.window), 90)
