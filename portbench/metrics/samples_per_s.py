"""Posterior samples a second through the main path: every seed of every
call that completed, over the time from the window's first enqueue to
the last completion (host clock)."""

from portbench import readers


def read(run):
    return readers.rate(run)
