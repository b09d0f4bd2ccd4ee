"""Samples a second that carry their exact log-posterior and importance
weight, counted as samples_per_s is."""

from portbench import readers


def read(run):
    return readers.rate(run)
