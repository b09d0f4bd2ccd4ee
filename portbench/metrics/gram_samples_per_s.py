"""Samples a second through the 'f32' Gram path, counted as samples_per_s
is."""

from portbench import readers


def read(run):
    return readers.rate(run)
