"""Seconds from the process's start to the window's first enqueue:
imports, checkpoint load, backward preparation, kernel load or build,
warm-up, seeds."""


def read(run):
    return run.setup_s
