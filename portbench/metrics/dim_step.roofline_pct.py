"""dim_step's least time at the card's peaks (work/dim_step.py, products as
one TF32 pass) over its time in the device trace."""

from portbench import readers


def read(run):
    return readers.roofline_pct(run, "dim_step")
