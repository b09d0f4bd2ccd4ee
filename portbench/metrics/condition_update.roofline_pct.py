"""condition_update's least time at the card's peaks
(work/condition_update.py) over its time in the device trace."""

from portbench import readers


def read(run):
    return readers.roofline_pct(run, "condition_update")
