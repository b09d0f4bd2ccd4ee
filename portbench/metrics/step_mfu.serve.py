"""A call's per-dimension steps at the card's peak rates (their operations'
least seconds) over a call's share of the traced window."""

from portbench import readers


def read(run):
    return readers.step_mfu_pct(run)
