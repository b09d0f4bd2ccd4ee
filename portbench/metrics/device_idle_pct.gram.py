"""Share of the traced stretch in which no operation ran on the card
(torch.profiler device trace)."""

from portbench import readers


def read(run):
    return readers.idle_pct(run)
