"""device_idle_pct.tput (%, device trace; layer: device): the share of the
traced stretch with no kernel, copy or set on the card, in the backlog
cells."""

from bench.harness import readers


def read(run):
    return readers.idle_pct(run)
