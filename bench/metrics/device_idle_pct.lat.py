"""device_idle_pct.lat (%, device trace; layer: device): the share of the
traced stretch with no kernel, copy or set on the card, in the rate
cells."""

from bench.harness import readers


def read(run):
    return readers.idle_pct(run)
