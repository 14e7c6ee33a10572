"""idle_share.<cell>: percent of the traced requests' time in which no
operation ran on the device (torch.profiler)."""

from benchmark.metrics._read import idle_share

UNIT = "%"


def read(run):
    return idle_share(run)
