"""lanes_per_s: (density, load) lanes certified over the seconds from
the first batch's start to the last batch's end; host clock."""

UNIT = "lanes/s"


def read(run):
    lanes = sum(r["energies"].size for r in run.records)
    return lanes / run.window_s if run.records else None
