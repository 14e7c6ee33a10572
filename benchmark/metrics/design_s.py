"""design_s: the window's seconds, first request's start to the last
one's end, over the designs it certified; host clock."""

UNIT = "s"


def read(run):
    return run.window_s / len(run.records) if run.records else None
