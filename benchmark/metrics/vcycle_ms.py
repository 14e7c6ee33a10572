"""vcycle_ms.<cell>: host milliseconds of one V-cycle application: the
window's ``timings`` whose last element is ``vcycle`` (the program's span
around each application, the one before each ``cg`` loop included) over
its applications, iterations plus refinement passes.  None where the
program has no such span."""

UNIT = "ms"


def _seconds(timings: dict):
    """The V-cycle's seconds of one solve; None without the span."""
    secs = [v for k, v in timings.items() if k.rsplit("/", 1)[-1] == "vcycle"]
    return sum(secs) if secs else None


def read(run):
    secs, n = 0.0, 0
    for r in run.records:
        s = _seconds(r["timings"])
        if s is not None:
            secs += s
            n += r["iterations"] + r["passes"]
    return 1e3 * secs / n if n else None
