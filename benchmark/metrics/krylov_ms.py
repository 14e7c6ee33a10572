"""krylov_ms.<cell>: host milliseconds of an MG-PCG iteration, measured
inside the loop: the window's ``timings["solve/krylov"]`` (the program's
span around each ``cg`` call, summed over the refinement passes) over its
iterations.  None where the program has no such span."""

UNIT = "ms"
KEY = "solve/krylov"


def read(run):
    recs = [r for r in run.records if KEY in r["timings"]]
    its = sum(r["iterations"] for r in recs)
    return 1e3 * sum(r["timings"][KEY] for r in recs) / its if its else None
