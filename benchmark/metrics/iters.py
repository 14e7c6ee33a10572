"""iters.<cell>: ``SolveResult.iterations`` (MG-PCG steps over every
refinement pass), mean over the window's solves."""

from benchmark.metrics._read import mean

UNIT = "count"


def read(run):
    return mean(r["iterations"] for r in run.records)
