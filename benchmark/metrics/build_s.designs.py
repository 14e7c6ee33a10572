"""build_s.designs: the program's ``build_operator`` phase
(``SolveResult.timings``, a PhaseTimer span: the block-ELL value pass
and hierarchy on the host), mean over the window's designs."""

from benchmark.metrics._read import mean

UNIT = "s"


def read(run):
    return mean(r["timings"]["build_operator"] for r in run.records
                if "build_operator" in r["timings"])
