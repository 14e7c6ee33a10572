"""sweep_iter_ms.sweep: the window's batch seconds over their PCG
iterations, a batch's iterations being its slowest lane's (host clock and
the counts ``evaluate_design_batch`` returns)."""

UNIT = "ms"


def read(run):
    its = sum(int(r["iterations"].max()) for r in run.records)
    secs = sum(r["t1"] - r["t0"] for r in run.records)
    return 1e3 * secs / its if its else None
