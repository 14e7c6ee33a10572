"""kernels_per_iter.loads: device kernels of the traced requests (the
whole request: loads, refinement, postprocess) over their MG-PCG
iterations (torch.profiler)."""

UNIT = "count"


def read(run):
    its = sum(r["iterations"] for r in run.profiled)
    if run.trace is None or run.trace.kernels == 0 or its == 0:
        return None
    return run.trace.kernels / its
