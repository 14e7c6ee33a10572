"""sweep_roofline.sweep: the least time the traced batches' lane-batched
PCG iterations can take (roofline/sweep_iteration.py, from every lane's
iteration count) over the device's busy time in those batches, in
percent."""

from benchmark.roofline import sweep_iteration

UNIT = "%"


def read(run):
    t = run.trace
    if t is None or t.busy_s <= 0 or not run.profiled:
        return None
    least = sum(sweep_iteration.least_seconds(r["iterations"], run.sizes)
                for r in run.profiled)
    return 100.0 * least / t.busy_s
