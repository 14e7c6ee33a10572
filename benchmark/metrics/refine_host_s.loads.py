"""refine_host_s.loads: the float64 refinement's host seconds of a solve,
mean over the window's load cases.

The program's ``timings["refine_host_matvec_seconds"]`` is the total of
the block-ELL system's host matvecs since it was built, so over a reused
hierarchy it grows from solve to solve; a solve's own seconds are the
difference to the previous solve of the run (set-up's for the first).
``refine_host_build_seconds`` is read the same way.
"""

from benchmark.metrics._read import mean

UNIT = "s"
KEYS = ("refine_host_build_seconds", "refine_host_matvec_seconds")


def _own(now: dict, before: dict, key: str) -> float:
    t, b = now.get(key, 0.0), before.get(key, 0.0)
    return t - b if t >= b else t


def read(run):
    return mean(sum(_own(r["timings"], r["timings_before"], k) for k in KEYS)
                for r in run.records
                if "refine_host_matvec_seconds" in r["timings"])
