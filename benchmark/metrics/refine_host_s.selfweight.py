"""refine_host_s.selfweight: the float64 refinement's host seconds of a
solve (``BellSystem.matvec64`` on the Tet10 matrices), mean over the
window's solves: the arithmetic of ``refine_host_s.loads``."""

from benchmark.core.harness import load_module

_LOADS = load_module("metrics", "refine_host_s.loads")
UNIT = _LOADS.UNIT
read = _LOADS.read
