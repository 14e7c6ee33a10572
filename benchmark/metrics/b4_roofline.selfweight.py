"""b4_roofline.selfweight: B4's share of its bytes bound on the Tet10
matrices of the traced requests: the arithmetic of ``b4_roofline.loads``
(the bytes of each matrix B4 was handed, over the launches' device
time)."""

from benchmark.core.harness import load_module

_LOADS = load_module("metrics", "b4_roofline.loads")
UNIT = _LOADS.UNIT
read = _LOADS.read
