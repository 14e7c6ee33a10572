"""The readers of the program's solver spans (``krylov_ms``,
``vcycle_ms``) on hand-made records and in the tiny traced beam cells,
and the trace reduction on a trace shaped like one traced beam request
with those spans."""

import time
import types

import pytest

from benchmark.core import harness, trace
from benchmark.tests._tiny import TINY

BEAMS = ("beam1m_tet4.designs", "beam1m_tet4.loads")
K = "solve/krylov"


def _run(*records):
    return types.SimpleNamespace(records=list(records))


def _rec(iterations, passes, **timings):
    return {"iterations": iterations, "passes": passes,
            "timings": {k.replace("__", "/"): v for k, v in timings.items()}}


def test_readers_are_sums_over_sums():
    krylov = harness.load_module("metrics", "krylov_ms.loads")
    vcycle = harness.load_module("metrics", "vcycle_ms.designs")
    assert krylov.UNIT == vcycle.UNIT == "ms"
    a = _rec(100, 4, solve__krylov=0.8, solve__krylov__vcycle=0.02,
             solve__krylov__iter__vcycle=0.5, solve__krylov__iter=0.7)
    b = _rec(300, 6, solve__krylov=2.6, solve__krylov__vcycle=0.04,
             solve__krylov__iter__vcycle=1.9)
    assert krylov.read(_run(a, b)) == pytest.approx(1e3 * 3.4 / 400)
    assert vcycle.read(_run(a, b)) == pytest.approx(
        1e3 * (0.52 + 1.94) / (104 + 306))
    # the parent's records (no such span) read nothing; a solve without
    # the span does not count
    bare = _rec(50, 2, build_operator=1.0, solve=2.0)
    assert krylov.read(_run(bare)) is None
    assert vcycle.read(_run(bare)) is None
    assert krylov.read(_run(a, bare)) == pytest.approx(8.0)
    assert vcycle.read(_run(bare, a)) == pytest.approx(1e3 * 0.52 / 104)
    assert krylov.read(_run()) is None and vcycle.read(_run()) is None


@pytest.mark.parametrize("name", BEAMS)
def test_tiny_traced_beam_cells_report_them(name):
    cell = name.split(".", 1)[1]
    w = harness.cell(name)[0]
    extra = [f"krylov_ms.{cell}", f"vcycle_ms.{cell}"]
    over = {**TINY[name], "workload": {"per_layer": w["per_layer"] + extra}}
    code, r = harness.run_cell(name, 2 ** 31 + 13, 0.3, True, device="cpu",
                               overrides=over)
    assert code == 0 and r["correct"]
    for m in extra:
        assert r["metrics"][m]["unit"] == "ms"
        assert r["metrics"][m]["value"] > 0
    assert (r["metrics"][f"vcycle_ms.{cell}"]["value"]
            < r["metrics"][f"krylov_ms.{cell}"]["value"])


def _beam_request(iterations=900, passes=5, levels=5):
    """(ranges, device) of one traced beam request: the harness's ranges,
    the program's build phases, and each MG-PCG iteration's spans with
    363 kernels among them, 20 us of host time before each kernel.
    Some gaps fall in ``iter``'s own time: without that span their owner
    is ``solve/krylov``, found by a scan back over the pass's ranges."""
    us = 1000
    ranges, device = [], []
    t = 0

    def kernels(n):
        nonlocal t
        for _ in range(n):
            t += 17 * us
            device.append((t, t + 3 * us, "k"))
            t += 3 * us

    def leaf(name, n, host_us=0):
        nonlocal t
        t += us
        s = t
        t += host_us * us
        kernels(n)
        t += us
        ranges.append((s, t, name))

    def vcycle(path):
        s = t
        for i in range(levels):
            leaf(f"{path}/L{i}", 34)
        leaf(f"{path}/coarse", 2)
        for i in reversed(range(levels)):
            leaf(f"{path}/L{i}", 31)
        ranges.append((s, t, path))

    r0 = t
    leaf("bench.load", 2)
    c0 = t
    leaf("build_operator", 1)
    s0 = t
    for p in range(passes):
        leaf("solve/refine/residual", 0, 40_000)    # the float64 residual
        leaf("solve/refine/transfer", 1)
        k0 = t
        leaf(K + "/matvec", 13)
        vcycle(K + "/vcycle")
        for _ in range(iterations // passes):
            i0 = t
            leaf(K + "/iter/matvec", 13)
            leaf(K + "/iter/update", 8)
            vcycle(K + "/iter/vcycle")
            leaf(K + "/iter/update", 10)
            leaf(K + "/iter/sync", 5)
            t += 30 * us                  # the loop's own host time
            ranges.append((i0, t, K + "/iter"))
        ranges.append((k0, t, K))
        leaf("solve/refine/transfer", 1)
    ranges.append((s0, t, "solve"))
    for name in ("verify", "relayout", "postprocess", "download"):
        leaf(name, 20)
    ranges.append((c0, t, "solve_system"))
    ranges.append((r0, t, trace.REQUEST_RANGE))
    return ranges, device


def test_reduce_a_traced_beam_request_in_seconds():
    ranges, device = _beam_request()
    assert len(device) > 900 * 363 and len(ranges) > 900 * 17
    t0 = time.perf_counter()
    s = trace.reduce(ranges, device)
    took = time.perf_counter() - t0
    assert took < 10.0, took
    assert s.kernels == len(device)
    # every gap has an owner among the program's spans
    assert "(no range)" not in s.idle_by_range
    assert sum(v for k, v in s.idle_by_range.items()
               if k.startswith("bench.")) < 1e-3 * (s.window_s - s.busy_s)
    assert s.idle_by_range["solve/refine/residual"] == pytest.approx(
        5 * 0.04, rel=0.01)
    assert s.idle_by_range[K + "/iter/vcycle/L0"] > 0
