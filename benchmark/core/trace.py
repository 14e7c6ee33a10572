"""Reduce a torch.profiler trace to what the per-layer metrics read.

The profiler covers whole requests of the window (at least one).  From its
events the reduction keeps:

- the traced window: first profiled request's start to the last one's
  end, from the harness's own ``bench.request`` ranges;
- the device's busy seconds: the union of the intervals of every device
  operation (kernels, copies, sets) inside that window;
- device time and launches by operation name;
- idle seconds by host range: each gap between device operations is
  charged to the innermost user range (the program's ``PhaseTimer``
  ranges, the harness's ``bench.*`` spans) open at the gap's middle.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Optional, Tuple

REQUEST_RANGE = "bench.request"


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernels: int                              # kernel launches seen
    by_name: Dict[str, Tuple[int, float]]     # name -> (count, seconds)
    idle_by_range: Dict[str, float]           # host range -> idle seconds

    def top_device_ops(self, n: int = 10) -> List[list]:
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1][1])[:n]
        return [[name[:120], secs] for name, (_, secs) in ops]

    def top_idle(self, n: int = 10) -> List[list]:
        gaps = sorted(self.idle_by_range.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:120], secs] for name, secs in gaps]

    def seconds_matching(self, *parts: str) -> Tuple[int, float]:
        """(launches, device seconds) of operations whose name holds every
        one of ``parts``."""
        n, s = 0, 0.0
        for name, (c, secs) in self.by_name.items():
            if all(p in name for p in parts):
                n += c
                s += secs
        return n, s


def summarize(events) -> Optional[TraceSummary]:
    """``events``: KinetoEvents (``prof.profiler.kineto_results.events()``):
    user ranges on the host, and every other event on the device (kernels,
    copies, sets).  None where the trace holds no profiled request."""
    ranges, device = [], []
    for e in events:
        span = (e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
        on_device = "CUDA" in str(e.device_type())
        if e.is_user_annotation():
            if not on_device:               # the device's copy of a range
                ranges.append(span)
        elif on_device:
            device.append(span)
    return reduce(ranges, device)


def reduce(ranges, device) -> Optional[TraceSummary]:
    """The summary from host ranges and device intervals, each a list of
    (start_ns, end_ns, name)."""
    requests = [r for r in ranges if r[2] == REQUEST_RANGE]
    if not requests:
        return None
    w0 = min(r[0] for r in requests)
    w1 = max(r[1] for r in requests)
    by_name: Dict[str, List] = {}
    kernels = 0
    spans = []
    for s, e, name in device:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        spans.append((s, e))
        rec = by_name.setdefault(name, [0, 0.0])
        rec[0] += 1
        rec[1] += (e - s) * 1e-9
        if not (name.startswith("Memcpy") or name.startswith("Memset")):
            kernels += 1
    spans.sort()
    busy_ns = 0
    gaps = []
    cur_s, cur_e = w0, w0
    for s, e in spans:
        if s > cur_e:
            busy_ns += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy_ns += cur_e - cur_s
    if cur_e < w1:
        gaps.append((cur_e, w1))
    # innermost range open at each gap's middle: the latest-starting range
    # that still covers it
    named = sorted(ranges, key=lambda r: r[0])
    starts = [r[0] for r in named]
    idle: Dict[str, float] = {}
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        j = bisect.bisect_right(starts, mid)
        owner = next((named[k][2] for k in range(j - 1, -1, -1)
                      if named[k][1] >= mid), "(no range)")
        idle[owner] = idle.get(owner, 0.0) + (g1 - g0) * 1e-9
    return TraceSummary(
        window_s=(w1 - w0) * 1e-9, busy_s=busy_ns * 1e-9, kernels=kernels,
        by_name={k: (v[0], v[1]) for k, v in by_name.items()},
        idle_by_range=idle)
