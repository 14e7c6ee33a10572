"""Phase timing, profiler hooks and device residency (counterpart of
``topopteval_tpu.utils.profiling``).

- :class:`PhaseTimer` accumulates named wall-clock phases; each phase also
  opens a ``torch.profiler.record_function`` range, so phases show up by
  name when a caller runs the solve under ``torch.profiler.profile``; with
  no profiler active the range costs a few microseconds.
- ``trace(name)`` opens such a range on its own.
- ``profile_to(log_dir)`` profiles the enclosed block and writes a Chrome
  trace (``chrome://tracing``, Perfetto) into ``log_dir``.
- ``device_tree_bytes(obj)`` counts the tensor bytes an operator holds.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
import types
from typing import Dict, List

import torch

from .terminal import log


@dataclasses.dataclass
class PhaseRecord:
    name: str
    seconds: float
    count: int = 1


class PhaseTimer:
    """Accumulating named phase timer.

    >>> timer = PhaseTimer()
    >>> with timer.phase("assemble"): ...
    >>> with timer.phase("solve"): ...
    >>> timer.report()
    """

    def __init__(self):
        self.records: Dict[str, PhaseRecord] = {}
        self._stack: List[str] = []

    @contextlib.contextmanager
    def phase(self, name: str, annotate_device: bool = True):
        self._stack.append(name)
        full = "/".join(self._stack)
        ctx = (torch.profiler.record_function(full) if annotate_device
               else contextlib.nullcontext())
        t0 = time.perf_counter()
        try:
            with ctx:
                yield
        finally:
            dt = time.perf_counter() - t0
            self._stack.pop()
            rec = self.records.get(full)
            if rec is None:
                self.records[full] = PhaseRecord(full, dt)
            else:
                rec.seconds += dt
                rec.count += 1

    def total(self) -> float:
        return sum(r.seconds for n, r in self.records.items()
                   if "/" not in n)

    def report(self) -> str:
        lines = ["phase timings:"]
        total = max(self.total(), 1e-12)
        for name, rec in sorted(self.records.items()):
            pct = rec.seconds / total * 100
            lines.append(f"  {name:<30s} {rec.seconds:9.3f}s "
                         f"x{rec.count:<4d} {pct:5.1f}%")
        text = "\n".join(lines)
        log(text)
        return text

    def as_dict(self) -> Dict[str, float]:
        return {n: r.seconds for n, r in self.records.items()}


@contextlib.contextmanager
def trace(name: str):
    """A named range on the profiler's timeline; errors of the body
    propagate."""
    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def profile_to(log_dir: str):
    """Profile the enclosed block with ``torch.profiler`` and write a
    Chrome trace into ``log_dir``; the CUDA activity is recorded whenever
    a card is present.  Yields a namespace whose ``path`` names the trace
    file once the block has ended."""
    os.makedirs(log_dir, exist_ok=True)
    on_cuda = torch.cuda.is_available()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if on_cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    out = types.SimpleNamespace(path=None)
    with torch.profiler.profile(activities=acts) as prof:
        yield out
        if on_cuda:
            torch.cuda.synchronize()
    out.path = os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(out.path)


def device_tree_bytes(obj) -> int:
    """Bytes of the tensors reachable from ``obj`` (an operator, a
    preconditioner, any nesting of them): the sum of ``nbytes`` over the
    distinct storages of the tensors found through attributes, dataclass
    fields, lists, tuples, sets and dicts.  A storage shared by several
    tensors (views, an aliased attribute) counts once.

    This is what a matrix-free operator really holds on its device; the
    reference-shaped ``estimate_memory_usage`` figures describe an
    assembled sparse matrix that is never allocated."""
    seen_obj = set()
    seen_storage = set()
    total = 0
    stack = [obj]
    while stack:
        o = stack.pop()
        if id(o) in seen_obj:
            continue
        seen_obj.add(id(o))
        if isinstance(o, torch.Tensor):
            st = o.untyped_storage()
            key = (st.device, st.data_ptr())
            if key not in seen_storage:
                seen_storage.add(key)
                total += st.nbytes()
        elif isinstance(o, dict):
            stack.extend(o.values())
        elif isinstance(o, (list, tuple, set, frozenset)):
            stack.extend(o)
        elif isinstance(o, (type, types.ModuleType, types.FunctionType,
                            types.MethodType, str, bytes, int, float,
                            complex, bool)) or o is None:
            continue
        else:
            if dataclasses.is_dataclass(o):
                stack.extend(getattr(o, f.name)
                             for f in dataclasses.fields(o))
            if hasattr(o, "__dict__"):
                stack.extend(vars(o).values())
            for slot in getattr(type(o), "__slots__", ()):
                if hasattr(o, slot):
                    stack.append(getattr(o, slot))
    return total
