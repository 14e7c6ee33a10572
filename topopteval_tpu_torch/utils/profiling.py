"""Phase timing, spans, profiler hooks and device residency (counterpart
of ``topopteval_tpu.utils.profiling``).

- :class:`PhaseTimer` accumulates named wall-clock phases under nested
  ``a/b/c`` paths: seconds and a count per path.
- ``PhaseTimer.call(name)`` makes the timer the current one for a public
  call (``solve_system``, ``evaluate_design_batch``): module-level
  ``span(name)`` then lands on it from any depth of the call without
  being handed the timer.  The call's outermost profiler range, ``name``,
  carries a process-wide call number as its argument (shown where the
  profiler records shapes, as ``profile_to`` does).
- ``span(name)`` adds its host seconds and its count to the current
  timer; with no current timer it does nothing.  A span opens a profiler
  range, named by its path, only while a profiler is recording, so the
  range sits on the profiler's clock beside the device's events.  A span
  never synchronises the device and launches nothing.
- ``steps()`` runs consecutive spans (a build's phases) and returns their
  seconds by name.
- ``profile_to(log_dir)`` profiles the enclosed block and writes a Chrome
  trace (``chrome://tracing``, Perfetto) into ``log_dir``.
- ``device_tree_bytes(obj)`` counts the tensor bytes an operator holds.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import itertools
import os
import time
import types
from typing import Dict, List, Optional

import torch

from .terminal import log

_perf_counter = time.perf_counter
_recording = torch.autograd._profiler_enabled
_range_enter = torch.autograd._record_function_with_args_enter
_range_exit = torch.autograd._record_function_with_args_exit

#: the timer of the public call running in this context
_CURRENT: contextvars.ContextVar[Optional["PhaseTimer"]] = \
    contextvars.ContextVar("topopteval_torch_phase_timer", default=None)
#: process-wide call numbers of the public calls (the request id)
_CALLS = itertools.count(1)


@dataclasses.dataclass
class PhaseRecord:
    name: str
    seconds: float
    count: int = 1


class _Span:
    """One phase of a timer: its host seconds and count under its nested
    path, and a profiler range of that path while a profiler records."""

    __slots__ = ("timer", "name", "path", "t0", "handle", "seconds")

    def __init__(self, timer: "PhaseTimer", name: str):
        self.timer = timer
        self.name = name

    def __enter__(self):
        stack = self.timer._stack
        self.path = path = (stack[-1] + "/" + self.name if stack
                            else self.name)
        stack.append(path)
        self.handle = _range_enter(path) if _recording() else None
        self.t0 = _perf_counter()
        return self

    def __exit__(self, *exc):
        dt = _perf_counter() - self.t0
        if self.handle is not None:
            _range_exit(self.handle)
        timer = self.timer
        timer._stack.pop()
        rec = timer.records.get(self.path)
        if rec is None:
            timer.records[self.path] = PhaseRecord(self.path, dt)
        else:
            rec.seconds += dt
            rec.count += 1
        self.seconds = dt
        return False


class _NoSpan:
    """The span outside any timer: nothing at all."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


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

    def phase(self, name: str) -> _Span:
        """A span of this timer, nested under its open phases."""
        return _Span(self, name)

    @contextlib.contextmanager
    def call(self, name: str):
        """Make this timer the current one for the block, inside a
        profiler range ``name`` whose argument is the call's number."""
        token = _CURRENT.set(self)
        number = next(_CALLS)
        handle = _range_enter(name, number) if _recording() else None
        try:
            yield
        finally:
            if handle is not None:
                _range_exit(handle)
            _CURRENT.reset(token)

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


def span(name: str):
    """A phase ``name`` of the current timer, under the phases open there;
    nothing at all where no timer is current.  Errors of the body
    propagate."""
    timer = _CURRENT.get()
    return _NO_SPAN if timer is None else _Span(timer, name)


class steps:
    """Consecutive spans, each ending where the next begins (a build's
    phases).  Inside ``with steps() as step:``, ``step(name)`` ends the
    open step and opens ``name``, ``step.end()`` ends it, and so does the
    block's end.  The spans land on the current timer, or on a timer of
    the block's own where none is current, so a build called on its own
    still times its phases.  After the block, ``seconds`` maps each span
    opened inside it, by its path below the block, to its seconds there.
    """

    def __init__(self):
        self.seconds: Dict[str, float] = {}
        self._open: Optional[_Span] = None

    def __enter__(self):
        timer = _CURRENT.get()
        self._token = None
        if timer is None:
            timer = PhaseTimer()
            self._token = _CURRENT.set(timer)
        self._timer = timer
        self._base = timer._stack[-1] + "/" if timer._stack else ""
        self._before = {k: r.seconds for k, r in timer.records.items()
                        if k.startswith(self._base)}
        return self

    def __call__(self, name: str) -> None:
        self.end()
        self._open = _Span(self._timer, name)
        self._open.__enter__()

    def end(self, *exc) -> None:
        if self._open is not None:
            opened, self._open = self._open, None
            opened.__exit__(*exc)

    def __exit__(self, *exc):
        self.end(*exc)
        if self._token is not None:
            _CURRENT.reset(self._token)
        n = len(self._base)
        for k, rec in self._timer.records.items():
            if k.startswith(self._base):
                before = self._before.get(k)
                if before is None or rec.seconds != before:
                    self.seconds[k[n:]] = rec.seconds - (before or 0.0)
        return False


@contextlib.contextmanager
def profile_to(log_dir: str):
    """Profile the enclosed block with ``torch.profiler`` and write a
    Chrome trace into ``log_dir``; the CUDA activity is recorded whenever
    a card is present, and the ops' shapes and scalar arguments (so each
    public call's outermost range shows its call number under
    ``Concrete Inputs``).  Yields a namespace whose ``path`` names the
    trace file once the block has ended."""
    os.makedirs(log_dir, exist_ok=True)
    on_cuda = torch.cuda.is_available()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if on_cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    out = types.SimpleNamespace(path=None)
    with torch.profiler.profile(activities=acts,
                                record_shapes=True) as prof:
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
