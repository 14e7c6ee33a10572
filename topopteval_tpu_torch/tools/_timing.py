"""Timing and bounds shared by the probes and chip_smoke.py.

On a CUDA device a call is timed by CUDA events around a replayed CUDA
graph of ``inner`` calls (device time, the host's Python between launches
left out), median of ``reps`` replays; on the CPU by the host clock, which
says how fast the plain PyTorch versions run there and nothing about a
device.  Bounds use the H100 SXM data sheet.
"""

from __future__ import annotations

import statistics
import time

import torch

#: H100 SXM data sheet: HBM3 bytes/s; fp32 and fp64 FLOP/s outside the
#: tensor cores (700 W power limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}


def bound_ms(n_bytes: float, n_ops: float, dtype) -> tuple:
    """(least ms, "bytes" or "operations"): the larger of the bytes over
    the memory rate and the operations over the peak rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / PEAK_FLOPS[dtype]
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def time_ms(fn, device: torch.device, reps: int = 21, inner: int = 10,
            graph: bool = True) -> float:
    """Median ms per call of ``fn`` (see the module docstring); with
    ``graph=False`` the card's batch is ``inner`` eager calls, the host's
    launch overhead included."""
    for _ in range(3):
        fn()
    if device.type != "cuda":
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            for _ in range(inner):
                fn()
            times.append(1e3 * (time.perf_counter() - t0) / inner)
        return statistics.median(times)
    torch.cuda.synchronize(device)
    if graph:
        cuda_graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(cuda_graph):
            for _ in range(inner):
                fn()
        batch = cuda_graph.replay
    else:
        def batch():
            for _ in range(inner):
                fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        batch()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def device_label(device: torch.device) -> str:
    """The device's name, for the probes' first line."""
    if device.type == "cuda":
        return f"cuda: {torch.cuda.get_device_name(device)}"
    return "cpu (plain PyTorch versions; host-clock times)"
