"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit), and the least time of a piece of
work: a frozen copy of the bound arithmetic of
``topopteval_tpu_torch/tools/_timing.bound_ms``."""

from __future__ import annotations

#: HBM3 bytes/s
HBM_BYTES_PER_S = 3.35e12
#: FLOP/s outside the tensor cores, by the vectors' width in bytes
PEAK_FLOPS = {4: 67e12, 8: 34e12}


def least_seconds(n_bytes: float, n_ops: float, itemsize: int) -> float:
    """The larger of the bytes over the memory rate and the operations
    over the peak rate of the vectors' width."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / PEAK_FLOPS[itemsize])


def bound_ms(n_bytes: float, n_ops: float, itemsize: int) -> tuple:
    """(least ms, "bytes" or "operations"), as tools/_timing.bound_ms."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / PEAK_FLOPS[itemsize]
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")
