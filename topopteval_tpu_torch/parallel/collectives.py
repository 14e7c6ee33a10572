"""Collectives over shards that one process drives (port-only: XLA
supplies the JAX package's ``all_gather`` and ``psum`` inside
``shard_map``, topopteval_tpu/parallel/halo.py:175-196).

A sharded quantity is a list with one tensor per shard, each on its
shard's device; several shards may share a device (a list of devices
with repeats, the counterpart of JAX's forced host devices).  A
collective copies each shard's piece to the destination device and
combines the pieces in shard order 0..S-1, so its result has the same
bits on every run and on every device layout.  Each distinct
destination device computes the result once, and the shards on it share
that tensor (callers never write into a collective's result).  Between
two GPUs the copies go peer to peer where the link allows.

:class:`SlabVector` is the slab-layout DOF vector of
parallel/halo.py: one tensor per shard, with the arithmetic that
``fem/solvers.cg`` and the sharded V-cycle apply to a vector.  Its dot
product sums the shards' float64 partial dots in shard order, the
counterpart of the psum of partial dots that XLA inserts.

``MOVED`` counts the elements each collective delivers to a destination
(the size of one result), so a test can hold the halo exchange to the
boundary's size.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Sequence

import torch

#: elements delivered per destination, summed over calls
MOVED = {"all_gather": 0, "psum": 0}


def reset_moved() -> None:
    for name in MOVED:
        MOVED[name] = 0


def replicate(devices: Sequence[torch.device],
              fn: Callable[[torch.device], object]) -> list:
    """``fn(device)`` once per distinct device, as a per-shard list (the
    shards on one device share the value)."""
    done = {}
    return [done[d] if d in done else done.setdefault(d, fn(d))
            for d in devices]


def all_gather(parts: Sequence[torch.Tensor],
               devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """Every shard's part, concatenated along dim 0 in shard order, on
    every shard's device."""
    out = replicate(devices, lambda d: torch.cat([p.to(d) for p in parts]))
    MOVED["all_gather"] += out[0].numel()
    return out


def psum(parts: Sequence[torch.Tensor],
         devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """The sum of the shards' parts, added in shard order, on every
    shard's device."""
    def total(d):
        acc = parts[0].to(d)
        for p in parts[1:]:
            acc = acc + p.to(d)
        return acc

    out = replicate(devices, total)
    MOVED["psum"] += out[0].numel()
    return out


def to_device(obj, device: torch.device):
    """A copy of ``obj`` (a tensor, or a tuple or dataclass holding
    tensors, such as a ``BellMG``) with every tensor on ``device``."""
    if torch.is_tensor(obj):
        return obj.to(device)
    if isinstance(obj, tuple):
        return tuple(to_device(o, device) for o in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: to_device(getattr(obj, f.name), device)
            for f in dataclasses.fields(obj) if f.init})
    return obj


def _on(x, device: torch.device):
    """A scalar tensor moved to ``device`` (Python numbers pass)."""
    if torch.is_tensor(x) and x.device != device:
        return x.to(device)
    return x


class SlabVector:
    """A vector in a sharded layout: one tensor per shard, each on its
    shard's device.  Elementwise arithmetic pairs the shards; a scalar
    operand (a Python number or a 0-dim tensor, moved to each shard's
    device) applies to all.  Scalars such as dot products live on the
    first shard's device."""

    __slots__ = ("parts",)

    def __init__(self, parts):
        self.parts = list(parts)

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    @property
    def device(self) -> torch.device:
        return self.parts[0].device

    def _map(self, other, fn) -> "SlabVector":
        if isinstance(other, SlabVector):
            return SlabVector(fn(a, b) for a, b in zip(self.parts,
                                                       other.parts))
        return SlabVector(fn(a, _on(other, a.device)) for a in self.parts)

    def __add__(self, other):
        return self._map(other, lambda a, b: a + b)

    def __sub__(self, other):
        return self._map(other, lambda a, b: a - b)

    def __rsub__(self, other):
        return self._map(other, lambda a, b: b - a)

    def __mul__(self, other):
        return self._map(other, lambda a, b: a * b)

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._map(other, lambda a, b: a / b)

    def clone(self) -> "SlabVector":
        return SlabVector(p.clone() for p in self.parts)

    def zeros_like(self) -> "SlabVector":
        return SlabVector(torch.zeros_like(p) for p in self.parts)

    def addcmul_(self, t1, t2: "SlabVector", value=1.0) -> "SlabVector":
        for a, b in zip(self.parts, t2.parts):
            a.addcmul_(_on(t1, a.device), b, value=value)
        return self

    def mul_(self, other) -> "SlabVector":
        for a in self.parts:
            a.mul_(_on(other, a.device))
        return self

    def add_(self, other: "SlabVector") -> "SlabVector":
        for a, b in zip(self.parts, other.parts):
            a.add_(b)
        return self

    def dot64(self, other: "SlabVector") -> torch.Tensor:
        """Float64 inner product: each shard's partial dot, summed in
        shard order on the first shard's device."""
        home = self.device
        total = None
        for a, b in zip(self.parts, other.parts):
            d = torch.dot(a.double(), b.double()).to(home)
            total = d if total is None else total + d
        return total

    def norm(self) -> float:
        """Euclidean norm, from the shards' norms in the working dtype."""
        return math.sqrt(sum(float(torch.linalg.vector_norm(p)) ** 2
                             for p in self.parts))
