"""Device grids and the element-sharded operator (counterpart of
``topopteval_tpu/parallel/sharding.py``).

One process drives every shard.  A :class:`DeviceMesh` is a (data, elem)
grid of ``torch.device``s, the counterpart of the JAX package's
``jax.sharding.Mesh``: the ``elem`` axis shards the finite-element mesh
(tensor parallelism, parallel/halo.py), the ``data`` axis the lanes of a
design sweep (data parallelism, parallel/sweep.py).  A device may appear
more than once, so several shards can sit on one card or on the CPU (the
counterpart of JAX's forced host devices); the collectives of
parallel/collectives.py copy between the devices in shard order.

:class:`ShardedStiffnessOperator` is the round-1 design kept by the JAX
package: a replicated displacement vector, each shard applying its slice
of the elements into a full-length accumulator, and a sum of the full
accumulators, an O(ndof) reduction per matvec.  parallel/halo.py is the
design the solver uses.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..fem.operator import (check_kernel_rule, element_diagonals,
                            element_forces)
from ..mesh import DIM, Mesh, resolve_device
from ..ops.elements import physical_gradients
from ..ops.scatter import RowScatterPlan
from .collectives import psum, replicate

ELEM_AXIS = "elem"
DATA_AXIS = "data"


def _normalize(device) -> torch.device:
    """``device`` as a torch.device with its index (``cuda`` is the
    current card), so that equal devices compare equal."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """A (data, elem) grid of devices: ``grid[i][j]`` holds data shard i's
    elem shard j.  Not to be confused with ``mesh.DeviceMesh``, a finite-
    element mesh's tensors on one device."""

    grid: Tuple[Tuple[torch.device, ...], ...]

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: len(self.grid), ELEM_AXIS: len(self.grid[0])}

    @property
    def elem_devices(self) -> list:
        """The devices of the elem axis (the first data row; the others
        hold replicas)."""
        return list(self.grid[0])

    @property
    def data_devices(self) -> list:
        """The devices of the data axis (the first elem column)."""
        return [row[0] for row in self.grid]


def build_device_mesh(n_devices: Optional[int] = None,
                      data_parallel: int = 1,
                      devices: Optional[Sequence] = None) -> DeviceMesh:
    """A (data, elem) device grid of ``n_devices`` shards.

    With no ``devices`` it takes the visible CUDA devices, one shard each,
    and raises where there is none: CPU shards come only from a device
    list.  A device list may repeat a device to put several shards on it."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device visible; pass a device list such as "
                "devices=['cpu'] * n for shards on the CPU")
        visible = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        n = n_devices or len(visible)
        if n > len(visible):
            raise ValueError(
                f"{n} shards asked for, {len(visible)} CUDA device(s) "
                f"visible; pass a device list such as "
                f"devices=[torch.device('cuda', 0)] * {n} to put "
                "several shards on one card")
        devices = visible
    else:
        devices = [_normalize(d) for d in devices]
        n = n_devices or len(devices)
        if n > len(devices):
            raise ValueError(f"{n} shards asked for, {len(devices)} "
                             "devices given")
    if n % data_parallel:
        raise ValueError(f"{n} devices not divisible by dp={data_parallel}")
    ep = n // data_parallel
    return DeviceMesh(tuple(tuple(devices[i * ep:(i + 1) * ep])
                            for i in range(data_parallel)))


@dataclasses.dataclass(frozen=True)
class _ElementShard:
    conn: torch.Tensor          # [Cs, k] int32
    lam: torch.Tensor           # [Cs]
    mu: torch.Tensor            # [Cs]
    plan: RowScatterPlan        # into the full [N] node rows


class ShardedStiffnessOperator:
    """Element-sharded matrix-free K: the coordinates and vectors are
    replicated (vectors live on the first elem device), the elements split
    into contiguous slices, one per elem shard.  ``matvec`` applies each
    slice into a full-length accumulator on its shard's device and sums
    the accumulators (``psum``)."""

    def __init__(self, coords, shards, free_mask, devices, element_type,
                 order):
        self.coords = coords            # per shard, [N, 3]
        self.shards = shards
        self.free_mask = free_mask      # [ndof] on devices[0]
        self.devices = devices
        self.element_type = element_type
        self.order = order

    @property
    def n_dofs(self) -> int:
        return DIM * self.coords[0].shape[0]

    @staticmethod
    def build(mesh: Mesh, lam, mu, device_mesh: DeviceMesh,
              free_mask: Optional[np.ndarray] = None,
              dtype=torch.float32, order: int = 2
              ) -> "ShardedStiffnessOperator":
        check_kernel_rule(mesh.element_type, order)
        devices = device_mesh.elem_devices
        S = len(devices)
        C = mesh.n_cells
        lam_e = np.broadcast_to(np.asarray(lam, np.float64), (C,))
        mu_e = np.broadcast_to(np.asarray(mu, np.float64), (C,))
        if free_mask is None:
            free_mask = np.ones(mesh.n_dofs)
        coords = replicate(devices, lambda d: torch.as_tensor(
            mesh.coords, dtype=dtype, device=d))
        step = -(-C // S)
        shards = []
        for s, d in enumerate(devices):
            sl = slice(s * step, min((s + 1) * step, C))
            conn = np.ascontiguousarray(mesh.conn[sl])
            shards.append(_ElementShard(
                torch.as_tensor(conn, dtype=torch.int32, device=d),
                torch.as_tensor(lam_e[sl], dtype=dtype, device=d),
                torch.as_tensor(mu_e[sl], dtype=dtype, device=d),
                RowScatterPlan.build(conn, mesh.n_nodes, d)))
        mask = torch.as_tensor(np.asarray(free_mask), dtype=dtype,
                               device=devices[0])
        return ShardedStiffnessOperator(coords, shards, mask, devices,
                                        mesh.element_type, order)

    def matvec_raw(self, u: torch.Tensor) -> torch.Tensor:
        parts = []
        for x, sh, d in zip(self.coords, self.shards, self.devices):
            f_e = element_forces(x, sh.conn, u.to(d), sh.lam, sh.mu,
                                 self.element_type, self.order)
            parts.append(sh.plan.scatter_add(f_e).reshape(-1))
        return psum(parts, self.devices)[0]

    def matvec(self, u: torch.Tensor) -> torch.Tensor:
        m = self.free_mask
        return m * self.matvec_raw(m * u) + (1.0 - m) * u

    def diagonal_raw(self) -> torch.Tensor:
        parts = []
        for x, sh in zip(self.coords, self.shards):
            g, wdet = physical_gradients(x[sh.conn.long()],
                                         self.element_type, self.order)
            parts.append(sh.plan.scatter_add(
                element_diagonals(g, wdet, sh.lam, sh.mu)).reshape(-1))
        return psum(parts, self.devices)[0]

    def diagonal(self) -> torch.Tensor:
        m = self.free_mask
        return m * m * self.diagonal_raw() + (1.0 - m)
