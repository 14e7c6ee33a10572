"""Halo-exchange sharded operator: node-partitioned DOFs, boundary-only
collectives (counterpart of ``topopteval_tpu/parallel/halo.py``).

- Nodes are partitioned into contiguous slabs along the longest mesh axis,
  one slab per shard of the ``elem`` axis.  DOF vectors are
  :class:`.collectives.SlabVector`s in that slab layout, so CG carries
  sharded vectors and only its dot products are reduced across shards.
- Each element belongs to one shard, the owner of its first node.  Nodes
  touched by elements of two or more shards are boundary nodes, stored at
  the front of their owner's slab.
- One matvec: all-gather the boundary rows; apply the shard's elements
  over its local node space (its slab, then the boundary table); sum the
  element forces per local row through a fixed incidence table; psum the
  boundary rows; the owner adds its slice.  Two collectives of
  O(boundary) = O(N^(2/3)) values per matvec, not O(ndof).

The element apply is the single-device one (``fem/operator.
element_forces``): on a CUDA shard the hand-written tet4, hex8 and tet10
apply kernels (ops/element_kernels.py) run over the shard's local node
table, with the shard's gather index as connectivity; on the CPU their
plain versions.  The partition, the slab layout and the incidence tables
are built on the host in NumPy and equal the JAX package's array for
array.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..fem.operator import (check_kernel_rule, element_diagonals,
                            element_forces, element_node_blocks)
from ..fem.solvers import block_jacobi_preconditioner
from ..mesh import DIM, Mesh
from ..ops.elements import physical_gradients
from ..ops.scatter import RowScatterPlan
from .collectives import SlabVector, all_gather, psum
from .sharding import DeviceMesh


@dataclasses.dataclass(frozen=True, eq=False)
class HaloPlan:
    """Host-built partition metadata (NumPy)."""

    n_shards: int
    ns_max: int                 # slab size (nodes) incl. padding
    nbs_max: int                # per-shard boundary count incl. padding
    perm: np.ndarray            # [n_nodes] old node id -> flat slab id
    slab_of: np.ndarray         # [n_nodes] owning shard
    n_boundary: int             # true boundary node count (unpadded)

    @property
    def n_local_dofs(self) -> int:
        return self.n_shards * self.ns_max * DIM

    def dofs(self) -> np.ndarray:
        """[3 n_nodes] the slab-layout position of every global DOF."""
        return (self.perm[:, None] * DIM + np.arange(DIM)).reshape(-1)


def _partition_nodes(mesh: Mesh, n_shards: int) -> np.ndarray:
    """Contiguous slabs along the longest bounding-box axis: the owning
    shard of every node [n_nodes]."""
    lo, hi = mesh.bounding_box()
    axis = int(np.argmax(hi - lo))
    order = np.argsort(mesh.coords[:, axis], kind="stable")
    owner = np.empty(mesh.n_nodes, dtype=np.int64)
    for s, chunk in enumerate(np.array_split(order, n_shards)):
        owner[chunk] = s
    return owner


@dataclasses.dataclass(frozen=True)
class _HaloShard:
    """One shard's element slice over its local node space (slab rows,
    then the S * nbs_max rows of the boundary table)."""

    coords: torch.Tensor        # [ns_max + S*nbs_max, 3]
    conn: torch.Tensor          # [Ce, k] int32 gather index (local rows)
    lam: torch.Tensor           # [Ce]
    mu: torch.Tensor            # [Ce]
    plan: RowScatterPlan        # element rows -> local rows


class SlabBlockJacobi:
    """Inverted 3x3 node blocks per shard [ns_max, 3, 3]; ``apply`` is the
    block-Jacobi preconditioner on slab vectors (``fem/solvers.
    apply_preconditioner`` takes any object with ``apply``)."""

    def __init__(self, blocks: List[torch.Tensor]):
        self.blocks = blocks

    def apply(self, r: SlabVector) -> SlabVector:
        return SlabVector(
            torch.bmm(b, p.reshape(-1, DIM, 1)).reshape(p.shape)
            for b, p in zip(self.blocks, r.parts))


class HaloShardedOperator:
    """Matrix-free K over node-partitioned slab vectors.

    Vectors are :class:`.collectives.SlabVector`s of ``S`` parts
    [ns_max * 3], part s on ``devices[s]``; :meth:`to_local` and
    :meth:`from_local` convert global interleaved vectors.  ``matvec`` has
    the operator contract of ``fem/operator.StiffnessOperator``, so
    ``fem/solvers.cg`` drives it unchanged."""

    def __init__(self, shards: List[_HaloShard], free_mask: SlabVector,
                 plan: HaloPlan, devices: List[torch.device],
                 element_type: str, order: int):
        self.shards = shards
        self.free_mask = free_mask
        self.plan = plan
        self.devices = devices
        self.element_type = element_type
        self.order = order

    @property
    def n_shards(self) -> int:
        return self.plan.n_shards

    @property
    def ns_max(self) -> int:
        return self.plan.ns_max

    @property
    def nbs_max(self) -> int:
        return self.plan.nbs_max

    @property
    def n_dofs(self) -> int:
        return self.plan.n_local_dofs

    @property
    def dtype(self) -> torch.dtype:
        return self.free_mask.dtype

    # -- layout conversion ----------------------------------------------------

    def to_local(self, u_global) -> SlabVector:
        """[n_dofs_global] host vector → slab vector (padding zero)."""
        out = np.zeros(self.plan.n_local_dofs)
        out[self.plan.dofs()] = np.asarray(u_global, np.float64).reshape(-1)
        n = self.ns_max * DIM
        return SlabVector(
            torch.as_tensor(out[s * n:(s + 1) * n], dtype=self.dtype,
                            device=d) for s, d in enumerate(self.devices))

    def from_local(self, u_local: SlabVector) -> np.ndarray:
        """Slab vector → [n_dofs_global] float64 host vector."""
        flat = torch.cat([p.detach().double().cpu()
                          for p in u_local.parts]).numpy()
        return flat[self.plan.dofs()]

    # -- application ----------------------------------------------------------

    def _reduce(self, accs: List[torch.Tensor]) -> List[torch.Tensor]:
        """Local row sums [NS, w] per shard → the owned rows [ns_max, w]:
        the boundary rows are summed over the shards (one psum of S*nbs_max
        rows) and each owner adds its slice."""
        ns, nbs = self.ns_max, self.nbs_max
        bsum = psum([a[ns:] for a in accs], self.devices)
        out = []
        for s, a in enumerate(accs):
            own = a[:ns]
            own[:nbs] += bsum[s][s * nbs:(s + 1) * nbs]
            out.append(own)
        return out

    def matvec_raw(self, u: SlabVector) -> SlabVector:
        """K u in the slab layout, without BC masking."""
        nbs = self.nbs_max
        bnd = all_gather([p.view(-1, DIM)[:nbs] for p in u.parts],
                         self.devices)
        accs = []
        for sh, p, b in zip(self.shards, u.parts, bnd):
            src = torch.cat([p.view(-1, DIM), b]).reshape(-1)
            f_e = element_forces(sh.coords, sh.conn, src, sh.lam, sh.mu,
                                 self.element_type, self.order)
            accs.append(sh.plan.scatter_add(f_e))
        return SlabVector(o.reshape(-1) for o in self._reduce(accs))

    def matvec(self, u: SlabVector) -> SlabVector:
        m = self.free_mask
        return m * self.matvec_raw(m * u) + (1.0 - m) * u

    # -- preconditioning --------------------------------------------------------

    def _geometry(self, sh: _HaloShard):
        return physical_gradients(sh.coords[sh.conn.long()],
                                  self.element_type, self.order)

    def node_blocks_raw(self) -> List[torch.Tensor]:
        """Per shard the 3x3 node blocks [ns_max, 3, 3] of the slab rows."""
        accs = []
        for sh in self.shards:
            blocks = element_node_blocks(*self._geometry(sh), sh.lam, sh.mu)
            C, k = blocks.shape[:2]
            accs.append(sh.plan.scatter_add(blocks.reshape(C, k, DIM * DIM)))
        return [o.reshape(-1, DIM, DIM) for o in self._reduce(accs)]

    def block_jacobi(self) -> SlabBlockJacobi:
        """Inverted node blocks of the constrained operator (fixed DOFs
        and padded slots get identity rows)."""
        return SlabBlockJacobi([
            block_jacobi_preconditioner(b, m)
            for b, m in zip(self.node_blocks_raw(), self.free_mask.parts)])

    def diagonal_raw(self) -> SlabVector:
        accs = [sh.plan.scatter_add(element_diagonals(
            *self._geometry(sh), sh.lam, sh.mu)) for sh in self.shards]
        return SlabVector(o.reshape(-1) for o in self._reduce(accs))

    def diagonal(self) -> SlabVector:
        m = self.free_mask
        return m * m * self.diagonal_raw() + (1.0 - m)

    # -- construction -----------------------------------------------------------

    @staticmethod
    def build(mesh: Mesh, lam, mu, device_mesh: DeviceMesh,
              free_mask: Optional[np.ndarray] = None,
              dtype=torch.float32, order: int = 2) -> "HaloShardedOperator":
        check_kernel_rule(mesh.element_type, order)
        devices = device_mesh.elem_devices
        S = len(devices)
        k = mesh.nodes_per_cell
        conn = mesh.conn.astype(np.int64)
        C = mesh.n_cells
        lam_e = np.broadcast_to(np.asarray(lam, np.float64), (C,))
        mu_e = np.broadcast_to(np.asarray(mu, np.float64), (C,))
        if free_mask is None:
            free_mask = np.ones(mesh.n_dofs)
        free_mask = np.asarray(free_mask, np.float64).reshape(-1)

        owner = _partition_nodes(mesh, S)
        elem_shard = owner[conn[:, 0]]
        # boundary: nodes touched by any element living on a shard other
        # than the node's owner (cross-shard sharing, and nodes whose
        # elements all live elsewhere)
        touch_min = np.full(mesh.n_nodes, S, np.int64)
        touch_max = np.full(mesh.n_nodes, -1, np.int64)
        es = np.repeat(elem_shard, k)
        np.minimum.at(touch_min, conn.reshape(-1), es)
        np.maximum.at(touch_max, conn.reshape(-1), es)
        is_bnd = (touch_max >= 0) & ((touch_min < owner)
                                     | (touch_max > owner))

        # slab layout per shard: [owned boundary..., interior..., pad]
        nbs = np.zeros(S, dtype=np.int64)
        nown = np.zeros(S, dtype=np.int64)
        slab_pos = np.empty(mesh.n_nodes, dtype=np.int64)
        for s in range(S):
            mine = np.flatnonzero(owner == s)
            b = mine[is_bnd[mine]]
            i = mine[~is_bnd[mine]]
            nbs[s] = b.size
            nown[s] = mine.size
            slab_pos[b] = np.arange(b.size)
            slab_pos[i] = b.size + np.arange(i.size)
        nbs_max = max(int(nbs.max()), 1)
        ns_max = int(nown.max()) if nown.max() else 1
        ns_max = max(ns_max, nbs_max)
        perm = owner * ns_max + slab_pos
        plan = HaloPlan(n_shards=S, ns_max=ns_max, nbs_max=nbs_max,
                        perm=perm, slab_of=owner,
                        n_boundary=int(is_bnd.sum()))

        # local node space of every shard: its slab (ns_max rows), then the
        # boundary table (S*nbs_max rows, shard-major, the all-gather's
        # order); a boundary node's table row:
        bnd_id = owner * nbs_max + slab_pos
        NS = ns_max + S * nbs_max
        table = np.zeros((S * nbs_max, DIM))
        table[bnd_id[is_bnd]] = mesh.coords[is_bnd]
        shards = []
        for s, d in enumerate(devices):
            els = np.flatnonzero(elem_shard == s)
            nodes = conn[els]                            # [Ce, k]
            x = np.zeros((NS, DIM))
            mine = owner == s
            x[slab_pos[mine]] = mesh.coords[mine]
            x[ns_max:] = table
            # gather: own nodes from the slab, the others from the table
            gidx = np.where(owner[nodes] == s, slab_pos[nodes],
                            ns_max + bnd_id[nodes])
            # scatter: every boundary node into the boundary rows (summed
            # over the shards), own interior nodes into the slab
            tgt = np.where(is_bnd[nodes], ns_max + bnd_id[nodes],
                           slab_pos[nodes])

            def put(a, dt=dtype):
                return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                                       device=d)

            shards.append(_HaloShard(
                coords=put(x), conn=put(gidx, torch.int32),
                lam=put(lam_e[els]), mu=put(mu_e[els]),
                plan=RowScatterPlan.build(tgt, NS, d)))

        # permuted free mask (padded slab slots are fixed)
        mask_l = np.zeros(plan.n_local_dofs)
        mask_l[plan.dofs()] = free_mask
        n = ns_max * DIM
        mask = SlabVector(torch.as_tensor(mask_l[s * n:(s + 1) * n],
                                          dtype=dtype, device=d)
                          for s, d in enumerate(devices))
        return HaloShardedOperator(shards, mask, plan, devices,
                                   mesh.element_type, order)

