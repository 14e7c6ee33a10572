"""Sharded multigrid: halo-exchange fine level, replicated coarse levels
(counterpart of ``topopteval_tpu/parallel/halo_mg.py``).

The V-cycle preconditioner over slab vectors:

- **fine level**: the node-partitioned :class:`.halo.HaloShardedOperator`
  smoothed by the Chebyshev / damped block-Jacobi recurrence of
  ``fem/bell.BellMG``, with the block inverses and lambda_max taken from
  the host-built block-ELL hierarchy, so the sharded and single-device
  preconditioners are the same linear operator (the same CG trajectory);
- **restriction**: each shard applies the transpose of its slab rows'
  transfer (a row-wise scalar matrix over the level-1 rows, built on the
  host, applied by the transfer kernel ``ops/bell.sell_matvec``: a fixed
  gather order, no atomics), and one psum sums the shards' level-1
  partials in shard order;
- **coarse levels**: the hierarchy's levels 1.. and the coarsest
  pseudo-inverse, run once per distinct device (shards on one device
  share the copy and its result): no communication;
- **prolongation**: local to each shard (each slab row gathers its voxel
  parents from the replicated coarse correction, ``sell_matvec`` again).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..fem.bell import BellMG, BellSystem
from ..mesh import DIM, Mesh
from ..ops.bell import BlockCSR, csr_arrays, sell_matvec
from ..utils.profiling import span
from .collectives import SlabVector, psum, replicate, to_device
from .halo import HaloShardedOperator, SlabBlockJacobi
from .sharding import DeviceMesh


@dataclasses.dataclass(frozen=True)
class HaloMG:
    """V-cycle preconditioner over slab vectors: a drop-in ``M`` for
    ``fem/solvers.cg`` driving the halo operator.

    ``prolong_ops`` and ``restrict_ops`` hold the slab-layout fine
    transfer (:func:`slab_transfer_arrays`) per shard as row-wise scalar
    matrices.  ``coarse`` and ``m_c`` hold one copy per distinct device."""

    op: HaloShardedOperator
    binv: SlabBlockJacobi
    prolong_ops: Tuple[BlockCSR, ...]      # per shard [ns_max, n1p]
    restrict_ops: Tuple[BlockCSR, ...]     # per shard [n1p, ns_max]
    coarse: Dict[torch.device, BellMG]
    m_c: Dict[torch.device, torch.Tensor]  # [3 * n1p] level-1 free mask
    n1p: int
    lam_max: Optional[float] = None
    nu: int = 2
    omega: float = 0.7
    smoother: str = "chebyshev"

    # -- fine-level smoothing ------------------------------------------------

    def _smooth(self, r: SlabVector, z, sweeps: int) -> SlabVector:
        if self.smoother == "chebyshev" and self.lam_max is not None:
            return self._smooth_chebyshev(r, z, sweeps)
        for _ in range(sweeps):
            res = r if z is None else r - self.op.matvec(z)
            dz = self.binv.apply(res)
            z = self.omega * dz if z is None else z + self.omega * dz
        return z

    def _smooth_chebyshev(self, r: SlabVector, z, sweeps: int):
        # the recurrence and band of fem/multigrid.MultigridPreconditioner
        b = 1.1 * self.lam_max
        a = self.lam_max / 4.0
        theta = 0.5 * (b + a)
        delta = 0.5 * (b - a)
        s1 = theta / delta
        if z is None:
            d = self.binv.apply(r) * (1.0 / theta)
            z = d
        else:
            d = self.binv.apply(r - self.op.matvec(z)) * (1.0 / theta)
            z = z + d
        rho_old = 1.0 / s1
        for _ in range(sweeps - 1):
            rho = 1.0 / (2.0 * s1 - rho_old)
            rr = r - self.op.matvec(z)
            d = (rho * rho_old) * d + (2.0 * rho / delta) \
                * self.binv.apply(rr)
            z = z + d
            rho_old = rho
        return z

    # -- transfers (one psum per restriction; prolongation is local) ---------

    def restrict(self, r: SlabVector) -> List[torch.Tensor]:
        """Slab residual → the level-1 residual [3 * n1p] (component-
        major), replicated: one tensor per shard, shared per device."""
        parts = [sell_matvec(p.view(-1, DIM).t().contiguous(), R)
                 for p, R in zip(r.parts, self.restrict_ops)]
        return [c.reshape(-1) for c in psum(parts, self.op.devices)]

    def prolong(self, zc: List[torch.Tensor]) -> SlabVector:
        """Level-1 correction [3 * n1p] per shard → slab vector."""
        return SlabVector(
            sell_matvec(z.view(DIM, -1), P).t().reshape(-1)
            for z, P in zip(zc, self.prolong_ops))

    # -- V-cycle ---------------------------------------------------------------

    def _coarse_apply(self, rc: List[torch.Tensor]) -> List[torch.Tensor]:
        """The hierarchy's V-cycle from level 1 down, once per distinct
        device."""
        first = {}
        for r in rc:
            first.setdefault(r.device, r)

        def run(d):
            r2d = (first[d] * self.m_c[d]).view(DIM, -1)
            return self.coarse[d]._vcycle(0, r2d, top=1).reshape(-1)

        return replicate(self.op.devices, run)

    def apply(self, r: SlabVector) -> SlabVector:
        """The V-cycle: spans ``vcycle`` and, inside it, ``L0`` (the
        sharded fine level) and the coarse hierarchy's ``L1``, ... and
        ``coarse``, as on one device."""
        with span("vcycle"):
            with span("L0"):
                z = self._smooth(r, None, self.nu)
                res = r - self.op.matvec(z)
                m_f = self.op.free_mask
                rc = self.restrict(res * m_f)
            zc = self._coarse_apply(rc)
            with span("L0"):
                z = z + self.prolong(zc) * m_f
                return self._smooth(r, z, self.nu)


def _slab_transfer(slab_of_rcm: np.ndarray, ft: dict, n_slab_rows: int):
    """The fine transfer's triplets (fine RCM rows) in the slab layout:
    ELL parents / weights [n_slab_rows, dmax], rows in the stable order of
    the triplets (the JAX package's arrays)."""
    rows_sf = slab_of_rcm[np.asarray(ft["rows"], np.int64)]
    srt = np.argsort(rows_sf, kind="stable")
    rs = rows_sf[srt]
    cs = np.asarray(ft["cols"], np.int64)[srt]
    ws = np.asarray(ft["w"], np.float64)[srt]
    counts = np.bincount(rs, minlength=n_slab_rows)
    dmax = max(int(counts.max()), 1)
    starts = np.zeros(n_slab_rows, np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    pos = np.arange(len(rs)) - starts[rs]
    parents = np.zeros((n_slab_rows, dmax), np.int32)
    weights = np.zeros((n_slab_rows, dmax), np.float64)
    parents[rs, pos] = cs
    weights[rs, pos] = ws
    return parents, weights, counts


def slab_transfer_arrays(hop: HaloShardedOperator, system: BellSystem
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """The fine transfer in the slab layout: parents and weights
    [S, ns_max, dmax] (the JAX package's ``HaloMG.parents`` /
    ``pweights``), slab rows mapped through the halo plan and the
    hierarchy's RCM order."""
    S, ns = hop.n_shards, hop.ns_max
    parents, weights, _ = _slab_transfer(hop.plan.perm[system.perm],
                                         system.fine_transfer, S * ns)
    return parents.reshape(S, ns, -1), weights.reshape(S, ns, -1)


def build_halo_multigrid(
        mesh: Mesh, lam, mu, device_mesh: DeviceMesh,
        free_mask: Optional[np.ndarray] = None,
        dtype=torch.float64, order: int = 2,
        hierarchy: Optional[tuple] = None,
) -> Tuple[HaloShardedOperator, HaloMG, BellSystem]:
    """(halo_op, halo_mg, bell_system) for a sharded MG-PCG solve.

    ``hierarchy`` reuses a host-built block-ELL hierarchy, ``(system, mg)``
    or ``(system, mg, info)`` (a build, the api's caches, or
    ``bell_from_numpy`` of a JAX-package file); its system must carry
    ``fine_transfer``.  Without one, the hierarchy is
    built on the first shard's device.  The returned ``bell_system``
    gives the exact float64 host matvec for the mixed-precision
    refinement of float32 sharded solves."""
    from ..fem.bell import build_bell_multigrid

    devices = device_mesh.elem_devices
    if free_mask is None:
        free_mask = np.ones(mesh.n_dofs)
    if hierarchy is None:
        hierarchy = build_bell_multigrid(mesh, lam, mu, free_mask=free_mask,
                                         dtype=dtype, order=order,
                                         device=devices[0])
    system, bmg = hierarchy[:2]
    ft = system.fine_transfer
    if ft is None:
        raise ValueError("the hierarchy carries no fine_transfer triplets "
                         "(built before the cache versions that record "
                         "them?): rebuild the block-ELL hierarchy")

    hop = HaloShardedOperator.build(mesh, lam, mu, device_mesh,
                                    free_mask=free_mask, dtype=dtype,
                                    order=order)
    S, ns = hop.n_shards, hop.ns_max
    N = mesh.n_nodes

    # RCM fine position -> slab flat id
    slab_of_rcm = hop.plan.perm[system.perm]

    # fine block inverses: the host-built values of the single-device level
    # 0 in the slab layout (padded slots get the identity: their mask is 0
    # and the masked operator acts as I there)
    binv_rcm = bmg.levels[0].binv9[:, :N].double().cpu().numpy() \
        .T.reshape(N, DIM, DIM)
    binv = np.tile(np.eye(DIM), (S * ns, 1, 1))
    binv[slab_of_rcm] = binv_rcm

    if len(bmg.levels) > 1:
        n1p = bmg.levels[1].op.n_rows_p
        m_c0 = bmg.levels[1].op.free_mask.to(dtype)
    else:
        n1p = int(bmg.coarse_inv.shape[0]) // DIM
        m_c0 = torch.ones(DIM * n1p, dtype=dtype,
                          device=bmg.coarse_inv.device)   # masked already
    parents, weights, counts = _slab_transfer(slab_of_rcm, ft, S * ns)
    dmax = parents.shape[1]
    live = np.arange(dmax)[None, :] < counts[:, None]
    prolong_ops, restrict_ops = [], []
    for s, d in enumerate(devices):
        sl = slice(s * ns, (s + 1) * ns)
        rows = np.repeat(np.arange(ns), dmax).reshape(ns, dmax)[live[sl]]
        cols = parents[sl][live[sl]].astype(np.int64)
        w = weights[sl][live[sl]]
        P = csr_arrays(rows, cols, w, ns)
        R = csr_arrays(cols, rows, w, n1p)
        prolong_ops.append(BlockCSR.from_numpy(*P, n1p, dtype, d))
        restrict_ops.append(BlockCSR.from_numpy(*R, ns, dtype, d))

    # coarse chain: levels 1.. and the coarsest pseudo-inverse, one copy per
    # distinct device
    coarse0 = BellMG(tuple(bmg.levels[1:]), bmg.coarse_inv, nu=bmg.nu,
                     omega=bmg.omega, smoother=bmg.smoother)
    coarse, m_c = {}, {}
    for d in devices:
        if d not in coarse:
            coarse[d] = to_device(coarse0, d)
            m_c[d] = m_c0.to(d)
    hmg = HaloMG(
        op=hop,
        binv=SlabBlockJacobi([
            torch.as_tensor(binv[s * ns:(s + 1) * ns], dtype=dtype, device=d)
            for s, d in enumerate(devices)]),
        prolong_ops=tuple(prolong_ops), restrict_ops=tuple(restrict_ops),
        coarse=coarse, m_c=m_c, n1p=n1p, lam_max=bmg.levels[0].lam_max,
        nu=bmg.nu, omega=bmg.omega, smoother=bmg.smoother)
    return hop, hmg, system
