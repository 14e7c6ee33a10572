"""Geometric multigrid preconditioners (counterpart of
``topopteval_tpu.fem.multigrid``): the structured-box hierarchy and the
Galerkin voxel hierarchy for any mesh (``build_unstructured_multigrid``,
the ``TOPOPT_MG=galerkin`` route).

The reference's answer to large problems is Jacobi-preconditioned Krylov
(reference: FiniteElementAnalysis.jl:570-598; RobustSolver.jl:196-216),
whose iteration count grows like n^(1/3).  This is a matrix-free geometric
V-cycle on the nested structured grids of grid.py: trilinear
transfer operators as row gathers and a deterministic incidence
gather-sum, damped block-Jacobi (or Chebyshev) smoothing, and an exact
dense solve on the coarsest level, giving mesh-independent CG iteration
counts.

Used as the preconditioner ``M`` of :func:`..fem.solvers.cg` (symmetric
V-cycle with symmetric smoother + exact coarse solve → SPD).  The
hierarchy is built once per mesh on the host in float64; the V-cycle runs
on the operator's device.

The Galerkin voxel hierarchy embeds any mesh in a voxel lattice: level 1
is P^T A P by colored probing of the matrix-free fine operator, the levels
below it host RAP products, all stored as :class:`.ell.ELLBlockOperator`
(kernel B9a), with transfers as row-wise ELL tables (:class:`EllTransfer`,
kernel B9b).  The JAX package's ``chunked`` transfer lowering and width-8
loops exist for TPU padding and have no counterpart.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..mesh import Mesh, resolve_device
from ..grid import _TET_SPLIT, generate_grid_hex, generate_grid_tet
from ..ops.ell import pack_ell_rows, sell_matvec_window
from ..ops.stencil import CORNER_OFFSETS
from ..utils.profiling import span, steps
from .host_operator import HostFineOperator, block_power_iteration
from .operator import StiffnessOperator, assemble_scipy
from .solvers import block_jacobi_preconditioner
from .structured import StructuredStiffnessOperator


# ---------------------------------------------------------------------------
# Coarsest-level pseudo-inverse eigencut
# ---------------------------------------------------------------------------


def coarse_pinv_weights(evals: np.ndarray, dtype) -> np.ndarray:
    """Inverse-eigenvalue weights for a coarsest-level pseudo-inverse.

    Two failure modes pull the cutoff in opposite directions:

    * Rank-deficient junk modes (voxel-embedded coarse bases over porous /
      partially-filled geometry) must be DISCARDED: inverting them turns
      the coarse correction into rounding-noise amplification and stalls
      the outer fp32 CG.
    * Genuine global physics can land arbitrarily low: on a slender beam
      the two global bending modes sit at RELATIVE coarsest eigenvalues
      1e-8..1e-6 — below a fixed fp32 cutoff of 1e-6 — and zeroing them
      destroys the attainable accuracy of the solve.

    The eigenvalues come from a float64 host build, so real modes resolve
    down to ~1e-13 relative; structural junk clusters many decades below
    the lowest physics.  The cut is therefore placed at the largest
    spectral GAP whose lower edge is in the numerical-zero zone (<= 1e-11
    relative).  When no such clean gap exists (SIMP void-mode continua),
    fall back to a fixed ceiling (1e-6 for float32, 1e-10 for float64).
    """
    evals = np.asarray(evals, np.float64)
    lam_max = max(float(evals.max()), 1e-300)
    rel = evals / lam_max
    ceiling = 1e-6 if dtype == torch.float32 else 1e-10
    noise = 1e-11
    cut = ceiling
    low = np.sort(rel[(rel > 0) & (rel < ceiling)])
    if low.size:
        if low[0] > noise:
            # numerically full rank below the ceiling: nothing is junk,
            # the exact inverse is the ideal coarse solve — keep all.
            cut = noise
        else:
            above = rel[rel >= ceiling]
            fence = float(above.min()) if above.size else 1.0
            seq = np.concatenate([np.maximum(low, 1e-300), [fence]])
            ratios = seq[1:] / seq[:-1]
            # candidate gaps must START in the junk zone
            ratios = np.where(seq[:-1] <= noise, ratios, 0.0)
            j = int(np.argmax(ratios))
            if ratios[j] >= 1e3:
                cut = float(np.sqrt(seq[j] * seq[j + 1]))
    cut_abs = lam_max * cut
    keep = evals > cut_abs
    return np.where(keep, 1.0 / np.where(keep, evals, 1.0), 0.0)


# ---------------------------------------------------------------------------
# Transfer operators between nested structured node lattices
# ---------------------------------------------------------------------------


def _restriction_incidence(parents: np.ndarray, N_c: int) -> np.ndarray:
    """Incidence table [N_c, Dc] of (fine, slot) contributions per coarse
    node for the P^T gather; sentinel rows index an appended zero row."""
    N_f = parents.shape[0]
    flat_targets = parents.reshape(-1).astype(np.int64)      # [N_f*8]
    real = np.flatnonzero(flat_targets < N_c)                # drop sentinels
    order = real[np.argsort(flat_targets[real], kind="stable")]
    sorted_t = flat_targets[order]
    starts = np.searchsorted(sorted_t, np.arange(N_c), "left")
    ends = np.searchsorted(sorted_t, np.arange(N_c), "right")
    degree = ends - starts
    Dc = max(int(degree.max()) if degree.size else 1, 1)
    inc = np.full((N_c, Dc), N_f * parents.shape[1],
                  dtype=np.int64)                            # zero-row pad
    col = (np.concatenate([np.arange(d) for d in degree])
           if degree.sum() else np.zeros(0, np.int64))
    rows = np.repeat(np.arange(N_c), degree)
    inc[rows, col] = order
    return inc.astype(np.int32)


def propagate_fixed(parents: np.ndarray, weights: np.ndarray,
                    fixed_fine: np.ndarray, n_coarse: int) -> np.ndarray:
    """Coarse Dirichlet mask from a fine one: coarse (node, comp) is fixed
    iff any fine fixed node maps to it with positive weight.  Exact for
    domain-face plane constraints on nested lattices (plane nodes only
    ever parent to plane nodes)."""
    fixed_fine = np.asarray(fixed_fine, bool).reshape(parents.shape[0], 3)
    out = np.zeros((n_coarse + 1, 3), dtype=bool)   # +1 sentinel slot
    live = weights > 0
    for comp in range(3):
        rows = fixed_fine[:, comp]
        tgt = parents[rows][live[rows]]
        if tgt.size:
            cnt = np.bincount(tgt, minlength=n_coarse + 1)
            out[:, comp] |= cnt > 0
    return out[:n_coarse]


def build_transfer_tables(nx_f: int, ny_f: int, nz_f: int):
    """Trilinear prolongation tables between node lattices of a
    (nx_f, ny_f, nz_f)-cell box and its 2x-coarsened counterpart.

    Returns (parents [N_f, 8], weights [N_f, 8], incidence [N_c, Dc])
    as NumPy arrays.
    """
    assert nx_f % 2 == ny_f % 2 == nz_f % 2 == 0, "cells must be even"
    nxc, nyc, nzc = nx_f // 2, ny_f // 2, nz_f // 2
    N_f = (nx_f + 1) * (ny_f + 1) * (nz_f + 1)
    N_c = (nxc + 1) * (nyc + 1) * (nzc + 1)

    iz, iy, ix = np.meshgrid(np.arange(nz_f + 1), np.arange(ny_f + 1),
                             np.arange(nx_f + 1), indexing="ij")
    ix, iy, iz = ix.reshape(-1), iy.reshape(-1), iz.reshape(-1)

    def axis(i):
        # two parent candidates per axis: even nodes collapse to one
        p0, p1 = i // 2, i // 2 + (i % 2)
        w0 = np.where(i % 2 == 1, 0.5, 1.0)
        w1 = np.where(i % 2 == 1, 0.5, 0.0)
        return (p0, w0), (p1, w1)

    ax, ay, az = axis(ix), axis(iy), axis(iz)
    # unused slots point at the sentinel coarse id N_c (weight 0); padding
    # with node 0 would concentrate millions of zero contributions on one
    # coarse node and blow up the restriction incidence width
    parents = np.empty((N_f, 8), dtype=np.int32)
    weights = np.empty((N_f, 8), dtype=np.float64)
    s_ = 0
    for pz, wz in az:
        for py, wy in ay:
            for px, wx in ax:
                w = wx * wy * wz
                cid = px + py * (nxc + 1) + pz * (nxc + 1) * (nyc + 1)
                parents[:, s_] = np.where(w > 0, cid, N_c)
                weights[:, s_] = w
                s_ += 1

    return parents, weights, _restriction_incidence(parents, N_c)


def build_voxel_transfer(coords: np.ndarray, lo, hi,
                         dims: Tuple[int, int, int]):
    """Trilinear embedding of arbitrary nodes into a (vx, vy, vz)-cell
    voxel lattice over [lo, hi]: the first transfer of the block-ELL
    hierarchy (fem/bell.py), whose fine nodes lie anywhere in the box.

    Returns (parents [N, 8], weights [N, 8], incidence) NumPy arrays in
    the :class:`Transfer` format (sentinel id = n_coarse for zero-weight
    slots, keeping the restriction incidence narrow).
    """
    vx, vy, vz = (int(d) for d in dims)
    lo = np.asarray(lo, np.float64)
    hi = np.asarray(hi, np.float64)
    coords = np.asarray(coords, np.float64)
    N = coords.shape[0]
    N_c = (vx + 1) * (vy + 1) * (vz + 1)
    d = np.array([vx, vy, vz], np.float64)
    span = np.where(hi - lo > 0, hi - lo, 1.0)
    t = (coords - lo) / span * d
    cell = np.clip(np.floor(t).astype(np.int64), 0,
                   np.array([vx, vy, vz]) - 1)
    frac = np.clip(t - cell, 0.0, 1.0)
    parents = np.empty((N, 8), dtype=np.int64)
    weights = np.empty((N, 8), dtype=np.float64)
    s = 0
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                w = ((frac[:, 0] if dx else 1.0 - frac[:, 0])
                     * (frac[:, 1] if dy else 1.0 - frac[:, 1])
                     * (frac[:, 2] if dz else 1.0 - frac[:, 2]))
                cid = ((cell[:, 0] + dx) + (cell[:, 1] + dy) * (vx + 1)
                       + (cell[:, 2] + dz) * (vx + 1) * (vy + 1))
                parents[:, s] = np.where(w > 0, cid, N_c)
                weights[:, s] = w
                s += 1
    return (parents.astype(np.int32), weights,
            _restriction_incidence(parents, N_c))


@dataclasses.dataclass(frozen=True)
class Transfer:
    """Prolongation (coarse→fine) / restriction (fine→coarse) pair, as one
    [N_f, 8, 3] row gather and one [N_c, Dc, 3] incidence gather-sum.  The
    restriction gathers rather than scatter-adds, so it gives the same
    bits every run."""

    parents: torch.Tensor    # [N_f, 8] int64
    weights: torch.Tensor    # [N_f, 8]
    incidence: torch.Tensor  # [N_c, Dc] int64 into [N_f*8] flat (+ sentinel)

    @staticmethod
    def from_tables(parents: np.ndarray, weights: np.ndarray,
                    incidence: np.ndarray, dtype, device) -> "Transfer":
        return Transfer(
            torch.as_tensor(parents, dtype=torch.int64, device=device),
            torch.as_tensor(weights, dtype=dtype, device=device),
            torch.as_tensor(incidence, dtype=torch.int64, device=device))

    def prolong(self, u_c: torch.Tensor) -> torch.Tensor:
        """[N_c, 3] → [N_f, 3]: row gathers + weighted sum.  Sentinel
        parent ids index an appended zero row."""
        u_pad = torch.cat([u_c, u_c.new_zeros((1, 3))], dim=0)
        rows = u_pad[self.parents]                           # [N_f, 8, 3]
        return torch.sum(rows * self.weights[:, :, None], dim=1)

    def restrict(self, r_f: torch.Tensor) -> torch.Tensor:
        """[N_f, 3] → [N_c, 3]: P^T via incidence gather."""
        contrib = (self.weights[:, :, None]
                   * r_f[:, None, :]).reshape(-1, 3)         # [N_f*8, 3]
        contrib = torch.cat([contrib, r_f.new_zeros((1, 3))], dim=0)
        return torch.sum(contrib[self.incidence], dim=1)


@dataclasses.dataclass(frozen=True)
class EllTable:
    """A scalar-weight matrix as row-wise ELL (``ops/ell.pack_ell_rows``),
    applied to node-major [n_cols, 3] rows by ``sell_matvec_window``."""

    cols2: torch.Tensor      # [Nt*S, 128] int32
    w2: torch.Tensor         # [Nt*S, 128] weights, slot-major
    wblk: torch.Tensor       # [Nt] int32
    gbounds: torch.Tensor    # [Nt, 1, 2*S/8] int32 (JAX signature only)
    S: int
    kc: int
    n_rows: int

    @staticmethod
    def from_triplets(rows, cols, w, n_rows: int, n_cols: int, dtype,
                      device) -> "EllTable":
        pk = pack_ell_rows(rows, cols, np.asarray(w, np.float64), n_rows,
                           n_cols)

        def t(key, dt=None):
            return torch.as_tensor(pk[key], dtype=dt, device=device)

        return EllTable(t("cols2"), t("vals2", dtype), t("wblk"),
                        t("gbounds"), pk["S"], pk["kc"], int(n_rows))

    def apply(self, u: torch.Tensor) -> torch.Tensor:
        return sell_matvec_window(self.cols2, self.w2, self.wblk,
                                  self.gbounds, u, self.S, self.kc,
                                  node_major=True, n_rows=self.n_rows)


@dataclasses.dataclass(frozen=True)
class EllTransfer:
    """The :class:`Transfer` pair as two row-wise ELL tables: P over the
    fine rows and P^T over the coarse rows, each row summed in column
    order by kernel B9b on the card (its plain version on the CPU)."""

    P: EllTable              # [N_f] rows over [N_c] columns
    R: EllTable              # [N_c] rows over [N_f] columns

    @staticmethod
    def from_tables(parents: np.ndarray, weights: np.ndarray, n_coarse: int,
                    dtype, device) -> "EllTransfer":
        """From the [N_f, 8] parent/weight tables of
        :func:`build_transfer_tables` / :func:`build_voxel_transfer`
        (sentinel and zero-weight slots dropped)."""
        n_fine = parents.shape[0]
        live = (weights > 0) & (parents < n_coarse)
        rows = np.repeat(np.arange(n_fine), parents.shape[1]).reshape(
            parents.shape)[live]
        cols = parents[live].astype(np.int64)
        w = weights[live]
        return EllTransfer(
            EllTable.from_triplets(rows, cols, w, n_fine, n_coarse, dtype,
                                   device),
            EllTable.from_triplets(cols, rows, w, n_coarse, n_fine, dtype,
                                   device))

    def prolong(self, u_c: torch.Tensor) -> torch.Tensor:
        """[N_c, 3] → [N_f, 3]."""
        return self.P.apply(u_c)

    def restrict(self, r_f: torch.Tensor) -> torch.Tensor:
        """[N_f, 3] → [N_c, 3]: P^T."""
        return self.R.apply(r_f)


# ---------------------------------------------------------------------------
# Host-side (NumPy) hierarchy build functions, float64
# ---------------------------------------------------------------------------


def _host_node_blocks_structured(op) -> np.ndarray:
    """fp64 NumPy twin of StructuredStiffnessOperator.node_blocks_raw."""
    nx, ny, nz = op.dims
    g = np.asarray(op.g, np.float64)          # [6,4,3]
    vol = np.asarray(op.vol, np.float64)      # [6]
    escale = (None if op.escale is None
              else op.escale.double().cpu().numpy())
    eye = np.eye(3)
    blocks = np.zeros((nz + 1, ny + 1, nx + 1, 3, 3))
    for t in range(6):
        tet = _TET_SPLIT[t]
        for k in range(4):
            gk = g[t, k]
            blk = vol[t] * ((op.lam + op.mu) * np.outer(gk, gk)
                            + op.mu * np.dot(gk, gk) * eye)
            oz, oy, ox = CORNER_OFFSETS[tet[k]]
            region = blocks[oz:oz + nz, oy:oy + ny, ox:ox + nx]
            if escale is None:
                region += blk
            else:
                region += escale[..., None, None] * blk
    return blocks.reshape(-1, 3, 3)


def _host_block_jacobi(blocks: np.ndarray, free_mask: np.ndarray):
    """fp64 NumPy twin of solvers.block_jacobi_preconditioner."""
    m = np.asarray(free_mask, np.float64).reshape(-1, 3)
    eye = np.eye(3)
    bm = (blocks * (m[:, :, None] * m[:, None, :])
          + (1.0 - m)[:, :, None] * eye)
    det = np.linalg.det(bm)
    sing = det == 0
    if sing.any():
        bm = np.where(sing[:, None, None], eye, bm)
    inv = np.linalg.inv(bm)
    if sing.any():
        inv = np.where(sing[:, None, None], eye, inv)
    return inv


def _host_tet4_ke_batch(coords: np.ndarray, conn: np.ndarray,
                        lam, mu) -> np.ndarray:
    """fp64 Tet4 element stiffness batch [C, 12, 12] (constant-B exact
    1-point rule).  ``lam``/``mu`` may be scalars or per-element [C]
    arrays (SIMP)."""
    X = np.asarray(coords, np.float64)[conn]       # [C,4,3]
    E = X[:, 1:] - X[:, :1]
    vol = np.linalg.det(E) / 6.0
    invE = np.linalg.inv(E)
    C = conn.shape[0]
    lam = np.broadcast_to(np.asarray(lam, np.float64), (C,))
    mu = np.broadcast_to(np.asarray(mu, np.float64), (C,))
    l5 = lam[:, None, None, None, None]
    m5 = mu[:, None, None, None, None]
    g = np.empty((C, 4, 3))
    g[:, 1:, :] = np.transpose(invE, (0, 2, 1))
    g[:, 0, :] = -g[:, 1:, :].sum(axis=1)
    dots = np.einsum("cia,cja->cij", g, g)
    ke = (l5 * np.einsum("cia,cjb->ciajb", g, g)
          + m5 * np.einsum("cib,cja->ciajb", g, g)
          + m5 * dots[:, :, None, :, None] * np.eye(3)[None, None, :,
                                                       None, :])
    return vol[:, None, None] * ke.reshape(C, 12, 12)


def _host_dense_constrained_matrix(mesh: Mesh, lam, mu,
                                   free_mask: np.ndarray) -> np.ndarray:
    """Dense fp64 K' = M K M + (I - M) of a small tet4 mesh on host.
    ``lam``/``mu`` may be per-element arrays (SIMP)."""
    ke = _host_tet4_ke_batch(mesh.coords, mesh.conn, lam, mu)
    edofs = (3 * mesh.conn[:, :, None] + np.arange(3)).reshape(-1, 12)
    n = mesh.n_dofs
    K = np.zeros((n, n))
    np.add.at(K, (edofs[:, :, None], edofs[:, None, :]), ke)
    m = np.asarray(free_mask, np.float64)
    return m[:, None] * K * m[None, :] + np.diag(1.0 - m)


# ---------------------------------------------------------------------------
# Multigrid hierarchy
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MGLevel:
    op: object                       # constrained operator at this level
    binv: torch.Tensor               # [N, 3, 3] block-Jacobi inverse blocks
    transfer: Optional[Transfer]     # to the next coarser level
    lam_max: Optional[float] = None  # lambda_max(B^-1 A), Chebyshev bound


def _apply_blocks(binv: torch.Tensor, v2d: torch.Tensor) -> torch.Tensor:
    """[N,3,3] blocks times [N,3] rows, as a broadcast product and a sum:
    one pass over the blocks.  (An einsum or ``bmm`` goes to a batched
    3x3 gemv, which took half the V-cycle's device time on an H100.)"""
    return torch.sum(binv * v2d[:, None, :], dim=2)


@dataclasses.dataclass(frozen=True)
class MultigridPreconditioner:
    """Symmetric V-cycle: pre/post block-smoothing + exact dense coarse
    solve.  Drop-in ``M`` for :func:`..fem.solvers.cg`
    (``apply_preconditioner`` dispatches on the ``apply`` method).

    Two smoothers (same matvec cost per sweep):

    - ``"jacobi"``: damped block-Jacobi.  ``omega`` must satisfy
      omega * lambda_max(B^-1 A) < 2 to contract; for tet meshes with
      non-cubic cells lambda_max exceeds 2, so the safe-and-fast default
      is 0.7 (0.9 diverges already at 1.25:1 cell anisotropy).
    - ``"chebyshev"``: block-Jacobi-preconditioned Chebyshev targeting
      [lam_max/4, 1.1*lam_max] per level (each MGLevel carries its
      lam_max; a level without one takes the Jacobi smoother).  The fixed
      polynomial keeps the V-cycle symmetric → still a valid CG
      preconditioner.
    """

    levels: Tuple[MGLevel, ...]
    coarse_inv: torch.Tensor     # [n_dofs_c, n_dofs_c] dense inverse
    omega: float = 0.7
    nu: int = 2
    smoother: str = "jacobi"

    # layout hooks: node-major [N, 3] vectors and [N, 3, 3] smoother blocks
    # here; fem/bell.BellMG overrides them for component-major [3, Np]
    def _shape(self, r: torch.Tensor) -> torch.Tensor:
        return r.reshape(-1, 3)

    def _mask(self, L) -> torch.Tensor:
        return L.op.free_mask.reshape(-1, 3)

    def _binv(self, L, v: torch.Tensor) -> torch.Tensor:
        return _apply_blocks(L.binv, v)

    def _amul(self, L, z: torch.Tensor) -> torch.Tensor:
        return L.op.matvec(z.reshape(-1)).reshape(z.shape)

    def _smooth(self, L, r2d, z2d, sweeps: int):
        if self.smoother == "chebyshev" and L.lam_max is not None:
            return self._smooth_chebyshev(L, r2d, z2d, sweeps)
        for _ in range(sweeps):
            res = r2d if z2d is None else r2d - self._amul(L, z2d)
            dz = self._binv(L, res)
            z2d = self.omega * dz if z2d is None else z2d + self.omega * dz
        return z2d

    def _smooth_chebyshev(self, L, r2d, z2d, sweeps: int):
        """Three-term Chebyshev recurrence on B^-1 A over
        [lam_max/4, 1.1 lam_max].  The 1.1 headroom matters: Chebyshev
        polynomials grow fast OUTSIDE the band, so an underestimated
        lam_max would turn the smoother into an amplifier."""
        b = 1.1 * L.lam_max
        a = L.lam_max / 4.0
        theta = 0.5 * (b + a)
        delta = 0.5 * (b - a)
        s1 = theta / delta

        if z2d is None:
            d = self._binv(L, r2d) * (1.0 / theta)
            z2d = d
        else:
            d = self._binv(L, r2d - self._amul(L, z2d)) * (1.0 / theta)
            z2d = z2d + d
        rho_old = 1.0 / s1
        for _ in range(sweeps - 1):
            rho = 1.0 / (2.0 * s1 - rho_old)
            rr = r2d - self._amul(L, z2d)
            d = (rho * rho_old) * d + (2.0 * rho / delta) * self._binv(L, rr)
            z2d = z2d + d
            rho_old = rho
        return z2d

    def _vcycle(self, lvl: int, r2d, top: int = 0):
        """The V-cycle from level ``lvl`` down.  Each level's own work
        (down: smoothing, residual, restriction; up: prolongation,
        smoothing) is a span ``L<lvl + top>``, the dense coarse solve a
        span ``coarse``; the recursion stays outside the level's span, so
        the names stay flat and each span's seconds are its own."""
        if lvl == len(self.levels):
            with span("coarse"):
                return (self.coarse_inv @ r2d.reshape(-1)).reshape(r2d.shape)
        L = self.levels[lvl]
        name = f"L{lvl + top}"
        with span(name):
            z = self._smooth(L, r2d, None, self.nu)
            res = r2d - self._amul(L, z)
            m_f = self._mask(L)
            rc = L.transfer.restrict(res * m_f)
            if lvl + 1 < len(self.levels):
                rc = rc * self._mask(self.levels[lvl + 1])
        zc = self._vcycle(lvl + 1, rc, top)
        with span(name):
            z = z + L.transfer.prolong(zc) * m_f
            return self._smooth(L, r2d, z, self.nu)

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        with span("vcycle"):
            return self._vcycle(0, self._shape(r)).reshape(r.shape)


def _per_element_material(lam, mu, esc, element: str):
    """(lam, mu) per element from a per-hex scale grid [nz, ny, nx]: the
    generators number hexes x-major (grid.py _hex_conn), with 6
    tets per hex on tet meshes."""
    if esc is None:
        return lam, mu
    e_t = np.repeat(esc.transpose(2, 1, 0).reshape(-1),
                    6 if element == "tet4" else 1)
    return lam * e_t, mu * e_t


def build_structured_multigrid(
        nx: int, ny: int, nz: int,
        lo: Sequence[float], hi: Sequence[float],
        lam: float, mu: float,
        fixed_plane_axis: int = 0,
        fixed_plane_value: Optional[float] = None,
        element: str = "tet4",
        n_levels: Optional[int] = None,
        max_coarse_dofs: int = 4000,
        dtype: torch.dtype = torch.float32,
        omega: float = 0.7, nu: int = 2,
        operator: str = "structured",
        free_mask: Optional[np.ndarray] = None,
        escale: Optional[np.ndarray] = None,
        device="cuda",
) -> Tuple[Mesh, object, MultigridPreconditioner]:
    """Hierarchy over a structured box: returns (fine mesh, fine operator,
    V-cycle preconditioner).  Cell counts must be divisible by 2^(levels-1).

    ``operator="structured"`` (the default for tet4) uses the gather-free
    stencil operator (fem/structured.py) on every level; anything else
    (``element="hex8"``, or another ``operator``) the connectivity-based
    :class:`.operator.StiffnessOperator`.

    ``free_mask`` (fine-level, [ndof]) generalizes the fixed-plane BC:
    coarse-level masks derive by transfer-weight propagation (exact for
    domain-face planes).  ``escale`` is an optional per-hex [nz, ny, nx]
    Young's-modulus scale grid (SIMP); coarser levels use 2x2x2 averages.
    """
    from .bc import DirichletBC, free_mask_from_bcs, nodes_at_plane

    device = resolve_device(device)
    gen = generate_grid_tet if element == "tet4" else generate_grid_hex
    if fixed_plane_value is None:
        fixed_plane_value = float(lo[fixed_plane_axis])

    # decide level count
    dims = [nx, ny, nz]
    max_levels = 1
    while all(d % (2 ** max_levels) == 0 for d in dims) \
            and min(d // 2 ** max_levels for d in dims) >= 1:
        max_levels += 1
    if n_levels is None:
        n_levels = max_levels
    n_levels = min(n_levels, max_levels)
    f = 2 ** (n_levels - 1)
    ndofs_c = 3 * (nx // f + 1) * (ny // f + 1) * (nz // f + 1)
    if ndofs_c > max_coarse_dofs:
        raise ValueError(
            f"coarsest level has {ndofs_c} dofs > max_coarse_dofs="
            f"{max_coarse_dofs}; cell counts must allow deeper 2:1 "
            "coarsening (use dimensions divisible by higher powers of 2)")

    structured_path = operator == "structured" and element == "tet4"
    order = 1 if element == "tet4" else 2     # tet4: the 1-point rule is exact
    levels = []
    fine_mesh = None
    fine_op = None
    mask = None
    esc = (None if escale is None
           else np.asarray(escale, np.float64).reshape(nz, ny, nx))
    for li in range(n_levels):
        f = 2 ** li
        cnx, cny, cnz = nx // f, ny // f, nz // f
        mesh = gen(cnx, cny, cnz, lo, hi)
        if li == 0:
            if free_mask is not None:
                mask = np.asarray(free_mask, np.float64).reshape(-1)
            else:
                fixed = nodes_at_plane(mesh, fixed_plane_axis,
                                       fixed_plane_value, tol=1e-9)
                mask = free_mask_from_bcs(mesh.n_dofs,
                                          [DirichletBC.fixed(fixed)])
        if structured_path:
            op = StructuredStiffnessOperator.build(
                cnx, cny, cnz, lo, hi, lam, mu, free_mask=mask,
                escale=esc, dtype=dtype, device=device)
            binv = torch.as_tensor(_host_block_jacobi(
                _host_node_blocks_structured(op), mask), dtype=dtype,
                device=device)
        else:
            op = StiffnessOperator.build(
                mesh.device(dtype=dtype, device=device),
                *_per_element_material(lam, mu, esc, element),
                free_mask=torch.as_tensor(mask, dtype=dtype, device=device),
                mode="otf", order=order)
            binv = block_jacobi_preconditioner(op.node_blocks_raw(),
                                               op.free_mask)
        transfer = None
        if li + 1 < n_levels:
            parents, weights, inc = build_transfer_tables(cnx, cny, cnz)
            transfer = Transfer.from_tables(parents, weights, inc, dtype,
                                            device)
            # propagate the Dirichlet mask + average the material down
            n_coarse = (cnx // 2 + 1) * (cny // 2 + 1) * (cnz // 2 + 1)
            fixed_c = propagate_fixed(parents, weights,
                                      mask.reshape(-1, 3) == 0, n_coarse)
            mask = np.where(fixed_c, 0.0, 1.0).reshape(-1)
            if esc is not None:
                esc = esc.reshape(cnz // 2, 2, cny // 2, 2,
                                  cnx // 2, 2).mean(axis=(1, 3, 5))
        levels.append(MGLevel(op, binv, transfer))
        if li == 0:
            fine_mesh, fine_op = mesh, op

    # exact dense inverse of the coarsest constrained operator, assembled
    # and inverted on the host in fp64 (mesh, mask and esc from the last
    # loop iteration ARE the coarsest level's); the fixed rows/cols are
    # zeroed so restricted residual components at coarse Dirichlet dofs
    # cannot leak into the prolonged correction
    lam_e, mu_e = _per_element_material(lam, mu, esc, element)
    if structured_path:
        K_c = _host_dense_constrained_matrix(mesh, lam_e, mu_e, mask)
    else:
        K_c = assemble_scipy(mesh, lam_e, mu_e, order=order,
                             free_mask=mask).toarray()
    inv_np = np.linalg.inv(K_c)
    coarse_inv = torch.as_tensor(mask[:, None] * inv_np * mask[None, :],
                                 dtype=dtype, device=device)

    # the V-cycle descends len(levels) smoothed levels and then applies the
    # dense inverse: the coarsest MGLevel is dropped, its operator kept
    # only through coarse_inv
    mg = MultigridPreconditioner(tuple(levels[:-1]), coarse_inv,
                                 omega=omega, nu=nu)
    return fine_mesh, fine_op, mg


# ---------------------------------------------------------------------------
# Galerkin voxel multigrid (any mesh)
# ---------------------------------------------------------------------------


def galerkin_voxel_operator(op, transfer: EllTransfer, mask_c: np.ndarray,
                            dims: Tuple[int, int, int],
                            reach: Tuple[int, int, int] = (2, 2, 2),
                            dtype: torch.dtype = torch.float32):
    """True Galerkin coarse operator A_c = P^T A' P on the voxel lattice,
    computed by COLORED PROBING of the matrix-free fine operator: coarse
    lattice nodes of the same (mod 2*reach+1 per axis) color have disjoint
    in-reach stencils, so prod(2r+1)*3 masked matvecs recover every 3x3
    coupling block exactly.  The probes run one after another on the
    operator's device; the extraction runs on the host in float64.

    Rediscretized voxel operators diverge on porous/optimized geometry (no
    relation to P^T A P); the Galerkin form makes the coarse-grid
    correction an A-orthogonal projection, never error-increasing.

    Returns (ELLBlockOperator, updated mask_c): coarse dofs with an empty
    Galerkin row (voxel corners supporting no fine node) become fixed.
    """
    from .ell import ELLBlockOperator

    device = op.free_mask.device
    vx, vy, vz = (int(d) for d in dims)
    nxn, nyn, nzn = vx + 1, vy + 1, vz + 1
    N_c = nxn * nyn * nzn
    rx, ry, rz = reach
    px, py, pz = 2 * rx + 1, 2 * ry + 1, 2 * rz + 1
    n_probes = px * py * pz * 3

    iz, iy, ix = np.meshgrid(np.arange(nzn), np.arange(nyn),
                             np.arange(nxn), indexing="ij")
    ix, iy, iz = ix.ravel(), iy.ravel(), iz.ravel()
    color = torch.as_tensor(((iz % pz) * py + iy % py) * px + ix % px,
                            device=device)
    mask_c2 = torch.as_tensor(mask_c, dtype=dtype,
                              device=device).reshape(N_c, 3)
    eye3 = torch.eye(3, dtype=dtype, device=device)
    W = torch.empty((n_probes, N_c * 3), dtype=dtype, device=device)
    for pidx in range(n_probes):
        # probe pidx = 3 * ((cz * py + cy) * px + cx) + b
        ind = (color == pidx // 3).to(dtype)
        e = ind[:, None] * eye3[pidx % 3][None, :] * mask_c2
        v = transfer.prolong(e)                 # [N_f, 3], already zero
        w = op.matvec(v.reshape(-1))            # at fine fixed dofs
        W[pidx] = (transfer.restrict(w.reshape(-1, 3)) * mask_c2).reshape(-1)
    W = W.double().cpu().numpy().reshape(n_probes, N_c, 3)

    # host extraction: for row i and lattice offset o, the probed value at
    # i in the probe colored like j = i + o IS the (i, j) block column
    offsets = [(dx, dy, dz)
               for dz in range(-rz, rz + 1)
               for dy in range(-ry, ry + 1)
               for dx in range(-rx, rx + 1)]
    O = len(offsets)
    cols_full = np.full((N_c, O), N_c, dtype=np.int64)
    blocks_full = np.zeros((N_c, O, 3, 3))
    rows_idx = np.arange(N_c)
    for o_idx, (dx, dy, dz) in enumerate(offsets):
        jx, jy, jz = ix + dx, iy + dy, iz + dz
        valid = ((jx >= 0) & (jx < nxn) & (jy >= 0) & (jy < nyn)
                 & (jz >= 0) & (jz < nzn))
        j = jx + jy * nxn + jz * nxn * nyn
        base = (((jz % pz) * py + jy % py) * px + jx % px) * 3
        for b in range(3):
            vals = W[base + b, rows_idx, :]      # [N_c, 3]
            blocks_full[valid, o_idx, :, b] = vals[valid]
        cols_full[valid, o_idx] = j[valid]

    # pack rows: drop zero blocks, fix dofs whose Galerkin diagonal is 0
    nz = (np.abs(blocks_full).max(axis=(2, 3)) > 0) & (cols_full < N_c)
    o_diag = offsets.index((0, 0, 0))
    diag = blocks_full[:, o_diag][:, np.arange(3), np.arange(3)]  # [N_c,3]
    mask_new = np.asarray(mask_c, np.float64).reshape(N_c, 3).copy()
    mask_new[diag <= 0] = 0.0
    counts = nz.sum(axis=1)
    D = max(int(counts.max()) if N_c else 1, 1)
    order = np.argsort(~nz, axis=1, kind="stable")[:, :D]
    packed_nz = np.take_along_axis(nz, order, axis=1)
    cols_p = np.where(packed_nz,
                      np.take_along_axis(cols_full, order, axis=1), N_c)
    blocks_p = np.where(packed_nz[:, :, None, None],
                        np.take_along_axis(
                            blocks_full, order[:, :, None, None]
                            .repeat(3, 2).repeat(3, 3), axis=1), 0.0)
    ell = ELLBlockOperator.from_block_rows(cols_p, blocks_p,
                                           mask_new.reshape(-1), dtype,
                                           device)
    return ell, mask_new.reshape(-1)


def _rap_host(ell, parents: np.ndarray, weights: np.ndarray,
              n_coarse_nodes: int, mask_c: np.ndarray, dtype):
    """Host Galerkin triple product A_{l+1} = P^T A_l P between ELL levels
    (small matrices, scipy CSR math), returning (ELL operator, mask)."""
    import scipy.sparse as sp
    from .ell import ELLBlockOperator

    K = ell.to_scipy_bsr()                       # raw fp64
    N_f = parents.shape[0]
    live = (weights > 0) & (parents < n_coarse_nodes)
    rows = np.repeat(np.arange(N_f), parents.shape[1]).reshape(
        N_f, -1)[live]
    P_node = sp.coo_matrix((weights[live], (rows, parents[live])),
                           shape=(N_f, n_coarse_nodes)).tocsr()
    P_dof = sp.kron(P_node, sp.eye(3), format="csr")
    A2 = (P_dof.T @ K @ P_dof).tocsr()
    # prune numerical noise to keep the ELL width tight
    if A2.nnz:
        tol = 1e-14 * np.abs(A2.diagonal()).max()
        A2.data[np.abs(A2.data) < tol] = 0.0
        A2.eliminate_zeros()
    # fix dofs with empty/zero diagonal
    d = A2.diagonal()
    mask_new = np.asarray(mask_c, np.float64).reshape(-1).copy()
    mask_new[d <= 0] = 0.0
    return (ELLBlockOperator.from_scipy_bsr(A2, mask_new, dtype, ell.device),
            mask_new)


def estimate_smoother_lambda_max(op, binv: torch.Tensor, iters: int = 30,
                                 seed: int = 0) -> float:
    """lambda_max(B^-1 A) by power iteration on the operator's device.  The
    damped block-Jacobi smoother needs omega * lambda_max < 2 to contract;
    unstructured meshes push lambda_max to ~3-4, so it is measured, not
    assumed.  The start vector comes from ``torch.Generator`` seeded with
    ``seed`` on the CPU, so every device starts from the same vector (not
    the JAX package's: its generator differs)."""
    mask = op.free_mask
    gen = torch.Generator().manual_seed(seed)
    v = torch.randn(op.n_dofs, generator=gen, dtype=mask.dtype).to(
        mask.device) * mask
    v = v / torch.linalg.vector_norm(v)
    lam = 0.0
    for _ in range(iters):
        w = _apply_blocks(binv, op.matvec(v).reshape(-1, 3)).reshape(-1)
        lam = float(torch.linalg.vector_norm(w))
        v = w / max(lam, 1e-300)
    return lam


def _host_binv_and_lambda_max(ell, mask: np.ndarray, iters: int = 30):
    """Host fp64 (block_jacobi_preconditioner, power iteration) of an ELL
    Galerkin level."""
    A = ell.to_scipy_bsr()
    N = ell.n_nodes
    m = np.asarray(mask, np.float64).reshape(-1)
    m3 = m.reshape(N, 3)
    Ab = A.tobsr(blocksize=(3, 3))
    Ab.sort_indices()
    diag = np.zeros((N, 3, 3))
    counts = Ab.indptr[1:] - Ab.indptr[:-1]
    rows = np.repeat(np.arange(N), counts)
    sel = Ab.indices == rows
    diag[rows[sel]] = Ab.data[sel]
    eye = np.eye(3)
    bm = diag * (m3[:, :, None] * m3[:, None, :]) \
        + (1.0 - m3)[:, :, None] * eye
    det = np.linalg.det(bm)
    bm[det == 0] = eye
    binv = np.linalg.inv(bm)
    lam = block_power_iteration(
        lambda v: m * (A @ (m * v)) + (1.0 - m) * v, binv, m, iters)
    return binv, lam


#: voxel spacing of the lattice over the mean node spacing
_VOXEL_COARSEN = 2.0
#: Chebyshev smoothing steps before and after the coarse correction
_VOXEL_NU = 2
#: quadrature order of the fine operator and its host twin
_VOXEL_ORDER = 2


def build_unstructured_multigrid(
        mesh: Mesh, lam, mu,
        free_mask: Optional[np.ndarray] = None,
        dtype: torch.dtype = torch.float32,
        max_coarse_dofs: int = 4000,
        device="cuda",
        info: Optional[dict] = None,
) -> Tuple[StiffnessOperator, MultigridPreconditioner]:
    """Matrix-free V-cycle preconditioner for an ARBITRARY mesh.

    Fine level = the matrix-free :class:`StiffnessOperator` (``otf``: the
    element-apply kernels); coarse levels = Galerkin operators on an
    embedded voxel lattice (:class:`.ell.ELLBlockOperator`).  ``lam``/``mu``
    may be per-element arrays (SIMP).  Every level smooths with Chebyshev
    over its measured lambda_max(B^-1 A).  ``info``, when given, receives
    the lattice, the level sizes and the build seconds by phase (the
    seconds of its ``steps``).

    Returns (fine operator, MultigridPreconditioner), a drop-in ``M`` for
    :func:`..fem.solvers.cg`.
    """
    info = {} if info is None else info
    with steps() as step:
        out = _build_unstructured(mesh, lam, mu, free_mask, dtype,
                                  max_coarse_dofs, device, info, step)
    info["phases"] = {k: v for k, v in step.seconds.items() if "/" not in k}
    return out


def _build_unstructured(mesh: Mesh, lam, mu, free_mask, dtype,
                        max_coarse_dofs: int, device, info: dict,
                        step: steps):
    import time as _time

    device = resolve_device(device)
    t_start = _time.perf_counter()

    C = mesh.n_cells
    lam_e = np.broadcast_to(np.asarray(lam, np.float64), (C,))
    mu_e = np.broadcast_to(np.asarray(mu, np.float64), (C,))
    if free_mask is None:
        free_mask = np.ones(mesh.n_dofs)
    free_np = np.asarray(free_mask, np.float64).reshape(-1)

    # --- fine level ---------------------------------------------------------
    step("fine_op_and_blocks")
    op = StiffnessOperator.build(
        mesh.device(dtype=dtype, device=device), np.array(lam_e),
        np.array(mu_e),
        free_mask=torch.as_tensor(free_np, dtype=dtype, device=device),
        mode="otf", order=_VOXEL_ORDER)
    host_fine = HostFineOperator(mesh, lam_e, mu_e, free_np, _VOXEL_ORDER)
    binv_np = _host_block_jacobi(host_fine.node_blocks(), free_np)
    binv_fine = torch.as_tensor(binv_np, dtype=dtype, device=device)
    step("transfer_and_fine_lambda_max")

    # --- voxel lattice dims -------------------------------------------------
    lo, hi = mesh.bounding_box()
    extent = np.maximum(hi - lo, 1e-300)
    # voxel edge ~ _VOXEL_COARSEN x mean node spacing (bbox-based estimate)
    h = _VOXEL_COARSEN * (float(np.prod(extent))
                   / max(mesh.n_nodes, 1)) ** (1.0 / 3.0)
    dims0 = np.maximum(np.round(extent / h).astype(int), 1)

    # structured levels below the voxel level: round dims up to multiples
    # of 2^(L-1); pick the fewest voxel levels whose coarsest fits the
    # dense inverse
    def rounded(L):
        f = 2 ** (L - 1)
        dr = ((dims0 + f - 1) // f) * f
        nd = 3 * int(np.prod(dr // f + 1))
        return dr, nd

    L = 1
    while True:
        dims_r, ndc = rounded(L)
        if ndc <= max_coarse_dofs or L >= 12:
            break
        L += 1
    if ndc > max_coarse_dofs:
        raise ValueError(
            f"coarsest voxel level has {ndc} dofs > max_coarse_dofs="
            f"{max_coarse_dofs}")
    vx, vy, vz = (int(x) for x in dims_r)

    # --- fine → voxel transfer + Galerkin level 1 ----------------------------
    parents, weights, _ = build_voxel_transfer(mesh.coords, lo, hi,
                                               (vx, vy, vz))
    n_vox_nodes = (vx + 1) * (vy + 1) * (vz + 1)
    transfer0 = EllTransfer.from_tables(parents, weights, n_vox_nodes,
                                        dtype, device)
    fixed_c = propagate_fixed(parents, weights,
                              free_np.reshape(-1, 3) == 0, n_vox_nodes)
    mask_c = np.where(fixed_c, 0.0, 1.0).reshape(-1)

    lam_max_fine = host_fine.power_lambda_max(binv_np)
    del host_fine, binv_np
    levels = [MGLevel(op, binv_fine, transfer0, lam_max=lam_max_fine)]
    step("probing")

    # coupling reach on the lattice: an element spanning k voxels along an
    # axis links corners k+1 apart; reach 2 covers elements up to one
    # voxel wide (_VOXEL_COARSEN >= 2 guarantees this for graded
    # meshes, but irregular imports can contain outlier elements)
    X = mesh.coords[mesh.conn]
    ext = X.max(axis=1) - X.min(axis=1)           # [C, 3]
    del X
    h_vox = (np.asarray(hi) - np.asarray(lo)) / np.array([vx, vy, vz])
    reach = tuple(int(r) for r in
                  np.clip(np.ceil(ext.max(axis=0) / h_vox) + 1, 2, 4))

    ell, mask_c = galerkin_voxel_operator(op, transfer0, mask_c,
                                          (vx, vy, vz), reach=reach,
                                          dtype=dtype)
    step("coarse_levels")

    # --- Galerkin (RAP) coarser levels ---------------------------------------
    cur_dims = (vx, vy, vz)
    level_nodes = [mesh.n_nodes, n_vox_nodes]
    widths = [ell.S]
    for li in range(L):
        binv_np, lam_max_l = _host_binv_and_lambda_max(ell, mask_c)
        binv = torch.as_tensor(binv_np, dtype=dtype, device=device)
        if li + 1 < L:
            cnx, cny, cnz = cur_dims
            p2, w2, _ = build_transfer_tables(cnx, cny, cnz)
            n_coarse = (cnx // 2 + 1) * (cny // 2 + 1) * (cnz // 2 + 1)
            transfer = EllTransfer.from_tables(p2, w2, n_coarse, dtype,
                                               device)
            fixed_next = propagate_fixed(p2, w2,
                                         mask_c.reshape(-1, 3) == 0,
                                         n_coarse)
            mask_next = np.where(fixed_next, 0.0, 1.0).reshape(-1)
            levels.append(MGLevel(ell, binv, transfer, lam_max=lam_max_l))
            ell, mask_c = _rap_host(ell, p2, w2, n_coarse, mask_next, dtype)
            cur_dims = (cnx // 2, cny // 2, cnz // 2)
            level_nodes.append(n_coarse)
            widths.append(ell.S)
        else:
            levels.append(MGLevel(ell, binv, None, lam_max=lam_max_l))
    step("coarsest_pinv")

    # --- coarsest level: eigendecomposition pseudo-inverse -------------------
    # On porous/optimized geometry a voxel can contain fewer fine nodes
    # than its corners carry coarse basis functions, making P^T A P
    # locally RANK-DEFICIENT (nonzero diagonal, singular matrix): a plain
    # inverse explodes the V-cycle.  The eigenvalue-cutoff pseudo-inverse
    # keeps the coarse correction an A-orthogonal projection onto the
    # well-represented subspace: still exactly non-expansive.
    K_c = ell.to_dense_constrained()
    K_c = 0.5 * (K_c + K_c.T)
    evals, evecs = np.linalg.eigh(K_c)
    inv_e = coarse_pinv_weights(evals, dtype)
    inv_np = (evecs * inv_e) @ evecs.T
    m_c = np.asarray(mask_c, np.float64).reshape(-1)
    coarse_inv = torch.as_tensor(m_c[:, None] * inv_np * m_c[None, :],
                                 dtype=dtype, device=device)
    step.end()

    # the Jacobi damping the JAX package records beside its Chebyshev
    # smoother (no level smooths with it: each has its lambda_max)
    omega = float(min(0.7, 1.4 / max(lam_max_fine, 1e-6)))
    info.update({"lattice": (vx, vy, vz), "voxel_levels": L,
                 "reach": reach, "n_probes": 3 * int(np.prod(
                     [2 * r + 1 for r in reach])),
                 "level_nodes": level_nodes, "ell_widths": widths,
                 "lam_max_fine": lam_max_fine, "omega": omega,
                 "build_seconds": _time.perf_counter() - t_start})
    mg = MultigridPreconditioner(tuple(levels[:-1]), coarse_inv,
                                 omega=omega, nu=_VOXEL_NU,
                                 smoother="chebyshev")
    return op, mg
