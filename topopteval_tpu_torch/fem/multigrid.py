"""Geometric multigrid preconditioner for structured box meshes
(counterpart of ``topopteval_tpu.fem.multigrid``, structured part).

The reference's answer to large problems is Jacobi-preconditioned Krylov
(reference: FiniteElementAnalysis.jl:570-598; RobustSolver.jl:196-216),
whose iteration count grows like n^(1/3).  This is a matrix-free geometric
V-cycle on the nested structured grids of models/beams.py: trilinear
transfer operators as row gathers and a deterministic incidence
gather-sum, damped block-Jacobi (or Chebyshev) smoothing, and an exact
dense solve on the coarsest level, giving mesh-independent CG iteration
counts.

Used as the preconditioner ``M`` of :func:`..fem.solvers.cg` (symmetric
V-cycle with symmetric smoother + exact coarse solve → SPD).  The
hierarchy is built once per mesh on the host in float64; the V-cycle runs
on the operator's device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..mesh import Mesh, resolve_device
from ..models.beams import _TET_SPLIT, generate_grid_hex, generate_grid_tet
from ..ops.stencil import CORNER_OFFSETS
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

    def _smooth(self, L: MGLevel, r2d, z2d, sweeps: int):
        if self.smoother == "chebyshev" and L.lam_max is not None:
            return self._smooth_chebyshev(L, r2d, z2d, sweeps)
        for _ in range(sweeps):
            if z2d is None:
                res = r2d
            else:
                Az = L.op.matvec(z2d.reshape(-1)).reshape(-1, 3)
                res = r2d - Az
            dz = _apply_blocks(L.binv, res)
            z2d = self.omega * dz if z2d is None else z2d + self.omega * dz
        return z2d

    def _smooth_chebyshev(self, L: MGLevel, r2d, z2d, sweeps: int):
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
            rr = r2d
            d = _apply_blocks(L.binv, rr) * (1.0 / theta)
            z2d = d
        else:
            Az = L.op.matvec(z2d.reshape(-1)).reshape(-1, 3)
            rr = r2d - Az
            d = _apply_blocks(L.binv, rr) * (1.0 / theta)
            z2d = z2d + d
        rho_old = 1.0 / s1
        for _ in range(sweeps - 1):
            rho = 1.0 / (2.0 * s1 - rho_old)
            Az = L.op.matvec(z2d.reshape(-1)).reshape(-1, 3)
            rr = r2d - Az
            d = (rho * rho_old) * d + (2.0 * rho / delta) * _apply_blocks(
                L.binv, rr)
            z2d = z2d + d
            rho_old = rho
        return z2d

    def _vcycle(self, lvl: int, r2d):
        if lvl == len(self.levels):
            return (self.coarse_inv @ r2d.reshape(-1)).reshape(-1, 3)
        L = self.levels[lvl]
        z = self._smooth(L, r2d, None, self.nu)
        Az = L.op.matvec(z.reshape(-1)).reshape(-1, 3)
        res = r2d - Az
        m_f = L.op.free_mask.reshape(-1, 3)
        rc = L.transfer.restrict(res * m_f)
        if lvl + 1 < len(self.levels):
            rc = rc * self.levels[lvl + 1].op.free_mask.reshape(-1, 3)
        zc = self._vcycle(lvl + 1, rc)
        z = z + L.transfer.prolong(zc) * m_f
        return self._smooth(L, r2d, z, self.nu)

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        return self._vcycle(0, r.reshape(-1, 3)).reshape(r.shape)


def _per_element_material(lam, mu, esc, element: str):
    """(lam, mu) per element from a per-hex scale grid [nz, ny, nx]: the
    generators number hexes x-major (models/beams.py _hex_conn), with 6
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
