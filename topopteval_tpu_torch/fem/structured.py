"""Stencil (gather-free) matrix-free operator for structured box meshes
(counterpart of ``topopteval_tpu.fem.structured``).

On the uniform grids of grid.py every hexahedron is congruent, so
each of its 6 tetrahedra has constant physical shape-function gradients
and one assembled 24x24 hex stiffness serves every cell.  The matvec then
needs no connectivity at all: it is the fused stencil of ops/stencil.py
over the node lattice, scaled per hex for SIMP.

Same ``matvec`` contract as :class:`.operator.StiffnessOperator`, so it
drives ``cg`` and the multigrid V-cycle unchanged.  Supports a uniform
material and a per-hex Young's-modulus scale.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..mesh import resolve_device
from ..grid import _TET_SPLIT
from ..ops.stencil import CORNER_OFFSETS, cell_table, stencil_matvec


def _reference_tet_gradients(dx: float, dy: float, dz: float):
    """Constant gradients g [6, 4, 3] + volumes [6] for the 6 congruent
    tets of a dx*dy*dz hex (split _TET_SPLIT, grid.py)."""
    corners = np.array([(ox * dx, oy * dy, oz * dz)
                        for (oz, oy, ox) in CORNER_OFFSETS])
    g = np.zeros((6, 4, 3))
    vol = np.zeros(6)
    for t, tet in enumerate(_TET_SPLIT):
        X = corners[tet]                       # [4, 3]
        E = X[1:] - X[0]                       # edge matrix (rows)
        vol[t] = np.linalg.det(E) / 6.0
        invE = np.linalg.inv(E)
        # dN_{i+1}/dx_a = (E^{-1})[a][i]
        g[t, 1:, :] = invE.T
        g[t, 0, :] = -invE.T.sum(axis=0)
    return g, vol


class StructuredStiffnessOperator:
    """Gather-free stiffness operator on an (nx, ny, nz) box of 6-tet hexes.

    ``escale`` is an optional per-hex Young's-modulus scale grid
    [nz, ny, nx] (SIMP); the material is otherwise uniform (lam, mu).  All
    tensors live on one device; on a CUDA device ``matvec_raw`` always
    runs a stencil kernel, on the CPU that kernel's plain version.
    """

    def __init__(self, g: np.ndarray, vol: np.ndarray, lam: float, mu: float,
                 free_mask: torch.Tensor, escale: Optional[torch.Tensor],
                 dims: Tuple[int, int, int]):
        self.g = g                    # [6, 4, 3] constant tet gradients
        self.vol = vol                # [6] tet volumes
        self.lam = lam
        self.mu = mu
        self.free_mask = free_mask    # [ndof] 1.0 free / 0.0 fixed
        self.escale = escale          # [nz, ny, nx] or None
        self.dims = dims              # (nx, ny, nz) cells
        #: the hex stiffness (the window kernel and the plain version) and
        #: the six tets' cell table (the plane kernel), in the working dtype
        self.ke = torch.as_tensor(self._hex_ke(), dtype=free_mask.dtype,
                                  device=free_mask.device)
        self.table = cell_table(g, vol, lam, mu, free_mask.dtype,
                                free_mask.device)

    @staticmethod
    def build(nx: int, ny: int, nz: int,
              lo: Sequence[float], hi: Sequence[float],
              lam: float, mu: float,
              free_mask: Optional[np.ndarray] = None,
              escale: Optional[np.ndarray] = None,
              dtype: torch.dtype = torch.float32,
              device="cuda") -> "StructuredStiffnessOperator":
        device = resolve_device(device)
        dx = (hi[0] - lo[0]) / nx
        dy = (hi[1] - lo[1]) / ny
        dz = (hi[2] - lo[2]) / nz
        g, vol = _reference_tet_gradients(dx, dy, dz)
        if free_mask is None:
            free_mask = np.ones(3 * (nx + 1) * (ny + 1) * (nz + 1))
        m_flat = np.asarray(free_mask, np.float64).reshape(-1)
        return StructuredStiffnessOperator(
            g, vol, float(lam), float(mu),
            torch.as_tensor(m_flat, dtype=dtype, device=device),
            None if escale is None else torch.as_tensor(
                np.asarray(escale, np.float64).reshape(nz, ny, nx),
                dtype=dtype, device=device).contiguous(),
            (int(nx), int(ny), int(nz)))

    @property
    def n_dofs(self) -> int:
        nx, ny, nz = self.dims
        return 3 * (nx + 1) * (ny + 1) * (nz + 1)

    # -- application --------------------------------------------------------

    def _hex_ke(self) -> np.ndarray:
        """Assembled 24x24 uniform-material hex stiffness (corner-major
        DOF order k*3+a) from the 6 congruent tets, float64 on the host."""
        K = np.zeros((24, 24))
        eye = np.eye(3)
        for t, tet in enumerate(_TET_SPLIT):
            gt = self.g[t]                          # [4, 3]
            for i in range(4):
                for j in range(4):
                    blk = (self.lam * np.outer(gt[i], gt[j])
                           + self.mu * np.outer(gt[j], gt[i])
                           + self.mu * float(gt[i] @ gt[j]) * eye)
                    K[tet[i] * 3:tet[i] * 3 + 3,
                      tet[j] * 3:tet[j] * 3 + 3] += self.vol[t] * blk
        return K

    def matvec_raw(self, u: torch.Tensor) -> torch.Tensor:
        """K @ u without BC masking: the fused stencil of ops/stencil.py."""
        return stencil_matvec(u.contiguous(), self.escale, self.ke, self.dims,
                              table=self.table)

    def matvec(self, u: torch.Tensor) -> torch.Tensor:
        """Constrained operator A'(u) = m*A(m*u) + (1-m)*u."""
        m = self.free_mask
        return m * self.matvec_raw(m * u) + (1.0 - m) * u

    # -- preconditioning ----------------------------------------------------

    def node_blocks_raw(self) -> torch.Tensor:
        """3x3 node blocks [n_nodes, 3, 3] via shifted adds of constant
        per-corner blocks (uniform material) or escale-weighted grids
        (SIMP)."""
        nx, ny, nz = self.dims
        m = self.free_mask
        blocks = torch.zeros((nz + 1, ny + 1, nx + 1, 3, 3), dtype=m.dtype,
                             device=m.device)
        eye = np.eye(3)
        for t, tet in enumerate(_TET_SPLIT):
            for k in range(4):
                gk = self.g[t, k]
                blk = torch.as_tensor(
                    self.vol[t] * ((self.lam + self.mu) * np.outer(gk, gk)
                                   + self.mu * np.dot(gk, gk) * eye),
                    dtype=m.dtype, device=m.device)
                oz, oy, ox = CORNER_OFFSETS[tet[k]]
                region = blocks[oz:oz + nz, oy:oy + ny, ox:ox + nx]
                if self.escale is None:
                    region += blk
                else:
                    region += self.escale[..., None, None] * blk
        return blocks.reshape(-1, 3, 3)

    def diagonal_raw(self) -> torch.Tensor:
        return torch.diagonal(self.node_blocks_raw(), dim1=1,
                              dim2=2).reshape(-1)

    def diagonal(self) -> torch.Tensor:
        """diag of the constrained operator (fixed dofs get 1.0)."""
        m = self.free_mask
        return m * m * self.diagonal_raw() + (1.0 - m)

    # -- reductions ---------------------------------------------------------

    def energy(self, u: torch.Tensor) -> torch.Tensor:
        """0.5 u^T K u (reference: FiniteElementAnalysis.jl:550),
        accumulated in float64, as StiffnessOperator.energy."""
        Ku = self.matvec(u)
        return 0.5 * torch.dot(u.double(), Ku.double())
