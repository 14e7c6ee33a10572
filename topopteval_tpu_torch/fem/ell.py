"""Block-ELL operator of the Galerkin voxel multigrid's coarse levels
(counterpart of ``topopteval_tpu/fem/ell.py``).

A coarse level is a true Galerkin operator A_c = P^T A P (fem/multigrid.py
builds it by colored probing of the fine operator, and by host RAP below
that).  It is stored in the row-slot ELL layout of ``ops/ell.pack_ell_rows``
and applied by ``ops/ell.bell_matvec_window``: the kernel B9a on the card,
its plain version on the CPU.  Vectors are the V-cycle's interleaved
``[3N]`` (node-major), read by the kernel as a strided view.

The JAX package applies the operator in chunks of 8 block columns, because
a full gather pads its minor dimension 3 to 128 on the TPU; that loop has
no counterpart here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..mesh import resolve_device
from ..ops.ell import bell_matvec_window, pack_ell_rows


@dataclasses.dataclass(frozen=True)
class ELLBlockOperator:
    """Constrained block-ELL operator A'(u) = m*A(m*u) + (1-m)*u."""

    cols2: torch.Tensor      # [Nt*S, 128] int32
    vals2: torch.Tensor      # [Nt*9*S, 128], plane-major 3x3 blocks
    wblk: torch.Tensor       # [Nt] int32 window bases
    gbounds: torch.Tensor    # [Nt, 1, 2*S/8] int32 (JAX signature only)
    free_mask: torch.Tensor  # [3N]
    n_nodes: int
    S: int
    kc: int

    @property
    def n_dofs(self) -> int:
        return 3 * self.n_nodes

    @property
    def device(self) -> torch.device:
        return self.vals2.device

    def matvec_raw(self, u: torch.Tensor) -> torch.Tensor:
        out = bell_matvec_window(self.cols2, self.vals2, self.wblk,
                                 self.gbounds, u.reshape(self.n_nodes, 3),
                                 self.S, self.kc, node_major=True,
                                 n_rows=self.n_nodes)
        return out.reshape(-1)

    def matvec(self, u: torch.Tensor) -> torch.Tensor:
        m = self.free_mask
        return m * self.matvec_raw(m * u) + (1.0 - m) * u

    # -- preconditioning ------------------------------------------------------

    def _slots(self):
        """(cols [Np, S], blocks [Np, S, 3, 3]) of every row, pad rows and
        pad slots included."""
        Nt, S = self.wblk.shape[0], self.S
        cols = self.cols2.reshape(Nt, S, 128).permute(0, 2, 1) \
            .reshape(Nt * 128, S)
        blocks = self.vals2.reshape(Nt, 3, 3, S, 128).permute(0, 4, 3, 1, 2) \
            .reshape(Nt * 128, S, 3, 3)
        return cols, blocks

    def node_blocks_raw(self) -> torch.Tensor:
        """Diagonal 3x3 blocks [N, 3, 3] (the slots whose column is the
        row itself; a pad slot that repeats it carries zeros)."""
        cols, blocks = self._slots()
        N = self.n_nodes
        rowids = torch.arange(N, device=cols.device)[:, None]
        is_diag = cols[:N].long() == rowids
        return torch.sum(torch.where(is_diag[:, :, None, None], blocks[:N],
                                     blocks.new_zeros(())), dim=1)

    def diagonal_raw(self) -> torch.Tensor:
        return torch.diagonal(self.node_blocks_raw(), dim1=1,
                              dim2=2).reshape(-1)

    def diagonal(self) -> torch.Tensor:
        m = self.free_mask
        return m * m * self.diagonal_raw() + (1.0 - m)

    # -- host conversions -----------------------------------------------------

    @staticmethod
    def from_triplets(rows, cols, blocks, n_nodes: int, free_mask, dtype,
                      device="cuda") -> "ELLBlockOperator":
        """Block triplets (rows [nnz], cols [nnz], blocks [nnz, 3, 3]) in
        the ``pack_ell_rows`` layout on ``device``, values in ``dtype``."""
        device = resolve_device(device)
        pk = pack_ell_rows(rows, cols, np.asarray(blocks, np.float64)
                           .reshape(-1, 3, 3), n_nodes, n_nodes)

        def t(key, dt=None):
            return torch.as_tensor(pk[key], dtype=dt, device=device)

        return ELLBlockOperator(
            cols2=t("cols2"), vals2=t("vals2", dtype), wblk=t("wblk"),
            gbounds=t("gbounds"),
            free_mask=torch.as_tensor(np.asarray(free_mask).reshape(-1),
                                      dtype=dtype, device=device),
            n_nodes=int(n_nodes), S=pk["S"], kc=pk["kc"])

    @staticmethod
    def from_block_rows(cols_np: np.ndarray, blocks_np: np.ndarray,
                        free_mask: np.ndarray, dtype,
                        device="cuda") -> "ELLBlockOperator":
        """cols [N, D] (sentinel N), blocks [N, D, 3, 3] NumPy -> operator;
        the sentinel slots are dropped."""
        N, D = cols_np.shape
        valid = cols_np < N
        rows = np.repeat(np.arange(N), D).reshape(N, D)[valid]
        return ELLBlockOperator.from_triplets(
            rows, cols_np[valid], np.asarray(blocks_np).reshape(N, D, 3, 3)
            [valid], N, free_mask, dtype, device)

    @staticmethod
    def from_scipy_bsr(A_bsr, free_mask: np.ndarray, dtype,
                       device="cuda") -> "ELLBlockOperator":
        """scipy sparse (blocksize 3x3) -> ELL, one slot per stored block."""
        A_bsr = A_bsr.tobsr(blocksize=(3, 3))
        A_bsr.sort_indices()
        N = A_bsr.shape[0] // 3
        rows = np.repeat(np.arange(N), np.diff(A_bsr.indptr))
        return ELLBlockOperator.from_triplets(
            rows, A_bsr.indices, A_bsr.data, N, free_mask, dtype, device)

    def triplets(self):
        """(rows, cols, blocks [nnz, 3, 3] float64) of the stored blocks,
        on the host; pad slots (all-zero blocks) are left out."""
        cols, blocks = self._slots()
        N = self.n_nodes
        cols = cols[:N].cpu().numpy().astype(np.int64)
        blocks = blocks[:N].cpu().double().numpy()
        live = np.abs(blocks).max(axis=(2, 3)) > 0
        rows = np.repeat(np.arange(N), self.S).reshape(N, self.S)
        return rows[live], cols[live], blocks[live]

    def to_scipy_bsr(self):
        """ELL -> scipy CSR (fp64) of the RAW (unconstrained) operator."""
        import scipy.sparse as sp

        N = self.n_nodes
        rows, cc, data = self.triplets()
        ii = 3 * rows[:, None, None] + np.arange(3)[None, :, None]
        jj = 3 * cc[:, None, None] + np.arange(3)[None, None, :]
        return sp.coo_matrix(
            (data.reshape(-1),
             (np.broadcast_to(ii, data.shape).reshape(-1),
              np.broadcast_to(jj, data.shape).reshape(-1))),
            shape=(3 * N, 3 * N)).tocsr()

    def to_dense_constrained(self) -> np.ndarray:
        """Dense fp64 M K M + (I - M) (for the coarsest-level inverse)."""
        K = self.to_scipy_bsr().toarray()
        m = self.free_mask.double().cpu().numpy()
        return m[:, None] * K * m[None, :] + np.diag(1.0 - m)
