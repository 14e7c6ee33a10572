"""Exact float64 host twin of the masked fine operator (counterpart of
``_HostFineOperator.__init__``, ``_ke64`` and ``matvec64`` in
topopteval_tpu/fem/multigrid.py:822-960), and the chunked host Ke batch
that it and ``assemble_scipy`` share.

Mixed-precision refinement (api._refined_generic) evaluates every outer
residual with this NumPy matvec, so a float32 device solve can certify
tolerances below float32's own reach.
"""

from __future__ import annotations

import numpy as np
import torch

from ..mesh import Mesh
from ..ops.elements import element_stiffness

#: Ke entries per chunk of the host build.  The plain einsum route holds
#: about four Ke-sized float64 temporaries per chunk; this bounds each to
#: ~240 MB (32,768 tet10 elements, the JAX operator's _REDUCE_CHUNK).  At
#: full width the tet10 Ke batch alone is 1.1 GB, its temporaries several
#: times that.
_KE_CHUNK_ENTRIES = 32768 * 900
_CHUNK = 131072     # elements per chunk of the host matvec


def host_element_stiffness(mesh: Mesh, lam_e, mu_e, order: int
                           ) -> np.ndarray:
    """Exact float64 Ke batch [C, 3k, 3k] of the whole mesh, built on the
    host in chunks through the plain ``element_stiffness``."""
    C, k = mesh.conn.shape
    ek = 3 * k
    lam = torch.from_numpy(np.array(np.broadcast_to(
        np.asarray(lam_e, np.float64), (C,))))
    mu = torch.from_numpy(np.array(np.broadcast_to(
        np.asarray(mu_e, np.float64), (C,))))
    step = max(1, _KE_CHUNK_ENTRIES // (ek * ek))
    ke = np.empty((C, ek, ek), np.float64)
    for c0 in range(0, C, step):
        sl = slice(c0, c0 + step)
        coords_e = torch.from_numpy(mesh.coords[mesh.conn[sl]])
        ke[sl] = element_stiffness(coords_e, lam[sl], mu[sl],
                                   mesh.element_type, order).numpy()
    return ke


class HostFineOperator:
    """float64 NumPy ``m*K*m*u + (1-m)*u`` with a stored Ke batch."""

    def __init__(self, mesh: Mesh, lam_e, mu_e, mask, order: int):
        self.mesh = mesh
        self.order = order
        self.conn = mesh.conn.astype(np.int64)
        self.n_nodes = mesh.n_nodes
        self.lam_e = np.asarray(lam_e, np.float64)
        self.mu_e = np.asarray(mu_e, np.float64)
        self.mask = np.asarray(mask, np.float64).reshape(-1)
        self._ke_cache64 = None

    def _ke64(self) -> np.ndarray:
        """Exact fp64 Ke batch [C, 3k, 3k], built once."""
        if self._ke_cache64 is None:
            self._ke_cache64 = host_element_stiffness(
                self.mesh, self.lam_e, self.mu_e, self.order)
        return self._ke_cache64

    def matvec64(self, u: np.ndarray) -> np.ndarray:
        """Exact fp64 masked matvec (m*K*m*u + (1-m)*u)."""
        m = self.mask
        um = (m * u).reshape(self.n_nodes, 3)
        k = self.conn.shape[1]
        ke = self._ke64()
        f = np.zeros((self.n_nodes, 3))
        C = self.conn.shape[0]
        for c0 in range(0, C, 2 * _CHUNK):
            cn = self.conn[c0:c0 + 2 * _CHUNK]
            u_e = um[cn].reshape(-1, 3 * k, 1)
            fe3 = (ke[c0:c0 + 2 * _CHUNK] @ u_e)[:, :, 0].reshape(-1, k, 3)
            fl = cn.reshape(-1)
            for a in range(3):
                f[:, a] += np.bincount(
                    fl, weights=fe3[:, :, a].reshape(-1),
                    minlength=self.n_nodes)
        f = f.reshape(-1)
        return m * f + (1.0 - m) * u
