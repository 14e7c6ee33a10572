"""Host NumPy twin of the masked fine operator (counterpart of
``_HostFineOperator`` in topopteval_tpu/fem/multigrid.py:822-973), and the
chunked host Ke batch that it and ``assemble_scipy`` share.

Mixed-precision refinement (api._refined_generic) evaluates every outer
residual with the exact float64 ``matvec64``, so a float32 device solve can
certify tolerances below float32's own reach.  The Galerkin voxel
multigrid build (fem/multigrid.build_unstructured_multigrid) takes the
fine level's smoother blocks from ``node_blocks`` and its Chebyshev bound
from ``power_lambda_max``, whose matvec runs a stored float32 Ke batch, as
the JAX package's does.
"""

from __future__ import annotations

import numpy as np
import torch

from ..mesh import Mesh
from ..ops.elements import element_stiffness, element_tables

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
    """NumPy ``m*K*m*u + (1-m)*u``: exact in float64 (``matvec64``) and
    with a float32 Ke batch (``matvec``), plus the node-diagonal blocks."""

    def __init__(self, mesh: Mesh, lam_e, mu_e, mask, order: int):
        self.mesh = mesh
        self.order = order
        self.conn = mesh.conn.astype(np.int64)
        self.n_nodes = mesh.n_nodes
        self.lam_e = np.asarray(lam_e, np.float64)
        self.mu_e = np.asarray(mu_e, np.float64)
        self.mask = np.asarray(mask, np.float64).reshape(-1)
        self._ke_cache64 = None
        self._ke_cache32 = None
        self._geom = None

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

    # -- float32 twin and node blocks (the Galerkin multigrid build) -------

    def _geometry(self):
        """(g [C, q, k, 3], w det [C, q]) in float64, built once, with
        the JAX package's formulas (det and inverse of J by LAPACK)."""
        if self._geom is None:
            _, dN, w = element_tables(self.mesh.element_type, self.order)
            X = self.mesh.coords[self.mesh.conn]               # [C,k,3]
            J = np.einsum("cka,qkb->cqab", X, dN, optimize=True)
            detJ = np.linalg.det(J)
            invJ = np.linalg.inv(
                np.where((detJ == 0)[..., None, None], np.eye(3), J))
            g = np.einsum("qkb,cqba->cqka", dN, invJ, optimize=True)
            self._geom = (g, w[None, :] * detJ)
        return self._geom

    def node_blocks(self) -> np.ndarray:
        """3x3 node-diagonal blocks [N, 3, 3] of the raw K, float64."""
        g, wdet = self._geometry()
        wl = wdet * self.lam_e[:, None]
        wm = wdet * self.mu_e[:, None]
        outer = (np.einsum("cq,cqka,cqkb->ckab", wl, g, g, optimize=True)
                 + np.einsum("cq,cqkb,cqka->ckab", wm, g, g, optimize=True))
        norm2 = np.einsum("cq,cqka,cqka->ck", wm, g, g, optimize=True)
        blocks_ck = outer + norm2[..., None, None] * np.eye(3)
        flat = self.conn.reshape(-1)
        out = np.zeros((self.n_nodes, 3, 3))
        for a in range(3):
            for b in range(3):
                out[:, a, b] = np.bincount(
                    flat, weights=blocks_ck[:, :, a, b].reshape(-1),
                    minlength=self.n_nodes)
        return out

    def _ke32(self) -> np.ndarray:
        """Stored float32 Ke batch [C, 3k, 3k] (built in float64 chunks,
        then rounded): the power iteration's matvec is one batched
        product."""
        if self._ke_cache32 is None:
            g, wdet = self._geometry()
            C, q, k, _ = g.shape
            ek = 3 * k
            ke = np.empty((C, ek, ek), np.float32)
            eye = np.eye(3)
            for c0 in range(0, C, _CHUNK):
                gs = g[c0:c0 + _CHUNK]
                wl = (wdet * self.lam_e[:, None])[c0:c0 + _CHUNK]
                wm = (wdet * self.mu_e[:, None])[c0:c0 + _CHUNK]
                K1 = np.einsum("cq,cqia,cqjb->ciajb", wl, gs, gs,
                               optimize=True)
                K2 = np.einsum("cq,cqib,cqja->ciajb", wm, gs, gs,
                               optimize=True)
                dots = np.einsum("cq,cqid,cqjd->cij", wm, gs, gs,
                                 optimize=True)
                K3 = dots[:, :, None, :, None] * eye[None, None, :, None, :]
                ke[c0:c0 + _CHUNK] = (K1 + K2 + K3).reshape(-1, ek, ek)
            self._ke_cache32 = ke
        return self._ke_cache32

    def matvec(self, u: np.ndarray) -> np.ndarray:
        """Masked matvec through the float32 Ke batch (float32 products,
        float64 sums)."""
        m = self.mask
        um = (m * u).reshape(self.n_nodes, 3)
        k = self.conn.shape[1]
        u_e = um[self.conn].reshape(-1, 3 * k, 1).astype(np.float32)
        f_e = (self._ke32() @ u_e)[:, :, 0].astype(np.float64)
        flat = self.conn.reshape(-1)
        f = np.zeros((self.n_nodes, 3))
        fe3 = f_e.reshape(-1, k, 3)
        for a in range(3):
            f[:, a] = np.bincount(flat, weights=fe3[:, :, a].reshape(-1),
                                  minlength=self.n_nodes)
        f = f.reshape(-1)
        return m * f + (1.0 - m) * u

    def power_lambda_max(self, binv: np.ndarray, iters: int = 12,
                         seed: int = 0) -> float:
        """Upper estimate of lambda_max(B^-1 A), inflated 10% to cover
        power-iteration under-convergence (Chebyshev needs an UPPER bound;
        its polynomial amplifies above the band)."""
        return 1.1 * block_power_iteration(self.matvec, binv, self.mask,
                                           iters, seed)


def block_power_iteration(matvec, binv: np.ndarray, mask: np.ndarray,
                          iters: int, seed: int = 0) -> float:
    """lambda_max(B^-1 A) by ``iters`` steps of host power iteration: A is
    ``matvec`` on flat float64 vectors, B^-1 the [N, 3, 3] blocks ``binv``,
    and the start vector NumPy's ``default_rng(seed)`` normals times
    ``mask``, as in the JAX package."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(mask.shape[0]) * mask
    v /= np.linalg.norm(v)
    lam = 0.0
    for _ in range(iters):
        w = np.einsum("nab,nb->na", binv,
                      matvec(v).reshape(-1, 3)).reshape(-1)
        lam = float(np.linalg.norm(w))
        v = w / max(lam, 1e-300)
    return lam
