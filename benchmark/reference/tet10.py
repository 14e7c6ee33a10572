"""Plain PyTorch reference: linear-elastic Tet10 with SIMP under a
density-weighted body force, written from the equations alone.

Nothing here comes from the program it judges: the quadratic mesh is
built from the linear one (a mid-edge node on each sorted edge pair), the
element gradients come from each tet's Jacobian and the quadratic shape
functions in barycentric coordinates, and the operator applies strain,
Hooke's law and the divergence element by element, in blocks.

- Shape functions (VTK quadratic order): corner i, L_i (2 L_i - 1);
  mid-edge node on edge (i, j), 4 L_i L_j.  Their gradients are linear
  in the barycentric coordinates L, whose physical gradients are constant
  on a straight-sided tet.
- Quadrature: the 4-point rule of degree 2, L = (b, a, a, a) and its
  permutations, a = (5 - sqrt 5) / 20, b = (5 + 3 sqrt 5) / 20, weight
  V / 4 each.  It is exact for the stiffness of a straight-sided Tet10
  (gradient products, degree 2) and for the integrals of N_i (degree 2).
- Body force: f_i = sum_e rho_e b int_e N_i dOmega, cells with
  rho_e < 1e-6 skipped (TopOptEval.jl VolumeForce.jl:199-201).
- Stresses: Hooke's law at the 4 points, averaged; von Mises of the
  average (FiniteElementAnalysis.jl:487-492).

Vectors are [N, 3, P] (P lanes), Lame parameters per element [C, P]; the
constrained operator is m * K (m * u) + (1 - m) * u, m the free-DOF
mask, as in reference/elasticity.py, whose solver and judgement take this
class too.  Imports nothing of the program and nothing of JAX.
"""

from __future__ import annotations

import math

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

#: the tet's edges in VTK quadratic order: node 4 + k sits on EDGES[k]
EDGES = ((0, 1), (1, 2), (2, 0), (0, 3), (1, 3), (2, 3))
_A = (5.0 - math.sqrt(5.0)) / 20.0
_B = (5.0 + 3.0 * math.sqrt(5.0)) / 20.0
#: barycentric coordinates [4 points, 4] of the degree-2 rule
POINTS = np.full((4, 4), _A) + np.eye(4) * (_B - _A)
#: physical gradients of the linear shape functions on the reference tet
_DL = ((-1.0, -1.0, -1.0), (1.0, 0.0, 0.0), (0.0, 1.0, 0.0),
       (0.0, 0.0, 1.0))


def tet10_mesh(coords, conn):
    """(coords [N10, 3], conn [C, 10]) of the quadratic mesh over a Tet4
    mesh: the corner nodes as they are, then one node at the middle of
    each distinct edge, numbered in the order of the sorted edge pairs."""
    coords = np.asarray(coords, np.float64)
    conn = np.asarray(conn, np.int64)
    pairs = np.sort(conn[:, np.asarray(EDGES)], axis=2).reshape(-1, 2)
    edges, which = np.unique(pairs, axis=0, return_inverse=True)
    mid = 0.5 * (coords[edges[:, 0]] + coords[edges[:, 1]])
    conn10 = np.hstack([conn, len(coords) + which.reshape(len(conn), 6)])
    return np.vstack([coords, mid]), conn10


def match_nodes(ours, theirs, tol: float = 1e-9) -> np.ndarray:
    """``idx`` with ``ours[idx[j]] == theirs[j]`` for every node j of
    another numbering of the same nodes, found by their coordinates; an
    error where the two sets of points differ by more than ``tol`` of the
    mesh's extent."""
    ours = np.asarray(ours, np.float64)
    theirs = np.asarray(theirs, np.float64)
    if ours.shape != theirs.shape:
        raise ValueError(f"{len(ours)} nodes against {len(theirs)}")
    extent = float(np.ptp(ours, axis=0).max()) or 1.0
    q = np.round(ours / (extent * tol))
    o_ours = np.lexsort(q.T[::-1])
    o_theirs = np.lexsort(np.round(theirs / (extent * tol)).T[::-1])
    gap = np.abs(ours[o_ours] - theirs[o_theirs]).max()
    if gap > 10 * tol * extent:
        raise ValueError(f"the nodes differ by up to {gap:.3e}")
    idx = np.empty(len(theirs), np.int64)
    idx[o_theirs] = o_ours
    return idx


class Tet10Reference:
    """Geometry of a Tet10 mesh (straight-sided, its corner nodes first in
    each row) and the operators built on it, in ``dtype`` on ``device``.
    ``block`` elements at a time bound the temporaries of one apply."""

    def __init__(self, coords, conn, device="cpu", dtype=torch.float64,
                 block: int = 1 << 18):
        dev = torch.device(device)
        conn = torch.as_tensor(np.asarray(conn, np.int64), device=dev)
        x = torch.as_tensor(np.asarray(coords, np.float64),
                            device=dev)[conn[:, :4]]
        J = x[:, 1:] - x[:, :1]                 # J[c, a, b] = dx_b / dxi_a
        dL = torch.tensor(_DL, dtype=torch.float64, device=dev)
        # grad_x L_m = J^-1 grad_xi L_m: [C, 4, 3]
        self.GL = torch.einsum("cba,ma->cmb", torch.linalg.inv(J), dL
                               ).to(dtype)
        self.vol = (torch.linalg.det(J).abs() / 6.0).to(dtype)
        self.conn = conn
        self.n_nodes = int(len(coords))
        self.dtype, self.device, self.block = dtype, dev, int(block)
        # gradient table T [q, 10, 4]: grad N_n(L_q) = sum_m T[q, n, m]
        # grad L_m
        T = np.zeros((4, 10, 4))
        for q, L in enumerate(POINTS):
            for i in range(4):
                T[q, i, i] = 4.0 * L[i] - 1.0
            for k, (i, j) in enumerate(EDGES):
                T[q, 4 + k, i] += 4.0 * L[j]
                T[q, 4 + k, j] += 4.0 * L[i]
        self.T = torch.as_tensor(T, dtype=dtype, device=dev)
        # shape functions N [q, 10] at the points
        N = np.empty((4, 10))
        for q, L in enumerate(POINTS):
            N[q, :4] = L * (2.0 * L - 1.0)
            N[q, 4:] = [4.0 * L[i] * L[j] for i, j in EDGES]
        self.N = N

    def _blocks(self):
        C = self.conn.shape[0]
        for c0 in range(0, C, self.block):
            yield slice(c0, min(C, c0 + self.block))

    def gradients(self, sl) -> torch.Tensor:
        """Physical gradients [c, 4 points, 10, 3] of the elements in
        ``sl``."""
        return torch.einsum("qnm,cmb->cqnb", self.T, self.GL[sl])

    def stress(self, u, lam, mu, sl) -> torch.Tensor:
        """Stresses [c, 4 points, 3, 3, P] of the elements in ``sl``."""
        g = self.gradients(sl)
        ue = u[self.conn[sl]]                   # [c, 10, 3, P]
        gu = torch.einsum("ckap,cqkb->cqabp", ue, g)
        eps = 0.5 * (gu + gu.transpose(2, 3))
        tr = eps[:, :, 0, 0] + eps[:, :, 1, 1] + eps[:, :, 2, 2]
        eye = torch.eye(3, dtype=u.dtype, device=u.device)[..., None]
        return (2.0 * mu[sl][:, None, None, None] * eps
                + (lam[sl][:, None] * tr)[:, :, None, None] * eye)

    def apply(self, u, lam, mu):
        """K u: ``u`` [N, 3, P], ``lam``/``mu`` [C, P] (or [C, 1])."""
        out = torch.zeros_like(u)
        for sl in self._blocks():
            sig = self.stress(u, lam, mu, sl)
            fe = (0.25 * self.vol[sl])[:, None, None, None] * torch.einsum(
                "cqabp,cqkb->ckap", sig, self.gradients(sl))
            out.index_add_(0, self.conn[sl].reshape(-1),
                           fe.reshape(-1, 3, u.shape[-1]))
        return out

    def constrained(self, u, lam, mu, m):
        """m * K (m * u) + (1 - m) * u, ``m`` [N, 3, 1] of 0 and 1."""
        return m * self.apply(m * u, lam, mu) + (1.0 - m) * u

    def block_inverses(self, lam, mu, m):
        """Inverted 3x3 node blocks of the constrained operator,
        [N, 3, 3, P], worked out in float64."""
        P = lam.shape[-1]
        B = torch.zeros((self.n_nodes, 3, 3, P), dtype=torch.float64,
                        device=self.device)
        eye = torch.eye(3, dtype=torch.float64, device=self.device)
        for sl in self._blocks():
            g = self.gradients(sl).double()                 # [c, q, 10, 3]
            gg = torch.einsum("cqka,cqkb->ckab", g, g)       # [c, 10, 3, 3]
            n2 = torch.diagonal(gg, dim1=2, dim2=3).sum(-1)[..., None,
                                                            None] * eye
            v = (0.25 * self.vol[sl].double())[:, None, None, None, None]
            be = v * (lam[sl].double()[:, None, None, None, :]
                      * gg[..., None]
                      + mu[sl].double()[:, None, None, None, :]
                      * (gg.transpose(2, 3) + n2)[..., None])
            B.index_add_(0, self.conn[sl].reshape(-1),
                         be.reshape(-1, 3, 3, P))
        mm = m.double().reshape(-1, 3)
        mask2 = (mm[:, :, None] * mm[:, None, :])[..., None]
        B = B * mask2 + ((1.0 - mm)[:, :, None] * eye)[..., None]
        inv = torch.linalg.inv(B.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return inv.to(self.dtype).contiguous()

    def von_mises(self, u, lam, mu):
        """Element von Mises stresses [C, P] of the stress averaged over
        the 4 points."""
        out = []
        for sl in self._blocks():
            s = self.stress(u, lam, mu, sl).mean(dim=1)      # [c, 3, 3, P]
            tr = (s[:, 0, 0] + s[:, 1, 1] + s[:, 2, 2]) / 3.0
            dev = s - tr[:, None, None] * torch.eye(
                3, dtype=s.dtype, device=s.device)[..., None]
            out.append(torch.sqrt(1.5 * (dev * dev).sum(dim=(1, 2))))
        return torch.cat(out)

    def node_weights(self, density, void: float = 1e-6) -> np.ndarray:
        """[N] float64: sum over the elements of rho_e int_e N_i dOmega,
        elements with rho_e < ``void`` left out; the body force b gives
        the load f[i] = weights[i] * b."""
        rho = np.asarray(density, np.float64).reshape(-1)
        rho = np.where(rho < void, 0.0, rho)
        vol = self.vol.double().cpu().numpy()
        we = (rho * vol)[:, None] * (0.25 * self.N.sum(axis=0))[None, :]
        return np.bincount(self.conn.cpu().numpy().reshape(-1),
                           weights=we.reshape(-1), minlength=self.n_nodes)

    def body_force(self, vector, density, void: float = 1e-6) -> np.ndarray:
        """The load [3 N] (node-major) of the body force ``vector`` per
        unit volume, weighted by each element's density."""
        w = self.node_weights(density, void)
        return (w[:, None] * np.asarray(vector, np.float64)[None, :]
                ).reshape(-1)

    def stiffness(self, lam, mu):
        """The assembled K [3N, 3N] (scipy CSR, float64) of one lane's
        Lame parameters [C]: for the direct solves of small tests."""
        import scipy.sparse as sp

        lam = torch.as_tensor(np.asarray(lam, np.float64).reshape(-1),
                              device=self.device)
        mu = torch.as_tensor(np.asarray(mu, np.float64).reshape(-1),
                             device=self.device)
        rows, cols, vals = [], [], []
        eye = torch.eye(3, dtype=torch.float64, device=self.device)
        for sl in self._blocks():
            g = self.gradients(sl).double()
            w = (0.25 * self.vol[sl].double())[:, None]
            # Ke[(i,a),(j,b)] = sum_q w (lam g_ia g_jb + mu g_ib g_ja
            #                            + mu delta_ab g_i . g_j)
            kl = torch.einsum("cq,cqia,cqjb->ciajb", w, g, g)
            km = torch.einsum("cq,cqib,cqja->ciajb", w, g, g)
            kd = torch.einsum("cq,cqid,cqjd,ab->ciajb", w, g, g, eye)
            ke = (lam[sl][:, None, None, None, None] * kl
                  + mu[sl][:, None, None, None, None] * (km + kd))
            dof = (3 * self.conn[sl][:, :, None]
                   + torch.arange(3, device=self.device)).reshape(-1, 30)
            rows.append(dof[:, :, None].expand(-1, 30, 30).reshape(-1))
            cols.append(dof[:, None, :].expand(-1, 30, 30).reshape(-1))
            vals.append(ke.reshape(-1, 30, 30).reshape(-1))
        n = 3 * self.n_nodes
        return sp.coo_matrix(
            (torch.cat(vals).cpu().numpy(),
             (torch.cat(rows).cpu().numpy(), torch.cat(cols).cpu().numpy())),
            shape=(n, n)).tocsr()
