"""Plain PyTorch reference: linear-elastic Tet4 with SIMP, written from the
equations alone.

Nothing here comes from the program: the element gradients come from the
Jacobian of each tet, the operator applies strain, Hooke's law and the
divergence element by element, and the solver is a textbook block-Jacobi
preconditioned CG over lanes.  Inputs are the benchmark's own arrays
(coordinates, connectivity, densities, clamped nodes, loads).

Vectors are [N, 3, P]: P lanes (load cases or designs) side by side, each
with per-element Lame parameters [C, P].  The constrained operator is
m * K (m * u) + (1 - m) * u, with m the free-DOF mask, so a clamped DOF's
row is the identity and its load 0.
"""

from __future__ import annotations

import torch

#: reference gradients of the four linear shape functions
_DN = ((-1.0, -1.0, -1.0), (1.0, 0.0, 0.0), (0.0, 1.0, 0.0),
       (0.0, 0.0, 1.0))


def simp_lame(density, E0: float, nu: float, Emin: float, p: float):
    """E(rho) = Emin + (E0 - Emin) rho^p (FiniteElementAnalysis.jl:623),
    then (lambda, mu) of (E, nu)."""
    E = Emin + (E0 - Emin) * density ** p
    return E * nu / ((1 + nu) * (1 - 2 * nu)), E / (2 * (1 + nu))


class Tet4Reference:
    """Element geometry of a Tet4 mesh and the operators built on it, in
    ``dtype`` on ``device``.  ``block`` elements at a time bound the
    temporaries of one apply."""

    def __init__(self, coords, conn, device="cpu", dtype=torch.float64,
                 block: int = 1 << 20):
        dev = torch.device(device)
        x = torch.as_tensor(coords, dtype=torch.float64, device=dev)[
            torch.as_tensor(conn, dtype=torch.int64, device=dev)]
        J = x[:, 1:] - x[:, :1]                 # J[c, a, b] = dx_b / dxi_a
        dN = torch.tensor(_DN, dtype=torch.float64, device=dev)
        # grad_x N_k = J^-1 grad_xi N_k
        self.G = torch.einsum("cba,ka->ckb", torch.linalg.inv(J), dN
                              ).to(dtype)
        self.vol = (torch.linalg.det(J).abs() / 6.0).to(dtype)
        self.conn = torch.as_tensor(conn, dtype=torch.int64, device=dev)
        self.n_nodes = int(len(coords))
        self.dtype, self.device, self.block = dtype, dev, int(block)

    def _blocks(self):
        C = self.conn.shape[0]
        for c0 in range(0, C, self.block):
            yield slice(c0, min(C, c0 + self.block))

    def _strain(self, u, sl):
        ue = u[self.conn[sl]]                   # [c, 4, 3, P]
        gu = torch.einsum("ckap,ckb->cabp", ue, self.G[sl])
        return 0.5 * (gu + gu.transpose(1, 2))

    def stress(self, u, lam, mu, sl):
        """Element stresses [c, 3, 3, P] of the elements in ``sl``."""
        eps = self._strain(u, sl)
        tr = eps[:, 0, 0] + eps[:, 1, 1] + eps[:, 2, 2]
        eye = torch.eye(3, dtype=u.dtype, device=u.device)[..., None]
        return (2.0 * mu[sl][:, None, None] * eps
                + (lam[sl] * tr)[:, None, None] * eye)

    def apply(self, u, lam, mu):
        """K u: ``u`` [N, 3, P], ``lam``/``mu`` [C, P] (or [C, 1])."""
        out = torch.zeros_like(u)
        for sl in self._blocks():
            sig = self.stress(u, lam, mu, sl)
            fe = self.vol[sl][:, None, None, None] * torch.einsum(
                "cabp,ckb->ckap", sig, self.G[sl])
            out.index_add_(0, self.conn[sl].reshape(-1),
                           fe.reshape(-1, 3, u.shape[-1]))
        return out

    def constrained(self, u, lam, mu, m):
        """m * K (m * u) + (1 - m) * u, ``m`` [N, 3, 1] of 0 and 1."""
        return m * self.apply(m * u, lam, mu) + (1.0 - m) * u

    def block_inverses(self, lam, mu, m):
        """Inverted 3x3 node blocks of the constrained operator,
        [N, 3, 3, P], worked out in float64."""
        G = self.G.double()
        P = lam.shape[-1]
        B = torch.zeros((self.n_nodes, 3, 3, P), dtype=torch.float64,
                        device=self.device)
        eye = torch.eye(3, dtype=torch.float64, device=self.device)
        for sl in self._blocks():
            g = G[sl]
            gg = torch.einsum("cka,ckb->ckab", g, g)           # [c, 4, 3, 3]
            n2 = (g * g).sum(-1)[..., None, None] * eye       # [c, 4, 3, 3]
            v = self.vol[sl].double()[:, None, None, None, None]
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
        """Element von Mises stresses [C, P]."""
        out = []
        for sl in self._blocks():
            s = self.stress(u, lam, mu, sl)
            tr = (s[:, 0, 0] + s[:, 1, 1] + s[:, 2, 2]) / 3.0
            dev = s - tr[:, None, None] * torch.eye(
                3, dtype=s.dtype, device=s.device)[..., None]
            out.append(torch.sqrt(1.5 * (dev * dev).sum(dim=(1, 2))))
        return torch.cat(out)


def _dot(a, b):
    return (a * b).sum(dim=(0, 1))


def pcg(ref: Tet4Reference, lam, mu, m, b, tol: float, maxiter: int,
        check_every: int = 20):
    """Block-Jacobi PCG on every lane of ``b`` [N, 3, P] in ``b``'s dtype
    until each lane's residual is under ``tol`` of its load, or
    ``maxiter`` steps.  Returns (x, steps)."""
    binv = ref.block_inverses(lam, mu, m).to(b.dtype)

    def prec(r):
        return (binv * r[:, None]).sum(dim=2)

    x = torch.zeros_like(b)
    r = m * b
    z = prec(r)
    p = z
    rz = _dot(r, z)
    goal = tol * torch.sqrt(_dot(r, r))
    k = 0
    while k < maxiter:
        Ap = ref.constrained(p, lam, mu, m)
        pAp = _dot(p, Ap)
        alpha = rz / torch.where(pAp == 0, torch.ones_like(pAp), pAp)
        x = x + alpha * p
        r = r - alpha * Ap
        k += 1
        if k % check_every == 0 and bool(
                (torch.sqrt(_dot(r, r)) <= goal).all()):
            break
        z = prec(r)
        rz_new = _dot(r, z)
        p = z + (rz_new / torch.where(rz == 0, torch.ones_like(rz), rz)) * p
        rz = rz_new
    return x, k
