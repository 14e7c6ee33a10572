"""Global stiffness operator with Dirichlet masking (counterpart of
``topopteval_tpu.fem.operator``).

The global K never materializes: ``A(u) = scatter(f_e(gather(u)))``, with
the scatter by the deterministic gather-sum of ops/scatter.py.  Two modes,
as in the JAX package:

- ``otf`` (default): the element apply recomputes the geometry each
  matvec, in the fused kernels of ops/element_kernels.py (tet4, hex8,
  tet10; hex20 takes the batched plain apply, as it does there);
- ``stored``: the Ke batch is built once (ops/elements.element_stiffness,
  which runs the Ke-batch kernels on the card) and each matvec is one
  batched product ``Ke @ u_e``.

Dirichlet constraints are a free-DOF mask:

    A'(u) = m * A(m * u) + (1 - m) * u

which equals Ferrite's symmetric ``apply!`` condensation for zero
prescribed values (reference: FiniteElementAnalysis.jl:314-333, 540-542).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..mesh import DIM, DeviceMesh, Mesh, element_dofs
from .host_operator import host_element_stiffness
from ..ops.element_kernels import hex8_apply, tet4_apply, tet10_apply
from ..ops.elements import (QUADRATURE, apply_element_stiffness,
                            element_stiffness, element_volumes,
                            physical_gradients)
from ..ops.scatter import RowScatterPlan

_APPLY = {"tet4": tet4_apply, "hex8": hex8_apply, "tet10": tet10_apply}
#: the rule each apply kernel implements, by element type: an operator
#: whose order gives another rule is refused (tet4's 1-point rule is exact
#: at any order)
_KERNEL_RULE = {"hex8": ("hex", 2), "tet10": ("tet", 2)}
_MODES = ("otf", "stored")


def _ke_batch(dmesh: DeviceMesh, lam: torch.Tensor, mu: torch.Tensor,
              order: int) -> torch.Tensor:
    """The mesh's Ke batch [C, 3k, 3k], through the Ke-batch kernels on the
    card where a kernel computes this rule (ops/elements.element_stiffness
    decides)."""
    return element_stiffness(dmesh.coords[dmesh.conn.long()], lam, mu,
                             dmesh.element_type, order)


def check_kernel_rule(element_type: str, order: int) -> None:
    """Refuse an ``otf`` operator whose quadrature order gives another rule
    than the element type's apply kernel implements."""
    rule = _KERNEL_RULE.get(element_type)
    if rule is not None and QUADRATURE.get((rule[0], order)) \
            is not QUADRATURE[rule]:
        raise ValueError(
            f"the {element_type} apply kernel implements the "
            f"{QUADRATURE[rule][1].size}-point order-2 rule; order="
            f"{order} gives another")


def element_forces(coords: torch.Tensor, conn: torch.Tensor,
                   u: torch.Tensor, lam: torch.Tensor, mu: torch.Tensor,
                   element_type: str, order: int) -> torch.Tensor:
    """f_e = Ke u_e [C, k, 3] for every element of ``conn`` over the node
    table ``coords`` [N, 3] and ``u`` [3N]: the fused apply kernel of the
    element type (its plain version on the CPU), the batched plain apply
    for hex20, which has a kernel in neither package."""
    if element_type in _APPLY:
        return _APPLY[element_type](coords, conn, u.contiguous(), lam, mu)
    idx = conn.long()
    return apply_element_stiffness(coords[idx], u.reshape(-1, DIM)[idx],
                                   lam, mu, element_type, order)


def element_diagonals(g: torch.Tensor, wdet: torch.Tensor,
                      lam: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """Each element's share of diag(K) [C, k, 3] from its gradients
    g [C, q, k, 3] and weights wdet [C, q], without materializing Ke:
    Ke[(i,a),(i,a)] = sum_q wdet ((lam+mu) g_ia^2 + mu |g_i|^2)."""
    g2 = g * g
    norm2 = torch.sum(g2, dim=-1, keepdim=True)
    return (torch.einsum("cq,cqka->cka", wdet * (lam + mu)[:, None], g2)
            + torch.einsum("cq,cqka->cka", wdet * mu[:, None],
                           torch.broadcast_to(norm2, g2.shape)))


def element_node_blocks(g: torch.Tensor, wdet: torch.Tensor,
                        lam: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """Each element's 3x3 node-diagonal blocks [C, k, 3, 3]:
    block(i)_ab = sum_q wdet (lam g_a g_b + mu g_b g_a + mu d_ab |g|^2)."""
    outer = (torch.einsum("cq,cqka,cqkb->ckab", wdet * lam[:, None], g, g)
             + torch.einsum("cq,cqkb,cqka->ckab", wdet * mu[:, None], g, g))
    norm2 = torch.einsum("cq,cqka,cqka->ck", wdet * mu[:, None], g, g)
    eye = torch.eye(DIM, dtype=g.dtype, device=g.device)
    return outer + norm2[..., None, None] * eye


def _cells(x, dmesh: DeviceMesh) -> torch.Tensor:
    """A scalar or per-element value as a contiguous [C] tensor."""
    return torch.broadcast_to(torch.as_tensor(
        x, dtype=dmesh.coords.dtype, device=dmesh.device),
        (dmesh.conn.shape[0],)).contiguous()


class StiffnessOperator:
    """K of one mesh and material, with a BC mask.

    All tensors live on ``dmesh.device``.  On a CUDA device ``matvec_raw``
    runs the element-apply kernel in ``otf`` mode (fp32 and fp64 alike) and
    ``stored`` mode builds its Ke batch with the Ke-batch kernels; on the
    CPU both run those kernels' plain PyTorch versions.
    """

    def __init__(self, dmesh: DeviceMesh, plan: RowScatterPlan,
                 lam: torch.Tensor, mu: torch.Tensor,
                 free_mask: torch.Tensor, order: int,
                 ke: Optional[torch.Tensor] = None):
        self.dmesh = dmesh
        self.plan = plan
        self.lam = lam              # [C] per-element lambda (SIMP-ready)
        self.mu = mu                # [C] per-element mu
        self.free_mask = free_mask  # [ndof] 1.0 free / 0.0 fixed
        self.order = order
        self.ke = ke                # [C, 3k, 3k] in stored mode, else None

    @staticmethod
    def build(dmesh: DeviceMesh, lam, mu,
              free_mask: Optional[torch.Tensor] = None,
              mode: str = "otf", order: int = 2) -> "StiffnessOperator":
        if mode not in _MODES:
            raise ValueError(f"operator mode must be one of {_MODES}, got "
                             f"{mode!r}")
        if mode == "otf":
            check_kernel_rule(dmesh.element_type, order)
        lam = _cells(lam, dmesh)
        mu = _cells(mu, dmesh)
        plan = RowScatterPlan.build(dmesh.conn.cpu().numpy(),
                                    dmesh.coords.shape[0],
                                    device=dmesh.device)
        if free_mask is None:
            free_mask = torch.ones(DIM * plan.n_nodes,
                                   dtype=dmesh.coords.dtype,
                                   device=dmesh.device)
        ke = _ke_batch(dmesh, lam, mu, order) if mode == "stored" else None
        return StiffnessOperator(dmesh, plan, lam, mu, free_mask, order, ke)

    def with_material(self, lam, mu) -> "StiffnessOperator":
        """The same mesh, plan and mask with another material; a stored
        operator builds its Ke batch anew (reference:
        topopteval_tpu/fem/operator.py:139-148)."""
        lam = _cells(lam, self.dmesh)
        mu = _cells(mu, self.dmesh)
        ke = (None if self.ke is None
              else _ke_batch(self.dmesh, lam, mu, self.order))
        return StiffnessOperator(self.dmesh, self.plan, lam, mu,
                                 self.free_mask, self.order, ke)

    @property
    def n_dofs(self) -> int:
        return DIM * self.plan.n_nodes

    # -- application --------------------------------------------------------

    def matvec_raw(self, u: torch.Tensor) -> torch.Tensor:
        """K @ u without BC masking."""
        dm = self.dmesh
        if self.ke is not None:
            C, ek, _ = self.ke.shape
            u_e = u.reshape(-1, DIM)[dm.conn.long()].reshape(C, ek, 1)
            f_e = torch.bmm(self.ke, u_e).reshape(C, -1, DIM)
        else:
            f_e = element_forces(dm.coords, dm.conn, u, self.lam, self.mu,
                                 dm.element_type, self.order)
        return self.plan.scatter_add(f_e).reshape(-1)

    def matvec(self, u: torch.Tensor) -> torch.Tensor:
        """Constrained operator A'(u) = m*A(m*u) + (1-m)*u."""
        m = self.free_mask
        return m * self.matvec_raw(m * u) + (1.0 - m) * u

    # -- preconditioning ----------------------------------------------------

    def _geometry(self):
        dm = self.dmesh
        return physical_gradients(dm.coords[dm.conn.long()],
                                  dm.element_type, self.order)

    def diagonal_raw(self) -> torch.Tensor:
        """diag(K) without materializing Ke (:func:`element_diagonals`)."""
        g, wdet = self._geometry()
        return self.plan.scatter_add(
            element_diagonals(g, wdet, self.lam, self.mu)).reshape(-1)

    def diagonal(self) -> torch.Tensor:
        """diag of the constrained operator (fixed dofs get 1.0)."""
        m = self.free_mask
        return m * m * self.diagonal_raw() + (1.0 - m)

    def node_blocks_raw(self) -> torch.Tensor:
        """3x3 node-diagonal blocks [n_nodes, 3, 3] for block-Jacobi
        (:func:`element_node_blocks`)."""
        g, wdet = self._geometry()
        blocks = element_node_blocks(g, wdet, self.lam, self.mu)
        C, k = blocks.shape[:2]
        return self.plan.scatter_add(blocks.reshape(C, k, DIM * DIM)).reshape(
            -1, DIM, DIM)

    # -- reductions ---------------------------------------------------------

    def energy(self, u: torch.Tensor) -> torch.Tensor:
        """Deformation energy 0.5 * u^T K u (reference:
        FiniteElementAnalysis.jl:550), accumulated in float64."""
        Ku = self.matvec(u)
        return 0.5 * torch.dot(u.double(), Ku.double())

    def volume(self, weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Density-weighted mesh volume (reference: Utils.jl:24-92)."""
        dm = self.dmesh
        vols = element_volumes(dm.coords[dm.conn.long()], dm.element_type,
                               self.order)
        w = dm.density if weights is None else weights
        return torch.sum(vols * w * dm.cell_mask)


# ---------------------------------------------------------------------------
# Host-side assembled oracle (reference semantics: CSC assembly + `K \\ f`)
# ---------------------------------------------------------------------------


def assemble_scipy(mesh: Mesh, lam, mu, order: int = 2,
                   free_mask: Optional[np.ndarray] = None):
    """Assemble the global sparse K as scipy CSR in float64 (the reference's
    Ferrite assembler in role).  With ``free_mask``, applies the same
    symmetric zero-Dirichlet condensation as ``apply!`` (rows/cols zeroed,
    unit diagonal)."""
    import scipy.sparse as sp

    ke = host_element_stiffness(mesh, lam, mu, order)
    edofs = element_dofs(mesh.conn)                    # [C, ek]
    ek = edofs.shape[1]
    rows = np.repeat(edofs, ek, axis=1).reshape(-1)
    cols = np.tile(edofs, (1, ek)).reshape(-1)
    K = sp.coo_matrix((ke.reshape(-1), (rows, cols)),
                      shape=(mesh.n_dofs, mesh.n_dofs)).tocsr()
    if free_mask is not None:
        m = sp.diags(np.asarray(free_mask, dtype=np.float64))
        ident_fixed = sp.diags(1.0 - np.asarray(free_mask, dtype=np.float64))
        K = (m @ K @ m + ident_fixed).tocsr()
    return K
