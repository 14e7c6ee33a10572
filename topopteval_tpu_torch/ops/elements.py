"""Reference-element tables and batched element math (plain PyTorch).

Counterpart of ``topopteval_tpu.ops.elements`` for tet4, hex8, tet10 and
hex20.  Every element-level quantity is computed for the whole batch at
once with einsums over ``[C, ...]`` tensors on the caller's device; on a
CUDA tensor :func:`element_stiffness` hands tet4, hex8 and tet10 to the
Ke-batch kernels of ops/ke_kernels.py.

Conventions (as in the JAX package)
-----------------------------------
- Reference tetrahedron: vertices (0,0,0),(1,0,0),(0,1,0),(0,0,1).
- Reference hexahedron: [-1,1]^3, trilinear, VTK/Ferrite node order;
  tet10 and hex20 add their mid-edge nodes in VTK quadratic order.
- Quadrature: the reference's order-2 rules, 4 points/tet and 2x2x2
  Gauss/hex (reference: FiniteElementAnalysis.jl:160-168); hex20
  defaults to 3x3x3 Gauss (api.Problem).

The isotropic stiffness identity used throughout:

  Ke[(i,a),(j,b)] = sum_q w*detJ * ( lam * dNi_a dNj_b
                                   + mu  * dNi_b dNj_a
                                   + mu  * delta_ab * (grad Ni . grad Nj) )
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

DIM = 3

# ---------------------------------------------------------------------------
# Shape functions on reference elements
# ---------------------------------------------------------------------------


def tet4_shape(xi):
    x, y, z = xi
    return np.array([1 - x - y - z, x, y, z])


def tet4_grad(xi=None):
    return np.array([[-1.0, -1.0, -1.0],
                     [1.0, 0.0, 0.0],
                     [0.0, 1.0, 0.0],
                     [0.0, 0.0, 1.0]])


HEX_SIGNS = np.array([
    [-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
    [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1],
], dtype=np.float64)


def hex8_shape(xi):
    s = HEX_SIGNS
    return (1 + s[:, 0] * xi[0]) * (1 + s[:, 1] * xi[1]) \
        * (1 + s[:, 2] * xi[2]) / 8.0


def hex8_grad(xi):
    s = HEX_SIGNS
    gx = s[:, 0] * (1 + s[:, 1] * xi[1]) * (1 + s[:, 2] * xi[2]) / 8.0
    gy = (1 + s[:, 0] * xi[0]) * s[:, 1] * (1 + s[:, 2] * xi[2]) / 8.0
    gz = (1 + s[:, 0] * xi[0]) * (1 + s[:, 1] * xi[1]) * s[:, 2] / 8.0
    return np.stack([gx, gy, gz], axis=1)


def tet10_shape(xi):
    x, y, z = xi
    l1, l2, l3, l4 = 1 - x - y - z, x, y, z
    return np.array([
        l1 * (2 * l1 - 1), l2 * (2 * l2 - 1),
        l3 * (2 * l3 - 1), l4 * (2 * l4 - 1),
        4 * l1 * l2, 4 * l2 * l3, 4 * l3 * l1,
        4 * l1 * l4, 4 * l2 * l4, 4 * l3 * l4,
    ])


def tet10_grad(xi):
    x, y, z = xi
    l1 = 1 - x - y - z
    dl1 = np.array([-1.0, -1.0, -1.0])
    dl2 = np.array([1.0, 0.0, 0.0])
    dl3 = np.array([0.0, 1.0, 0.0])
    dl4 = np.array([0.0, 0.0, 1.0])
    l2, l3, l4 = x, y, z
    return np.stack([
        (4 * l1 - 1) * dl1, (4 * l2 - 1) * dl2,
        (4 * l3 - 1) * dl3, (4 * l4 - 1) * dl4,
        4 * (l1 * dl2 + l2 * dl1), 4 * (l2 * dl3 + l3 * dl2),
        4 * (l3 * dl1 + l1 * dl3), 4 * (l1 * dl4 + l4 * dl1),
        4 * (l2 * dl4 + l4 * dl2), 4 * (l3 * dl4 + l4 * dl3),
    ])


#: natural coordinates of the 20 serendipity hex nodes in
#: VTK_QUADRATIC_HEXAHEDRON order: 8 corners (VTK hex order), then the 12
#: mid-edge nodes of EDGE_TABLES['hex8'] (one zero entry marks a mid-edge
#: node's edge direction)
HEX20_NAT = np.array(
    [list(s) for s in HEX_SIGNS]
    + [[0, -1, -1], [1, 0, -1], [0, 1, -1], [-1, 0, -1],
       [0, -1, 1], [1, 0, 1], [0, 1, 1], [-1, 0, 1],
       [-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]],
    dtype=np.float64)


def hex20_shape(xi):
    """20-node serendipity hexahedron (the quadratic hex of VTK/gmsh
    meshes; reference path FiniteElementAnalysis.jl:160-163)."""
    x, y, z = xi
    out = np.empty(20)
    for i, (a, b, c) in enumerate(HEX20_NAT):
        if a == 0:
            out[i] = (1 - x * x) * (1 + b * y) * (1 + c * z) / 4.0
        elif b == 0:
            out[i] = (1 + a * x) * (1 - y * y) * (1 + c * z) / 4.0
        elif c == 0:
            out[i] = (1 + a * x) * (1 + b * y) * (1 - z * z) / 4.0
        else:
            out[i] = ((1 + a * x) * (1 + b * y) * (1 + c * z)
                      * (a * x + b * y + c * z - 2.0) / 8.0)
    return out


def hex20_grad(xi):
    x, y, z = xi
    out = np.empty((20, 3))
    for i, (a, b, c) in enumerate(HEX20_NAT):
        if a == 0:
            out[i] = [-2 * x * (1 + b * y) * (1 + c * z) / 4.0,
                      (1 - x * x) * b * (1 + c * z) / 4.0,
                      (1 - x * x) * (1 + b * y) * c / 4.0]
        elif b == 0:
            out[i] = [a * (1 - y * y) * (1 + c * z) / 4.0,
                      (1 + a * x) * (-2 * y) * (1 + c * z) / 4.0,
                      (1 + a * x) * (1 - y * y) * c / 4.0]
        elif c == 0:
            out[i] = [a * (1 + b * y) * (1 - z * z) / 4.0,
                      (1 + a * x) * b * (1 - z * z) / 4.0,
                      (1 + a * x) * (1 + b * y) * (-2 * z) / 4.0]
        else:
            q = a * x + b * y + c * z - 2.0
            out[i] = [
                a * (1 + b * y) * (1 + c * z) * (q + (1 + a * x)) / 8.0,
                b * (1 + a * x) * (1 + c * z) * (q + (1 + b * y)) / 8.0,
                c * (1 + a * x) * (1 + b * y) * (q + (1 + c * z)) / 8.0,
            ]
    return out


# ---------------------------------------------------------------------------
# Quadrature rules (order-2 defaults = reference parity)
# ---------------------------------------------------------------------------

_TET_A = (5.0 - np.sqrt(5.0)) / 20.0
_TET_B = (5.0 + 3.0 * np.sqrt(5.0)) / 20.0
_G = 1.0 / np.sqrt(3.0)
_G3P = np.array([-np.sqrt(3.0 / 5.0), 0.0, np.sqrt(3.0 / 5.0)])
_G3W = np.array([5.0 / 9.0, 8.0 / 9.0, 5.0 / 9.0])

#: (points [nqp,3], weights [nqp]) per (element family, order)
QUADRATURE = {
    ("tet", 1): (np.array([[0.25, 0.25, 0.25]]), np.array([1.0 / 6.0])),
    ("tet", 2): (
        np.array([
            [_TET_A, _TET_A, _TET_A],  # barycentric (b,a,a,a)
            [_TET_B, _TET_A, _TET_A],
            [_TET_A, _TET_B, _TET_A],
            [_TET_A, _TET_A, _TET_B],
        ]),
        np.full(4, 1.0 / 24.0),
    ),
    ("hex", 1): (np.zeros((1, 3)), np.array([8.0])),
    ("hex", 2): (
        np.array([[sx * _G, sy * _G, sz * _G]
                  for sz in (-1, 1) for sy in (-1, 1) for sx in (-1, 1)]),
        np.ones(8),
    ),
    # 3x3x3 Gauss (degree-5 exact)
    ("hex", 3): (
        np.array([[x, y, z] for z in _G3P for y in _G3P for x in _G3P]),
        np.array([wx * wy * wz for wz in _G3W for wy in _G3W
                  for wx in _G3W]),
    ),
}
# order-3 tets take the 4-point rule (the JAX package's choice)
QUADRATURE[("tet", 3)] = QUADRATURE[("tet", 2)]

_FAMILY = {"tet4": "tet", "tet10": "tet", "hex8": "hex", "hex20": "hex"}
_SHAPE_FNS = {"tet4": (tet4_shape, tet4_grad),
              "tet10": (tet10_shape, tet10_grad),
              "hex8": (hex8_shape, hex8_grad),
              "hex20": (hex20_shape, hex20_grad)}


@functools.lru_cache(maxsize=None)
def element_tables(element_type: str, order: int = 2
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Precompute (N [nqp,k], dN_ref [nqp,k,3], weights [nqp]) tables."""
    pts, wts = QUADRATURE[(_FAMILY[element_type], order)]
    shape_fn, grad_fn = _SHAPE_FNS[element_type]
    N = np.stack([shape_fn(p) for p in pts])
    if element_type == "tet4":
        dN = np.broadcast_to(tet4_grad(), (len(pts), 4, 3)).copy()
    else:
        dN = np.stack([grad_fn(p) for p in pts])
    return N, dN, wts


# ---------------------------------------------------------------------------
# Batched geometry: physical gradients + integration weights
# ---------------------------------------------------------------------------


def _inv3x3(J: torch.Tensor):
    """Batched 3x3 inverse + determinant via the adjugate.  det == 0
    (degenerate cells, singular blocks) divides by 1 instead, so the
    result stays finite."""
    a, b, c = J[..., 0, 0], J[..., 0, 1], J[..., 0, 2]
    d, e, f = J[..., 1, 0], J[..., 1, 1], J[..., 1, 2]
    g, h, i = J[..., 2, 0], J[..., 2, 1], J[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    det = a * A + d * B + g * C
    safe = torch.where(det == 0, torch.ones_like(det), det)
    inv = torch.stack([
        torch.stack([A, B, C], dim=-1),
        torch.stack([f * g - d * i, a * i - c * g, c * d - a * f], dim=-1),
        torch.stack([d * h - e * g, b * g - a * h, a * e - b * d], dim=-1),
    ], dim=-2) / safe[..., None, None]
    return inv, det


def physical_gradients(coords_e: torch.Tensor, element_type: str,
                       order: int = 2):
    """Element batch geometry.

    Parameters
    ----------
    coords_e : [C, k, 3] gathered element node coordinates

    Returns
    -------
    g : [C, nqp, k, 3] physical shape-function gradients
    wdet : [C, nqp] quadrature weight * |J|
    """
    _, dN, w = element_tables(element_type, order)
    dN = torch.as_tensor(dN, dtype=coords_e.dtype, device=coords_e.device)
    w = torch.as_tensor(w, dtype=coords_e.dtype, device=coords_e.device)
    # J[c,q,a,b] = d x_a / d xi_b = sum_k coords[c,k,a] dN[q,k,b]
    J = torch.einsum("cka,qkb->cqab", coords_e, dN)
    invJ, detJ = _inv3x3(J)
    # dN/dx_a = sum_b dN_ref[q,k,b] * invJ[c,q,b,a]
    g = torch.einsum("qkb,cqba->cqka", dN, invJ)
    return g, w[None, :] * detJ


def _broadcast_cells(x, C: int, like: torch.Tensor) -> torch.Tensor:
    return torch.broadcast_to(
        torch.as_tensor(x, dtype=like.dtype, device=like.device), (C,))


def has_ke_kernel(element_type: str, order: int) -> bool:
    """Whether a Ke-batch kernel computes this element's rule: tet4 at any
    order (constant strain makes the 1-point rule exact), hex8 and tet10 at
    the order-2 rule (the JAX gate, topopteval_tpu/ops/elements.py:308-312,
    without its TPU dtype limit)."""
    return element_type == "tet4" or (element_type in ("hex8", "tet10")
                                      and order == 2)


def element_stiffness(coords_e: torch.Tensor, lam, mu, element_type: str,
                      order: int = 2, use_kernel=None) -> torch.Tensor:
    """Batched Ke [C, 3k, 3k] for isotropic elasticity; ``lam``/``mu`` are
    scalars or per-element arrays [C] (reference:
    FiniteElementAnalysis.jl:669-703).

    ``use_kernel=None`` sends a CUDA batch that :func:`has_ke_kernel`
    covers to the Ke-batch kernels of ops/ke_kernels.py (fp32 and fp64);
    everything else, and ``use_kernel=False``, takes the batched plain
    route below, which is also those kernels' plain version."""
    C, k, _ = coords_e.shape
    lam = _broadcast_cells(lam, C, coords_e)
    mu = _broadcast_cells(mu, C, coords_e)
    if use_kernel is None:
        use_kernel = (coords_e.device.type == "cuda"
                      and has_ke_kernel(element_type, order))
    if use_kernel:
        from .ke_kernels import KE_KERNELS
        # the kernels gather node rows through conn; the batch is its own
        # node table here
        conn = torch.arange(C * k, dtype=torch.int32,
                            device=coords_e.device).reshape(C, k)
        coords = coords_e.reshape(-1, DIM).contiguous()
        return KE_KERNELS[element_type](coords, conn, lam.contiguous(),
                                        mu.contiguous())
    g, wdet = physical_gradients(coords_e, element_type, order)
    wl = wdet * lam[:, None]
    wm = wdet * mu[:, None]
    K1 = torch.einsum("cq,cqia,cqjb->ciajb", wl, g, g)
    K2 = torch.einsum("cq,cqib,cqja->ciajb", wm, g, g)
    dots = torch.einsum("cq,cqid,cqjd->cij", wm, g, g)
    eye = torch.eye(DIM, dtype=coords_e.dtype,
                    device=coords_e.device)[None, None, :, None, :]
    Ke = K1 + K2 + dots[:, :, None, :, None] * eye
    return Ke.reshape(C, k * DIM, k * DIM)


def apply_element_stiffness(coords_e: torch.Tensor, u_e: torch.Tensor,
                            lam, mu, element_type: str, order: int = 2
                            ) -> torch.Tensor:
    """Matrix-free f_e = Ke @ u_e without forming Ke (the strain route:
    grad_u → sigma → gradient-weighted sum).

    coords_e, u_e : [C, k, 3]  →  f_e : [C, k, 3]
    """
    C = coords_e.shape[0]
    g, wdet = physical_gradients(coords_e, element_type, order)
    lam = _broadcast_cells(lam, C, coords_e)
    mu = _broadcast_cells(mu, C, coords_e)
    grad_u = torch.einsum("cqkb,cka->cqab", g, u_e)
    eps = 0.5 * (grad_u + grad_u.transpose(-1, -2))
    tr = eps[..., 0, 0] + eps[..., 1, 1] + eps[..., 2, 2]
    eye = torch.eye(DIM, dtype=coords_e.dtype, device=coords_e.device)
    sigma = (lam[:, None, None, None] * tr[..., None, None] * eye
             + 2.0 * mu[:, None, None, None] * eps)
    return torch.einsum("cq,cqab,cqkb->cka", wdet, sigma, g)


def element_volumes(coords_e: torch.Tensor, element_type: str,
                    order: int = 2) -> torch.Tensor:
    """Per-element volumes [C] = sum_q w*detJ (reference: Utils.jl:79-84)."""
    _, wdet = physical_gradients(coords_e, element_type, order)
    return torch.sum(wdet, dim=1)
