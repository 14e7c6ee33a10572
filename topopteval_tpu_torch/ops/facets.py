"""Facet (boundary face) quadrature: areas, traction integration
(counterpart of ``topopteval_tpu.ops.facets``, copied table for table).

Replaces Ferrite's FacetValues machinery the reference uses for
mesh-independent surface loads (reference:
src/FiniteElementAnalysis/SurfaceTraction.jl:94-125, 196-228).  The 2D
surface Jacobian is computed from each face's own node coordinates for the
whole facet batch at once: tri3 and quad4 faces of tet4 and hex8 elements
(the only kinds the reference supports, SurfaceTraction.jl:98-108), and
the tri6 and quad8 faces of tet10 and hex20.  Host NumPy, as in the JAX
package: a facet batch is a few thousand faces.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

_SQ3 = 1.0 / np.sqrt(3.0)

#: order-2 rules on the reference facets
#: tri: 3-point rule on the unit triangle (weights sum to 1/2 = area)
_TRI_PTS = np.array([[1 / 6, 1 / 6], [2 / 3, 1 / 6], [1 / 6, 2 / 3]])
_TRI_W = np.full(3, 1.0 / 6.0)
#: quad: 2x2 Gauss on [-1,1]^2
_QUAD_PTS = np.array([[-_SQ3, -_SQ3], [_SQ3, -_SQ3],
                      [_SQ3, _SQ3], [-_SQ3, _SQ3]])
_QUAD_W = np.ones(4)


def _tri_shape(p):
    xi, eta = p
    return np.array([1 - xi - eta, xi, eta])


def _tri_grad(p):
    return np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]])


def _quad_shape(p):
    xi, eta = p
    return 0.25 * np.array([(1 - xi) * (1 - eta), (1 + xi) * (1 - eta),
                            (1 + xi) * (1 + eta), (1 - xi) * (1 + eta)])


def _quad_grad(p):
    xi, eta = p
    return 0.25 * np.array([
        [-(1 - eta), -(1 - xi)],
        [(1 - eta), -(1 + xi)],
        [(1 + eta), (1 + xi)],
        [-(1 + eta), (1 - xi)],
    ])


#: 6-point degree-4 rule on the unit triangle (weights sum to 1/2) for
#: quadratic tri6 facets (tet10 surface loads — the reference treats
#: interpolation_order=2 as first-class, FiniteElementAnalysis.jl:160-168)
_T6A = 0.445948490915965
_T6B = 0.091576213509771
_TRI6_PTS = np.array([
    [_T6B, _T6B], [1 - 2 * _T6B, _T6B], [_T6B, 1 - 2 * _T6B],
    [_T6A, _T6A], [1 - 2 * _T6A, _T6A], [_T6A, 1 - 2 * _T6A],
])
_TRI6_W = np.array([0.109951743655322] * 3
                   + [0.223381589678011] * 3) * 0.5


def _tri6_shape(p):
    xi, eta = p
    l1, l2, l3 = 1 - xi - eta, xi, eta
    return np.array([l1 * (2 * l1 - 1), l2 * (2 * l2 - 1),
                     l3 * (2 * l3 - 1),
                     4 * l1 * l2, 4 * l2 * l3, 4 * l3 * l1])


def _tri6_grad(p):
    xi, eta = p
    l1, l2, l3 = 1 - xi - eta, xi, eta
    d1 = np.array([-1.0, -1.0])
    d2 = np.array([1.0, 0.0])
    d3 = np.array([0.0, 1.0])
    return np.stack([
        (4 * l1 - 1) * d1, (4 * l2 - 1) * d2, (4 * l3 - 1) * d3,
        4 * (l1 * d2 + l2 * d1), 4 * (l2 * d3 + l3 * d2),
        4 * (l3 * d1 + l1 * d3),
    ])


#: quad8 serendipity facets (hex20 surface loads), 3x3 Gauss (degree-5
#: exact — the quadratic geometry makes the metric itself quadratic)
_G35 = np.sqrt(3.0 / 5.0)
_QUAD8_PTS = np.array([[x, y] for y in (-_G35, 0.0, _G35)
                       for x in (-_G35, 0.0, _G35)])
_W13 = np.array([5.0 / 9.0, 8.0 / 9.0, 5.0 / 9.0])
_QUAD8_W = np.array([_W13[i] * _W13[j] for j in range(3)
                     for i in range(3)])
#: natural coords of the 8 serendipity quad nodes (4 corners + 4 mids)
_QUAD8_NAT = np.array([[-1, -1], [1, -1], [1, 1], [-1, 1],
                       [0, -1], [1, 0], [0, 1], [-1, 0]], dtype=float)


def _quad8_shape(p):
    xi, eta = p
    out = np.empty(8)
    for i, (a, b) in enumerate(_QUAD8_NAT):
        if a == 0:
            out[i] = (1 - xi * xi) * (1 + b * eta) / 2.0
        elif b == 0:
            out[i] = (1 + a * xi) * (1 - eta * eta) / 2.0
        else:
            out[i] = (1 + a * xi) * (1 + b * eta) \
                * (a * xi + b * eta - 1.0) / 4.0
    return out


def _quad8_grad(p):
    xi, eta = p
    out = np.empty((8, 2))
    for i, (a, b) in enumerate(_QUAD8_NAT):
        if a == 0:
            out[i] = [-xi * (1 + b * eta),
                      (1 - xi * xi) * b / 2.0]
        elif b == 0:
            out[i] = [a * (1 - eta * eta) / 2.0,
                      -(1 + a * xi) * eta]
        else:
            q = a * xi + b * eta - 1.0
            out[i] = [a * (1 + b * eta) * (q + (1 + a * xi)) / 4.0,
                      b * (1 + a * xi) * (q + (1 + b * eta)) / 4.0]
    return out


def facet_tables(n_face_nodes: int):
    """(N [q, fk], dN [q, fk, 2], w [q]) for tri3 / quad4 / tri6 / quad8
    facets."""
    if n_face_nodes == 3:
        pts, w, sh, gr = _TRI_PTS, _TRI_W, _tri_shape, _tri_grad
    elif n_face_nodes == 4:
        pts, w, sh, gr = _QUAD_PTS, _QUAD_W, _quad_shape, _quad_grad
    elif n_face_nodes == 6:
        pts, w, sh, gr = _TRI6_PTS, _TRI6_W, _tri6_shape, _tri6_grad
    elif n_face_nodes == 8:
        pts, w, sh, gr = _QUAD8_PTS, _QUAD8_W, _quad8_shape, _quad8_grad
    else:
        raise NotImplementedError(
            f"facet with {n_face_nodes} nodes not supported")
    N = np.stack([sh(p) for p in pts])
    dN = np.stack([gr(p) for p in pts])
    return N, dN, w


def facet_geometry(face_coords: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Batched facet quadrature geometry.

    Parameters
    ----------
    face_coords : [F, fk, 3] global coordinates of each facet's nodes

    Returns
    -------
    N : [q, fk] shape values at facet quadrature points
    dGamma : [F, q] surface measure (the reference's facet getdetJdV,
        SurfaceTraction.jl:119, 204)
    xq : [F, q, 3] physical quadrature-point positions
    """
    fk = face_coords.shape[1]
    N, dN, w = facet_tables(fk)
    # tangents t_a[f,q,3] = sum_k dN[q,k,a] * X[f,k,:]
    t = np.einsum("qka,fkd->fqad", dN, face_coords)   # [F,q,2,3]
    cross = np.cross(t[:, :, 0, :], t[:, :, 1, :])    # [F,q,3]
    dGamma = np.linalg.norm(cross, axis=-1) * w[None, :]
    xq = np.einsum("qk,fkd->fqd", N, face_coords)
    return N, dGamma, xq


def facet_areas(face_coords: np.ndarray) -> np.ndarray:
    """Per-facet areas [F] = integral of 1 dGamma."""
    _, dGamma, _ = facet_geometry(face_coords)
    return dGamma.sum(axis=1)
