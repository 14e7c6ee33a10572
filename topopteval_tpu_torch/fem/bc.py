"""Boundary topology + node selection + Dirichlet constraints.

Counterpart of ``topopteval_tpu.fem.bc`` (reference: SelectNodesForBC.jl,
FiniteElementAnalysis.jl:314-374).  Surface extraction: faces belonging
to exactly one element are surface faces (SelectNodesForBC.jl:59-91),
counted by the host library's hash kernel (io/native.py) or, without it,
with ``np.unique``.  Dirichlet constraints become a free-DOF mask (see
fem/operator.py).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np

from ..mesh import (DIM, FACE_TABLES, FULL_FACE_TABLES, Mesh,
                    dofs_of_nodes)
from ..utils.terminal import log


@dataclasses.dataclass(frozen=True)
class SurfaceTopology:
    """Boundary faces + nodes of a mesh (reference: SelectNodesForBC.jl:
    30-38, SurfaceTraction.jl:45-67)."""

    surface_nodes: np.ndarray    # sorted unique surface node ids
    is_surface: np.ndarray       # bool [n_nodes]
    face_cells: np.ndarray       # [F] owning cell of each surface face
    face_local: np.ndarray       # [F] local face index within the cell
    face_conn: np.ndarray        # [F, face_k] global node ids (corner nodes)


def extract_surface(mesh: Mesh) -> SurfaceTopology:
    """Faces appearing once across all cells are surface faces
    (reference: SelectNodesForBC.jl:59-123).  The host library's hash
    kernel and the NumPy fallback give the same sorted face indices."""
    from ..io.native import extract_surface_faces_native
    faces = np.asarray(FACE_TABLES[mesh.element_type], dtype=np.int64)
    nf, fk = faces.shape
    conn = mesh.conn.astype(np.int64)
    flat = conn[:, faces].reshape(-1, fk)             # [C*nf, fk]
    idx = extract_surface_faces_native(mesh.conn, faces)
    if idx is None:
        keys = np.sort(flat, axis=1)
        _, inverse, counts = np.unique(keys, axis=0, return_inverse=True,
                                       return_counts=True)
        idx = np.flatnonzero(counts[inverse.reshape(-1)] == 1)
    face_cells = idx // nf
    face_local = idx % nf
    face_conn = flat[idx]
    # higher-order elements: mid-edge nodes of surface faces are surface
    # nodes too
    full = np.asarray(FULL_FACE_TABLES[mesh.element_type], dtype=np.int64)
    if full.shape[1] > fk:
        full_conn = conn[face_cells[:, None], full[face_local]]
        node_ids = np.unique(full_conn.reshape(-1))
    else:
        node_ids = np.unique(face_conn.reshape(-1))
    is_surface = np.zeros(mesh.n_nodes, dtype=bool)
    is_surface[node_ids] = True
    log(f"Surface extraction complete: {node_ids.size} surface nodes out of "
        f"{mesh.n_nodes} total nodes")
    log(f"Surface coverage: {round(node_ids.size / mesh.n_nodes * 100, 1)}%")
    return SurfaceTopology(node_ids, is_surface, face_cells, face_local,
                           face_conn)


def select_nodes_by_plane(mesh: Mesh, point: Sequence[float],
                          normal: Sequence[float],
                          tolerance: float = 1.0) -> np.ndarray:
    """Surface nodes within ``tolerance`` of the plane (point, normal).

    reference: SelectNodesForBC.jl:146-188, 323-334 (default tol 1.0)
    """
    surf = mesh.surface()
    point = np.asarray(point, dtype=np.float64)
    normal = np.asarray(normal, dtype=np.float64)
    unit = normal / np.linalg.norm(normal)
    coords = mesh.coords[surf.surface_nodes]
    dist = np.abs((coords - point) @ unit)
    sel = surf.surface_nodes[dist < tolerance]
    log(f"Selected {sel.size} surface nodes on the specified plane")
    return sel


def select_nodes_by_circle(mesh: Mesh, center: Sequence[float],
                           normal: Sequence[float], radius: float,
                           tolerance: float = 1.0) -> np.ndarray:
    """Surface nodes on the plane and within radius + tolerance of center
    (in-plane distance).

    reference: SelectNodesForBC.jl:213-266, 356-368
    """
    on_plane = select_nodes_by_plane(mesh, center, normal, tolerance)
    center = np.asarray(center, dtype=np.float64)
    normal = np.asarray(normal, dtype=np.float64)
    unit = normal / np.linalg.norm(normal)
    v = mesh.coords[on_plane] - center
    in_plane = v - np.outer(v @ unit, unit)
    planar = np.linalg.norm(in_plane, axis=1)
    sel = on_plane[planar <= radius + tolerance]
    log(f"Selected {sel.size} surface nodes in the circular region")
    return sel


def select_nodes_by_set(mesh: Mesh, name: str) -> np.ndarray:
    """Nodes of a NAMED set imported with the mesh (a gmsh physical
    surface group, io/gmsh.py): FerriteGmsh carries $PhysicalNames groups
    through ``togrid`` as named sets usable for BC selection (reference:
    MeshImport.jl:28)."""
    try:
        return np.asarray(mesh.nodesets[name], dtype=np.int64)
    except KeyError:
        raise KeyError(
            f"mesh has no nodeset {name!r}; available: "
            f"{sorted(mesh.nodesets)}") from None


def nodes_at_plane(mesh: Mesh, axis: int, value: float,
                   tol: float = 1e-6) -> np.ndarray:
    """Brute-force axis-aligned node selection over ALL nodes (reference:
    test/runtests.jl:10-18). axis is 0/1/2."""
    return np.flatnonzero(np.abs(mesh.coords[:, axis] - value) < tol)


@dataclasses.dataclass(frozen=True)
class DirichletBC:
    """Zero-valued Dirichlet constraint on selected nodes/components
    (the reference only ever prescribes zero, FiniteElementAnalysis.jl:
    323, 362)."""

    fixed_dofs: np.ndarray       # unique global dof ids

    @staticmethod
    def fixed(nodes: Iterable[int]) -> "DirichletBC":
        """All three components fixed (reference:
        FiniteElementAnalysis.jl:314-333)."""
        nodes = np.asarray(list(nodes) if not isinstance(nodes, np.ndarray)
                           else nodes, dtype=np.int64)
        dofs = dofs_of_nodes(nodes).reshape(-1)
        log(f"Defined fixed boundary conditions for {nodes.size} nodes")
        return DirichletBC(np.unique(dofs))

    @staticmethod
    def sliding(nodes: Iterable[int],
                fixed_components: Sequence[int]) -> "DirichletBC":
        """Only the given components (0=x,1=y,2=z) fixed (reference:
        FiniteElementAnalysis.jl:356-374, which is 1-based)."""
        nodes = np.asarray(list(nodes) if not isinstance(nodes, np.ndarray)
                           else nodes, dtype=np.int64)
        comps = np.asarray(fixed_components, dtype=np.int64)
        if comps.size and (comps.min() < 0 or comps.max() >= DIM):
            raise ValueError("components must be in {0,1,2}")
        dofs = (nodes[:, None] * DIM + comps[None, :]).reshape(-1)
        log(f"Defined sliding boundary conditions for {nodes.size} nodes, "
            f"fixing DOFs: {list(comps)}")
        return DirichletBC(np.unique(dofs))


def free_mask_from_bcs(n_dofs: int,
                       bcs: Sequence[DirichletBC]) -> np.ndarray:
    """Combine constraints into the free-DOF mask (1 free / 0 fixed)."""
    mask = np.ones(n_dofs, dtype=np.float64)
    for bc in bcs:
        mask[bc.fixed_dofs] = 0.0
    return mask


def precompute_surface_nodes(mesh: Mesh) -> SurfaceTopology:
    """Extract the surface now rather than at the first selection
    (reference: SelectNodesForBC.jl:385-398)."""
    return mesh.surface()


def clear_surface_cache(mesh: Mesh) -> None:
    """Drop the cached surface topology (reference: SelectNodesForBC.jl:
    370-382, a global cache there, one per mesh here)."""
    mesh.clear_surface_cache()
