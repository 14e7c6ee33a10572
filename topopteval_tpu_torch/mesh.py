"""Mesh data model: host container + device tensors.

Counterpart of ``topopteval_tpu.mesh``.  A mesh is a pair of dense arrays —
``coords [n_nodes, 3]`` and ``conn [n_cells, k]`` — with DOF numbering
defined arithmetically as ``dof = 3*node + comp`` (reference:
FiniteElementAnalysis.jl:265-293, collapsed into index math).

- :class:`Mesh` — host-side container (NumPy): cellsets, cached surface
  topology, host-only preprocessing.
- :class:`DeviceMesh` — the same arrays as tensors on one explicit device.
  The JAX package pads them to TPU-friendly sizes; here they are unpadded.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Element topology registry (copied from topopteval_tpu/mesh.py:47-124)
# ---------------------------------------------------------------------------

#: canonical local-face → local-node tables, matching the Ferrite facet
#: convention the reference pins down (reference: FiniteElementAnalysis.jl:42-67).
#: Node indices are 0-based here (the reference is 1-based Julia).
FACE_TABLES: Dict[str, tuple] = {
    "tet4": ((0, 2, 1), (0, 1, 3), (1, 2, 3), (0, 3, 2)),
    # corner nodes only — face IDENTITY/topology (a face is uniquely keyed
    # by its corners); quadrature and node selection use FULL_FACE_TABLES
    "tet10": ((0, 2, 1), (0, 1, 3), (1, 2, 3), (0, 3, 2)),
    "hex20": (
        (0, 3, 2, 1), (0, 1, 5, 4), (1, 2, 6, 5),
        (2, 3, 7, 6), (0, 4, 7, 3), (4, 5, 6, 7),
    ),
    "hex8": (
        (0, 3, 2, 1),  # bottom (z=-1)
        (0, 1, 5, 4),  # front  (y=-1)
        (1, 2, 6, 5),  # right  (x=+1)
        (2, 3, 7, 6),  # back   (y=+1)
        (0, 4, 7, 3),  # left   (x=-1)
        (4, 5, 6, 7),  # top    (z=+1)
    ),
    "tri3": ((0, 1), (1, 2), (2, 0)),
    "quad4": ((0, 1), (1, 2), (2, 3), (3, 0)),
}

#: full face tables including higher-order nodes (VTK_QUADRATIC_TRIANGLE /
#: VTK_QUADRATIC_QUAD orders), used for surface-node selection
FULL_FACE_TABLES: Dict[str, tuple] = dict(FACE_TABLES)
FULL_FACE_TABLES["tet10"] = (
    (0, 2, 1, 6, 5, 4),
    (0, 1, 3, 4, 8, 7),
    (1, 2, 3, 5, 9, 8),
    (0, 3, 2, 7, 9, 6),
)
FULL_FACE_TABLES["hex20"] = (
    (0, 3, 2, 1, 11, 10, 9, 8),     # bottom
    (0, 1, 5, 4, 8, 17, 12, 16),    # front
    (1, 2, 6, 5, 9, 18, 13, 17),    # right
    (2, 3, 7, 6, 10, 19, 14, 18),   # back
    (0, 4, 7, 3, 16, 15, 19, 11),   # left
    (4, 5, 6, 7, 12, 13, 14, 15),   # top
)

#: edge tables in VTK quadratic-node order: mid-edge node k of a tet10
#: sits on edge EDGE_TABLES['tet4'][k]
EDGE_TABLES: Dict[str, tuple] = {
    "tet4": ((0, 1), (1, 2), (2, 0), (0, 3), (1, 3), (2, 3)),
    "hex8": (
        (0, 1), (1, 2), (2, 3), (3, 0),
        (4, 5), (5, 6), (6, 7), (7, 4),
        (0, 4), (1, 5), (2, 6), (3, 7),
    ),
}

#: VTK cell-type ids (reference reads these from VTU, MeshImport.jl:72-89).
VTK_CELL_IDS: Dict[str, int] = {
    "line2": 3,
    "tri3": 5,
    "quad4": 9,
    "tet4": 10,
    "hex8": 12,
    "tet10": 24,
    "hex20": 25,
}
VTK_ID_TO_TYPE = {v: k for k, v in VTK_CELL_IDS.items()}

NODES_PER_CELL: Dict[str, int] = {
    "line2": 2,
    "tri3": 3,
    "quad4": 4,
    "tet4": 4,
    "hex8": 8,
    "tet10": 10,
    "hex20": 20,
}

#: element types the FEM layer can analyze (3D solids)
SOLID_TYPES = ("tet4", "hex8", "tet10", "hex20")

DIM = 3  # 3D problems throughout (reference: FiniteElementAnalysis.jl:152)


def resolve_device(device) -> torch.device:
    """``device`` as a :class:`torch.device`; a CUDA device must exist.

    The port never moves work to the CPU by itself: asking for ``cuda``
    on a machine without one is an error, not a fallback."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU")
    return dev


def dofs_of_nodes(node_ids: np.ndarray) -> np.ndarray:
    """Node ids → their 3 DOF ids, shape [..., 3] (reference:
    FiniteElementAnalysis.jl:265-293)."""
    node_ids = np.asarray(node_ids)
    return node_ids[..., None] * DIM + np.arange(DIM, dtype=node_ids.dtype)


def element_dofs(conn: np.ndarray) -> np.ndarray:
    """Connectivity [C,k] → element DOF matrix [C, 3k] (interleaved xyz)."""
    C, k = conn.shape
    return dofs_of_nodes(conn).reshape(C, k * DIM)


# ---------------------------------------------------------------------------
# Device tensors
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """One homogeneous element batch as tensors on one device."""

    coords: torch.Tensor       # [N, 3] node coordinates
    conn: torch.Tensor         # [C, k] int32 connectivity
    density: torch.Tensor      # [C] per-element density (1.0 default)
    cell_mask: torch.Tensor    # [C] 1.0 for real cells
    n_nodes: int
    n_cells: int
    element_type: str

    @property
    def device(self) -> torch.device:
        return self.coords.device

    @property
    def n_dofs(self) -> int:
        return DIM * self.n_nodes


# ---------------------------------------------------------------------------
# Host mesh
# ---------------------------------------------------------------------------

class Mesh:
    """Host-side homogeneous mesh (dominant cell type, like the reference's
    Grid built from the most common VTK cell type, MeshImport.jl:92-121).

    Parameters
    ----------
    coords : float array [n_nodes, 3]
    conn : int array [n_cells, k]  (0-based connectivity)
    element_type : one of ``tet4 | hex8 | tet10 | hex20 | tri3 | quad4 | line2``
    density : optional per-cell density field
    cellsets : optional mapping name -> cell-index array (reference
        imports these from VTU cell-data fields, MeshImport.jl:129-150)
    nodesets : optional mapping name -> node-index array (named physical
        surface groups of a .msh import, which FerriteGmsh carries
        through togrid, MeshImport.jl:28; selected for BCs by
        ``fem.bc.select_nodes_by_set``)
    """

    def __init__(
        self,
        coords: np.ndarray,
        conn: np.ndarray,
        element_type: str,
        density: Optional[np.ndarray] = None,
        cellsets: Optional[Dict[str, np.ndarray]] = None,
        nodesets: Optional[Dict[str, np.ndarray]] = None,
    ):
        coords = np.ascontiguousarray(coords, dtype=np.float64)
        if coords.ndim != 2 or coords.shape[1] != DIM:
            raise ValueError(f"coords must be [n,3], got {coords.shape}")
        conn = np.ascontiguousarray(conn, dtype=np.int32)
        k = NODES_PER_CELL.get(element_type)
        if k is None:
            raise ValueError(f"unknown element type {element_type!r}")
        if conn.ndim != 2 or conn.shape[1] != k:
            raise ValueError(
                f"conn for {element_type} must be [C,{k}], got {conn.shape}")
        if conn.size and (conn.min() < 0 or conn.max() >= len(coords)):
            raise ValueError("connectivity indices out of range")
        self.coords = coords
        self.conn = conn
        self.element_type = element_type
        self.density = (None if density is None
                        else np.asarray(density, dtype=np.float64).reshape(-1))
        if self.density is not None and len(self.density) != len(conn):
            raise ValueError(
                f"density length ({len(self.density)}) does not match "
                f"number of cells ({len(conn)})")
        self.cellsets: Dict[str, np.ndarray] = dict(cellsets or {})
        self.nodesets: Dict[str, np.ndarray] = dict(nodesets or {})
        self._surface_cache = None  # lazy (reference: SelectNodesForBC.jl:30-38)
        #: set by the structured generators (grid.py): cell counts
        #: and box corners; None for an imported mesh
        self.structured_info = None

    # -- basic queries ------------------------------------------------------

    @property
    def n_nodes(self) -> int:
        return self.coords.shape[0]

    @property
    def n_cells(self) -> int:
        return self.conn.shape[0]

    @property
    def n_dofs(self) -> int:
        return DIM * self.n_nodes

    @property
    def nodes_per_cell(self) -> int:
        return self.conn.shape[1]

    def bounding_box(self):
        return self.coords.min(axis=0), self.coords.max(axis=0)

    def __repr__(self) -> str:
        return (f"Mesh({self.element_type}, nodes={self.n_nodes}, "
                f"cells={self.n_cells})")

    # -- surface topology (host-side, cached) -------------------------------

    def surface(self):
        """Lazily-computed surface topology; see :mod:`.fem.bc`."""
        if self._surface_cache is None:
            from .fem.bc import extract_surface  # local import to avoid cycle
            self._surface_cache = extract_surface(self)
        return self._surface_cache

    def clear_surface_cache(self) -> None:
        """Drop the cached surface topology (reference:
        SelectNodesForBC.jl:379-382)."""
        self._surface_cache = None

    # -- refinement ---------------------------------------------------------

    def to_quadratic(self) -> "Mesh":
        """Tet4 -> Tet10 / Hex8 -> Hex20 by mid-edge node insertion
        (reference: FiniteElementAnalysis.jl:160-163, which attaches
        quadratic Lagrange DOFs to a linear grid of either family).

        Mid-edge nodes follow the VTK quadratic orderings (EDGE_TABLES) and
        are numbered after the corner nodes in the order of ``np.unique``
        over the sorted edge pairs, as topopteval_tpu/mesh.py:300-328
        numbers them, so both packages give the same arrays.  The result
        carries no ``structured_info``: its nodes are no longer a box
        lattice."""
        quad_of = {"tet4": "tet10", "hex8": "hex20"}
        if self.element_type not in quad_of:
            raise ValueError(
                f"quadratic refinement supports tet4 and hex8 meshes "
                f"(got {self.element_type!r})")
        edges = np.asarray(EDGE_TABLES[self.element_type], dtype=np.int64)
        ev = np.sort(self.conn[:, edges], axis=2).reshape(-1, 2)
        uniq, inverse = np.unique(ev, axis=0, return_inverse=True)
        mid_coords = 0.5 * (self.coords[uniq[:, 0]] + self.coords[uniq[:, 1]])
        mid_ids = (self.n_nodes + inverse.reshape(-1)).reshape(self.n_cells,
                                                             len(edges))
        return Mesh(np.vstack([self.coords, mid_coords]),
                    np.hstack([self.conn, mid_ids]).astype(np.int32),
                    quad_of[self.element_type], density=self.density,
                    cellsets=self.cellsets, nodesets=self.nodesets)

    # -- device transfer ----------------------------------------------------

    def device(self, dtype: torch.dtype = torch.float32,
               device="cuda") -> DeviceMesh:
        """The mesh as tensors of ``dtype`` on ``device``."""
        dev = resolve_device(device)
        dens = (np.ones(self.n_cells) if self.density is None
                else self.density)
        return DeviceMesh(
            coords=torch.as_tensor(self.coords, dtype=dtype, device=dev),
            conn=torch.as_tensor(self.conn, dtype=torch.int32, device=dev),
            density=torch.as_tensor(dens, dtype=dtype, device=dev),
            cell_mask=torch.ones(self.n_cells, dtype=dtype, device=dev),
            n_nodes=self.n_nodes,
            n_cells=self.n_cells,
            element_type=self.element_type,
        )
