"""Result export to VTU (counterpart of ``topopteval_tpu.io.results``;
reference: src/ResultsExport/ResultsExport.jl).

- displacement export (point data "u") — reference :25-37
- stress export (cell data von_Mises_stress / principal_stress_max /
  principal_stress_min from qp-averaged tensors) — reference :55-92
- boundary-condition visualization mesh (surface faces whose nodes share
  one BC type, cell data "boundary_type": 1=fixed, 2=force) — reference
  :108-193, on the canonical corner-node FACE_TABLES as in the JAX
  package (the reference's private face order is a known quirk)
"""

from __future__ import annotations

import numpy as np
import torch

from ..mesh import FACE_TABLES, Mesh
from ..utils.terminal import log
from .vtu import write_vtu


def export_results(data, mesh_or_problem, output_file: str) -> str:
    """Polymorphic export like the reference's two export_results methods.

    - displacement vector [ndof] or [n_nodes, 3] → point-data "u"
    - stress array [C, nqp, 3, 3] or [C, 3, 3] or a SolveResult → cell-data
      von Mises + principal stresses
    """
    mesh = getattr(mesh_or_problem, "mesh", mesh_or_problem)
    if hasattr(data, "stress_qp"):          # SolveResult
        export_displacement(np.asarray(data.u), mesh,
                            output_file + "_u")
        return export_stress(data.stress_qp, mesh, output_file + "_stress")
    arr = np.asarray(data)
    if arr.ndim <= 2 and arr.size == mesh.n_dofs:
        return export_displacement(arr, mesh, output_file)
    return export_stress(arr, mesh, output_file)


def export_displacement(u: np.ndarray, mesh: Mesh, output_file: str) -> str:
    """reference: ResultsExport.jl:25-37."""
    log(f"Exporting results to {output_file}...")
    u = np.asarray(u, dtype=np.float64).reshape(mesh.n_nodes, 3)
    path = write_vtu(output_file, mesh, point_data={"u": u})
    log(f"Results exported successfully to {path}")
    return path


def export_stress(stress: np.ndarray, mesh: Mesh, output_file: str) -> str:
    """Cell-averaged von Mises + principal stresses (reference:
    ResultsExport.jl:55-92), evaluated on the host in float64."""
    from ..ops.stress import principal_stresses, von_mises

    log(f"Exporting stress results to {output_file}...")
    s = np.asarray(stress, dtype=np.float64)
    if s.ndim == 4:                          # [C, nqp, 3, 3] → qp average
        s = s.mean(axis=1)
    if s.shape != (mesh.n_cells, 3, 3):
        raise ValueError(f"stress must be [C,3,3] or [C,nqp,3,3], got "
                         f"{np.asarray(stress).shape}")
    st = torch.from_numpy(s)
    vm = von_mises(st).numpy()
    pr = principal_stresses(st).numpy()      # ascending [C,3]
    path = write_vtu(output_file, mesh, cell_data={
        "von_Mises_stress": vm,
        "principal_stress_max": pr[:, 2],
        "principal_stress_min": pr[:, 0],
    })
    log(f"Stress results exported successfully to {path}")
    return path


def export_boundary_conditions(mesh: Mesh, fixed_nodes, force_nodes,
                               output_file: str) -> str:
    """Surface mesh of faces whose nodes all share one nonzero BC type
    (reference: ResultsExport.jl:108-193).  Faces are taken by their corner
    nodes (FACE_TABLES), so a tet10 face exports as a tri3."""
    log(f"Exporting mesh with boundary conditions to {output_file}...")
    bc = np.zeros(mesh.n_nodes, dtype=np.int64)
    bc[np.asarray(list(fixed_nodes), dtype=np.int64)] = 1
    bc[np.asarray(list(force_nodes), dtype=np.int64)] = 2

    faces = np.asarray(FACE_TABLES[mesh.element_type], dtype=np.int64)
    face_nodes = mesh.conn[:, faces].reshape(-1, faces.shape[1])  # [C*nf, fk]
    types = bc[face_nodes]
    same = (types == types[:, :1]).all(axis=1) & (types[:, 0] > 0)
    sel = face_nodes[same]
    sel_type = types[same, 0]

    fk = faces.shape[1]
    etype = "tri3" if fk == 3 else "quad4"
    bmesh = Mesh(mesh.coords, sel.astype(np.int32), etype)
    path = write_vtu(output_file, bmesh,
                     cell_data={"boundary_type": sel_type.astype(np.int32)})
    log(f"Boundary conditions successfully exported to {path}")
    return path
