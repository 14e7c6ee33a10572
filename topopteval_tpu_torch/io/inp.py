"""Abaqus .inp mesh reader and .inp → .vtu converter (counterpart of
``topopteval_tpu.io.inp``; reference: src/Utils/InpToVtu.jl).

Its own .inp parser (no external reader): the 20+ element-type map
(C3D4/8/10/20, wedges, shells, planar, axisymmetric → VTK types,
InpToVtu.jl:190-275), file validation (:316-375), element diagnostics
(:389-443), a dominant-type :class:`..mesh.Mesh` reader, and the converter
to a heterogeneous .vtu through ``io.vtu.write_vtu_heterogeneous``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..mesh import Mesh, VTK_ID_TO_TYPE
from ..utils.terminal import log, print_warning

#: Abaqus element name → (VTK cell id, node count).  Mirrors the
#: reference's map (InpToVtu.jl:190-275) including planar/axisymmetric
#: families mapped onto their geometric VTK shapes.
ABAQUS_TO_VTK: Dict[str, Tuple[int, int]] = {
    # 3D solids
    "C3D4": (10, 4), "C3D4H": (10, 4),
    "C3D8": (12, 8), "C3D8R": (12, 8), "C3D8I": (12, 8), "C3D8H": (12, 8),
    "C3D10": (24, 10), "C3D10M": (24, 10),
    "C3D20": (25, 20), "C3D20R": (25, 20),
    "C3D6": (13, 6), "C3D6H": (13, 6),          # wedge
    "C3D15": (26, 15),                          # quadratic wedge
    # shells
    "S3": (5, 3), "S3R": (5, 3), "STRI3": (5, 3),
    "S4": (9, 4), "S4R": (9, 4), "S4RS": (9, 4),
    "STRI65": (22, 6), "S6": (22, 6),           # quadratic triangle
    "S8": (23, 8), "S8R": (23, 8),              # quadratic quad
    # trusses / beams
    "T3D2": (3, 2), "B31": (3, 2), "B21": (3, 2),
    "T3D3": (21, 3), "B32": (21, 3),            # quadratic edge
    # planar
    "CPS3": (5, 3), "CPE3": (5, 3), "CPS4": (9, 4), "CPE4": (9, 4),
    "CPS4R": (9, 4), "CPE4R": (9, 4),
    "CPS6": (22, 6), "CPE6": (22, 6), "CPS8": (23, 8), "CPE8": (23, 8),
    # axisymmetric
    "CAX3": (5, 3), "CAX4": (9, 4), "CAX4R": (9, 4),
    "CAX6": (22, 6), "CAX8": (23, 8),
}


class InpMesh:
    """Raw parse result: possibly heterogeneous element sections."""

    def __init__(self):
        self.nodes: Dict[int, List[float]] = {}
        self.sections: List[Tuple[str, str, List[Tuple[int, List[int]]]]] = []
        # (abaqus_type, elset_name, [(elem_id, node_ids), ...])
        self.unsupported: Dict[str, int] = {}


def parse_inp(path: str) -> InpMesh:
    """Tolerant *NODE / *ELEMENT parser (handles continuation lines)."""
    out = InpMesh()
    mode = None
    current: Optional[List[Tuple[int, List[int]]]] = None
    etype = elset = ""
    nodes_per = 0
    pending: List[int] = []

    with open(path) as fh:
        for raw in fh:
            line = raw.strip()
            if not line or line.startswith("**"):
                continue
            if line.startswith("*"):
                key = line.split(",")[0].strip().upper()
                opts = {}
                for part in line.split(",")[1:]:
                    if "=" in part:
                        k, v = part.split("=", 1)
                        opts[k.strip().upper()] = v.strip()
                if key == "*NODE":
                    mode = "node"
                elif key == "*ELEMENT":
                    etype = opts.get("TYPE", "").upper()
                    elset = opts.get("ELSET", "")
                    if etype in ABAQUS_TO_VTK:
                        current = []
                        out.sections.append((etype, elset, current))
                        nodes_per = ABAQUS_TO_VTK[etype][1]
                        mode = "element"
                    else:
                        out.unsupported[etype] = 0
                        mode = "skip_element"
                else:
                    mode = None
                pending = []
                continue
            if mode == "node":
                parts = [p for p in line.replace(",", " ").split() if p]
                nid = int(float(parts[0]))
                coords = [float(x) for x in parts[1:4]]
                coords += [0.0] * (3 - len(coords))
                out.nodes[nid] = coords
            elif mode == "element":
                vals = [int(float(p)) for p in
                        line.rstrip(",").replace(",", " ").split()]
                pending.extend(vals)
                # a full record is 1 + nodes_per ints; continuation lines
                # (trailing comma in Abaqus) just keep accumulating
                while len(pending) >= 1 + nodes_per:
                    rec, pending = pending[: 1 + nodes_per], \
                        pending[1 + nodes_per:]
                    current.append((rec[0], rec[1:]))
                if not raw.rstrip().endswith(","):
                    pending = []
            elif mode == "skip_element":
                out.unsupported[etype] = out.unsupported.get(etype, 0) + 1
    return out


def validate_inp_file(path: str) -> Dict[str, object]:
    """File validation report (reference: InpToVtu.jl:316-375)."""
    import os
    report = {"exists": os.path.isfile(path), "has_nodes": False,
              "has_elements": False, "n_nodes": 0, "n_elements": 0,
              "element_types": {}, "unsupported_types": {}, "valid": False}
    if not report["exists"]:
        return report
    parsed = parse_inp(path)
    report["n_nodes"] = len(parsed.nodes)
    report["has_nodes"] = bool(parsed.nodes)
    counts: Dict[str, int] = {}
    for etype, _, elems in parsed.sections:
        counts[etype] = counts.get(etype, 0) + len(elems)
    report["element_types"] = counts
    report["n_elements"] = sum(counts.values())
    report["has_elements"] = report["n_elements"] > 0
    report["unsupported_types"] = dict(parsed.unsupported)
    report["valid"] = report["has_nodes"] and report["has_elements"]
    return report


def inspect_inp_elements(path: str) -> Dict[str, int]:
    """Element-type census diagnostics (reference: InpToVtu.jl:389-443)."""
    report = validate_inp_file(path)
    log(f"INP inspection of {path}:")
    for t, c in sorted(report["element_types"].items()):
        vtk_id = ABAQUS_TO_VTK[t][0]
        log(f"  {t}: {c} elements -> VTK type {vtk_id}")
    for t in report["unsupported_types"]:
        print_warning(f"  unsupported element type: {t}")
    return report["element_types"]


def _compact(parsed: InpMesh):
    """Node-id compaction: Abaqus ids → dense 0-based indices."""
    node_ids = np.array(sorted(parsed.nodes), dtype=np.int64)
    coords = np.array([parsed.nodes[int(i)] for i in node_ids])
    remap = {int(g): i for i, g in enumerate(node_ids)}
    return coords, remap


def read_inp_mesh(path: str) -> Mesh:
    """.inp → homogeneous :class:`Mesh` by the dominant solid type (same
    dominant-cell rule as the VTU path, MeshImport.jl:92-121)."""
    parsed = parse_inp(path)
    if not parsed.nodes or not parsed.sections:
        raise ValueError(f"{path}: no nodes/elements found")
    coords, remap = _compact(parsed)

    by_type: Dict[str, List[List[int]]] = {}
    for etype, _, elems in parsed.sections:
        vtk_id, _ = ABAQUS_TO_VTK[etype]
        if vtk_id not in VTK_ID_TO_TYPE:
            continue
        rows = by_type.setdefault(VTK_ID_TO_TYPE[vtk_id], [])
        rows.extend([remap[n] for n in conn] for _, conn in elems)
    if not by_type:
        raise ValueError("No supported cell types found in the mesh")
    dom = max(by_type, key=lambda t: len(by_type[t]))
    conn = np.asarray(by_type[dom], dtype=np.int32)
    mesh = Mesh(coords, conn, dom)
    log(f"Mesh imported successfully: {mesh.n_nodes} nodes, "
        f"{mesh.n_cells} elements")
    return mesh


def inp_to_vtu(inp_file: str, output_file: str,
               verbose: bool = True) -> bool:
    """Convert .inp → .vtu with ALL supported (possibly heterogeneous)
    elements (reference: InpToVtu.jl:63-180)."""
    import os
    if not os.path.isfile(inp_file):
        raise FileNotFoundError(f"Input file '{inp_file}' does not exist")
    if not inp_file.lower().endswith(".inp"):
        print_warning(f"Input file '{inp_file}' does not have .inp extension")
    try:
        parsed = parse_inp(inp_file)
        if verbose:
            log(f"Reading Abaqus .inp file: {inp_file}")
            log(f"  Found {len(parsed.nodes)} nodes")
        coords, remap = _compact(parsed)
        cells: List[Tuple[int, List[int]]] = []
        for etype, _, elems in parsed.sections:
            vtk_id, _ = ABAQUS_TO_VTK[etype]
            for _, conn in elems:
                cells.append((vtk_id, [remap[n] for n in conn]))
        for t, c in parsed.unsupported.items():
            print_warning(f"Skipped {c} elements of unsupported type {t}")
        if not cells:
            raise ValueError("no supported elements")
        from .vtu import write_vtu_heterogeneous
        path = write_vtu_heterogeneous(output_file, coords, cells)
        if verbose:
            log(f"  Wrote {len(cells)} cells to {path}")
        return True
    except Exception as e:
        print_warning(f"INP conversion failed: {e}")
        return False
