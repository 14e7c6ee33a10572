"""The benchmark's own meshes: a structured Tet4 box and a .vtu writer.

The box is split six tets a hex around the v0-v6 diagonal, nodes x
fastest, then y, then z, hexes x-major (ix slowest), so its arrays match
the generated beams that earlier chip runs used.  Both the program (which
reads the written .vtu back) and the reference get these arrays: the mesh
is an input of the benchmark, not something the program made.
"""

from __future__ import annotations

import os

import numpy as np

VTK_TETRA = 10
#: the six tets of a hex (VTK hex node order), all sharing v0-v6
TET_SPLIT = np.array([[0, 1, 2, 6], [0, 2, 3, 6], [0, 3, 7, 6],
                      [0, 7, 4, 6], [0, 4, 5, 6], [0, 5, 1, 6]], np.int64)


def box_tet4(dims, lo, hi):
    """(coords [N, 3] float64, conn [C, 4] int32) of an nx x ny x nz box
    of hexes over [lo, hi], six tets each."""
    nx, ny, nz = (int(d) for d in dims)
    xs, ys, zs = (np.linspace(lo[a], hi[a], n + 1)
                  for a, n in enumerate((nx, ny, nz)))
    Z, Y, X = np.meshgrid(zs, ys, xs, indexing="ij")
    coords = np.stack([X, Y, Z], axis=-1).reshape(-1, 3)
    ix, iy, iz = (a.reshape(-1) for a in np.meshgrid(
        np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"))

    def nid(i, j, k):
        return i + j * (nx + 1) + k * (nx + 1) * (ny + 1)

    hexes = np.stack([nid(ix, iy, iz), nid(ix + 1, iy, iz),
                      nid(ix + 1, iy + 1, iz), nid(ix, iy + 1, iz),
                      nid(ix, iy, iz + 1), nid(ix + 1, iy, iz + 1),
                      nid(ix + 1, iy + 1, iz + 1), nid(ix, iy + 1, iz + 1)],
                     axis=1)
    conn = hexes[:, TET_SPLIT].reshape(-1, 4).astype(np.int32)
    return coords, conn


def box_mesh(mesh: dict):
    """``box_tet4`` of a configuration's ``mesh`` group, which has to name
    the element the benchmark generates."""
    if mesh["element"] != "tet4":
        raise ValueError(f"no generator for {mesh['element']!r} meshes")
    return box_tet4(mesh["dims"], mesh["lo"], mesh["hi"])


def plane_nodes(coords, axis: int, value: float, tol: float = 1e-6):
    """Nodes on the plane x[axis] = value (the reference's brute-force
    selection, test/runtests.jl:10-18)."""
    return np.flatnonzero(np.abs(coords[:, axis] - value) < tol)


def write_vtu(path: str, coords, conn) -> str:
    """A Tet4 UnstructuredGrid .vtu with raw appended data (UInt64
    headers, no compression): points float64, connectivity int64."""
    coords = np.ascontiguousarray(coords, np.float64)
    conn = np.ascontiguousarray(conn, np.int64)
    C, k = conn.shape
    arrays = [coords.reshape(-1),
              conn.reshape(-1),
              np.arange(k, k * C + 1, k, dtype=np.int64),
              np.full(C, VTK_TETRA, np.uint8)]
    offsets, pos = [], 0
    for a in arrays:
        offsets.append(pos)
        pos += 8 + a.nbytes
    head = (
        '<?xml version="1.0"?>\n'
        '<VTKFile type="UnstructuredGrid" version="1.0" '
        'byte_order="LittleEndian" header_type="UInt64">\n'
        '<UnstructuredGrid>\n'
        f'<Piece NumberOfPoints="{coords.shape[0]}" NumberOfCells="{C}">\n'
        '<Points>\n'
        '<DataArray type="Float64" NumberOfComponents="3" '
        f'format="appended" offset="{offsets[0]}"/>\n'
        '</Points>\n<Cells>\n'
        '<DataArray type="Int64" Name="connectivity" format="appended" '
        f'offset="{offsets[1]}"/>\n'
        '<DataArray type="Int64" Name="offsets" format="appended" '
        f'offset="{offsets[2]}"/>\n'
        '<DataArray type="UInt8" Name="types" format="appended" '
        f'offset="{offsets[3]}"/>\n'
        '</Cells>\n</Piece>\n</UnstructuredGrid>\n'
        '<AppendedData encoding="raw">\n_')
    with open(path, "wb") as fh:
        fh.write(head.encode())
        for a in arrays:
            fh.write(np.uint64(a.nbytes).tobytes())
            fh.write(a.tobytes())
        fh.write(b"\n</AppendedData>\n</VTKFile>\n")
    return os.path.abspath(path)
