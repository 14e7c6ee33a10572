"""Structured box grids, the mesh-level half of the port's
``models.beams`` (counterpart of the generators in
``topopteval_tpu.models.beams``).  The multigrid modules build their
lattices from these, so they live below ``models``, whose problems import
the API.

- ``generate_grid_hex``: structured hex8 box grid (VTK node ordering)
- ``generate_grid_tet``: the same box split into 6 conforming tets per hex
  (all sharing the v0–v6 diagonal)

Both attach ``structured_info`` (cell counts and box corners), the
provenance ``solve_system`` reads to pick the stencil multigrid route.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from .mesh import Mesh

_TET_SPLIT = np.array([
    [0, 1, 2, 6],
    [0, 2, 3, 6],
    [0, 3, 7, 6],
    [0, 7, 4, 6],
    [0, 4, 5, 6],
    [0, 5, 1, 6],
], dtype=np.int64)


def _box_nodes(nx: int, ny: int, nz: int, lo, hi) -> np.ndarray:
    xs = np.linspace(lo[0], hi[0], nx + 1)
    ys = np.linspace(lo[1], hi[1], ny + 1)
    zs = np.linspace(lo[2], hi[2], nz + 1)
    Z, Y, X = np.meshgrid(zs, ys, xs, indexing="ij")
    return np.stack([X, Y, Z], axis=-1).reshape(-1, 3)


def _hex_conn(nx: int, ny: int, nz: int) -> np.ndarray:
    def nid(ix, iy, iz):
        return ix + iy * (nx + 1) + iz * (nx + 1) * (ny + 1)

    ix, iy, iz = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                             indexing="ij")
    ix, iy, iz = ix.reshape(-1), iy.reshape(-1), iz.reshape(-1)
    return np.stack([
        nid(ix, iy, iz), nid(ix + 1, iy, iz),
        nid(ix + 1, iy + 1, iz), nid(ix, iy + 1, iz),
        nid(ix, iy, iz + 1), nid(ix + 1, iy, iz + 1),
        nid(ix + 1, iy + 1, iz + 1), nid(ix, iy + 1, iz + 1),
    ], axis=1).astype(np.int32)


def _structured_info(nx, ny, nz, lo, hi) -> dict:
    return {"dims": (nx, ny, nz),
            "lo": tuple(float(v) for v in lo),
            "hi": tuple(float(v) for v in hi)}


def generate_grid_hex(nx: int, ny: int, nz: int,
                      lo: Sequence[float] = (0.0, 0.0, 0.0),
                      hi: Sequence[float] = (1.0, 1.0, 1.0)) -> Mesh:
    """Structured hex8 box grid (Ferrite generate_grid(Hexahedron, ...)
    equivalent)."""
    mesh = Mesh(_box_nodes(nx, ny, nz, lo, hi), _hex_conn(nx, ny, nz),
                "hex8")
    mesh.structured_info = _structured_info(nx, ny, nz, lo, hi)
    return mesh


def generate_grid_tet(nx: int, ny: int, nz: int,
                      lo: Sequence[float] = (0.0, 0.0, 0.0),
                      hi: Sequence[float] = (1.0, 1.0, 1.0)) -> Mesh:
    """Structured tet4 box grid: 6 conforming tets per hex cell."""
    hexes = _hex_conn(nx, ny, nz)                       # [H, 8]
    conn = hexes[:, _TET_SPLIT].reshape(-1, 4).astype(np.int32)
    mesh = Mesh(_box_nodes(nx, ny, nz, lo, hi), conn, "tet4")
    mesh.structured_info = _structured_info(nx, ny, nz, lo, hi)
    return mesh
