"""Density-field transfer between meshes (nearest-cell sampling).

Counterpart of ``topopteval_tpu.models.density``: resamples a source
mesh's cell densities onto any target mesh by cell-centroid lookup —
deterministic, so a CPU fp64 oracle reconstructs the identical field.
"""

from __future__ import annotations

import os

import numpy as np

from ..mesh import Mesh

#: the bundled vfrac-0.4 optimized density (reference fixture,
#: test/runtests.jl:54)
VFRAC04_FIXTURE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "data", "beam_vfrac_04_Raw.vtu")


def cell_centroids(mesh: Mesh) -> np.ndarray:
    """[C, 3] cell centroids (host numpy)."""
    coords = np.asarray(mesh.coords, np.float64)
    return coords[mesh.conn].mean(axis=1)


def sample_cell_density(src_mesh: Mesh, src_density: np.ndarray,
                        target_mesh: Mesh) -> np.ndarray:
    """Resample per-cell densities onto ``target_mesh`` by nearest source
    cell, via a uniform voxel grid over the source bounding box."""
    src_c = cell_centroids(src_mesh)
    tgt_c = cell_centroids(target_mesh)
    rho = np.asarray(src_density, np.float64).reshape(-1)
    if len(rho) != src_mesh.n_cells:
        raise ValueError("source density length does not match source "
                         "mesh cells")
    lo = src_c.min(axis=0)
    hi = src_c.max(axis=0)
    span = np.where(hi - lo > 0, hi - lo, 1.0)
    # voxel resolution: cube-root heuristic per axis, proportional to
    # the source extent (exact for box grids like the bundled fixture)
    n_per = max(int(round(src_mesh.n_cells ** (1.0 / 3.0))), 1)
    dims = np.maximum(np.round(span / span.prod() ** (1.0 / 3.0)
                               * n_per).astype(int), 1)
    # refine dims until each voxel holds <= a few source cells, capped
    for _ in range(8):
        idx = _voxel_index(src_c, lo, span, dims)
        counts = np.bincount(idx, minlength=int(np.prod(dims)))
        if counts.max() <= 2 or int(np.prod(dims)) > 4 * len(rho):
            break
        dims = dims * 2
    nvox = int(np.prod(dims))
    vox_rho = np.zeros(nvox)
    vox_n = np.zeros(nvox)
    np.add.at(vox_rho, idx, rho)
    np.add.at(vox_n, idx, 1.0)
    filled = vox_n > 0
    vox_rho[filled] /= vox_n[filled]
    # fill empty voxels from the nearest filled one along x
    if not filled.all():
        fill_src = np.where(filled, np.arange(nvox), -1)
        np.maximum.accumulate(fill_src, out=fill_src)
        fill_src[fill_src < 0] = int(np.flatnonzero(filled)[0])
        vox_rho = vox_rho[fill_src]
    t_idx = _voxel_index(tgt_c, lo, span, dims)
    return vox_rho[t_idx]


def _voxel_index(points: np.ndarray, lo, span, dims) -> np.ndarray:
    t = np.clip((points - lo) / span, 0.0, 1.0 - 1e-12)
    ijk = (t * dims).astype(np.int64)
    return (ijk[:, 0] * dims[1] + ijk[:, 1]) * dims[2] + ijk[:, 2]


def bench_simp_density(nx: int, ny: int, nz: int) -> np.ndarray:
    """The benchmark's SIMP field: the bundled vfrac-0.4 optimized density
    resampled per hex onto an (nx, ny, nz) grid over the 60x20x4 beam and
    replicated to its 6 tets (``generate_grid_tet`` numbers tets
    hex-major), so the data/oracle_energies.json ``simp_beam_scale_*``
    oracles rebuild the identical field."""
    from .beams import generate_grid_hex

    hmesh = generate_grid_hex(nx, ny, nz, (0.0, 0.0, 0.0),
                              (60.0, 20.0, 4.0))
    return np.repeat(vfrac04_density_for(hmesh), 6)


def vfrac04_density_for(target_mesh: Mesh,
                        fixture_path: str = VFRAC04_FIXTURE) -> np.ndarray:
    """The bundled vfrac-0.4 optimized density resampled onto
    ``target_mesh``."""
    from ..io.vtu import read_cell_density, read_vtu_mesh

    src = read_vtu_mesh(fixture_path)
    rho = read_cell_density(fixture_path)
    return sample_cell_density(src, rho, target_mesh)
