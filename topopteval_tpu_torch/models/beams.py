"""Structured mesh generators (counterpart of
``topopteval_tpu.models.beams``).

- ``generate_grid_hex``, ``generate_grid_tet``: the box grids of
  :mod:`..grid`, named here as in the JAX package
- ``refined_beam``: parametric cantilever with about a target number of
  tets in the fixture beam's 60x20x4 proportions
"""

from __future__ import annotations

from typing import Tuple

from ..grid import generate_grid_hex, generate_grid_tet  # noqa: F401
from ..mesh import Mesh


def refined_beam(target_tets: int = 1_000_000,
                 dims: Tuple[float, float, float] = (60.0, 20.0, 4.0)
                 ) -> Mesh:
    """Cantilever beam with ~target_tets tet4 elements in the fixture
    beam's 60x20x4 proportions."""
    L, W, H = dims
    # 6 tets per hex; nx:ny:nz ~ L:W:H
    vol_per_hex = L * W * H / (target_tets / 6)
    h = vol_per_hex ** (1.0 / 3.0)
    nx = max(1, round(L / h))
    ny = max(1, round(W / h))
    nz = max(1, round(H / h))
    return generate_grid_tet(nx, ny, nz, (0, 0, 0), (L, W, H))
