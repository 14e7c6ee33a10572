"""Canonical problem setups (counterpart of
``topopteval_tpu.models.problems``).

Each constructor reproduces one of the reference's workflows end-to-end
(reference: test/runtests.jl:21-89; test/VolumeForces/testVolumeForces.jl)
as a ready-to-solve :class:`..api.Problem`.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..api import (Problem, apply_fixed_boundary, apply_force,
                   assemble_stiffness_matrix, assemble_stiffness_matrix_simp,
                   extract_cell_density, import_mesh, setup_problem)
from ..fem.bc import nodes_at_plane, select_nodes_by_plane
from ..fem.loads import apply_gravity
from ..grid import generate_grid_hex
from ..materials import create_material_model, create_simp_material_model


def _clamp_and_load(problem: Problem, axis: int, tip_force) -> Problem:
    mesh = problem.mesh
    lo, hi = mesh.bounding_box()
    apply_fixed_boundary(problem, nodes_at_plane(mesh, axis, float(lo[axis])))
    apply_force(problem, nodes_at_plane(mesh, axis, float(hi[axis])),
                list(tip_force))
    return problem


def cantilever_beam(mesh_or_path, E: float = 1.0, nu: float = 0.3,
                    tip_force: Sequence[float] = (0.0, 0.0, -1.0),
                    axis: int = 0, interpolation_order: int = 1,
                    dtype: torch.dtype = torch.float32,
                    device="cuda") -> Problem:
    """Clamp the min-axis plane, apply a tip load at the max-axis plane
    (reference: test/runtests.jl:21-49)."""
    mesh = (import_mesh(mesh_or_path) if isinstance(mesh_or_path, str)
            else mesh_or_path)
    problem = setup_problem(mesh, interpolation_order=interpolation_order,
                            dtype=dtype, device=device)
    assemble_stiffness_matrix(problem, *create_material_model(E, nu))
    return _clamp_and_load(problem, axis, tip_force)


def simp_beam(mesh_path: str, E0: float = 1.0, nu: float = 0.3,
              Emin: float = 1e-8, p: float = 3.0,
              density: Optional[np.ndarray] = None,
              tip_force: Sequence[float] = (0.0, 0.0, -1.0),
              axis: int = 0, dtype: torch.dtype = torch.float32,
              device="cuda") -> Problem:
    """SIMP density evaluation of a topology-optimization result
    (reference: test/runtests.jl:51-89, explicit params at :63-67)."""
    mesh = import_mesh(mesh_path)
    if density is None:
        density = extract_cell_density(mesh_path)
    problem = setup_problem(mesh, dtype=dtype, device=device)
    material = create_simp_material_model(E0, nu, Emin, p)
    assemble_stiffness_matrix_simp(problem, material, density)
    return _clamp_and_load(problem, axis, tip_force)


def cantilever_under_gravity(nx: int = 40, ny: int = 8, nz: int = 8,
                             L: float = 10.0, w: float = 1.0,
                             h: float = 1.0, E: float = 200e9,
                             nu: float = 0.3, rho: float = 7850.0,
                             g: float = 9.81,
                             dtype: torch.dtype = torch.float32,
                             device="cuda") -> Problem:
    """Self-weight cantilever with an Euler-Bernoulli analytical solution
    (reference: testVolumeForces.jl:6-60)."""
    mesh = generate_grid_hex(nx, ny, nz, (0, 0, 0), (L, w, h))
    problem = setup_problem(mesh, dtype=dtype, device=device)
    assemble_stiffness_matrix(problem, *create_material_model(E, nu))
    apply_fixed_boundary(
        problem, select_nodes_by_plane(mesh, [0.0, 0, 0], [1.0, 0, 0],
                                       1e-9))
    apply_gravity(problem, rho, g, [0.0, 0.0, -1.0])
    return problem


def cube_under_gravity(n: int = 8, E: float = 200e9, nu: float = 0.3,
                       rho: float = 7850.0, g: float = 9.81,
                       dtype: torch.dtype = torch.float32,
                       device="cuda") -> Problem:
    """Unit cube on a fixed floor under gravity (reference:
    testVolumeForces.jl:65-102; sigma_zz(bottom) = -rho g h)."""
    mesh = generate_grid_hex(n, n, n)
    problem = setup_problem(mesh, dtype=dtype, device=device)
    assemble_stiffness_matrix(problem, *create_material_model(E, nu))
    apply_fixed_boundary(
        problem, select_nodes_by_plane(mesh, [0.0, 0, 0], [0.0, 0, 1.0],
                                       1e-9))
    apply_gravity(problem, rho, g)
    return problem
