"""The port's Galerkin voxel multigrid as a solver, on the CPU:

- MG-PCG on the imported Tet4 cantilever fixture in float64 over the
  port's own hierarchy: the JAX package's iteration count on the same
  fixture (111, which tests/test_torch_galerkin.py holds the JAX package
  to), the energy within 1e-8 of the host direct solve;
- the V-cycle is symmetric and positive (CG needs it);
- ``solve_system`` with ``TOPOPT_MG=galerkin`` through both packages on a
  box without ``structured_info`` (tests/test_unstructured_mg.py's 6x3x3
  cantilever): the route, the iteration count and the energy in float64
  (1e-10: the same solve in two packages), and the float32 route through
  float64 refinement against the direct solve (1e-8).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import threadpoolctl
import torch

from topopteval_tpu import api as jax_api
from topopteval_tpu.config import SolverConfig as JaxSolverConfig
from topopteval_tpu.fem.bc import nodes_at_plane as jax_nodes_at_plane
from topopteval_tpu.models.beams import generate_grid_tet as jax_grid_tet
import topopteval_tpu_torch as tt
from topopteval_tpu_torch.fem import multigrid as port_mg
from topopteval_tpu_torch.fem.operator import (StiffnessOperator,
                                               assemble_scipy)
from topopteval_tpu_torch.fem.solvers import cg, direct_solve

tt.set_verbosity(False)
torch.set_num_threads(1)

LAM, MU = tt.lame_parameters(1.0, 0.3)
#: the MG-PCG count of both packages on the fixture at tolerance 1e-10
#: (float64, CPU; tests/test_torch_galerkin.py holds the JAX package to it)
FIXTURE_ITERATIONS = 111


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    with threadpoolctl.threadpool_limits(1):
        yield


@pytest.fixture(scope="module")
def fixture_solve(beam_tet_path):
    mesh = tt.import_mesh(beam_tet_path)
    mask = tt.free_mask_from_bcs(mesh.n_dofs, [tt.DirichletBC.fixed(
        tt.nodes_at_plane(mesh, 0, 0.0, tol=1e-6))])
    tip = tt.nodes_at_plane(mesh, 0, 60.0, tol=1e-6)
    f = np.zeros(mesh.n_dofs)
    f[tip * 3 + 2] = -1.0 / tip.size
    op, mg = port_mg.build_unstructured_multigrid(
        mesh, LAM, MU, free_mask=mask, dtype=torch.float64, device="cpu")
    return mesh, mask, f, op, mg


def test_mg_pcg_takes_the_jax_count_and_the_direct_energy(fixture_solve):
    mesh, mask, f, op, mg = fixture_solve
    res = cg(op, torch.as_tensor(f) * op.free_mask, M=mg, tol=1e-10,
             maxiter=300)
    assert res.converged and res.niter == FIXTURE_ITERATIONS
    K = assemble_scipy(mesh, LAM, MU, free_mask=mask)
    u_d = direct_solve(K, f * mask)
    e_d = 0.5 * float(u_d @ (K @ u_d))
    assert abs(float(op.energy(res.x)) - e_d) / e_d <= 1e-8


def test_vcycle_is_symmetric_and_positive(fixture_solve):
    *_, op, mg = fixture_solve
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal(op.n_dofs)) * op.free_mask
    y = torch.as_tensor(rng.standard_normal(op.n_dofs)) * op.free_mask
    xMy = float(torch.dot(x, mg.apply(y)))
    yMx = float(torch.dot(y, mg.apply(x)))
    assert abs(xMy - yMx) / abs(xMy) < 1e-10
    assert float(torch.dot(x, mg.apply(x))) > 0


def _cantilever(pkg, mesh, dtype):
    if pkg == "jax":
        p = jax_api.setup_problem(mesh, dtype=dtype)
        jax_api.assemble_stiffness_matrix(p, LAM, MU)
        jax_api.apply_fixed_boundary(p, jax_nodes_at_plane(mesh, 0, 0.0,
                                                           tol=1e-6))
        jax_api.apply_force(p, jax_nodes_at_plane(mesh, 0, 6.0, tol=1e-6),
                            [0.0, 0.0, -1.0])
        return p
    p = tt.setup_problem(mesh, dtype=dtype, device="cpu")
    tt.assemble_stiffness_matrix(p, LAM, MU)
    tt.apply_fixed_boundary(p, tt.nodes_at_plane(mesh, 0, 0.0, tol=1e-6))
    tt.apply_force(p, tt.nodes_at_plane(mesh, 0, 6.0, tol=1e-6),
                   [0.0, 0.0, -1.0])
    return p


def test_solve_system_galerkin_route_matches_jax(monkeypatch):
    monkeypatch.setenv("TOPOPT_MG", "galerkin")
    cfg = dict(method="cg", preconditioner="multigrid", tolerance=1e-10,
               max_iterations=300, verbose=False)
    jmesh = jax_grid_tet(6, 3, 3, (0, 0, 0), (6.0, 3.0, 3.0))
    jmesh.structured_info = None            # the Galerkin voxel route
    mesh = tt.generate_grid_tet(6, 3, 3, (0, 0, 0), (6.0, 3.0, 3.0))
    mesh.structured_info = None
    jr = jax_api.solve_system(_cantilever("jax", jmesh, jnp.float64),
                              JaxSolverConfig(**cfg))
    p = _cantilever("port", mesh, torch.float64)
    r = tt.solve_system(p, tt.SolverConfig(**cfg))
    _, op, _ = p._mg_cache
    assert isinstance(op, StiffnessOperator)
    assert p._mg_build_info["route"] == "galerkin"
    assert r.method == "cg" and r.converged and jr.converged
    assert r.iterations == jr.iterations
    assert abs(r.energy - jr.energy) <= 1e-10 * abs(jr.energy)
    # float32: MG-PCG under float64 refinement, held to the direct solve
    p32 = _cantilever("port", mesh, torch.float32)
    r32 = tt.solve_system(p32, tt.SolverConfig(**cfg))
    direct = tt.solve_system(p, tt.SolverConfig(method="direct"))
    assert r32.converged and r32.refinement_passes > 0
    assert abs(r32.energy - direct.energy) <= 1e-8 * abs(direct.energy)
    # without the switch, the same mesh takes the block-ELL route
    monkeypatch.delenv("TOPOPT_MG")
    p_bell = _cantilever("port", mesh, torch.float64)
    tt.solve_system(p_bell, tt.SolverConfig(**cfg))
    assert p_bell._mg_build_info.get("route") != "galerkin"
    assert getattr(p_bell._mg_cache[1], "layout", None) == "cm"
