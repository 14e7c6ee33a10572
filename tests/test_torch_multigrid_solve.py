"""The multigrid slice of the port as a whole, against the JAX package:
``solve_system(SolverConfig(method="cg", preconditioner="multigrid"))`` on
generated tet4 boxes, on the CPU in float64 unless stated.

A JAX-package problem goes to the port as plain NumPy state through
``problem_from_numpy``, ``structured_info`` included, so both take the
stencil-hierarchy route on the same problem: the scale-2 beam
(``generate_grid_tet(25, 8, 2)``, whose odd dims leave one level: the
V-cycle is the dense inverse alone) through both packages, and a 16x8x4
cantilever with a seeded per-hex SIMP scale against the direct oracle.
Where the structured hierarchy does not apply the
port raises ``NotImplementedError``; it never solves another way.

Tolerances are stated where they are used.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topopteval_tpu import api as jax_api
from topopteval_tpu.config import SolverConfig as JaxSolverConfig
from topopteval_tpu.fem.bc import nodes_at_plane as jax_nodes_at_plane
from topopteval_tpu.materials import lame_parameters
from topopteval_tpu.models import beams as jax_beams
import topopteval_tpu_torch as tt

tt.set_verbosity(False)
# these tests work on small tensors: one intra-op thread each, so that
# test processes running side by side do not fight over the cores (torch's
# thread pool spins at its barriers when the machine is oversubscribed)
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAM, MU = lame_parameters(1.0, 0.3)
MG_KW = dict(method="cg", preconditioner="multigrid", tolerance=1e-10,
             max_iterations=500, verbose=False)


def _oracle(key):
    with open(os.path.join(REPO, "data", "oracle_energies.json")) as fh:
        return json.load(fh)[key]


def _rel(a, b):
    return abs(a - b) / abs(b)


def _jax_cantilever(nx, ny, nz, box, escale=None):
    mesh = jax_beams.generate_grid_tet(nx, ny, nz, (0.0, 0.0, 0.0), box)
    problem = jax_api.setup_problem(mesh, dtype=jnp.float64)
    jax_api.assemble_stiffness_matrix(problem, LAM, MU)
    if escale is not None:          # per-hex SIMP scale, x-major hex order
        e_t = np.repeat(escale.transpose(2, 1, 0).reshape(-1), 6)
        problem.lam, problem.mu = problem.lam * e_t, problem.mu * e_t
    jax_api.apply_fixed_boundary(problem, jax_nodes_at_plane(mesh, 0, 0.0))
    jax_api.apply_force(problem, jax_nodes_at_plane(mesh, 0, box[0]),
                        [0.0, 0.0, -1.0])
    return problem


def _state(problem) -> dict:
    """A JAX-package Problem as the plain NumPy state the port takes."""
    return {"coords": problem.mesh.coords, "conn": problem.mesh.conn,
            "element_type": problem.mesh.element_type,
            "lam": problem.lam, "mu": problem.mu,
            "density": problem.density, "f": problem.f,
            "fixed_dofs": [bc.fixed_dofs for bc in problem.bcs],
            "quad_order": problem.quad_order,
            "structured_info": problem.mesh.structured_info}


def test_solve_system_multigrid_matches_jax_on_the_scale2_beam():
    """Odd dims: one level, the V-cycle is the dense inverse alone."""
    ref_p = _jax_cantilever(25, 8, 2, (60.0, 20.0, 4.0))
    ref = jax_api.solve_system(ref_p, JaxSolverConfig(**MG_KW))
    problem = tt.problem_from_numpy(_state(ref_p), device="cpu",
                                    dtype=torch.float64)
    ours = tt.solve_system(problem, tt.SolverConfig(**MG_KW))
    assert ours.method == "cg" and ours.converged
    assert ours.iterations == ref.iterations <= 2
    # both converge the same iteration to 1e-10 relative residual; the
    # energies then agree far inside the 1e-8 oracle gate
    assert _rel(ours.energy, ref.energy) <= 1e-10
    assert _rel(ours.energy, _oracle("tet_beam_scale_2")) <= 1e-8
    np.testing.assert_allclose(ours.u, ref.u, rtol=0,
                               atol=1e-8 * np.abs(ref.u).max())
    np.testing.assert_allclose(ours.von_mises, ref.von_mises, rtol=0,
                               atol=1e-8 * ref.von_mises.max())


def test_solve_system_multigrid_simp_box_meets_the_direct_oracle():
    """A 16x8x4 cantilever with a seeded per-hex scale in [0.2, 1], from
    a JAX-package problem: the SIMP branch of ``_get_multigrid`` (its
    [nx,ny,nz] -> [nz,ny,nx] transpose) against the float64 host direct
    solve of the per-tet materials.  The uniform 16x8x4 hierarchy is held
    to the JAX package in tests/test_torch_multigrid.py; the same solve
    through the JAX package takes these 22 iterations too, and 20 s of
    tracing, which is why it is not run here."""
    from topopteval_tpu_torch.fem.operator import assemble_scipy
    from topopteval_tpu_torch.fem.solvers import direct_solve
    esc = np.random.default_rng(11).uniform(0.2, 1.0, (4, 8, 16))
    ref_p = _jax_cantilever(16, 8, 4, (16.0, 8.0, 4.0), esc)
    problem = tt.problem_from_numpy(_state(ref_p), device="cpu",
                                    dtype=torch.float64)
    ours = tt.solve_system(problem, tt.SolverConfig(**MG_KW))
    assert ours.method == "cg" and ours.converged
    assert ours.iterations == 22
    mask = tt.free_mask_from_bcs(problem.n_dofs, problem.bcs)
    K = assemble_scipy(problem.mesh, problem.lam, problem.mu, free_mask=mask)
    u = direct_solve(K, problem.f * mask)
    assert _rel(ours.energy, 0.5 * float(u @ (K @ u))) <= 1e-8
    np.testing.assert_allclose(ours.u, u, rtol=0, atol=1e-7 * np.abs(u).max())
    # the hierarchy is cached on the problem per material and BCs
    op, mg = tt.api._get_multigrid(problem)
    assert op.escale is not None
    again = tt.api._get_multigrid(problem)
    assert again[0] is op and again[1] is mg
    problem.lam = problem.lam * 2.0
    assert tt.api._get_multigrid(problem)[0] is not op


def test_scale4_multigrid_meets_the_oracle_in_the_jax_iteration_count():
    """The scale-4 beam (19,200 tets, 13,005 DOFs, two levels) through the
    port alone: the same call through the JAX package takes 21 iterations
    on the CPU but 18 s of tracing, too long for this file, so its count
    stands here as a number; the energy gate is the 1e-8 oracle
    contract."""
    mesh = tt.generate_grid_tet(50, 16, 4, (0, 0, 0), (60.0, 20.0, 4.0))
    problem = tt.cantilever_beam(mesh, dtype=torch.float64, device="cpu")
    result = tt.solve_system(problem, tt.SolverConfig(**MG_KW))
    assert result.method == "cg" and result.converged
    assert result.iterations == 21
    assert _rel(result.energy, _oracle("tet_beam_scale_4")) <= 1e-8


def test_solve_system_multigrid_float32_refines_to_the_oracle():
    """float32 with tolerance 1e-10: multigrid PCG inside the float64
    host-residual refinement, certified against the scale-2 oracle."""
    mesh = tt.generate_grid_tet(25, 8, 2, (0, 0, 0), (60.0, 20.0, 4.0))
    problem = tt.cantilever_beam(mesh, dtype=torch.float32, device="cpu")
    result = tt.solve_system(problem, tt.SolverConfig(**MG_KW))
    assert result.method == "cg" and result.converged
    assert result.refinement_passes >= 1
    assert result.u.dtype == np.float64
    assert _rel(result.energy, _oracle("tet_beam_scale_2")) <= 1e-8


@pytest.mark.parametrize("case", ["imported", "no_coarsening", "hex8",
                                  "material_inside_hex"])
def test_multigrid_raises_where_the_structured_hierarchy_does_not_apply(
        case, beam_tet_path):
    """No quiet substitute: these need the block-ELL hierarchy."""
    if case == "imported":
        mesh = tt.import_mesh(beam_tet_path)
    elif case == "no_coarsening":     # odd dims, 4,680 > 4,000 coarse DOFs
        mesh = tt.generate_grid_tet(25, 9, 5, (0, 0, 0), (25.0, 9.0, 5.0))
    elif case == "hex8":
        mesh = tt.generate_grid_hex(4, 2, 2)
    else:
        mesh = tt.generate_grid_tet(4, 2, 2)
    problem = tt.cantilever_beam(mesh, dtype=torch.float64, device="cpu")
    if case == "material_inside_hex":
        problem.mu = problem.mu * np.random.default_rng(0).uniform(
            0.5, 1.0, mesh.n_cells)
    with pytest.raises(NotImplementedError, match="Queue A item 6"):
        tt.solve_system(problem, tt.SolverConfig(**MG_KW))
