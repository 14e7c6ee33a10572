"""The tet10 solve of the PyTorch port against the JAX package, on the
CPU in float64.

The scale-2 cantilever beam (``generate_grid_tet(25, 8, 2)`` over
60x20x4) made quadratic with ``interpolation_order=2``: 2,400 tet10
elements, 13,005 DOFs.  Both packages solve it with block-Jacobi CG at
tolerance 1e-10 (the port through its plain tet10 apply, B7's plain
version): the iteration counts agree within 2 (the same recurrence and
stopping rule, matvecs equal to ~1e-15 but not bit for bit, as
tests/test_torch_solve.py allows on the tet4 beam), and the energy lies
within 1e-8 of ``tet10_beam_scale_2`` in
data/oracle_energies.json.  The result is exported and read back.

The block-ELL route and hex20 are in tests/test_torch_quadratic_routes.py,
which keeps this file under 40 s.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topopteval_tpu.api import (apply_fixed_boundary, apply_force,
                                assemble_stiffness_matrix, setup_problem,
                                solve_system)
from topopteval_tpu.config import SolverConfig as JaxSolverConfig
from topopteval_tpu.fem.bc import nodes_at_plane
from topopteval_tpu.materials import lame_parameters
from topopteval_tpu.models.beams import generate_grid_tet
import topopteval_tpu_torch as tt
from topopteval_tpu_torch.io.vtu import VTUFile

tt.set_verbosity(False)
# these tests work on small tensors: one intra-op thread each, so that
# test processes running side by side do not fight over the cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CG_KW = dict(method="cg", preconditioner="block_diagonal", tolerance=1e-10,
             max_iterations=20000, verbose=False)


def _oracle(key):
    with open(os.path.join(REPO, "data", "oracle_energies.json")) as fh:
        return json.load(fh)[key]


@pytest.fixture(scope="module")
def tet10_beam2():
    """The scale-2 beam as a JAX-package tet10 problem (float64)."""
    mesh = generate_grid_tet(25, 8, 2, (0.0, 0.0, 0.0), (60.0, 20.0, 4.0))
    problem = setup_problem(mesh, interpolation_order=2, dtype=jnp.float64)
    assemble_stiffness_matrix(problem, *lame_parameters(1.0, 0.3))
    apply_fixed_boundary(problem, nodes_at_plane(problem.mesh, 0, 0.0))
    apply_force(problem, nodes_at_plane(problem.mesh, 0, 60.0),
                [0.0, 0.0, -1.0])
    return problem


@pytest.fixture(scope="module")
def port_result(tet10_beam2):
    jp = tet10_beam2
    state = {"coords": jp.mesh.coords, "conn": jp.mesh.conn,
             "element_type": jp.mesh.element_type, "lam": jp.lam,
             "mu": jp.mu, "f": jp.f,
             "fixed_dofs": [bc.fixed_dofs for bc in jp.bcs],
             "quad_order": jp.quad_order}
    problem = tt.problem_from_numpy(state, device="cpu",
                                    dtype=torch.float64)
    return problem, tt.solve_system(problem, tt.SolverConfig(**CG_KW))


def test_tet10_beam_cg_matches_jax_iterations_and_oracle(tet10_beam2,
                                                         port_result):
    problem, ours = port_result
    assert problem.mesh.element_type == "tet10"
    assert problem.n_dofs == 13_005 and problem.mesh.n_cells == 2_400
    ref = solve_system(tet10_beam2, JaxSolverConfig(**CG_KW))
    assert ours.method == "cg" and ours.converged
    assert abs(ours.iterations - ref.iterations) <= 2, (ours.iterations,
                                                        ref.iterations)
    oracle = _oracle("tet10_beam_scale_2")
    assert abs(ours.energy - oracle) <= 1e-8 * oracle
    assert abs(ref.energy - oracle) <= 1e-8 * oracle
    # stresses at the 4 points of every element, finite; the two CG
    # iterates agree to about the 1e-10 solve tolerance times the
    # conditioning, so the stresses to 1e-6
    assert ours.stress_qp.shape == (2_400, 4, 3, 3)
    assert np.all(np.isfinite(ours.von_mises))
    np.testing.assert_allclose(ours.von_mises, np.asarray(ref.von_mises),
                               rtol=1e-6, atol=1e-6 * ours.max_von_mises)


def test_tet10_result_exports_and_reads_back(port_result, tmp_path):
    problem, result = port_result
    path = tt.export_results(result, problem, str(tmp_path / "tet10"))
    u = VTUFile(str(tmp_path / "tet10_u.vtu")).point_data()["u"]
    np.testing.assert_array_equal(u, result.u.reshape(-1, 3))
    back = tt.read_vtu_mesh(path)
    assert back.element_type == "tet10"          # VTK type 24
    np.testing.assert_array_equal(back.coords, problem.mesh.coords)
    np.testing.assert_array_equal(back.conn, problem.mesh.conn)
    cells = VTUFile(path).cell_data()
    np.testing.assert_allclose(cells["von_Mises_stress"], result.von_mises,
                               rtol=1e-12)
    assert np.all(cells["principal_stress_max"]
                  >= cells["principal_stress_min"])
