"""Solve-level parity of the PyTorch port against the JAX package, on the
CPU (float64 unless stated).

- The scale-2 cantilever beam (``generate_grid_tet(25, 8, 2)``, 2,400
  tets) with block-Jacobi CG at tolerance 1e-10: the port must take the
  JAX package's iteration count (±2, see the test) and land within 1e-8
  of ``tet_beam_scale_2`` in data/oracle_energies.json, in float64 and in
  float32 through the float64-certified refinement route.
- The SIMP fixture (Hex8, 1e-8 density contrast) with the same CG in
  float64, against the port's own float64 host direct oracle.
- The routes: auto → direct below 50k DOFs, NotImplementedError for the
  routes not ported yet, no silent CPU fallback for ``device="cuda"``.
- Export and result round-trips, and a subprocess check that the port
  loads neither ``jax`` nor ``topopteval_tpu``.

The 1e-8 energy gate is the JAX package's own contract
(tests/test_end_to_end.py:62-116).
"""

import json
import os
import subprocess
import sys

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
from topopteval_tpu_torch.fem.operator import assemble_scipy
from topopteval_tpu_torch.fem.solvers import direct_solve
from topopteval_tpu_torch.io.vtu import VTUFile

tt.set_verbosity(False)
# these tests work on small tensors: one intra-op thread each, so that
# test processes running side by side do not fight over the cores (torch's
# thread pool spins at its barriers when the machine is oversubscribed)
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CG_KW = dict(method="cg", preconditioner="block_diagonal", tolerance=1e-10,
             max_iterations=20000, verbose=False)
CG = tt.SolverConfig(**CG_KW)


def _oracle(key):
    with open(os.path.join(REPO, "data", "oracle_energies.json")) as fh:
        return json.load(fh)[key]


def _rel(a, b):
    return abs(a - b) / abs(b)


def _state(problem) -> dict:
    """A JAX-package Problem as the plain NumPy state the port takes."""
    return {"coords": problem.mesh.coords, "conn": problem.mesh.conn,
            "element_type": problem.mesh.element_type,
            "lam": problem.lam, "mu": problem.mu,
            "density": problem.density, "f": problem.f,
            "fixed_dofs": [bc.fixed_dofs for bc in problem.bcs],
            "quad_order": problem.quad_order}


@pytest.fixture(scope="module")
def beam2():
    """The scale-2 cantilever as a JAX-package problem (float64)."""
    mesh = generate_grid_tet(25, 8, 2, (0.0, 0.0, 0.0), (60.0, 20.0, 4.0))
    problem = setup_problem(mesh, dtype=jnp.float64)
    assemble_stiffness_matrix(problem, *lame_parameters(1.0, 0.3))
    apply_fixed_boundary(problem, nodes_at_plane(mesh, 0, 0.0))
    apply_force(problem, nodes_at_plane(mesh, 0, 60.0), [0.0, 0.0, -1.0])
    return problem


@pytest.fixture(scope="module")
def beam2_port_fp64(beam2):
    return tt.solve_system(tt.problem_from_numpy(
        _state(beam2), device="cpu", dtype=torch.float64), CG)


def test_scale2_fp64_cg_matches_jax_iterations_and_oracle(beam2,
                                                          beam2_port_fp64):
    ref = solve_system(beam2, JaxSolverConfig(**CG_KW))
    ours = beam2_port_fp64
    assert ours.method == "cg" and ours.converged
    # same recurrence and stopping rule; the matvecs agree to ~1e-15
    # relative but not bit for bit (the port's tet4 apply uses the exact
    # 1-point rule, the JAX CPU path the 4-point einsum), and over ~500
    # iterations that may move the last stopping test by an iteration or
    # two
    assert abs(ours.iterations - ref.iterations) <= 2, (ours.iterations,
                                                        ref.iterations)
    assert _rel(ours.energy, _oracle("tet_beam_scale_2")) <= 1e-8
    assert _rel(ours.energy, ref.energy) <= 1e-8
    np.testing.assert_allclose(ours.u, ref.u, rtol=0,
                               atol=1e-6 * np.abs(ref.u).max())
    np.testing.assert_allclose(ours.von_mises, ref.von_mises, rtol=0,
                               atol=1e-6 * ref.von_mises.max())


def test_scale2_fp32_refinement_meets_oracle(beam2):
    problem = tt.problem_from_numpy(_state(beam2), device="cpu",
                                    dtype=torch.float32)
    result = tt.solve_system(problem, CG)
    assert result.method == "cg" and result.converged
    assert result.u.dtype == np.float64       # the fp64-certified iterate
    assert _rel(result.energy, _oracle("tet_beam_scale_2")) <= 1e-8


def test_scale2_jacobi_cg_matches_jax_iterations(beam2):
    kw = dict(CG_KW, preconditioner="diagonal")
    ref = solve_system(beam2, JaxSolverConfig(**kw))
    ours = tt.solve_system(tt.problem_from_numpy(
        _state(beam2), device="cpu", dtype=torch.float64),
        tt.SolverConfig(**kw))
    assert ours.converged
    # ±2 for the reason given in the block-Jacobi test above
    assert abs(ours.iterations - ref.iterations) <= 2, (ours.iterations,
                                                        ref.iterations)
    assert _rel(ours.energy, _oracle("tet_beam_scale_2")) <= 1e-8


def test_warm_start_and_history(beam2, beam2_port_fp64):
    problem = tt.problem_from_numpy(_state(beam2), device="cpu",
                                    dtype=torch.float64)
    cold = beam2_port_fp64
    warm = tt.solve_system(problem, tt.SolverConfig(**dict(CG_KW,
                                                          history=True)),
                           x0=cold.u)
    assert warm.converged
    assert warm.iterations <= max(cold.iterations // 10, 2)
    assert len(warm.history) == warm.iterations + 1
    assert _rel(warm.energy, cold.energy) < 1e-8


def test_failed_backward_error_gate_falls_back_to_direct(beam2, monkeypatch):
    """An iterate that claims convergence but is wrong must not pass: the
    backward-error gate rejects it, and below 100k DOFs the solve falls
    back to the host direct solve."""
    from topopteval_tpu_torch import api
    from topopteval_tpu_torch.fem.solvers import KrylovResult

    def wrong_cg(A, b, x0=None, M=None, tol=1e-8, maxiter=10000,
                 record_history=False):
        return KrylovResult(0.5 * b, 1, 0.0, True, None)

    monkeypatch.setattr(api, "cg", wrong_cg)
    problem = tt.problem_from_numpy(_state(beam2), device="cpu",
                                    dtype=torch.float64)
    result = tt.solve_system(problem, CG)
    assert result.method == "direct(verification-fallback)"
    assert result.converged
    assert _rel(result.energy, _oracle("tet_beam_scale_2")) <= 1e-8


def test_simp_fixture_fp64_cg_meets_direct_oracle(beam_hex_path):
    mesh = tt.import_mesh(beam_hex_path)
    problem = tt.setup_problem(mesh, dtype=torch.float64, device="cpu")
    tt.assemble_stiffness_matrix_simp(
        problem, tt.create_simp_material_model(1.0, 0.3, 1e-8, 3.0),
        tt.extract_cell_density(beam_hex_path))
    tt.apply_fixed_boundary(problem, tt.nodes_at_plane(mesh, 0, 0.0))
    tt.apply_force(problem, tt.nodes_at_plane(mesh, 0, 60.0),
                   [0.0, 0.0, -1.0])
    mask = tt.free_mask_from_bcs(problem.n_dofs, problem.bcs)
    K = assemble_scipy(mesh, problem.lam, problem.mu, free_mask=mask)
    u = direct_solve(K, problem.f * mask)
    e_oracle = 0.5 * float(u @ (K @ u))
    result = tt.solve_system(problem, CG)
    assert result.method == "cg" and result.converged
    assert _rel(result.energy, e_oracle) <= 1e-8


def test_cantilever_auto_selects_direct_below_50k(beam_tet_path):
    mesh = tt.import_mesh(beam_tet_path)
    problem = tt.setup_problem(mesh, dtype=torch.float64, device="cpu")
    tt.assemble_stiffness_matrix(problem, *tt.lame_parameters(1.0, 0.3))
    tt.apply_fixed_boundary(problem, tt.nodes_at_plane(mesh, 0, 0.0))
    tt.apply_force(problem, tt.nodes_at_plane(mesh, 0, 60.0),
                   [0.0, 0.0, -1.0])
    result = tt.solve_system(problem)
    assert result.method == "direct"      # 8631 dofs < 50k threshold
    assert result.converged and result.energy > 0.0
    assert _rel(result.energy, 621.8542083316273) <= 1e-8


@pytest.mark.parametrize("kwargs,item", [
    # the scale-2 state below carries no ``structured_info``: multigrid
    # takes the block-ELL hierarchy, whose monolithic build (what a
    # material with lam = 0, Poisson's ratio 0, needs) is not ported
    (dict(method="cg", preconditioner="multigrid", verbose=False),
     "item 6"),
    (dict(method="minres", verbose=False), "item 9"),
    (dict(method="cg", verbose=True), "item 9"),
])
def test_unported_routes_raise(beam2, kwargs, item):
    problem = tt.problem_from_numpy(_state(beam2), device="cpu",
                                    dtype=torch.float64)
    if kwargs.get("preconditioner") == "multigrid":
        problem.lam = np.zeros_like(problem.lam)
    with pytest.raises(NotImplementedError, match=item):
        tt.solve_system(problem, tt.SolverConfig(**kwargs))
    with pytest.raises(NotImplementedError, match="item 13"):
        tt.solve_system(problem, CG, devices=2)


def test_cuda_device_is_never_replaced_by_cpu(beam2):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists here: nothing to refuse")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tt.problem_from_numpy(_state(beam2))          # default device
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tt.setup_problem(tt.generate_grid_tet(2, 1, 1))


def test_export_roundtrip(beam2, beam2_port_fp64, tmp_path):
    result = beam2_port_fp64
    mesh = tt.Mesh(beam2.mesh.coords, beam2.mesh.conn, "tet4")
    path = tt.export_results(result, mesh, str(tmp_path / "beam2"))
    vtu_u = VTUFile(str(tmp_path / "beam2_u.vtu"))
    np.testing.assert_array_equal(vtu_u.point_data()["u"],
                                  result.u.reshape(-1, 3))
    back = tt.read_vtu_mesh(path)
    np.testing.assert_array_equal(back.coords, mesh.coords)
    np.testing.assert_array_equal(back.conn, mesh.conn)
    cells = VTUFile(path).cell_data()
    np.testing.assert_allclose(cells["von_Mises_stress"], result.von_mises,
                               rtol=1e-12)
    assert np.all(cells["principal_stress_max"]
                  >= cells["principal_stress_min"])


def test_save_load_result_roundtrip(beam2_port_fp64, tmp_path):
    r = beam2_port_fp64
    back = tt.load_result(tt.save_result(r, str(tmp_path / "result")))
    np.testing.assert_array_equal(back.u, r.u)
    assert back.energy == r.energy
    assert back.iterations == r.iterations and back.method == r.method
    np.testing.assert_array_equal(back.von_mises, r.von_mises)
    assert back.max_stress_cell == r.max_stress_cell
    u, energy, stress, max_vm, cell = r            # reference 5-tuple
    assert energy == r.energy and cell == r.max_stress_cell


def test_port_imports_neither_jax_nor_the_jax_package():
    code = """
import sys
import numpy as np, torch
import topopteval_tpu_torch as tt
import topopteval_tpu_torch.fem.structured, topopteval_tpu_torch.fem.multigrid
import topopteval_tpu_torch.ops.stencil, topopteval_tpu_torch.models.problems
tt.set_verbosity(False)
mesh = tt.generate_grid_tet(6, 2, 1, (0, 0, 0), (6.0, 2.0, 1.0))
p = tt.setup_problem(mesh, dtype=torch.float64, device="cpu")
tt.assemble_stiffness_matrix(p, *tt.lame_parameters(1.0, 0.3))
tt.apply_fixed_boundary(p, tt.nodes_at_plane(mesh, 0, 0.0))
tt.apply_force(p, tt.nodes_at_plane(mesh, 0, 6.0), [0.0, 0.0, -1.0])
r = tt.solve_system(p, tt.SolverConfig(method="cg", verbose=False,
                    preconditioner="block_diagonal", tolerance=1e-10))
assert r.converged and r.method == "cg", r
r = tt.solve_system(p, tt.SolverConfig(method="cg", verbose=False,
                    preconditioner="multigrid", tolerance=1e-10))
assert r.converged and r.method == "cg", r
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "topopteval_tpu" or m.startswith("topopteval_tpu."))
print("LOADED:", bad)
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LOADED: []" in out.stdout, out.stdout
