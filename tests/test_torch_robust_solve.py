"""The robust ladder through ``solve_system`` of the PyTorch port beside
the JAX package, on the CPU in float64 unless stated (the cases of
tests/test_solvers.py:163-320).

All four methods solve the small cantilever to the direct energy (1e-7)
and to the JAX package's energies (1e-10); ``solve_system_robust`` prints
the reference's headings and the JAX package's condition number; the
ladder takes the JAX ladder's rung when the budget is short; float32
runs under the float64 refinement; ``solve_system_adaptive`` routes by
size.  The Krylov methods themselves are in tests/test_torch_robust.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topopteval_tpu import api as japi
from topopteval_tpu.config import SolverConfig as JaxSolverConfig
from topopteval_tpu.fem import robust as jrob
from topopteval_tpu.fem.bc import nodes_at_plane as jax_nodes_at_plane
from topopteval_tpu.materials import lame_parameters
from topopteval_tpu.models.beams import generate_grid_tet as jax_grid_tet
import topopteval_tpu_torch as tt
from topopteval_tpu_torch import api

tt.set_verbosity(False)
torch.set_num_threads(1)

LAM, MU = lame_parameters(1.0, 0.3)


def _cantilever_pair(dtype=torch.float64):
    mesh = jax_grid_tet(4, 2, 2, (0, 0, 0), (4, 1, 1))
    jp = japi.setup_problem(mesh, dtype=jnp.float64)
    japi.assemble_stiffness_matrix(jp, LAM, MU)
    japi.apply_fixed_boundary(jp, jax_nodes_at_plane(mesh, 0, 0.0))
    japi.apply_force(jp, jax_nodes_at_plane(mesh, 0, 4.0), [0, 0, -1.0])
    tmesh = tt.generate_grid_tet(4, 2, 2, (0, 0, 0), (4, 1, 1))
    tp = tt.setup_problem(tmesh, dtype=dtype, device="cpu")
    tt.assemble_stiffness_matrix(tp, LAM, MU)
    tt.apply_fixed_boundary(tp, tt.nodes_at_plane(tmesh, 0, 0.0))
    tt.apply_force(tp, tt.nodes_at_plane(tmesh, 0, 4.0), [0, 0, -1.0])
    return jp, tp


@pytest.mark.parametrize("method", ["cg", "minres", "bicgstab", "gmres"])
def test_solver_methods_agree_on_fem_problem(method):
    """All four methods through ``solve_system`` on the cantilever of
    tests/test_solvers.py:163-185."""
    jp, tp = _cantilever_pair()
    e_ref = tt.solve_system(tp, tt.SolverConfig(method="direct",
                                                verbose=False)).energy
    kw = dict(method=method, preconditioner="diagonal", tolerance=1e-12,
              max_iterations=5000, verbose=False)
    ours = tt.solve_system(tp, tt.SolverConfig(**kw))
    ref = japi.solve_system(jp, JaxSolverConfig(**kw))
    assert ours.method == ref.method == method and ours.converged
    assert abs(ours.energy - e_ref) / e_ref < 1e-7
    assert abs(ours.energy - ref.energy) / abs(ref.energy) < 1e-10


def test_robust_entry_and_verbose(capsys):
    mesh = tt.generate_grid_tet(3, 2, 2)
    p = tt.setup_problem(mesh, dtype=torch.float64, device="cpu")
    tt.assemble_stiffness_matrix(p, LAM, MU)
    tt.apply_fixed_boundary(p, tt.nodes_at_plane(mesh, 0, 0.0))
    tt.apply_force(p, tt.nodes_at_plane(mesh, 0, 1.0), [0, 0, -1.0])
    tt.set_verbosity(True)
    try:
        r = tt.solve_system_robust(p, tt.SolverConfig(
            method="auto", verbose=True, history=True))
    finally:
        tt.set_verbosity(False)
    out = capsys.readouterr().out
    assert r.energy > 0 and r.method == "direct"
    assert "PRE-SOLVE DIAGNOSTICS" in out
    assert "FINAL ANALYSIS RESULTS" in out
    assert "Condition number:" in out
    kappa = float(out.split("Condition number:")[1].split()[0])
    assert 1.0 < kappa < 1e12
    assert "Operator device residency" in out
    assert tt.solve_system_robust_simp is tt.solve_system_robust
    # the JAX package's number for the same beam
    from topopteval_tpu.fem.operator import assemble_scipy as jax_assemble
    from topopteval_tpu.fem.bc import free_mask_from_bcs as jax_mask
    jmesh = jax_grid_tet(3, 2, 2)
    K = jax_assemble(jmesh, LAM, MU, free_mask=jax_mask(
        jmesh.n_dofs, [japi.DirichletBC.fixed(
            jax_nodes_at_plane(jmesh, 0, 0.0))]))
    assert abs(kappa - jrob.condition_number(K)) <= 0.01


def test_verbose_cg_takes_the_ladder_and_reports(capsys):
    jp, tp = _cantilever_pair()
    kw = dict(method="cg", preconditioner="block_diagonal",
              tolerance=1e-10, max_iterations=2000, verbose=True,
              history=True)
    tt.set_verbosity(True)
    try:
        ours = tt.solve_system(tp, tt.SolverConfig(**kw))
    finally:
        tt.set_verbosity(False)
    out = capsys.readouterr().out
    assert "KRYLOV SOLVER DETAILS" in out and "SOLVER RESULTS" in out
    assert "Iteration     0" in out
    ref = japi.solve_system(jp, JaxSolverConfig(**kw))
    assert ours.method == ref.method == "cg" and ours.converged
    assert len(ours.history) == ours.iterations + 1
    assert abs(ours.energy - ref.energy) / abs(ref.energy) < 1e-10


def test_multigrid_preconditioner_degrades_to_block_jacobi_off_cg():
    _, tp = _cantilever_pair()
    ours = tt.solve_system(tp, tt.SolverConfig(
        method="minres", preconditioner="multigrid", tolerance=1e-10,
        max_iterations=2000, verbose=False))
    plain = tt.solve_system(tp, tt.SolverConfig(
        method="minres", preconditioner="block_diagonal", tolerance=1e-10,
        max_iterations=2000, verbose=False))
    assert ours.method == "minres" and ours.iterations == plain.iterations
    assert ours.energy == plain.energy


@pytest.mark.parametrize("tol,iters,method", [
    (1e-12, 3, "direct(fallback)"),
    (1e-2, 50, "cg(fallback)"),
    (1e-12, 400, "gmres"),
])
def test_ladder_fallbacks_match_jax(tol, iters, method):
    """GMRES(2) with a small budget: plain CG at 10x the tolerance saves
    the solve, or the direct solve does; with enough iterations the
    widened retry converges.  The JAX ladder takes the same rung."""
    jp, tp = _cantilever_pair()
    kw = dict(method="gmres", preconditioner="diagonal", tolerance=tol,
              max_iterations=iters, restart=2, verbose=False)
    ours = tt.solve_system(tp, tt.SolverConfig(**kw))
    ref = japi.solve_system(jp, JaxSolverConfig(**kw))
    assert ours.method == ref.method == method and ours.converged
    if method == "cg(fallback)":
        # unpreconditioned CG stopped at 0.1 of the initial residual: the
        # matvecs' rounding may move the stop by an iteration (as in
        # tests/test_torch_solve.py), and the iterates differ at that scale
        assert abs(ours.iterations - ref.iterations) <= 2
        assert abs(ours.energy - ref.energy) / abs(ref.energy) < 1e-2
    else:
        assert ours.iterations == ref.iterations
        assert abs(ours.energy - ref.energy) / abs(ref.energy) < 1e-9


def _refine_cantilever(dtype):
    mesh = tt.generate_grid_tet(6, 3, 3, (0, 0, 0), (6, 1, 1))
    p = tt.setup_problem(mesh, dtype=dtype, device="cpu")
    tt.assemble_stiffness_matrix(p, LAM, MU)
    tt.apply_fixed_boundary(p, tt.nodes_at_plane(mesh, 0, 0.0))
    tt.apply_force(p, tt.nodes_at_plane(mesh, 0, 6.0), [0, 0, -1.0])
    return p


def test_fp32_refinement_ladder_path():
    """Non-CG methods under float32 honour tolerances below 1e-6 through
    the float64 refinement; the method name records it
    (tests/test_solvers.py:306-320)."""
    e_ref = tt.solve_system(_refine_cantilever(torch.float64),
                            tt.SolverConfig(method="direct",
                                            verbose=False)).energy
    r = tt.solve_system(_refine_cantilever(torch.float32), tt.SolverConfig(
        method="minres", preconditioner="diagonal", tolerance=1e-9,
        max_iterations=20000, verbose=False))
    assert r.converged and r.method == "minres+refine"
    assert r.refinement_passes >= 2 and r.u.dtype == np.float64
    assert abs(r.energy - e_ref) / abs(e_ref) < 1e-8


def test_adaptive_routes_by_size(monkeypatch):
    """Below the threshold the default (direct) solve; above it multigrid
    PCG with the reference's large-problem settings (tolerance 1e-7)."""
    p = _refine_cantilever(torch.float64)
    assert tt.solve_system_adaptive(p).method == "direct"
    e_ref = tt.solve_system(p, tt.SolverConfig(method="direct",
                                               verbose=False)).energy
    monkeypatch.setattr(api, "ADAPTIVE_DOF_THRESHOLD", 10)
    r = tt.solve_system_adaptive(p)
    assert r.method == "cg" and r.converged and p._mg_cache is not None
    assert len(r.history) == r.iterations + 1          # history=True
    assert abs(r.energy - e_ref) / abs(e_ref) < 1e-6
