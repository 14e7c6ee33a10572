"""The backward-error gate covers every iterative method of the port's
``solve_system`` (the cases of tests/test_verification_gate.py), on the
CPU in float64, beside the JAX package on the same problem.

A deliberately wrong "converged" solution is injected into each route:
the port's own ``cg`` on the plain route, and ``fem.robust.
solve_with_krylov`` on the ladder's routes (MINRES, BiCGSTAB, GMRES).  The
gate must reject it and fall back to the host direct solve, whose energy
is the direct solve's to 1e-12.  Honest MINRES and GMRES solves pass the
gate with the JAX package's method string and energy (1e-10).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topopteval_tpu import api as japi
from topopteval_tpu.config import SolverConfig as JaxSolverConfig
from topopteval_tpu.fem.bc import nodes_at_plane as jax_nodes_at_plane
from topopteval_tpu.materials import lame_parameters
from topopteval_tpu.models.beams import generate_grid_tet as jax_grid_tet
import topopteval_tpu_torch as tt
from topopteval_tpu_torch import api
from topopteval_tpu_torch.fem import robust
from topopteval_tpu_torch.fem.solvers import KrylovResult

tt.set_verbosity(False)
torch.set_num_threads(1)

LAM, MU = lame_parameters(1.0, 0.3)


def _problem():
    mesh = tt.generate_grid_tet(4, 2, 2, (0, 0, 0), (4, 2, 2))
    problem = tt.setup_problem(mesh, dtype=torch.float64, device="cpu")
    tt.assemble_stiffness_matrix(problem, LAM, MU)
    tt.apply_fixed_boundary(problem, tt.nodes_at_plane(mesh, 0, 0.0))
    tt.apply_force(problem, tt.nodes_at_plane(mesh, 0, 4.0), [0, 0, -1.0])
    return problem


def _jax_problem():
    mesh = jax_grid_tet(4, 2, 2, (0, 0, 0), (4, 2, 2))
    problem = japi.setup_problem(mesh, dtype=jnp.float64)
    japi.assemble_stiffness_matrix(problem, LAM, MU)
    japi.apply_fixed_boundary(problem, jax_nodes_at_plane(mesh, 0, 0.0))
    japi.apply_force(problem, jax_nodes_at_plane(mesh, 0, 4.0),
                     [0, 0, -1.0])
    return problem


@pytest.fixture(scope="module")
def direct_energy():
    return tt.solve_system(_problem(), tt.SolverConfig(
        method="direct", verbose=False)).energy


def test_gate_trips_on_corrupted_cg(monkeypatch, direct_energy):
    real_cg = api.cg

    def bad_cg(A, b, **kw):
        res = real_cg(A, b, **kw)
        # corrupt the solution but keep the reported convergence flag
        return KrylovResult(res.x * 1.5 + 1.0, res.niter,
                            res.residual_norm, True, res.history)

    monkeypatch.setattr(api, "cg", bad_cg)
    cfg = tt.SolverConfig(method="cg", preconditioner="diagonal",
                          tolerance=1e-10, max_iterations=2000,
                          verbose=False)    # verbose=False: the plain route
    res = tt.solve_system(_problem(), cfg)
    assert res.method == "direct(verification-fallback)"
    assert res.converged
    assert abs(res.energy - direct_energy) <= 1e-12 * direct_energy


@pytest.mark.parametrize("method", ["minres", "bicgstab", "gmres", "cg"])
def test_gate_trips_on_corrupted_krylov(monkeypatch, method, direct_energy):
    """``cg`` with ``verbose=True`` takes the ladder as the others do."""
    problem = _problem()
    calls = []

    def bad_solve(op, f_dev, m, config):
        calls.append(m)
        u = torch.ones(op.n_dofs, dtype=problem.dtype) * op.free_mask
        return u, 10, 1e-12, True, None, m

    monkeypatch.setattr(robust, "solve_with_krylov", bad_solve)
    cfg = tt.SolverConfig(method=method, preconditioner="diagonal",
                          tolerance=1e-8, max_iterations=2000, verbose=True)
    res = tt.solve_system(problem, cfg)
    assert calls == [method]
    assert res.method == "direct(verification-fallback)"
    assert res.converged and res.history is None
    assert abs(res.energy - direct_energy) <= 1e-12 * direct_energy


@pytest.mark.parametrize("method", ["minres", "gmres"])
def test_gate_passes_honest_krylov(method):
    kw = dict(method=method, preconditioner="diagonal", tolerance=1e-10,
              max_iterations=5000, verbose=True)
    res = tt.solve_system(_problem(), tt.SolverConfig(**kw))
    ref = japi.solve_system(_jax_problem(), JaxSolverConfig(**kw))
    assert res.converged
    assert res.method == ref.method == method
    assert abs(res.energy - ref.energy) <= 1e-10 * abs(ref.energy)
    np.testing.assert_allclose(res.u, ref.u, rtol=0,
                               atol=1e-8 * np.abs(ref.u).max())


def test_minres_stalls_above_the_gate_in_both_packages():
    """MINRES with block-Jacobi at tolerance 1e-10 on the scale-2 beam:
    its recurrence estimate reaches the tolerance while its true residual
    stalls near eps·cond·|f| (above CG's), so the backward-error gate
    rejects the iterate and both packages return the host direct solve.
    chip_smoke.py phase 14a meets the same outcome at scale 8."""
    from topopteval_tpu.fem.bc import nodes_at_plane as jnp_at_plane
    from topopteval_tpu_torch.fem import solvers
    kw = dict(method="minres", preconditioner="block_diagonal",
              tolerance=1e-10, max_iterations=20000, verbose=False)
    mesh = tt.generate_grid_tet(25, 8, 2, (0, 0, 0), (60.0, 20.0, 4.0))
    p = tt.cantilever_beam(mesh, dtype=torch.float64, device="cpu")
    ours = tt.solve_system(p, tt.SolverConfig(**kw))
    jmesh = jax_grid_tet(25, 8, 2, (0, 0, 0), (60.0, 20.0, 4.0))
    jp = japi.setup_problem(jmesh, dtype=jnp.float64)
    japi.assemble_stiffness_matrix(jp, LAM, MU)
    japi.apply_fixed_boundary(jp, jnp_at_plane(jmesh, 0, 0.0))
    japi.apply_force(jp, jnp_at_plane(jmesh, 0, 60.0), [0.0, 0.0, -1.0])
    ref = japi.solve_system(jp, JaxSolverConfig(**kw))
    assert ours.method == ref.method == "direct(verification-fallback)"
    assert abs(ours.energy - ref.energy) <= 1e-10 * ref.energy
    # the first rung alone: converged by its estimate, not by its residual
    op = p.build_operator()
    f = torch.as_tensor(p.f) * op.free_mask
    M = api._build_preconditioner(op, tt.SolverConfig(**kw))
    res = solvers.minres(op, f, M=M, tol=1e-10, maxiter=20000)
    cg = solvers.cg(op, f, M=M, tol=1e-10, maxiter=20000)
    assert res.converged and cg.converged
    true_cg = float(torch.linalg.vector_norm(f - op.matvec(cg.x)))
    assert res.residual_norm > 20 * true_cg
    eta, ffrac = api._backward_error(op, f, res.x)
    assert eta > 100 * 2.0 ** -52 + 100 * 1e-10 * ffrac
