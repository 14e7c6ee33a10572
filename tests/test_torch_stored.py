"""The stored-Ke operator (``mode="stored"``) and ``with_material`` of the
PyTorch port against the JAX package, on the CPU in float64.

For tet4, hex8 and tet10 (a perturbed box with non-uniform materials and
a clamped face) the same NumPy state goes through the JAX package's
stored operator and the port's: ``matvec_raw``, ``matvec`` and
``diagonal`` against the JAX operator and against the float64 assembled
matrix ``assemble_scipy``; the port's stored and ``otf`` operators against
each other; ``with_material`` against a fresh build.  On the CPU the Ke
batch comes from the plain ``element_stiffness`` (the Ke-batch kernels'
plain version); tests/test_torch_cuda.py runs the kernels.

Tolerance: rtol=1e-10 with an absolute floor of 1e-10 of the largest
entry, the JAX package's operator tolerance (tests/test_end_to_end.py:
119-143): the same float64 formulas in other summation orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topopteval_tpu.api import setup_problem as jax_setup
from topopteval_tpu.fem.bc import DirichletBC as JaxDirichletBC
from topopteval_tpu.fem.bc import free_mask_from_bcs
from topopteval_tpu.models.beams import generate_grid_hex, generate_grid_tet
import topopteval_tpu_torch as tt
from topopteval_tpu_torch.fem.operator import StiffnessOperator, assemble_scipy

tt.set_verbosity(False)
# these tests work on small tensors: one intra-op thread each, so that
# test processes running side by side do not fight over the cores
torch.set_num_threads(1)

RTOL = 1e-10


def _close(actual, desired):
    desired = np.asarray(desired)
    np.testing.assert_allclose(np.asarray(actual), desired, rtol=RTOL,
                               atol=RTOL * np.abs(desired).max())


def _jax_problem(element_type, mode):
    """A JAX-package problem on a perturbed 4x2x2 box with per-element
    materials and the x = 0 face clamped."""
    rng = np.random.default_rng(3)
    gen = generate_grid_hex if element_type == "hex8" else generate_grid_tet
    mesh = gen(4, 2, 2, (0, 0, 0), (4.0, 2.0, 2.0))
    clamp = np.flatnonzero(mesh.coords[:, 0] == 0.0)
    mesh.coords = mesh.coords + rng.uniform(-0.05, 0.05, mesh.coords.shape)
    mesh.coords[clamp, 0] = 0.0
    p = jax_setup(mesh, interpolation_order=2 if element_type == "tet10"
                  else 1, dtype=jnp.float64, mode=mode)
    C = p.mesh.n_cells
    p.lam = rng.uniform(0.2, 2.0, C)
    p.mu = rng.uniform(0.2, 2.0, C)
    fixed = np.flatnonzero(p.mesh.coords[:, 0] == 0.0)
    p.bcs.append(JaxDirichletBC.fixed(fixed))
    return p


def _state(p, mode):
    return {"coords": p.mesh.coords, "conn": p.mesh.conn,
            "element_type": p.mesh.element_type, "lam": p.lam, "mu": p.mu,
            "f": p.f, "fixed_dofs": [bc.fixed_dofs for bc in p.bcs],
            "quad_order": p.quad_order, "mode": mode}


@pytest.fixture(scope="module", params=["tet4", "hex8", "tet10"])
def stored_pair(request):
    """(JAX stored problem, port stored problem)."""
    jp = _jax_problem(request.param, "stored")
    pp = tt.problem_from_numpy(_state(jp, "stored"), device="cpu",
                               dtype=torch.float64)
    return jp, pp


def test_stored_operator_matches_jax_and_assembled(stored_pair):
    jp, pp = stored_pair
    assert pp.mesh.element_type == jp.mesh.element_type
    n = jp.n_dofs
    u = np.random.default_rng(0).standard_normal(n)
    op_raw = pp.build_operator(with_bc=False)
    op = pp.build_operator()
    assert op.ke.shape[1] == 3 * jp.mesh.conn.shape[1]
    j_raw, j_op = jp.build_operator(with_bc=False), jp.build_operator()
    assert j_op.ke is not None
    mask = free_mask_from_bcs(n, jp.bcs)
    K_raw = assemble_scipy(pp.mesh, pp.lam, pp.mu, order=pp.quad_order)
    K_bc = assemble_scipy(pp.mesh, pp.lam, pp.mu, order=pp.quad_order,
                          free_mask=mask)
    raw = op_raw.matvec_raw(torch.from_numpy(u)).numpy()
    _close(raw, np.asarray(j_raw.matvec_raw(jnp.asarray(u)))[:n])
    _close(raw, K_raw @ u)
    masked = op.matvec(torch.from_numpy(u)).numpy()
    _close(masked, np.asarray(j_op.matvec(jnp.asarray(u)))[:n])
    _close(masked, K_bc @ u)
    diag = op.diagonal().numpy()
    _close(diag, np.asarray(j_op.diagonal())[:n])
    _close(diag, K_bc.diagonal())
    # the stored Ke batch is the JAX package's
    _close(op.ke.numpy(), np.asarray(j_op.ke))


def test_stored_and_otf_operators_agree(stored_pair):
    _, pp = stored_pair
    u = torch.from_numpy(np.random.default_rng(1).standard_normal(pp.n_dofs))
    stored = pp.build_operator()
    pp.mode = "otf"
    try:
        otf = pp.build_operator()
    finally:
        pp.mode = "stored"
    assert otf.ke is None
    _close(stored.matvec(u).numpy(), otf.matvec(u).numpy())
    _close(stored.node_blocks_raw().numpy(), otf.node_blocks_raw().numpy())
    assert float(stored.energy(u)) == pytest.approx(float(otf.energy(u)),
                                                    rel=1e-12)


def test_with_material_equals_a_fresh_build(stored_pair):
    jp, pp = stored_pair
    rng = np.random.default_rng(2)
    C = pp.mesh.n_cells
    lam2, mu2 = rng.uniform(0.1, 3.0, C), rng.uniform(0.1, 3.0, C)
    u = torch.from_numpy(rng.standard_normal(pp.n_dofs))
    for mode in ("stored", "otf"):
        pp.mode = mode
        try:
            swapped = pp.build_operator().with_material(
                torch.from_numpy(lam2), torch.from_numpy(mu2))
            pp.lam, pp.mu, old = lam2, mu2, (pp.lam, pp.mu)
            fresh = pp.build_operator()
        finally:
            pp.mode = "stored"
            pp.lam, pp.mu = old
        assert (swapped.ke is None) == (fresh.ke is None) == (mode == "otf")
        assert swapped.free_mask is not None
        _close(swapped.matvec(u).numpy(), fresh.matvec(u).numpy())
        _close(swapped.diagonal().numpy(), fresh.diagonal().numpy())
        if mode == "stored":
            _close(swapped.ke.numpy(), fresh.ke.numpy())
    # the JAX package's own swap gives the same stored operator
    j_swapped = jp.build_operator().with_material(jnp.asarray(lam2),
                                                  jnp.asarray(mu2))
    pp.lam, pp.mu, old = lam2, mu2, (pp.lam, pp.mu)
    try:
        ours = pp.build_operator().matvec(u).numpy()
    finally:
        pp.lam, pp.mu = old
    _close(ours, np.asarray(j_swapped.matvec(jnp.asarray(u.numpy())))[
        :pp.n_dofs])


def test_stored_cg_solve_equals_otf():
    """A block-Jacobi CG solve on the stored tet10 operator takes the otf
    route's iterations and energy."""
    mesh = tt.generate_grid_tet(6, 2, 2, (0, 0, 0), (6.0, 2.0, 2.0))
    cfg = tt.SolverConfig(method="cg", preconditioner="block_diagonal",
                          tolerance=1e-10, verbose=False)
    out = {}
    for mode in ("otf", "stored"):
        p = tt.setup_problem(mesh, interpolation_order=2,
                             dtype=torch.float64, mode=mode, device="cpu")
        tt.assemble_stiffness_matrix(p, *tt.lame_parameters(1.0, 0.3))
        tt.apply_fixed_boundary(p, tt.nodes_at_plane(p.mesh, 0, 0.0))
        tt.apply_force(p, tt.nodes_at_plane(p.mesh, 0, 6.0), [0, 0, -1.0])
        out[mode] = tt.solve_system(p, cfg)
    assert out["stored"].method == "cg" and out["stored"].converged
    assert abs(out["stored"].iterations - out["otf"].iterations) <= 2
    assert out["stored"].energy == pytest.approx(out["otf"].energy,
                                                 rel=1e-10)


def test_operator_refuses_a_bad_mode_or_rule():
    mesh = tt.generate_grid_tet(2, 1, 1).to_quadratic()
    dm = mesh.device(dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="mode"):
        StiffnessOperator.build(dm, 1.0, 1.0, mode="assembled")
    # the tet10 apply kernel implements the 4-point rule; order 3 gives
    # the same rule, order 1 another
    StiffnessOperator.build(dm, 1.0, 1.0, order=3)
    with pytest.raises(ValueError, match="4-point"):
        StiffnessOperator.build(dm, 1.0, 1.0, order=1)
    # stored mode takes any rule through the plain Ke route
    op = StiffnessOperator.build(dm, 1.0, 1.0, mode="stored", order=1)
    assert op.ke.shape == (mesh.n_cells, 30, 30)
    hexes = tt.generate_grid_hex(2, 1, 1).device(dtype=torch.float64,
                                                 device="cpu")
    with pytest.raises(ValueError, match="8-point"):
        StiffnessOperator.build(hexes, 1.0, 1.0, order=3)
