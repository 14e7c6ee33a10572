"""The port's structured multigrid against the JAX package's, on the CPU
in float64 unless stated: the same seeded inputs go through both.

- transfer tables, mask propagation, the coarse eigencut and the host
  build functions: equal arrays (they are the same NumPy code, so bit for bit
  where no device value enters);
- the hierarchy of ``build_structured_multigrid(16, 8, 4, ...)``
  (tests/test_multigrid.py's box): per-level masks, smoother blocks,
  transfer tables and the dense coarse inverse to 1e-12; one V-cycle to
  1e-10 for both smoothers; V-cycle symmetry;
- MG-PCG on that box: the JAX package's iteration count and residual
  history, the host direct oracle, a float32 hierarchy.

The slice as a whole, through ``solve_system``, is held to the JAX
package in tests/test_torch_multigrid_solve.py.

Tolerances are stated where they are used.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topopteval_tpu.fem import multigrid as jax_mg
from topopteval_tpu.fem.solvers import cg as jax_cg
from topopteval_tpu.materials import lame_parameters
import topopteval_tpu_torch as tt
from topopteval_tpu_torch.fem import multigrid as port_mg
from topopteval_tpu_torch.fem.operator import assemble_scipy
from topopteval_tpu_torch.fem.solvers import cg, direct_solve

tt.set_verbosity(False)
# these tests work on small tensors: one intra-op thread each, so that
# test processes running side by side do not fight over the cores (torch's
# thread pool spins at its barriers when the machine is oversubscribed)
torch.set_num_threads(1)

LAM, MU = lame_parameters(1.0, 0.3)
BOX = (16, 8, 4, (0, 0, 0), (16.0, 8.0, 4.0))


# ---------------------------------------------------------------------------
# tables and host build functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dims", [(4, 2, 2), (6, 4, 2)])
def test_transfer_tables_and_mask_propagation_equal_jax(dims):
    ours = port_mg.build_transfer_tables(*dims)
    ref = jax_mg.build_transfer_tables(*dims)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    parents, weights, inc = ours
    fixed = np.random.default_rng(0).random((parents.shape[0], 3)) < 0.2
    np.testing.assert_array_equal(
        port_mg.propagate_fixed(parents, weights, fixed, inc.shape[0]),
        jax_mg.propagate_fixed(parents, weights, fixed, inc.shape[0]))


def test_transfer_transpose_property_and_partition_of_unity():
    parents, weights, inc = port_mg.build_transfer_tables(4, 4, 2)
    t = port_mg.Transfer.from_tables(parents, weights, inc, torch.float64,
                                     "cpu")
    ref = jax_mg.Transfer(jnp.asarray(parents), jnp.asarray(weights),
                          jnp.asarray(inc))
    rng = np.random.default_rng(0)
    uc = rng.standard_normal((inc.shape[0], 3))
    rf = rng.standard_normal((parents.shape[0], 3))
    # <P uc, rf> == <uc, P^T rf>: float64 sums in two orders
    lhs = float(torch.sum(t.prolong(torch.tensor(uc)) * torch.tensor(rf)))
    rhs = float(torch.sum(torch.tensor(uc) * t.restrict(torch.tensor(rf))))
    np.testing.assert_allclose(lhs, rhs, rtol=1e-12)
    np.testing.assert_allclose(
        t.prolong(torch.ones((inc.shape[0], 3), dtype=torch.float64)).numpy(),
        1.0, rtol=1e-14)
    # and both equal the JAX transfer (same gathers, float64): 1e-14
    np.testing.assert_allclose(t.prolong(torch.tensor(uc)).numpy(),
                               np.asarray(ref.prolong(jnp.asarray(uc))),
                               rtol=1e-14, atol=1e-14)
    np.testing.assert_allclose(t.restrict(torch.tensor(rf)).numpy(),
                               np.asarray(ref.restrict(jnp.asarray(rf))),
                               rtol=1e-14, atol=1e-14)


@pytest.mark.parametrize("case", ["low_physics", "continuum", "full_rank",
                                  "negative_and_zero"])
def test_coarse_pinv_weights_equal_jax(case):
    """The spectra of tests/test_multigrid.py's eigencut cases."""
    evals = {
        "low_physics": np.concatenate([
            np.full(168, 1e-16), [2e-8, 6e-7], np.linspace(1e-3, 1.0, 50)])
        * 1.0e4,
        "continuum": np.concatenate([np.logspace(-14, -6.2, 40),
                                     np.linspace(1e-4, 1.0, 20)]),
        "full_rank": np.concatenate([[3e-8, 4e-7],
                                     np.linspace(1e-4, 1.0, 20)]),
        "negative_and_zero": np.array([-1e-3, 0.0, 1e-16, 0.5, 1.0]),
    }[case]
    for ours_dt, ref_dt in ((torch.float32, jnp.float32),
                            (torch.float64, jnp.float64)):
        np.testing.assert_array_equal(
            port_mg.coarse_pinv_weights(evals, ours_dt),
            jax_mg.coarse_pinv_weights(evals, ref_dt))


def test_host_build_functions_equal_jax_and_port_device_paths():
    from topopteval_tpu.fem.structured import \
        StructuredStiffnessOperator as JaxStructured
    from topopteval_tpu_torch.fem.solvers import block_jacobi_preconditioner
    nx, ny, nz = 6, 4, 2
    lo, hi = (0.0, 0.0, 0.0), (6.0, 4.0, 2.0)
    mesh = tt.generate_grid_tet(nx, ny, nz, lo, hi)
    mask = tt.free_mask_from_bcs(
        mesh.n_dofs, [tt.DirichletBC.fixed(tt.nodes_at_plane(mesh, 0, 0.0))])
    esc = np.random.default_rng(1).uniform(0.2, 1.0, (nz, ny, nx))
    ours = tt.StructuredStiffnessOperator.build(
        nx, ny, nz, lo, hi, LAM, MU, free_mask=mask, escale=esc,
        dtype=torch.float64, device="cpu")
    ref = JaxStructured.build(nx, ny, nz, lo, hi, LAM, MU, free_mask=mask,
                              escale=esc, dtype=jnp.float64)
    # the same NumPy code on the same inputs: 1e-14
    blocks = port_mg._host_node_blocks_structured(ours)
    np.testing.assert_allclose(blocks,
                               jax_mg._host_node_blocks_structured(ref),
                               rtol=1e-14, atol=1e-14)
    np.testing.assert_array_equal(port_mg._host_block_jacobi(blocks, mask),
                                  jax_mg._host_block_jacobi(blocks, mask))
    e_t = np.repeat(esc.transpose(2, 1, 0).reshape(-1), 6)
    K = port_mg._host_dense_constrained_matrix(mesh, LAM * e_t, MU * e_t,
                                               mask)
    np.testing.assert_array_equal(
        K, jax_mg._host_dense_constrained_matrix(mesh, LAM * e_t, MU * e_t,
                                                 mask))
    # ... and the host twins equal the port's tensor paths (float64 in
    # another summation order: the JAX twin test's tolerances)
    np.testing.assert_allclose(blocks, ours.node_blocks_raw().numpy(),
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(
        port_mg._host_block_jacobi(blocks, mask),
        block_jacobi_preconditioner(ours.node_blocks_raw(),
                                    ours.free_mask).numpy(),
        rtol=1e-10, atol=1e-12)
    v = torch.tensor(np.random.default_rng(3).standard_normal(mesh.n_dofs))
    np.testing.assert_allclose(K @ v.numpy(), ours.matvec(v).numpy(),
                               rtol=1e-10, atol=1e-12)


# ---------------------------------------------------------------------------
# the hierarchy of the 16x8x4 box
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def hierarchies():
    """(JAX (mesh, op, mg), port (mesh, op, mg), tip load f) in float64."""
    ref = jax_mg.build_structured_multigrid(*BOX, LAM, MU, dtype=jnp.float64)
    ours = port_mg.build_structured_multigrid(*BOX, LAM, MU,
                                              dtype=torch.float64,
                                              device="cpu")
    mesh = ours[0]
    tip = tt.nodes_at_plane(mesh, 0, 16.0)
    f = np.zeros(mesh.n_dofs)
    f[tip * 3 + 2] = -1.0 / tip.size
    return ref, ours, f * ours[1].free_mask.numpy()


def test_hierarchy_arrays_equal_jax(hierarchies):
    (_, ref_op, ref), (_, our_op, ours), _ = hierarchies
    assert len(ours.levels) == len(ref.levels) == 2
    assert (ours.omega, ours.nu, ours.smoother) == (ref.omega, ref.nu,
                                                    ref.smoother)
    assert our_op is ours.levels[0].op
    for a, b in zip(ours.levels, ref.levels):
        assert a.op.dims == b.op.dims
        np.testing.assert_array_equal(a.op.free_mask.numpy(),
                                      np.asarray(b.op.free_mask))
        np.testing.assert_array_equal(a.transfer.parents.numpy(),
                                      np.asarray(b.transfer.parents))
        np.testing.assert_array_equal(a.transfer.incidence.numpy(),
                                      np.asarray(b.transfer.incidence))
        np.testing.assert_array_equal(a.transfer.weights.numpy(),
                                      np.asarray(b.transfer.weights))
        # host float64 builds of the same blocks: 1e-12
        np.testing.assert_allclose(a.binv.numpy(), np.asarray(b.binv),
                                   rtol=1e-12, atol=1e-12)
        assert a.lam_max is None and b.lam_max is None
    scale = float(np.abs(np.asarray(ref.coarse_inv)).max())
    np.testing.assert_allclose(ours.coarse_inv.numpy(),
                               np.asarray(ref.coarse_inv), rtol=0,
                               atol=1e-12 * scale)


@pytest.mark.parametrize("smoother", ["jacobi", "chebyshev"])
def test_vcycle_equals_jax(hierarchies, smoother):
    """One V-cycle on a seeded residual.  Chebyshev needs a per-level
    lambda_max, which the structured build does not set: both sides get
    2.2, a value above the measured spectrum of these levels."""
    (_, _, ref), (_, op, ours), _ = hierarchies
    if smoother == "chebyshev":
        ref = dataclasses.replace(ref, smoother="chebyshev", levels=tuple(
            dataclasses.replace(L, lam_max=2.2) for L in ref.levels))
        ours = dataclasses.replace(ours, smoother="chebyshev", levels=tuple(
            dataclasses.replace(L, lam_max=2.2) for L in ours.levels))
    r = np.random.default_rng(2).standard_normal(op.n_dofs) \
        * op.free_mask.numpy()
    a = np.asarray(ref.apply(jnp.asarray(r)))
    b = ours.apply(torch.tensor(r)).numpy()
    # the same float64 arithmetic in other summation orders, through ~10
    # matvecs and a dense 675x675 product: 1e-10 of the largest entry
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-10 * np.abs(a).max())


def test_vcycle_is_symmetric(hierarchies):
    _, (_, op, mg), _ = hierarchies
    rng = np.random.default_rng(2)
    r1 = torch.tensor(rng.standard_normal(op.n_dofs)) * op.free_mask
    r2 = torch.tensor(rng.standard_normal(op.n_dofs)) * op.free_mask
    a = float(torch.dot(mg.apply(r1), r2))
    b = float(torch.dot(r1, mg.apply(r2)))
    np.testing.assert_allclose(a, b, rtol=1e-10)


def test_max_coarse_dofs_raises_as_jax():
    with pytest.raises(ValueError, match="max_coarse_dofs"):
        port_mg.build_structured_multigrid(
            25, 9, 5, (0, 0, 0), (25.0, 9.0, 5.0), LAM, MU,
            dtype=torch.float64, device="cpu")


def test_general_operator_branch_builds_the_same_preconditioner(hierarchies):
    """``operator="general"`` rides the gather operator on every level and
    assembles the coarse matrix with scipy: the same hierarchy by another
    route, so one V-cycle agrees to 1e-10."""
    _, (_, op, mg), _ = hierarchies
    _, gop, gmg = port_mg.build_structured_multigrid(
        *BOX, LAM, MU, dtype=torch.float64, device="cpu", operator="general")
    r = torch.tensor(np.random.default_rng(5).standard_normal(op.n_dofs)) \
        * op.free_mask
    a, b = mg.apply(r), gmg.apply(r)
    assert float((a - b).abs().max()) <= 1e-10 * float(a.abs().max())
    assert float((gop.matvec(r) - op.matvec(r)).abs().max()) <= 1e-12


# ---------------------------------------------------------------------------
# MG-PCG on the 16x8x4 box
# ---------------------------------------------------------------------------


def test_mg_pcg_matches_jax_iterations_history_and_oracle(hierarchies):
    (_, ref_op, ref_mg), (mesh, op, mg), f = hierarchies
    ref = jax_cg(ref_op, jnp.asarray(f), M=ref_mg, tol=1e-10, maxiter=200,
                 record_history=True)
    ours = cg(op, torch.tensor(f), M=mg, tol=1e-10, maxiter=200,
              record_history=True)
    assert ours.converged and bool(ref.converged)
    # same recurrence, same stopping rule, same preconditioner: the SAME
    # count, not a bound
    assert ours.niter == int(ref.niter)
    assert ours.niter < 60
    # the residual falls ten decades; rounding differences grow with the
    # iteration, so the histories agree to 1e-6 relative, not to ulps
    np.testing.assert_allclose(
        ours.history, np.asarray(ref.history)[:ours.niter + 1], rtol=1e-6)
    K = assemble_scipy(mesh, LAM, MU, free_mask=op.free_mask.numpy())
    u_o = direct_solve(K, f)
    err = np.linalg.norm(ours.x.numpy() - u_o) / np.linalg.norm(u_o)
    assert err < 1e-7, f"u err {err:.2e}"      # the JAX test's own bound


def test_mg_pcg_float32_hierarchy_converges():
    """A float32 hierarchy reaches the float32-floor tolerance 1e-5 in
    under 60 iterations (tests/test_multigrid.py:87-99)."""
    mesh, op, mg = port_mg.build_structured_multigrid(
        *BOX, LAM, MU, dtype=torch.float32, device="cpu")
    tip = tt.nodes_at_plane(mesh, 0, 16.0)
    f = np.zeros(mesh.n_dofs)
    f[tip * 3 + 2] = -1.0 / tip.size
    res = cg(op, torch.tensor(f, dtype=torch.float32) * op.free_mask, M=mg,
             tol=1e-5, maxiter=150)
    assert res.converged and res.niter < 60
