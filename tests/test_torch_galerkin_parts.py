"""Parts of the port's Galerkin voxel multigrid against the JAX package's,
on the CPU in float64 (float32 where stated):

- ``galerkin_voxel_operator`` on the imported Tet4 cantilever at dims
  (10, 4, 2): the JAX package's probed operator (1e-12 of its largest
  entry) and the explicit Mc P^T Mf K Mf P Mc (1e-10, as
  tests/test_unstructured_mg.py:107-137), and the updated mask;
- ``EllTransfer`` (B9b's plain version) against the gather ``Transfer``
  and the JAX package's ``Transfer(chunked=True)``, on the 2:1 tables and
  on the fixture's voxel embedding (1e-13 prolongation, 1e-12
  restriction: the sums run in column order here, in slot or incidence
  order there), and P^T as the adjoint of P;
- ``HostFineOperator.node_blocks``, its float32-Ke ``matvec`` and
  ``power_lambda_max`` against the JAX package's ``_HostFineOperator``
  (the same NumPy code: 1e-12, and 1e-10 for lambda_max);
- ``estimate_smoother_lambda_max`` against the dense lambda_max(B^-1 A);
- a hierarchy with a host RAP level (a 16x4x4 box without
  ``structured_info``, coarsest at most 200 DOFs): every level's operator,
  mask, block inverse, lambda_max and transfer, the coarse inverse, one
  V-cycle and the MG-PCG iteration count.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import threadpoolctl
import torch

from topopteval_tpu.api import import_mesh as jax_import_mesh
from topopteval_tpu.fem import multigrid as jax_mg
from topopteval_tpu.fem.operator import StiffnessOperator as JaxOperator
from topopteval_tpu.fem.solvers import cg as jax_cg
from topopteval_tpu.models.beams import generate_grid_tet as jax_grid_tet
import topopteval_tpu_torch as tt
from topopteval_tpu_torch.fem import multigrid as port_mg
from topopteval_tpu_torch.fem.host_operator import HostFineOperator
from topopteval_tpu_torch.fem.operator import (StiffnessOperator,
                                               assemble_scipy)
from topopteval_tpu_torch.fem.solvers import (block_jacobi_preconditioner,
                                              cg)

tt.set_verbosity(False)
torch.set_num_threads(1)

LAM, MU = tt.lame_parameters(1.0, 0.3)


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    with threadpoolctl.threadpool_limits(1):
        yield


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _clamped(mesh, x0=0.0):
    return tt.free_mask_from_bcs(mesh.n_dofs, [tt.DirichletBC.fixed(
        tt.nodes_at_plane(mesh, 0, x0, tol=1e-6))])


def test_galerkin_probe_matches_jax_and_explicit_rap(beam_tet_path):
    mesh = tt.import_mesh(beam_tet_path)
    jmesh = jax_import_mesh(beam_tet_path)
    mask = _clamped(mesh)
    lo, hi = mesh.bounding_box()
    dims = (10, 4, 2)
    N_c = 11 * 5 * 3
    parents, weights, inc = port_mg.build_voxel_transfer(mesh.coords, lo,
                                                         hi, dims)
    fixed_c = port_mg.propagate_fixed(parents, weights,
                                      mask.reshape(-1, 3) == 0, N_c)
    mask_c = np.where(fixed_c, 0.0, 1.0).reshape(-1)
    op = StiffnessOperator.build(
        mesh.device(dtype=torch.float64, device="cpu"), LAM, MU,
        free_mask=torch.as_tensor(mask))
    ell, mask_c2 = port_mg.galerkin_voxel_operator(
        op, port_mg.EllTransfer.from_tables(parents, weights, N_c,
                                            torch.float64, "cpu"),
        mask_c, dims, dtype=torch.float64)
    A_probe = ell.to_scipy_bsr().toarray()

    jop = JaxOperator.build(jmesh.device(dtype=jnp.float64),
                            np.full(jmesh.n_cells, LAM),
                            np.full(jmesh.n_cells, MU),
                            free_mask=jnp.asarray(mask, jnp.float64))
    jtr = jax_mg.Transfer(jnp.asarray(parents),
                          jnp.asarray(weights, jnp.float64),
                          jnp.asarray(inc))
    jell, jmask_c2 = jax_mg.galerkin_voxel_operator(
        jop, jtr, mask_c, dims, dtype=jnp.float64)
    np.testing.assert_array_equal(mask_c2, jmask_c2)
    scale = np.abs(A_probe).max()
    assert np.abs(A_probe - jell.to_scipy_bsr().toarray()).max() \
        <= 1e-12 * scale

    K = assemble_scipy(mesh, LAM, MU, free_mask=mask)
    live = weights > 0
    rows = np.repeat(np.arange(mesh.n_nodes), 8).reshape(-1, 8)[live]
    P = sp.coo_matrix((weights[live], (rows, parents[live])),
                      shape=(mesh.n_nodes, N_c)).tocsr()
    P_dof = sp.kron(P, sp.eye(3), format="csr")
    Mf, Mc = sp.diags(mask), sp.diags(mask_c)
    A_exact = (Mc @ P_dof.T @ Mf @ K @ Mf @ P_dof @ Mc).toarray()
    np.testing.assert_allclose(A_probe, A_exact,
                               atol=1e-10 * np.abs(A_exact).max())


def _transfer_cases(beam_tet_path):
    p, w, inc = port_mg.build_transfer_tables(6, 4, 2)
    yield "tables_6x4x2", p, w, inc, inc.shape[0]
    mesh = tt.import_mesh(beam_tet_path)
    lo, hi = mesh.bounding_box()
    p, w, inc = port_mg.build_voxel_transfer(mesh.coords, lo, hi,
                                             (25, 8, 2))
    yield "voxel_fixture", p, w, inc, inc.shape[0]


def test_ell_transfer_matches_gather_transfer_and_jax(beam_tet_path):
    for label, parents, weights, inc, n_c in _transfer_cases(beam_tet_path):
        ell_t = port_mg.EllTransfer.from_tables(parents, weights, n_c,
                                                torch.float64, "cpu")
        gather = port_mg.Transfer.from_tables(parents, weights, inc,
                                              torch.float64, "cpu")
        jt = jax_mg.Transfer(jnp.asarray(parents), jnp.asarray(weights),
                             jnp.asarray(inc), chunked=True)
        rng = np.random.default_rng(0)
        uc = rng.standard_normal((n_c, 3))
        rf = rng.standard_normal((parents.shape[0], 3))
        pro = ell_t.prolong(torch.as_tensor(uc))
        res = ell_t.restrict(torch.as_tensor(rf))
        for ref_p, ref_r in ((gather.prolong(torch.as_tensor(uc)).numpy(),
                              gather.restrict(torch.as_tensor(rf)).numpy()),
                             (np.asarray(jt.prolong(jnp.asarray(uc))),
                              np.asarray(jt.restrict(jnp.asarray(rf))))):
            np.testing.assert_allclose(pro.numpy(), ref_p, rtol=1e-13,
                                       atol=1e-13, err_msg=label)
            np.testing.assert_allclose(res.numpy(), ref_r, rtol=1e-12,
                                       atol=1e-12, err_msg=label)
        lhs = float(torch.sum(pro * torch.as_tensor(rf)))
        rhs = float(torch.sum(torch.as_tensor(uc) * res))
        assert abs(lhs - rhs) <= 1e-12 * abs(lhs), label


def test_host_fine_operator_matches_jax():
    """Per-element materials on a small box (tests/test_unstructured_mg
    .py:329-358)."""
    jmesh = jax_grid_tet(5, 3, 2, (0, 0, 0), (2.5, 1.5, 1.0))
    mesh = tt.generate_grid_tet(5, 3, 2, (0, 0, 0), (2.5, 1.5, 1.0))
    mask = _clamped(mesh)
    rng = np.random.default_rng(1)
    lam_e = rng.uniform(0.2, 1.0, mesh.n_cells)
    mu_e = rng.uniform(0.2, 1.0, mesh.n_cells)
    host = HostFineOperator(mesh, lam_e, mu_e, mask, 2)
    ref = jax_mg._HostFineOperator(jmesh, lam_e, mu_e, mask, 2)
    blocks = host.node_blocks()
    np.testing.assert_allclose(blocks, ref.node_blocks(), rtol=1e-12,
                               atol=1e-12)
    op = StiffnessOperator.build(
        mesh.device(dtype=torch.float64, device="cpu"), lam_e, mu_e,
        free_mask=torch.as_tensor(mask))
    np.testing.assert_allclose(blocks, op.node_blocks_raw().numpy(),
                               rtol=1e-12, atol=1e-12)
    u = rng.standard_normal(mesh.n_dofs)
    np.testing.assert_allclose(host.matvec(u), ref.matvec(u), rtol=1e-12,
                               atol=1e-12)
    # the float32 Ke batch: float32-level agreement with the exact matvec
    np.testing.assert_allclose(host.matvec(u), host.matvec64(u), rtol=1e-4,
                               atol=1e-6)
    binv = port_mg._host_block_jacobi(blocks, mask)
    lam = host.power_lambda_max(binv)
    assert abs(lam - ref.power_lambda_max(binv)) <= 1e-10 * lam


def test_estimate_smoother_lambda_max_bounds_the_spectrum():
    mesh = tt.generate_grid_tet(4, 2, 2, (0, 0, 0), (4.0, 2.0, 2.0))
    mask = _clamped(mesh)
    op = StiffnessOperator.build(
        mesh.device(dtype=torch.float64, device="cpu"), LAM, MU,
        free_mask=torch.as_tensor(mask))
    binv = block_jacobi_preconditioner(op.node_blocks_raw(), op.free_mask)
    lam = port_mg.estimate_smoother_lambda_max(op, binv)
    assert lam == port_mg.estimate_smoother_lambda_max(op, binv)  # seeded
    K = assemble_scipy(mesh, LAM, MU, free_mask=mask).toarray()
    B = sp.block_diag(list(binv.numpy())).toarray()
    true = float(np.max(np.abs(np.linalg.eigvals(B @ K))))
    assert 0.9 * true <= lam <= true * (1 + 1e-12)


def test_hierarchy_with_rap_levels_equals_jax():
    dims, box = (16, 4, 4), (16.0, 4.0, 4.0)
    mesh = tt.generate_grid_tet(*dims, (0, 0, 0), box)
    jmesh = jax_grid_tet(*dims, (0, 0, 0), box)
    mesh.structured_info = jmesh.structured_info = None
    mask = _clamped(mesh)
    info = {}
    op, mg = port_mg.build_unstructured_multigrid(
        mesh, LAM, MU, free_mask=mask, dtype=torch.float64,
        max_coarse_dofs=200, device="cpu", info=info)
    jop, jmg = jax_mg.build_unstructured_multigrid(
        jmesh, LAM, MU, free_mask=mask, dtype=jnp.float64,
        max_coarse_dofs=200)
    assert info["lattice"] == (10, 2, 2) and info["voxel_levels"] == 2
    assert info["level_nodes"] == [425, 99, 24]
    assert len(mg.levels) == len(jmg.levels) == 2
    rng = np.random.default_rng(3)
    for li, (L, J) in enumerate(zip(mg.levels, jmg.levels)):
        np.testing.assert_array_equal(L.op.free_mask.numpy(),
                                      np.asarray(J.op.free_mask))
        assert abs(L.lam_max - J.lam_max) <= 1e-10 * J.lam_max
        assert _rel(L.binv.numpy(), J.binv) <= 1e-12
        if li:      # the probed Galerkin level
            assert _rel(L.op.to_scipy_bsr().toarray(),
                        J.op.to_scipy_bsr().toarray()) <= 1e-12
        n_c = info["level_nodes"][li + 1]
        uc = rng.standard_normal((n_c, 3))
        np.testing.assert_allclose(
            L.transfer.prolong(torch.as_tensor(uc)).numpy(),
            np.asarray(J.transfer.prolong(jnp.asarray(uc))), rtol=1e-13,
            atol=1e-13)
    assert _rel(mg.coarse_inv.numpy(), jmg.coarse_inv) <= 1e-9
    r = rng.standard_normal(op.n_dofs) * mask
    np.testing.assert_allclose(
        mg.apply(torch.as_tensor(r)).numpy(),
        np.asarray(jmg.apply(jnp.asarray(r))), rtol=1e-10,
        atol=1e-10 * np.abs(r).max())
    f = np.zeros(mesh.n_dofs)
    tip = tt.nodes_at_plane(mesh, 0, 16.0)
    f[tip * 3 + 2] = -1.0 / tip.size
    res = cg(op, torch.as_tensor(f) * op.free_mask, M=mg, tol=1e-10,
             maxiter=200)
    jres = jax_cg(jop, jnp.asarray(f) * jop.free_mask, M=jmg, tol=1e-10,
                  maxiter=200)
    assert res.converged and res.niter == int(jres.niter)
