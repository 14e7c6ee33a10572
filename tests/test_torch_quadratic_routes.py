"""Quadratic elements on the port's other routes, on the CPU in float64.

- The block-ELL multigrid hierarchy of the tet10 scale-2 beam (2,400
  tet10 elements, 13,005 DOFs; ``generate_grid_tet(25, 8, 2)`` made
  quadratic) built by both packages, the JAX package on its NumPy/scipy
  host build: the same RCM permutation, level sizes, fine block count,
  masks, Chebyshev bounds and coarse pseudo-inverse, and operators and
  transfers that agree on seeded vectors; then the port's multigrid solve
  of that beam against ``tet10_beam_scale_2``.
- A small hex20 box (the 3x3x3 default rule, no kernel in either
  package) solved with block-Jacobi CG against the port's float64 host
  direct solve to 1e-8, as tests/test_hex20.py:156 does for the JAX
  package, in both operator modes, and its result exported (VTK type 25)
  and read back.

Tolerances: the hierarchy's arrays to 1e-10 of their largest entry and
transfers to 1e-12 (as tests/test_torch_bell.py); energies to 1e-8.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import threadpoolctl
import torch

from topopteval_tpu.fem import bell as jax_bell
from topopteval_tpu.fem.bc import DirichletBC as JaxDirichletBC
from topopteval_tpu.fem.bc import free_mask_from_bcs, nodes_at_plane
from topopteval_tpu.io import native as jax_native
from topopteval_tpu.materials import lame_parameters
from topopteval_tpu.models.beams import generate_grid_tet
import topopteval_tpu_torch as tt
from topopteval_tpu_torch.io import native as port_native
from topopteval_tpu_torch.fem import bell as port_bell

tt.set_verbosity(False)
# these tests work on small tensors: one intra-op thread each, so that
# test processes running side by side do not fight over the cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAM, MU = lame_parameters(1.0, 0.3)


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    with threadpoolctl.threadpool_limits(1):
        yield


def _close(actual, desired, rtol):
    desired = np.asarray(desired)
    np.testing.assert_allclose(np.asarray(actual), desired, rtol=rtol,
                               atol=rtol * np.abs(desired).max())


def test_tet10_block_ell_hierarchy_equals_jax(monkeypatch):
    monkeypatch.setattr(jax_native, "_LIB", None)       # NumPy/scipy build
    monkeypatch.setattr(jax_native, "_TRIED", True)
    monkeypatch.setattr(port_native, "_ENABLED", False)  # in both packages
    monkeypatch.setenv("TOPOPT_MG_CACHE_DIR", "off")
    mesh = generate_grid_tet(25, 8, 2, (0, 0, 0), (60.0, 20.0, 4.0)
                             ).to_quadratic()
    assert mesh.n_dofs == 13_005
    mask = free_mask_from_bcs(mesh.n_dofs, [JaxDirichletBC.fixed(
        nodes_at_plane(mesh, 0, 0.0))])
    kw = dict(order=2, max_coarse_dofs=1500)
    sys_j, mg_j, _ = jax_bell.build_bell_multigrid(
        mesh, LAM, MU, free_mask=mask, dtype=jnp.float64, **kw)
    pmesh = tt.Mesh(mesh.coords, mesh.conn, "tet10")
    sys_p, mg_p, info = port_bell.build_bell_multigrid(
        pmesh, LAM, MU, free_mask=mask, dtype=torch.float64, device="cpu",
        **kw)
    np.testing.assert_array_equal(sys_p.perm, sys_j.perm)
    assert info["fine_blocks"] == len(sys_j.host_bsr["indices"])
    assert len(mg_p.levels) == len(mg_j.levels) == info["n_levels"] - 1
    # real node counts of the three levels (the padded sizes are compared
    # with the JAX package's level by level below)
    assert info["level_nodes"] == [4335, 1023, 192]
    rng = np.random.default_rng(10)
    for Lp, Lj in zip(mg_p.levels, mg_j.levels):
        assert Lp.op.n_dofs == Lj.op.n_dofs
        np.testing.assert_array_equal(Lp.op.free_mask.numpy(),
                                      np.asarray(Lj.op.free_mask))
        np.testing.assert_allclose(Lp.lam_max, Lj.lam_max, rtol=1e-12)
        _close(Lp.binv9.numpy(), Lj.binv9, 1e-10)
        u = rng.standard_normal(Lp.op.n_dofs)
        _close(Lp.op.matvec(torch.as_tensor(u)).numpy(),
               Lj.op.matvec(jnp.asarray(u)), 1e-10)
        uc = rng.standard_normal((3, Lp.transfer.P.n_cols))
        _close(Lp.transfer.prolong(torch.as_tensor(uc)).numpy(),
               Lj.transfer.prolong(jnp.asarray(uc)), 1e-12)
    assert mg_p.coarse_inv.shape == mg_j.coarse_inv.shape
    _close(mg_p.coarse_inv.numpy(), mg_j.coarse_inv, 1e-10)
    u = rng.standard_normal(sys_p.n_dofs)
    _close(sys_p.matvec(torch.as_tensor(u)).numpy(),
           sys_j.matvec(jnp.asarray(u)), 1e-10)


def test_tet10_multigrid_solve_meets_oracle(monkeypatch):
    """The tet10 beam on the block-ELL route (the mesh carries no
    ``structured_info`` once quadratic), float64."""
    monkeypatch.setenv("TOPOPT_MG_CACHE_DIR", "off")
    mesh = tt.generate_grid_tet(25, 8, 2, (0, 0, 0), (60.0, 20.0, 4.0))
    p = tt.setup_problem(mesh, interpolation_order=2, dtype=torch.float64,
                         device="cpu")
    assert p.mesh.structured_info is None
    tt.assemble_stiffness_matrix(p, LAM, MU)
    tt.apply_fixed_boundary(p, tt.nodes_at_plane(p.mesh, 0, 0.0))
    tt.apply_force(p, tt.nodes_at_plane(p.mesh, 0, 60.0), [0.0, 0.0, -1.0])
    r = tt.solve_system(p, tt.SolverConfig(
        method="cg", preconditioner="multigrid", tolerance=1e-10,
        verbose=False))
    assert r.method == "cg" and r.converged
    with open(os.path.join(REPO, "data", "oracle_energies.json")) as fh:
        oracle = json.load(fh)["tet10_beam_scale_2"]
    assert abs(r.energy - oracle) <= 1e-8 * oracle
    assert isinstance(tt.api._get_multigrid(p)[0], port_bell.BellSystem)


@pytest.mark.parametrize("mode", ["otf", "stored"])
def test_hex20_cg_matches_direct(mode, tmp_path):
    mesh = tt.generate_grid_hex(4, 2, 2, (0, 0, 0), (8.0, 2.0, 2.0))
    p = tt.setup_problem(mesh, interpolation_order=2, dtype=torch.float64,
                         mode=mode, device="cpu")
    assert p.mesh.element_type == "hex20" and p.quad_order == 3
    tt.assemble_stiffness_matrix(p, *tt.create_material_model(1.0, 0.3))
    tt.apply_fixed_boundary(p, tt.nodes_at_plane(p.mesh, 0, 0.0))
    tt.apply_force(p, tt.nodes_at_plane(p.mesh, 0, 8.0), [0, 0, -1.0])
    rd = tt.solve_system(p, tt.SolverConfig(method="direct"))
    rc = tt.solve_system(p, tt.SolverConfig(
        method="cg", preconditioner="block_diagonal", tolerance=1e-10,
        max_iterations=5000, verbose=False))
    assert rd.method == "direct" and rc.method == "cg" and rc.converged
    assert abs(rc.energy - rd.energy) <= 1e-8 * abs(rd.energy)
    assert rc.stress_qp.shape == (mesh.n_cells, 27, 3, 3)
    assert np.all(np.isfinite(rc.von_mises))
    # exported as VTK type 25 and read back
    path = tt.export_results(rc, p, str(tmp_path / "hex20"))
    back = tt.read_vtu_mesh(path)
    assert back.element_type == "hex20"
    np.testing.assert_array_equal(back.conn, p.mesh.conn)
    np.testing.assert_array_equal(back.coords, p.mesh.coords)
