"""The port's monolithic block-ELL build and its dispatch against the JAX
package, on the CPU in float64 unless stated.

- ``_build_bell_multigrid_legacy`` on a 12x4x4 tet box and on the SIMP
  Hex8 fixture equals the JAX package's: the JAX hierarchy is written by
  its ``save_hierarchy`` and read into the port's layout by
  ``bell_from_numpy``, then compared array for array (permutation, every
  level's block-CSR, masks, block inverses, Chebyshev bounds, transfers,
  the coarse pseudo-inverse, the fp64 host twin), once with the host
  library off on both sides and once with it on on both sides;
- the three routes into it: nu = 0 (lam = 0) by dispatch in both packages,
  the skeleton byte budget by keyword, and a skeleton mismatch (the
  library's RAP leaving a frozen pattern maps to ``SkeletonMismatch``;
  the dispatch warns and builds the monolithic hierarchy);
- the fp64 MG-PCG iteration count and energy of ``solve_system`` on an
  8x2x2 nu = 0 box equal the JAX package's (the JAX solve costs ~15 s of
  tracing here);
- the skeleton route with the library equals the JAX package's with its
  library.

Tolerances: the two packages run the same NumPy/scipy (or library)
arithmetic, so operators agree to 1e-12 of their largest entry, and the
dense coarse pseudo-inverses (LAPACK eigensolves) to 1e-10.
"""


import jax.numpy as jnp
import numpy as np
import pytest
import threadpoolctl
import torch

from topopteval_tpu import api as jax_api
from topopteval_tpu.config import SolverConfig as JaxSolverConfig
from topopteval_tpu.fem import bell as jax_bell
from topopteval_tpu.fem.bc import DirichletBC as JaxDirichletBC
from topopteval_tpu.fem.bc import free_mask_from_bcs as jax_free_mask
from topopteval_tpu.fem.bc import nodes_at_plane as jax_nodes_at_plane
from topopteval_tpu.io import native as jax_native
from topopteval_tpu.io.vtu import read_cell_density as jax_read_density
from topopteval_tpu.io.vtu import read_vtu_mesh as jax_read_vtu
from topopteval_tpu.materials import SIMPMaterial, lame_parameters
from topopteval_tpu.models import beams as jax_beams
import topopteval_tpu_torch as tt
from topopteval_tpu_torch.fem import bell
from topopteval_tpu_torch.io import native
from topopteval_tpu_torch.utils import terminal

tt.set_verbosity(False)
torch.set_num_threads(1)

LAM, MU = lame_parameters(1.0, 0.3)
MG_KW = dict(method="cg", preconditioner="multigrid", tolerance=1e-10,
             max_iterations=500, verbose=False)


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """The host builds' dense eigensolves and sparse products run in
    OpenBLAS: one thread, so that test processes side by side do not
    fight over the cores."""
    with threadpoolctl.threadpool_limits(1):
        yield


@pytest.fixture(params=["library_off", "library_on"])
def library(request, monkeypatch):
    """Both packages on their NumPy/scipy host build, or both on their
    host libraries."""
    if request.param == "library_off":
        monkeypatch.setattr(jax_native, "_LIB", None)
        monkeypatch.setattr(jax_native, "_TRIED", True)
        with native.use_native(False):
            yield False
    else:
        if jax_native.native_v2() is None:
            pytest.skip("the JAX package's native library is not built")
        assert native.native_available(), native.LOAD_ERROR
        yield True


def _box(nu=0.3, nx=12, ny=4, nz=4):
    mesh = jax_beams.generate_grid_tet(nx, ny, nz, (0, 0, 0),
                                       (float(nx), float(ny), float(nz)))
    mesh.structured_info = None
    lam, mu = lame_parameters(1.0, nu)
    return (mesh, np.full(mesh.n_cells, lam), np.full(mesh.n_cells, mu),
            jax_nodes_at_plane(mesh, 0, 0.0), 4000)


def _hex8_fixture():
    from topopteval_tpu_torch.models.density import VFRAC04_FIXTURE
    mesh = jax_read_vtu(VFRAC04_FIXTURE)
    lam, mu = SIMPMaterial(1.0, 0.3, 1e-8, 3.0).lame(
        jax_read_density(VFRAC04_FIXTURE))
    return (mesh, np.asarray(lam), np.asarray(mu),
            jax_nodes_at_plane(mesh, 0, 0.0), 1500)


def _mask(mesh, fixed):
    return jax_free_mask(mesh.n_dofs, [JaxDirichletBC.fixed(fixed)])


def _port_mesh(mesh):
    return tt.Mesh(mesh.coords, mesh.conn, mesh.element_type)


def _close(ours, ref, rtol):
    ours = np.asarray(ours, np.float64)
    ref = np.asarray(ref, np.float64)
    assert ours.shape == ref.shape
    assert np.abs(ours - ref).max() <= rtol * np.abs(ref).max()


def _csr_equal(A, B, rtol=1e-12):
    np.testing.assert_array_equal(A.indptr.numpy(), B.indptr.numpy())
    np.testing.assert_array_equal(A.cols.numpy(), B.cols.numpy())
    _close(A.vals.numpy(), B.vals.numpy(), rtol)


def _assert_same_hierarchy(port, jax_built, tmp_path):
    """The port's (system, mg) against the JAX package's, carried over by
    save_hierarchy → bell_from_numpy."""
    sys_p, mg_p = port
    path = jax_bell.save_hierarchy(str(tmp_path / "jax.npz"), *jax_built)
    sys_j, mg_j = bell.bell_from_numpy(np.load(path), torch.float64, "cpu")
    np.testing.assert_array_equal(sys_p.perm, sys_j.perm)
    _csr_equal(sys_p.matrix.A, sys_j.matrix.A)
    np.testing.assert_array_equal(sys_p.free_mask.numpy(),
                                  sys_j.free_mask.numpy())
    assert len(mg_p.levels) == len(mg_j.levels)
    for Lp, Lj in zip(mg_p.levels, mg_j.levels):
        _csr_equal(Lp.op.A, Lj.op.A)
        np.testing.assert_array_equal(Lp.op.free_mask.numpy(),
                                      Lj.op.free_mask.numpy())
        _close(Lp.binv9.numpy(), Lj.binv9.numpy(), 1e-12)
        np.testing.assert_allclose(Lp.lam_max, Lj.lam_max, rtol=1e-12)
        _csr_equal(Lp.transfer.P, Lj.transfer.P, 0.0)
        _csr_equal(Lp.transfer.R, Lj.transfer.R, 0.0)
    _close(mg_p.coarse_inv.numpy(), mg_j.coarse_inv.numpy(), 1e-10)
    for key in ("indptr", "indices"):
        np.testing.assert_array_equal(sys_p.host_bsr[key],
                                      sys_j.host_bsr[key])
    _close(np.asarray(sys_p.host_bsr["data"]).reshape(-1),
           np.asarray(sys_j.host_bsr["data"]).reshape(-1), 1e-12)


@pytest.mark.parametrize("case", ["box_12x4x4", "hex8_fixture"])
def test_monolithic_hierarchy_equals_jax(case, library, tmp_path):
    mesh, lam, mu, fixed, max_coarse = (_box() if case == "box_12x4x4"
                                        else _hex8_fixture())
    mask = _mask(mesh, fixed)
    kw = dict(free_mask=mask, max_coarse_dofs=max_coarse, order=2)
    jax_built = jax_bell._build_bell_multigrid_legacy(
        mesh, lam, mu, dtype=jnp.float64, **kw)
    sys_p, mg_p, info = bell._build_bell_multigrid_legacy(
        _port_mesh(mesh), lam, mu, dtype=torch.float64, device="cpu", **kw)
    assert info["route"] == "monolithic" and info["host_library"] is library
    for phase in ("assemble_triplets", "rcm_permute", "rap_chain",
                  "rap_chain_sub", "coarse_pinv"):
        assert phase in info["phases"]
    ft, ft_j = info["fine_transfer"], jax_built[2]["fine_transfer"]
    for key in ("rows", "cols", "w", "n_coarse"):
        np.testing.assert_array_equal(ft[key], ft_j[key])
    _assert_same_hierarchy((sys_p, mg_p), jax_built, tmp_path)


def test_monolithic_float32_keeps_the_hi_lo_split(tmp_path):
    """float32: the fine operator's hi plane and its float64 remainder are
    the JAX package's; the V-cycle copies narrow to bf16."""
    mesh, lam, mu, fixed, _ = _box(nx=8, ny=2, nz=2)
    mask = _mask(mesh, fixed)
    sys_j, mg_j, info_j = jax_bell._build_bell_multigrid_legacy(
        mesh, lam, mu, free_mask=mask, dtype=jnp.float32)
    path = jax_bell.save_hierarchy(str(tmp_path / "f32.npz"), sys_j, mg_j,
                                   info_j)
    ref, _ = bell.bell_from_numpy(np.load(path), torch.float32, "cpu")
    ours, mg, _ = bell._build_bell_multigrid_legacy(
        _port_mesh(mesh), lam, mu, free_mask=mask, dtype=torch.float32,
        device="cpu")
    assert mg.levels[0].op.A.vals.dtype == torch.bfloat16
    np.testing.assert_array_equal(ours.matrix.A.vals.numpy(),
                                  ref.matrix.A.vals.numpy())
    np.testing.assert_array_equal(ours.matrix.vals_lo.numpy(),
                                  ref.matrix.vals_lo.numpy())
    assert float(ours.matrix.vals_lo.abs().max()) > 0.0


def test_nu_zero_dispatches_to_the_monolithic_build_in_both(library,
                                                            tmp_path):
    mesh, lam, mu, fixed, _ = _box(nu=0.0, nx=8, ny=2, nz=2)
    assert np.all(lam == 0.0)
    mask = _mask(mesh, fixed)
    jax_built = jax_bell.build_bell_multigrid(mesh, lam, mu, free_mask=mask,
                                              dtype=jnp.float64)
    assert "rap_chain_sub" in jax_built[2]["phases"]   # its legacy build
    sys_p, mg_p, info = bell.build_bell_multigrid(
        _port_mesh(mesh), lam, mu, free_mask=mask, dtype=torch.float64,
        device="cpu")
    assert info["route"] == "monolithic"
    _assert_same_hierarchy((sys_p, mg_p), jax_built, tmp_path)


def test_skeleton_budget_keyword_forces_the_monolithic_build():
    mesh, lam, mu, fixed, _ = _box(nx=6, ny=2, nz=2)
    pmesh = _port_mesh(mesh)
    mask = _mask(mesh, fixed)
    C, k = mesh.conn.shape
    need = C * k * k * 9 * 8 * 2.5
    kw = dict(free_mask=mask, dtype=torch.float64, device="cpu")
    routes = {b: bell.build_bell_multigrid(pmesh, lam, mu, skel_max_bytes=b,
                                           **kw)[2]["route"]
              for b in (need, need * 0.999, None)}
    assert routes == {need: "skeleton", need * 0.999: "monolithic",
                      None: "skeleton"}


def test_skeleton_mismatch_is_raised_and_falls_back(monkeypatch):
    mesh, lam, mu, fixed, _ = _box(nx=8, ny=2, nz=2)
    pmesh = _port_mesh(mesh)
    mask = _mask(mesh, fixed)
    skel = bell.build_bell_skeleton(pmesh, mask)
    # a frozen level-1 pattern without the last block of its first row:
    # the value pass leaves it, with the library and without
    ip, cols = skel["C0_bsr_indptr"].copy(), skel["C0_cols_d"]
    keep = np.ones(cols.shape[0], bool)
    keep[ip[1] - 1] = False
    ip[1:] -= 1
    bad = dict(skel, C0_bsr_indptr=ip, C0_cols_d=cols[keep])
    for enabled in (True, False):
        with native.use_native(enabled), \
                pytest.raises(bell.SkeletonMismatch, match="level 1"):
            bell.build_bell_values(bad, lam, mu, dtype=torch.float64,
                                   device="cpu")

    warnings = []
    monkeypatch.setattr(terminal, "print_warning", warnings.append)

    def mismatch(*args, **kwargs):
        raise bell.SkeletonMismatch("level 1: forced")

    monkeypatch.setattr(bell, "build_bell_values", mismatch)
    _, _, info = bell.build_bell_multigrid(pmesh, lam, mu, free_mask=mask,
                                           dtype=torch.float64, device="cpu")
    assert info["route"] == "monolithic"
    assert len(warnings) == 1 and "monolithic build" in warnings[0] \
        and "forced" in warnings[0]


def test_solve_system_on_a_nu_zero_box_matches_jax(monkeypatch):
    """fp64 MG-PCG through ``solve_system`` of both packages on the
    monolithic hierarchy: equal iteration counts, energies within 1e-10."""
    monkeypatch.setenv("TOPOPT_MG_CACHE_DIR", "off")
    lam0, mu0 = lame_parameters(1.0, 0.0)
    mesh = _box(nu=0.0, nx=8, ny=2, nz=2)[0]
    ref_p = jax_api.setup_problem(mesh, dtype=jnp.float64)
    jax_api.assemble_stiffness_matrix(ref_p, lam0, mu0)
    jax_api.apply_fixed_boundary(ref_p, jax_nodes_at_plane(mesh, 0, 0.0))
    jax_api.apply_force(ref_p, jax_nodes_at_plane(mesh, 0, 8.0),
                        [0.0, 0.0, -1.0])
    ref = jax_api.solve_system(ref_p, JaxSolverConfig(
        **MG_KW, chunk_iterations=10 ** 6))
    pmesh = _port_mesh(mesh)
    p = tt.setup_problem(pmesh, dtype=torch.float64, device="cpu")
    tt.assemble_stiffness_matrix(p, lam0, mu0)
    tt.apply_fixed_boundary(p, tt.nodes_at_plane(pmesh, 0, 0.0))
    tt.apply_force(p, tt.nodes_at_plane(pmesh, 0, 8.0), [0.0, 0.0, -1.0])
    ours = tt.solve_system(p, tt.SolverConfig(**MG_KW))
    assert p._mg_build_info["route"] == "monolithic"
    assert ours.converged and ref.converged
    assert ours.iterations == ref.iterations
    assert abs(ours.energy - ref.energy) <= 1e-10 * abs(ref.energy)


@pytest.mark.parametrize("case", ["box_12x4x4", "hex8_fixture"])
def test_skeleton_hierarchy_with_the_library_equals_jax(case, tmp_path):
    """tests/test_torch_bell.py's comparison with both libraries on."""
    if jax_native.native_v2() is None:
        pytest.skip("the JAX package's native library is not built")
    assert native.native_available(), native.LOAD_ERROR
    mesh, lam, mu, fixed, max_coarse = (_box() if case == "box_12x4x4"
                                        else _hex8_fixture())
    mask = _mask(mesh, fixed)
    kw = dict(free_mask=mask, max_coarse_dofs=max_coarse, order=2)
    jax_built = jax_bell.build_bell_multigrid(mesh, lam, mu,
                                              dtype=jnp.float64, **kw)
    sys_p, mg_p, info = bell.build_bell_multigrid(
        _port_mesh(mesh), lam, mu, dtype=torch.float64, device="cpu", **kw)
    assert info["route"] == "skeleton" and info["host_library"] is True
    _assert_same_hierarchy((sys_p, mg_p), jax_built, tmp_path)
