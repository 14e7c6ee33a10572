"""The block-ELL slice of the port as a whole against the JAX package:
``solve_system(SolverConfig(method="cg", preconditioner="multigrid"))`` on
a 12x4x4 tet box whose ``structured_info`` is dropped, so both packages
take the block-ELL route, on the CPU in float64: the same iteration count
(the JAX package run unchunked, ``chunk_iterations=10**6``, on its
NumPy/scipy host build) and energies within 1e-10 of each other and 1e-8
of the host direct oracle.  Also the port's V-cycle on a hierarchy the
JAX package built and saved, carried over by ``bell_from_numpy``, against
the JAX V-cycle.  The JAX solve costs about 15 s of tracing here, so the
port's other block-ELL cases sit in tests/test_torch_bell_routes.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import threadpoolctl
import torch

from topopteval_tpu import api as jax_api
from topopteval_tpu.config import SolverConfig as JaxSolverConfig
from topopteval_tpu.fem import bell as jax_bell
from topopteval_tpu.fem.bc import DirichletBC
from topopteval_tpu.fem.bc import free_mask_from_bcs as jax_free_mask
from topopteval_tpu.fem.bc import nodes_at_plane as jax_nodes_at_plane
from topopteval_tpu.io import native as jax_native
from topopteval_tpu.materials import lame_parameters
from topopteval_tpu.models import beams as jax_beams
from topopteval_tpu.models.density import \
    bench_simp_density as jax_bench_simp_density
import topopteval_tpu_torch as tt
from topopteval_tpu_torch.io import native as port_native
from topopteval_tpu_torch.fem import bell
from topopteval_tpu_torch.fem.bell import BellSystem
from topopteval_tpu_torch.fem.operator import assemble_scipy
from topopteval_tpu_torch.fem.solvers import direct_solve

tt.set_verbosity(False)
# these tests work on small tensors: one intra-op thread each, so that
# test processes running side by side do not fight over the cores
torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """The host build's dense eigensolves and sparse products run in
    OpenBLAS: one thread here too, for the same reason."""
    with threadpoolctl.threadpool_limits(1):
        yield

LAM, MU = lame_parameters(1.0, 0.3)
MG_KW = dict(method="cg", preconditioner="multigrid", tolerance=1e-10,
             max_iterations=500, verbose=False)


def _rel(a, b):
    return abs(a - b) / abs(b)


def _direct_energy(problem) -> float:
    mask = tt.free_mask_from_bcs(problem.n_dofs, problem.bcs)
    K = assemble_scipy(problem.mesh, problem.lam, problem.mu,
                       order=problem.quad_order, free_mask=mask)
    u = direct_solve(K, problem.f * mask)
    return 0.5 * float(u @ (K @ u))


def _box(dtype):
    """The 12x4x4 cantilever box with its provenance dropped, so
    ``solve_system`` takes the block-ELL route."""
    mesh = tt.generate_grid_tet(12, 4, 4, (0, 0, 0), (12.0, 4.0, 4.0))
    mesh.structured_info = None
    p = tt.setup_problem(mesh, dtype=dtype, device="cpu")
    tt.assemble_stiffness_matrix(p, LAM, MU)
    tt.apply_fixed_boundary(p, tt.nodes_at_plane(mesh, 0, 0.0))
    tt.apply_force(p, tt.nodes_at_plane(mesh, 0, 12.0), [0.0, 0.0, -1.0])
    return p


def _close(ours, ref, rtol):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert ours.shape == ref.shape
    assert np.abs(ours - ref).max() <= rtol * np.abs(ref).max()


@pytest.fixture
def no_native(monkeypatch):
    """Both packages on their NumPy/scipy host build (the port's host
    library switched off too: the two builds agree only to rounding)."""
    monkeypatch.setattr(jax_native, "_LIB", None)
    monkeypatch.setattr(jax_native, "_TRIED", True)
    with port_native.use_native(False):
        yield


def test_solve_system_bell_matches_jax_on_the_box(monkeypatch, no_native):
    monkeypatch.setenv("TOPOPT_MG_CACHE_DIR", "off")
    mesh = jax_beams.generate_grid_tet(12, 4, 4, (0, 0, 0), (12.0, 4.0, 4.0))
    mesh.structured_info = None
    ref_p = jax_api.setup_problem(mesh, dtype=jnp.float64)
    jax_api.assemble_stiffness_matrix(ref_p, LAM, MU)
    jax_api.apply_fixed_boundary(ref_p, jax_nodes_at_plane(mesh, 0, 0.0))
    jax_api.apply_force(ref_p, jax_nodes_at_plane(mesh, 0, 12.0),
                        [0.0, 0.0, -1.0])
    ref = jax_api.solve_system(ref_p, JaxSolverConfig(
        **MG_KW, chunk_iterations=10 ** 6))
    problem = _box(torch.float64)
    ours = tt.solve_system(problem, tt.SolverConfig(**MG_KW))
    op, _ = tt.api._get_multigrid(problem)
    assert isinstance(op, BellSystem)
    assert ours.method == "cg" and ours.converged
    assert ours.iterations == ref.iterations
    assert _rel(ours.energy, ref.energy) <= 1e-10
    assert _rel(ours.energy, _direct_energy(problem)) <= 1e-8
    np.testing.assert_allclose(ours.u, ref.u, rtol=0,
                               atol=1e-8 * np.abs(ref.u).max())
    info = problem._mg_build_info
    assert info["n_levels"] == 2 and info["skeleton_cached"] is False


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_vcycle_on_the_jax_hierarchy_equals_jax(dtype, no_native,
                                                tmp_path):
    """A hierarchy built and saved by the JAX package, carried over with
    ``bell_from_numpy``: the same V-cycle to 1e-10 in float64; in float32
    (bf16 smoother copies in both packages) to 1e-5."""
    mesh = jax_beams.generate_grid_tet(12, 4, 4, (0, 0, 0), (12.0, 4.0, 4.0))
    mesh.structured_info = None
    lam, mu = np.full(mesh.n_cells, LAM), np.full(mesh.n_cells, MU)
    fixed = jax_nodes_at_plane(mesh, 0, 0.0)
    mask = jax_free_mask(mesh.n_dofs, [DirichletBC.fixed(fixed)])
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    sys_j, mg_j, info = jax_bell.build_bell_multigrid(
        mesh, lam, mu, free_mask=mask, dtype=jdt, order=2)
    path = jax_bell.save_hierarchy(str(tmp_path / "h.npz"), sys_j, mg_j,
                                   info)
    sys_p, mg_p = bell.bell_from_numpy(np.load(path), dtype, "cpu")
    if dtype == torch.float32:
        assert mg_p.levels[0].op.A.vals.dtype == torch.bfloat16
        assert sys_p.matrix.vals_lo is not None
    r = np.random.default_rng(4).standard_normal(sys_p.n_dofs) \
        * sys_p.free_mask.double().numpy()
    ours = mg_p.apply(torch.as_tensor(r, dtype=dtype)).double().numpy()
    ref = np.asarray(mg_j.apply(jnp.asarray(r, jdt)), np.float64)
    _close(ours, ref, 1e-10 if dtype == torch.float64 else 1e-5)
    ours = sys_p.matvec(torch.as_tensor(r, dtype=dtype)).double().numpy()
    ref = np.asarray(sys_j.matvec(jnp.asarray(r, jdt)), np.float64)
    _close(ours, ref, 1e-12 if dtype == torch.float64 else 1e-6)
    np.testing.assert_allclose(sys_p.matvec64(r), sys_j.matvec64(r),
                               rtol=1e-12, atol=1e-12 * np.abs(r).max())


def test_bench_simp_density_equals_jax():
    np.testing.assert_array_equal(tt.models.bench_simp_density(12, 4, 2),
                                  jax_bench_simp_density(12, 4, 2))
