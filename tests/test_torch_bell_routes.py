"""The block-ELL route of ``solve_system`` through the port alone, on the
CPU: the imported Tet4 cantilever fixture against the JAX package's
iteration count and energy on the same call (stated as numbers: that JAX
solve takes about a minute of tracing on the CPU; the fixture's hierarchy
is held to the JAX package's array for array in tests/test_torch_bell.py),
float32 through the refinement route, the hierarchy and skeleton disk
caches, the no-cache setting, the in-process skeleton cache of a SIMP
density swap, and the routes that are not ported.  The box case through
both packages is in tests/test_torch_bell_solve.py.

Tolerances are stated where they are used.
"""

import os

import numpy as np
import pytest
import threadpoolctl
import torch

import topopteval_tpu_torch as tt
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

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAM, MU = tt.lame_parameters(1.0, 0.3)
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


def _box(dtype, nx=12, ny=4, nz=4, density=None):
    """A cantilever box from the generator with its provenance dropped, so
    ``solve_system`` takes the block-ELL route."""
    mesh = tt.generate_grid_tet(nx, ny, nz, (0, 0, 0),
                                (float(nx), float(ny), float(nz)))
    mesh.structured_info = None
    p = tt.setup_problem(mesh, dtype=dtype, device="cpu")
    if density is None:
        tt.assemble_stiffness_matrix(p, LAM, MU)
    else:
        tt.assemble_stiffness_matrix_simp(
            p, tt.create_simp_material_model(1.0, 0.3, 1e-8, 3.0), density)
    tt.apply_fixed_boundary(p, tt.nodes_at_plane(mesh, 0, 0.0))
    tt.apply_force(p, tt.nodes_at_plane(mesh, 0, float(nx)),
                   [0.0, 0.0, -1.0])
    return p


def test_solve_system_bell_on_the_imported_fixture(beam_tet_path,
                                                   monkeypatch):
    """The Tet4 cantilever fixture (8,631 DOFs), imported: the same call
    through the JAX package (float64, its NumPy/scipy host build,
    ``chunk_iterations=10**6``) takes 116 iterations to energy
    621.8542083708658 on the CPU.  Both runs stop at a relative residual
    of 1e-10 and their rounding differs (another summation order in the
    dots and the dense coarse product); the energy moves with f.du, so the
    two agree to 1.6e-10, held here at 1e-9."""
    monkeypatch.setenv("TOPOPT_MG_CACHE_DIR", "off")
    mesh = tt.import_mesh(beam_tet_path)
    problem = tt.cantilever_beam(mesh, dtype=torch.float64, device="cpu")
    result = tt.solve_system(problem, tt.SolverConfig(**MG_KW))
    assert result.method == "cg" and result.converged
    assert result.iterations == 116
    assert _rel(result.energy, 621.8542083708658) <= 1e-9
    assert _rel(result.energy, 621.8542083316273) <= 1e-8     # oracle


def test_solve_system_bell_float32_refines_to_the_direct_oracle(monkeypatch):
    """float32: multigrid PCG (bf16 smoother copies) inside float64
    refinement whose residual is BellSystem.matvec64."""
    monkeypatch.setenv("TOPOPT_MG_CACHE_DIR", "off")
    problem = _box(torch.float32, 8, 4, 2)
    result = tt.solve_system(problem, tt.SolverConfig(**MG_KW))
    assert result.method == "cg" and result.converged
    assert result.refinement_passes >= 2
    assert result.u.dtype == np.float64
    assert result.timings["refine_host_matvec_seconds"] > 0.0
    op, mg = tt.api._get_multigrid(problem)
    assert op.matrix.vals_lo is not None
    assert mg.levels[0].op.A.vals.dtype == torch.bfloat16
    assert _rel(result.energy, _direct_energy(problem)) <= 1e-8


def test_disk_cache_round_trip(tmp_path, monkeypatch):
    monkeypatch.setenv("TOPOPT_MG_CACHE_DIR", str(tmp_path))
    first = _box(torch.float64, 8, 4, 2)
    r1 = tt.solve_system(first, tt.SolverConfig(**MG_KW))
    assert first._mg_build_info["cached"] is False
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].startswith("bell_torch_")
    second = _box(torch.float64, 8, 4, 2)
    r2 = tt.solve_system(second, tt.SolverConfig(**MG_KW))
    assert second._mg_build_info["cached"] is True
    assert r2.iterations == r1.iterations
    assert _rel(r2.energy, r1.energy) <= 1e-12
    # a file of another format in the cache is refused, then rebuilt over
    path = os.path.join(tmp_path, files[0])
    np.savez(path, perm=np.arange(3))
    third = _box(torch.float64, 8, 4, 2)
    r3 = tt.solve_system(third, tt.SolverConfig(**MG_KW))
    assert third._mg_build_info["cached"] is False
    assert _rel(r3.energy, r1.energy) <= 1e-12


def test_skeleton_disk_cache_round_trip(tmp_path, monkeypatch):
    """``TOPOPT_BELL_SKEL_DISK=1``: the skeleton is written beside the
    hierarchy and read back in a later build once the in-process cache is
    empty; a stale file (another skeleton version) is refused and
    rebuilt over."""
    monkeypatch.setenv("TOPOPT_MG_CACHE_DIR", str(tmp_path))
    monkeypatch.setenv("TOPOPT_BELL_SKEL_DISK", "1")
    tt.api._SKEL_RAM_CACHE.clear()
    first = _box(torch.float64, 8, 4, 2)
    r1 = tt.solve_system(first, tt.SolverConfig(**MG_KW))
    assert first._mg_build_info["skeleton_cached"] is False
    skel = [f for f in os.listdir(tmp_path) if f.startswith("bellskel_torch_")]
    assert len(skel) == 1
    for f in os.listdir(tmp_path):
        if f.startswith("bell_torch_"):       # force a fresh value pass
            os.remove(os.path.join(tmp_path, f))
    tt.api._SKEL_RAM_CACHE.clear()
    second = _box(torch.float64, 8, 4, 2)
    r2 = tt.solve_system(second, tt.SolverConfig(**MG_KW))
    assert second._mg_build_info["cached"] is False
    assert second._mg_build_info["skeleton_cached"] is True
    assert r2.iterations == r1.iterations
    assert _rel(r2.energy, r1.energy) <= 1e-12
    # a skeleton of another version is refused and rebuilt over
    path = os.path.join(tmp_path, skel[0])
    stale = dict(np.load(path))
    stale["version"] = np.int64(stale["version"]) + 1
    np.savez(path, **stale)
    for f in os.listdir(tmp_path):
        if f.startswith("bell_torch_"):
            os.remove(os.path.join(tmp_path, f))
    tt.api._SKEL_RAM_CACHE.clear()
    third = _box(torch.float64, 8, 4, 2)
    r3 = tt.solve_system(third, tt.SolverConfig(**MG_KW))
    assert third._mg_build_info["skeleton_cached"] is False
    assert _rel(r3.energy, r1.energy) <= 1e-12
    assert int(np.load(path)["version"]) == int(stale["version"]) - 1


def test_solve_system_bell_no_disk_cache(monkeypatch):
    """``TOPOPT_MG_CACHE_DIR=off``: nothing is written and the refinement
    oracle runs off the fp64 twin kept at build time (the JAX package's
    regression case, tests/test_unstructured_mg.py)."""
    monkeypatch.setenv("TOPOPT_MG_CACHE_DIR", "off")
    monkeypatch.chdir(REPO)
    before = os.path.exists(os.path.join(REPO, ".topopt_mg_cache"))
    problem = _box(torch.float32, 6, 3, 3)
    result = tt.solve_system(problem, tt.SolverConfig(
        method="cg", preconditioner="multigrid", tolerance=1e-8,
        max_iterations=300, verbose=False))
    assert result.converged
    assert os.path.exists(os.path.join(REPO, ".topopt_mg_cache")) == before
    assert _rel(result.energy, _direct_energy(problem)) < 1e-6


def test_density_swap_reuses_the_skeleton(monkeypatch):
    """A uniform solve, then a SIMP density on the same mesh and BCs: the
    second build takes the skeleton from the in-process RAM cache."""
    monkeypatch.setenv("TOPOPT_MG_CACHE_DIR", "off")
    uniform = _box(torch.float64, 8, 4, 2)
    tt.solve_system(uniform, tt.SolverConfig(**MG_KW))
    assert uniform._mg_build_info["skeleton_cached"] is False
    density = np.repeat(np.random.default_rng(3).uniform(
        0.05, 1.0, 8 * 4 * 2), 6)
    simp = _box(torch.float64, 8, 4, 2, density=density)
    result = tt.solve_system(simp, tt.SolverConfig(**MG_KW))
    assert simp._mg_build_info["skeleton_cached"] is True
    assert result.converged
    assert _rel(result.energy, _direct_energy(simp)) <= 1e-8


def test_unported_block_ell_routes_raise(monkeypatch):
    monkeypatch.setenv("TOPOPT_MG_CACHE_DIR", "off")
    problem = _box(torch.float64, 4, 2, 2)
    problem.lam = np.zeros_like(problem.lam)      # nu = 0: lam = 0
    with pytest.raises(NotImplementedError, match="Queue A item 6"):
        tt.solve_system(problem, tt.SolverConfig(**MG_KW))
    monkeypatch.setenv("TOPOPT_MG", "galerkin")
    with pytest.raises(NotImplementedError, match="Queue A item 12"):
        tt.solve_system(_box(torch.float64, 4, 2, 2),
                        tt.SolverConfig(**MG_KW))
