"""The float64 iteration count of the block-ELL multigrid on the SIMP beam
against the JAX package's (ROADMAP Queue C 5), on the CPU.

The scale-2 SIMP cantilever of the benchmark density (Emin 1e-8, the
loaded tip in void) goes through ``solve_system(SolverConfig(method="cg",
preconditioner="multigrid"))`` in both packages, in float64, on a mesh
without ``structured_info`` (the block-ELL route); the JAX package runs
unchunked (``chunk_iterations=10**6``) on its NumPy/scipy host build.

The two counts differ, and the test shows where the difference comes
from, with no tolerance on the count itself:

- every piece of the V-cycle (block-Jacobi blocks, the level operator,
  restriction, prolongation) and the system matvec give the JAX
  package's bits when the JAX piece runs op by op on its own hierarchy
  (carried over with ``bell_from_numpy``); the coarse dense product and
  the whole V-cycle agree to rounding (XLA's jit fuses the elementwise
  pieces into multiply-adds and sums the dense product in its own
  order);
- the port's CG on the JAX package's hierarchy takes the port's own
  count;
- the JAX package's own count moves by more than the gap between the two
  packages when its load moves by one part in 1e15 (twelve loads: the
  beam's own and eleven seeded moves): the count is set by rounding in
  this ill-conditioned system, not by the algorithm.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import threadpoolctl
import torch

from topopteval_tpu import api as jax_api
from topopteval_tpu.config import SolverConfig as JaxSolverConfig
from topopteval_tpu.fem import bell as jax_bell
from topopteval_tpu.fem.bc import nodes_at_plane as jax_nodes_at_plane
from topopteval_tpu.fem.solvers import cg as jax_cg
from topopteval_tpu.io import native as jax_native
from topopteval_tpu.materials import SIMPMaterial
from topopteval_tpu.models import beams as jax_beams
from topopteval_tpu.models.density import \
    bench_simp_density as jax_bench_simp_density
import topopteval_tpu_torch as tt
from topopteval_tpu_torch.io import native as port_native
from topopteval_tpu_torch.fem import bell
from topopteval_tpu_torch.fem.bell import BellSystem
from topopteval_tpu_torch.fem.solvers import cg

tt.set_verbosity(False)
# these tests work on small tensors: one intra-op thread each, so that
# test processes running side by side do not fight over the cores
torch.set_num_threads(1)

DIMS = (25, 8, 2)                        # tools/oracle_energy.py, scale 2
BOX = (60.0, 20.0, 4.0)
MG_KW = dict(method="cg", preconditioner="multigrid", tolerance=1e-10,
             max_iterations=3000, verbose=False)
#: loads the JAX package solves: the beam's own, then the same load
#: moved by one part in 1e15 (relative, seeded normal noise)
SEEDS = 12


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    with threadpoolctl.threadpool_limits(1):
        yield


@pytest.fixture
def no_native(monkeypatch):
    """Both packages on their NumPy/scipy host build (the port's host
    library switched off too: the two builds agree only to rounding)."""
    monkeypatch.setattr(jax_native, "_LIB", None)
    monkeypatch.setattr(jax_native, "_TRIED", True)
    with port_native.use_native(False):
        yield


def _jax_problem():
    mesh = jax_beams.generate_grid_tet(*DIMS, (0.0, 0.0, 0.0), BOX)
    mesh.structured_info = None
    p = jax_api.setup_problem(mesh, dtype=jnp.float64)
    jax_api.assemble_stiffness_matrix_simp(
        p, SIMPMaterial(E0=1.0, nu=0.3, Emin=1e-8, p=3.0),
        jax_bench_simp_density(*DIMS))
    jax_api.apply_fixed_boundary(p, jax_nodes_at_plane(mesh, 0, 0.0))
    jax_api.apply_force(p, jax_nodes_at_plane(mesh, 0, 60.0),
                        [0.0, 0.0, -1.0])
    return p


def _port_problem():
    mesh = tt.generate_grid_tet(*DIMS, (0.0, 0.0, 0.0), BOX)
    mesh.structured_info = None                # the block-ELL route
    p = tt.setup_problem(mesh, dtype=torch.float64, device="cpu")
    tt.assemble_stiffness_matrix_simp(
        p, tt.create_simp_material_model(1.0, 0.3, 1e-8, 3.0),
        tt.models.bench_simp_density(*DIMS))
    tt.apply_fixed_boundary(p, tt.nodes_at_plane(mesh, 0, 0.0))
    tt.apply_force(p, tt.nodes_at_plane(mesh, 0, 60.0), [0.0, 0.0, -1.0])
    return p


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_bell_simp_fp64_count_gap_is_rounding(monkeypatch, no_native,
                                              tmp_path):
    monkeypatch.setenv("TOPOPT_MG_CACHE_DIR", "off")
    ref_p = _jax_problem()
    ref = jax_api.solve_system(ref_p, JaxSolverConfig(
        **MG_KW, chunk_iterations=10 ** 6))
    problem = _port_problem()
    ours = tt.solve_system(problem, tt.SolverConfig(**MG_KW))
    sys_p, mg_p = tt.api._get_multigrid(problem)
    assert isinstance(sys_p, BellSystem)
    assert ref.converged and ours.converged and ours.method == "cg"
    # both energies within the float64 reach of this system's direct
    # solves (tests/test_torch_simp_oracle.py: about 6e-7)
    assert abs(ours.energy - ref.energy) / ref.energy <= 1e-6

    # the JAX hierarchy in the port: its pieces op by op
    sys_j, mg_j = jax_api._get_multigrid(ref_p)
    path = jax_bell.save_hierarchy(str(tmp_path / "h.npz"), sys_j, mg_j,
                                   ref_p._mg_build_info)
    sys_c, mg_c = bell.bell_from_numpy(np.load(path), torch.float64, "cpu")
    Lj, Lc = mg_j.levels[0], mg_c.levels[0]
    rng = np.random.default_rng(5)
    v = rng.standard_normal((3, Lj.op.n_rows_p))
    vt, vj = torch.as_tensor(v), jnp.asarray(v)
    with jax.disable_jit():
        pairs = {
            "blocks": (bell._binv_apply(Lc.binv9, vt),
                       jax_bell._binv_apply(Lj.binv9, vj)),
            "level operator": (Lc.op.matvec(vt.reshape(-1)),
                               Lj.op.matvec(vj.reshape(-1))),
            "restriction": (Lc.transfer.restrict(vt),
                            Lj.transfer.restrict(vj)),
            "system": (sys_c.matvec(vt.reshape(-1)),
                       sys_j.matrix.matvec(vj.reshape(-1))),
        }
        vc = rng.standard_normal(tuple(pairs["restriction"][1].shape))
        pairs["prolongation"] = (Lc.transfer.prolong(torch.as_tensor(vc)),
                                 Lj.transfer.prolong(jnp.asarray(vc)))
    for name, (a, b) in pairs.items():
        assert np.array_equal(a.numpy(), np.asarray(b)), name
    vc = vc.reshape(-1)
    assert _rel((mg_c.coarse_inv @ torch.as_tensor(vc)).numpy(),
                mg_j.coarse_inv @ jnp.asarray(vc)) <= 1e-15
    x = v.reshape(-1)
    assert _rel(mg_c.apply(torch.as_tensor(x)).numpy(),
                mg_j.apply(jnp.asarray(x))) <= 1e-15

    # the port's CG on the JAX hierarchy takes the port's own count: the
    # hierarchy is not where the counts part
    f = sys_j.to_cm(np.asarray(ref_p.f)) * np.asarray(sys_j.free_mask)
    assert cg(sys_c, torch.as_tensor(f), M=mg_c, tol=1e-10,
              maxiter=3000).niter == ours.iterations

    # the JAX package's own count under rounding-level moves of its load
    counts = []
    for seed in range(SEEDS):
        load = np.asarray(ref_p.f, np.float64) * (
            1.0 if seed == 0 else 1.0 + 1e-15 * np.random.default_rng(
                seed).standard_normal(len(ref_p.f)))
        r = jax_cg(sys_j.matrix, jnp.asarray(sys_j.to_cm(load))
                   * sys_j.free_mask, M=mg_j, tol=1e-10, maxiter=3000)
        assert bool(r.converged)
        counts.append(int(r.niter))
    assert counts[0] == ref.iterations
    gap = abs(ours.iterations - ref.iterations)
    assert gap <= max(counts) - min(counts), (ours.iterations, counts)
