"""How far float64 fixes the SIMP beam oracles (``simp_beam_scale_*`` in
data/oracle_energies.json), and the port's block-ELL multigrid against
that reach, on the CPU.

The oracle is the JAX package's host direct solve (SuperLU, column order
COLAMD) of the SIMP cantilever at Emin 1e-8 (tools/oracle_energy.py).
The loaded tip lies in void, so the system is ill-conditioned and the
rounding of one direct solve moves the energy: the same matrix solved
under another fill-reducing column order gives another energy.  At scale
2 the three SuperLU orders agree only to about 6e-7 (scale 8: about 1e-4,
PERF.md), so an energy gate of 1e-8 against these oracles tests rounding,
not the solver.  The port's float64 multigrid energy is held to twice
that reach: the direct solves of the JAX package's own matrix set it, and
the multigrid solve rounds in its own order (on this case its energy
moves by 3e-7 between one and two CPU threads).
"""

import numpy as np
import threadpoolctl
import torch
from scipy.sparse.linalg import splu

import jax.numpy as jnp

from topopteval_tpu import api as jax_api
from topopteval_tpu.fem.bc import free_mask_from_bcs as jax_free_mask
from topopteval_tpu.fem.bc import nodes_at_plane as jax_nodes_at_plane
from topopteval_tpu.fem.operator import assemble_scipy as jax_assemble
from topopteval_tpu.materials import SIMPMaterial
from topopteval_tpu.models import beams as jax_beams
from topopteval_tpu.models.density import \
    bench_simp_density as jax_bench_simp_density
import topopteval_tpu_torch as tt

tt.set_verbosity(False)
# these tests work on small tensors: one intra-op thread each, so that
# test processes running side by side do not fight over the cores
torch.set_num_threads(1)

ORACLE_SCALE_2 = 66116786.995269075     # data/oracle_energies.json
DIMS = (25, 8, 2)                        # tools/oracle_energy.py, scale 2


def _jax_system():
    """The JAX package's masked float64 matrix and load of the scale-2
    SIMP beam, assembled as tools/oracle_energy.py assembles it."""
    mesh = jax_beams.generate_grid_tet(*DIMS, (0.0, 0.0, 0.0),
                                       (60.0, 20.0, 4.0))
    mesh.structured_info = None
    p = jax_api.setup_problem(mesh, dtype=jnp.float64)
    jax_api.assemble_stiffness_matrix_simp(
        p, SIMPMaterial(E0=1.0, nu=0.3, Emin=1e-8, p=3.0),
        jax_bench_simp_density(*DIMS))
    jax_api.apply_fixed_boundary(p, jax_nodes_at_plane(mesh, 0, 0.0))
    jax_api.apply_force(p, jax_nodes_at_plane(mesh, 0, 60.0),
                        [0.0, 0.0, -1.0])
    mask = np.asarray(jax_free_mask(mesh.n_dofs, p.bcs), np.float64)
    K = jax_assemble(p.mesh, p.lam, p.mu, order=p.quad_order,
                     free_mask=mask).tocsc()
    return K, np.asarray(p.f, np.float64) * mask


def test_simp_oracle_reach_and_the_port_multigrid_inside_it(monkeypatch):
    monkeypatch.setenv("TOPOPT_MG_CACHE_DIR", "off")
    with threadpoolctl.threadpool_limits(1):
        K, f = _jax_system()
        energies = {spec: 0.5 * float(f @ splu(K, permc_spec=spec).solve(f))
                    for spec in ("COLAMD", "MMD_AT_PLUS_A", "MMD_ATA")}
        # the oracle is this solve: the same matrix, the same column order
        assert abs(energies["COLAMD"] - ORACLE_SCALE_2) \
            <= 1e-12 * ORACLE_SCALE_2
        reach = max(abs(e - ORACLE_SCALE_2) / ORACLE_SCALE_2
                    for e in energies.values())
        assert reach > 1e-8        # float64 does not fix the 9th digit

        mesh = tt.generate_grid_tet(*DIMS, (0.0, 0.0, 0.0),
                                    (60.0, 20.0, 4.0))
        mesh.structured_info = None          # the block-ELL route
        p = tt.setup_problem(mesh, dtype=torch.float64, device="cpu")
        tt.assemble_stiffness_matrix_simp(
            p, tt.create_simp_material_model(1.0, 0.3, 1e-8, 3.0),
            tt.models.bench_simp_density(*DIMS))
        tt.apply_fixed_boundary(p, tt.nodes_at_plane(mesh, 0, 0.0))
        tt.apply_force(p, tt.nodes_at_plane(mesh, 0, 60.0),
                       [0.0, 0.0, -1.0])
        r = tt.solve_system(p, tt.SolverConfig(
            method="cg", preconditioner="multigrid", tolerance=1e-10,
            max_iterations=3000, verbose=False))
    assert r.method == "cg" and r.converged
    assert abs(r.energy - ORACLE_SCALE_2) / ORACLE_SCALE_2 <= 2.0 * reach
