"""The ladder's restarted GMRES on the cantilever beam, in the PyTorch
port and in the JAX package, on the CPU in float64.

GMRES(30) with block-Jacobi stops on its left-preconditioned residual
estimate, so the energy of the iterate it returns is first order in the
residual (E(u) - E* = -r.(u + u*)/2 with r = f - K u): at tolerance 1e-10
both packages land about 1e-8 of the energy off the direct solve, and
their counts part after thousands of stagnating restarts.  The test holds
the port's error to its own residual and to the JAX package's.

Run as a script for the beams of chip_smoke.py (scale s: 25 s/2 x 4 s x s
hexes; scale 2 takes about 2 min in each package, scale 4 about 16 min in
the JAX package):

    python tests/test_torch_gmres_energy.py [scale ...] [--package jax|torch]
"""

if __name__ == "__main__":      # the settings tests/conftest.py makes
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

import sys
import time

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
from topopteval_tpu_torch.fem.operator import assemble_scipy
from topopteval_tpu_torch.fem.solvers import direct_solve

tt.set_verbosity(False)
torch.set_num_threads(1)

LAM, MU = lame_parameters(1.0, 0.3)
BOX = (60.0, 20.0, 4.0)
LADDER = dict(method="gmres", preconditioner="block_diagonal",
              tolerance=1e-10, max_iterations=20000, restart=30,
              verbose=False)


def _jax_problem(dims):
    mesh = jax_grid_tet(*dims, (0, 0, 0), BOX)
    p = japi.setup_problem(mesh, dtype=jnp.float64)
    japi.assemble_stiffness_matrix(p, LAM, MU)
    japi.apply_fixed_boundary(p, jax_nodes_at_plane(mesh, 0, 0.0))
    japi.apply_force(p, jax_nodes_at_plane(mesh, 0, BOX[0]), [0, 0, -1.0])
    return p


def _torch_problem(dims):
    mesh = tt.generate_grid_tet(*dims, (0, 0, 0), BOX)
    p = tt.setup_problem(mesh, dtype=torch.float64, device="cpu")
    tt.assemble_stiffness_matrix(p, LAM, MU)
    tt.apply_fixed_boundary(p, tt.nodes_at_plane(mesh, 0, 0.0))
    tt.apply_force(p, tt.nodes_at_plane(mesh, 0, BOX[0]), [0, 0, -1.0])
    return p


def _direct(p):
    """(K with the BCs, masked f, u*, E*) on the host."""
    mask = tt.free_mask_from_bcs(p.n_dofs, p.bcs)
    K = assemble_scipy(p.mesh, p.lam, p.mu, order=p.quad_order,
                       free_mask=mask)
    f = p.f * mask
    u = direct_solve(K, f)
    return K, f, u, 0.5 * float(u @ (K @ u))


@pytest.mark.parametrize("dims", [(6, 2, 1), (12, 4, 1)])
def test_ladder_gmres_energy_error_is_the_jax_packages(dims):
    tp = _torch_problem(dims)
    ours = tt.solve_system(tp, tt.SolverConfig(**LADDER))
    ref = japi.solve_system(_jax_problem(dims), JaxSolverConfig(**LADDER))
    assert ours.method == ref.method == "gmres"
    assert ours.converged and ref.converged
    K, f, u_star, e_star = _direct(tp)
    u = np.asarray(ours.u, dtype=np.float64)
    r = f - K @ u
    # the identity, up to the rounding of the two energies (eps |u|'|K||u|
    # bounds the rounding of one such product)
    aK = abs(K)
    rounding = np.finfo(np.float64).eps * (abs(u) @ (aK @ abs(u))
                                           + abs(u_star) @ (aK @ abs(u_star)))
    assert abs((ours.energy - e_star) + 0.5 * r @ (u + u_star)) \
        <= 64 * rounding
    err_ours = abs(ours.energy - e_star) / e_star
    err_ref = abs(ref.energy - e_star) / e_star
    assert 1e-9 < err_ref and err_ours <= 2.0 * err_ref


def main(argv):
    scales = [int(a) for a in argv if a.isdigit()] or [2]
    package = argv[argv.index("--package") + 1] if "--package" in argv \
        else None
    for s in scales:
        dims = (25 * s // 2, 4 * s, s)
        e_star = _direct(_torch_problem(dims))[3]
        for name in ("jax", "torch"):
            if package not in (None, name):
                continue
            p = _jax_problem(dims) if name == "jax" else _torch_problem(dims)
            t = time.perf_counter()
            if name == "jax":
                r = japi.solve_system(p, JaxSolverConfig(**LADDER))
            else:
                r = tt.solve_system(p, tt.SolverConfig(**LADDER))
            print(f"[gmres_energy] scale={s} package={name} method={r.method} "
                  f"iterations={r.iterations} converged={r.converged} "
                  f"energy={r.energy!r} direct={e_star!r} rel_err="
                  f"{abs(r.energy - e_star) / e_star:.3e} seconds="
                  f"{time.perf_counter() - t:.1f}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
