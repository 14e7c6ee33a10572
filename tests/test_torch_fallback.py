"""The backward-error gate's direct fallback on every route of
``solve_system`` (ROADMAP Queue C item 1): with the gate forced to reject
(``api._backward_error`` patched to (1, 1)), the solve must return
``direct(verification-fallback)`` with the energy of ``method="direct"``
to 1e-12, float64, on the CPU.

The block-ELL route works on component-major vectors while the direct
solve is interleaved; before the repair its energy crashed there.  The
stencil, Galerkin and block-Jacobi routes run on the 16x4x4 box, the
block-ELL route on the 12x4x4 box without ``structured_info``.
"""

import os

import pytest
import torch

import topopteval_tpu_torch as tt
from topopteval_tpu_torch import api
from topopteval_tpu_torch.fem.bell import BellSystem

tt.set_verbosity(False)
torch.set_num_threads(1)

MG = dict(method="cg", preconditioner="multigrid", tolerance=1e-10,
          max_iterations=500, verbose=False)
BJ = dict(MG, preconditioner="block_diagonal", max_iterations=5000)


def _problem(nx, structured):
    mesh = tt.generate_grid_tet(nx, 4, 4, (0, 0, 0), (float(nx), 4.0, 4.0))
    if not structured:
        mesh.structured_info = None
    p = tt.setup_problem(mesh, dtype=torch.float64, device="cpu")
    tt.assemble_stiffness_matrix(p, *tt.lame_parameters(1.0, 0.3))
    tt.apply_fixed_boundary(p, tt.nodes_at_plane(mesh, 0, 0.0))
    tt.apply_force(p, tt.nodes_at_plane(mesh, 0, float(nx)),
                   [0.0, 0.0, -1.0])
    return p


@pytest.mark.parametrize("route,nx,structured,config", [
    ("block_ell", 12, False, MG),
    ("stencil", 16, True, MG),
    ("galerkin", 16, False, MG),
    ("block_jacobi", 16, True, BJ),
])
def test_forced_fallback_returns_the_direct_energy(monkeypatch, route, nx,
                                                   structured, config):
    monkeypatch.setenv("TOPOPT_MG_CACHE_DIR", "off")
    if route == "galerkin":
        monkeypatch.setenv("TOPOPT_MG", "galerkin")
    direct = tt.solve_system(_problem(nx, structured),
                             tt.SolverConfig(method="direct"))
    monkeypatch.setattr(api, "_backward_error", lambda *args: (1.0, 1.0))
    p = _problem(nx, structured)
    r = tt.solve_system(p, tt.SolverConfig(**config))
    assert r.method == "direct(verification-fallback)" and r.converged
    assert abs(r.energy - direct.energy) <= 1e-12 * abs(direct.energy)
    assert abs(r.u - direct.u).max() <= 1e-12 * abs(direct.u).max()
    if route == "block_ell":
        assert isinstance(p._mg_cache[1], BellSystem)
        assert r.energy == pytest.approx(11.429637630379847, rel=1e-12)
    else:
        assert r.energy == pytest.approx(26.1939673820597, rel=1e-12)
