"""How ``correct`` is decided: the program's answers held against the
plain reference (reference/elasticity.py).

Numbers compared (each has its limit in the cell's workload file):

- ``resid``: ||A u - f|| / ||f|| of the program's displacements under the
  reference's own constrained operator A, in float64.  It covers the mesh
  import, the material, the clamp, the load and the solve.
- ``energy_gap``: the program's energy against f.u/2 of its own
  displacements, in float64: the energy it reports is the energy of the
  answer ``resid`` judged, summed at the precision the configuration
  states.
- ``vm_gap``: the largest gap of the program's element von Mises stress
  to the reference's from the same displacements, over the largest
  reference stress.
- ``lane_err``: for a design sweep, which returns energies only, the
  program's energy of a lane against the reference's block-Jacobi PCG of
  that lane in float64 to a residual of ``LANE_TOL``, E = f.x - x.Ax/2.
"""

from __future__ import annotations

import numpy as np
import torch

from .elasticity import Tet4Reference, pcg, simp_lame

#: the reference's own solves of sampled sweep lanes
LANE_TOL = 1e-10
LANE_MAXITER = 200_000


def free_mask(n_nodes: int, clamped: np.ndarray, device) -> torch.Tensor:
    m = torch.ones((n_nodes, 3, 1), dtype=torch.float64, device=device)
    m[torch.as_tensor(clamped, dtype=torch.int64, device=device)] = 0.0
    return m


def lame_lanes(densities, material: dict, device) -> tuple:
    """[C, P] (lambda, mu) of densities [P, C]."""
    rho = torch.as_tensor(np.asarray(densities, np.float64),
                          device=device).T
    return simp_lame(rho, material["E0"], material["nu"],
                     material["Emin"], material["p"])


def judge_solution(ref: Tet4Reference, lam, mu, m, f: np.ndarray,
                   u: np.ndarray, energy: float, vm: np.ndarray) -> dict:
    """{resid, energy_gap, vm_gap} of one solve; ``lam``/``mu`` [C, 1]."""
    dev = ref.device
    fm = m * torch.as_tensor(f, dtype=torch.float64, device=dev
                             ).reshape(-1, 3, 1)
    x = torch.as_tensor(np.asarray(u, np.float64), device=dev
                        ).reshape(-1, 3, 1)
    Ax = ref.constrained(x, lam, mu, m)
    resid = float(torch.linalg.vector_norm(Ax - fm)
                  / torch.linalg.vector_norm(fm))
    e_ref = 0.5 * float((fm * x).sum())
    vm_ref = ref.von_mises(x, lam, mu)[:, 0]
    vm_p = torch.as_tensor(np.asarray(vm, np.float64), device=dev)
    return {"resid": resid,
            "energy_gap": _rel(abs(float(energy) - e_ref), abs(e_ref)),
            "vm_gap": _rel(float((vm_p - vm_ref).abs().max()),
                           float(vm_ref.max()))}


def _rel(gap: float, scale: float) -> float:
    """gap / scale, infinite where a gap stands against a zero scale."""
    if scale > 0:
        return gap / scale
    return 0.0 if gap == 0 else float("inf")


def lane_energies(ref: Tet4Reference, lam, mu, m, loads: np.ndarray):
    """The reference's energies [P] of lanes with Lame parameters [C, P]
    and loads [P, ndof], and the PCG steps taken."""
    f = torch.as_tensor(np.asarray(loads, np.float64), device=ref.device
                        ).reshape(loads.shape[0], -1, 3).permute(1, 2, 0)
    f = m * f
    x, steps = pcg(ref, lam, mu, m, f, LANE_TOL, LANE_MAXITER)
    Ax = ref.constrained(x, lam, mu, m)
    e = _sum01(f * x) - 0.5 * _sum01(x * Ax)
    return e.cpu().numpy(), steps


def judge_lanes(ref: Tet4Reference, lam, mu, m, loads: np.ndarray,
                energies: np.ndarray) -> list:
    """``lane_err`` of each sampled lane."""
    e_ref, _ = lane_energies(ref, lam, mu, m, loads)
    return list(np.abs(np.asarray(energies, np.float64) - e_ref)
                / np.abs(e_ref))


def _sum01(t):
    return t.sum(dim=(0, 1))
