"""The controls: the reference put in the program's place, one precision
below what each configuration states, and judged like the program.

- Beam cells (energy certified in float64, stresses in float32): the
  reference's block-Jacobi PCG in float32 at the configuration's
  tolerance and step limit, with no float64 refinement, its energy f.u/2
  in float32, and the stresses worked out in bfloat16.
- Sweep cell (float32 lanes): the reference's block-Jacobi PCG of each
  lane run in bfloat16 at the program's tolerance and step limit, and its
  energy f.x/2 in bfloat16.

Not run by the benchmark's own runs: ``benchmark/controls.py`` and the
tests call these.
"""

from __future__ import annotations

import numpy as np
import torch

from .elasticity import Tet4Reference, pcg
from .judge import free_mask, judge_solution, lame_lanes, lane_energies


def beam_control(coords, conn, clamped, density, material: dict,
                 f: np.ndarray, tol: float, maxiter: int, device) -> tuple:
    """({resid, energy_gap, vm_gap}, notes) of the beam control."""
    ref = Tet4Reference(coords, conn, device)
    m = free_mask(len(coords), clamped, ref.device)
    lam, mu = lame_lanes(np.asarray(density)[None], material, ref.device)
    f32 = Tet4Reference(coords, conn, device, dtype=torch.float32)
    fm = m.float() * torch.as_tensor(f, dtype=torch.float32,
                                     device=ref.device).reshape(-1, 3, 1)
    u32, steps = pcg(f32, lam.float(), mu.float(), m.float(), fm, tol,
                     maxiter)
    energy = float(0.5 * (fm * u32).sum())
    del f32
    low = Tet4Reference(coords, conn, device, dtype=torch.bfloat16)
    vm = low.von_mises(u32.bfloat16(), lam.bfloat16(), mu.bfloat16())[:, 0]
    got = judge_solution(ref, lam, mu, m, f, u32.double().cpu().numpy(),
                         energy, vm.float().cpu().numpy())
    return got, {"solve_steps": steps}


def lane_control(coords, conn, clamped, densities, material: dict,
                 loads: np.ndarray, tol: float, maxiter: int,
                 device) -> tuple:
    """(``lane_err`` of each lane, notes) for the sweep control: densities
    [P, C], loads [P, ndof]."""
    ref = Tet4Reference(coords, conn, device)
    m = free_mask(len(coords), clamped, ref.device)
    lam, mu = lame_lanes(densities, material, ref.device)
    e_ref, _ = lane_energies(ref, lam, mu, m, loads)
    low = Tet4Reference(coords, conn, device, dtype=torch.bfloat16)
    bf = torch.bfloat16
    f = torch.as_tensor(np.asarray(loads), dtype=bf, device=ref.device
                        ).reshape(loads.shape[0], -1, 3).permute(1, 2, 0)
    x, steps = pcg(low, lam.to(bf), mu.to(bf), m.to(bf), m.to(bf) * f,
                   tol, maxiter)
    e = (0.5 * (f * x).sum(dim=(0, 1))).double().cpu().numpy()
    return list(np.abs(e - e_ref) / np.abs(e_ref)), {"steps": steps}
