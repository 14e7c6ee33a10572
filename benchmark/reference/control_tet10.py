"""The control of the Tet10 beam cells: the reference put in the program's
place one precision below what the configuration states (energy certified
in float64, stresses in float32), judged like the program.

The Tet10 reference's block-Jacobi PCG (reference/elasticity.pcg) in
float32 at the configuration's tolerance and step limit, with no float64
refinement, its energy f.u/2 in float32, and its stresses worked out in
bfloat16.  ``benchmark/controls.py`` and the tests call it; the
benchmark's own runs do not.
"""

from __future__ import annotations

import numpy as np
import torch

from .elasticity import pcg
from .judge import free_mask, judge_solution, lame_lanes
from .tet10 import Tet10Reference


def tet10_control(coords, conn, clamped, density, material: dict,
                  vector, tol: float, maxiter: int, device) -> tuple:
    """({resid, energy_gap, vm_gap}, notes): ``coords``/``conn`` the
    reference's own Tet10 mesh, ``clamped`` its clamped nodes, ``vector``
    the body force per unit volume, weighted by ``density``."""
    ref = Tet10Reference(coords, conn, device)
    f = ref.body_force(vector, density)
    m = free_mask(len(coords), clamped, ref.device)
    lam, mu = lame_lanes(np.asarray(density)[None], material, ref.device)
    f32 = Tet10Reference(coords, conn, device, dtype=torch.float32)
    fm = m.float() * torch.as_tensor(f, dtype=torch.float32,
                                     device=ref.device).reshape(-1, 3, 1)
    u32, steps = pcg(f32, lam.float(), mu.float(), m.float(), fm, tol,
                     maxiter)
    energy = float(0.5 * (fm * u32).sum())
    del f32
    low = Tet10Reference(coords, conn, device, dtype=torch.bfloat16)
    vm = low.von_mises(u32.bfloat16(), lam.bfloat16(), mu.bfloat16())[:, 0]
    got = judge_solution(ref, lam, mu, m, f, u32.double().cpu().numpy(),
                         energy, vm.float().cpu().numpy())
    return got, {"solve_steps": steps}
