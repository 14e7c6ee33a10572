"""Run the robust ladder's GMRES(30) on the generated cantilever beam, as
the ladder's first rung alone or through ``solve_system``.

    python -m topopteval_tpu_torch.tools.ladder_probe [scale ...] [--rung]
        [--device cpu]

On the beam of each ``scale`` (25 s/2 x 4 s x s hexes, 6 tets each,
clamped at x = 0, a unit load at x = 60, float64) with the ladder's
settings (block-Jacobi, tolerance 1e-10, 20,000 iterations, restart 30)
it runs GMRES either alone (``--rung``: one restarted run with the
ladder's preconditioner, without the widened retry) or through
``solve_system`` (the whole ladder), and prints one line per scale: the
method as reported, iterations, convergence, wall seconds and ms per
iteration, and the energy against data/oracle_energies.json.  These runs
take minutes on the card, so chip_smoke.py leaves them out.
``--device cpu`` runs the plain versions of the kernels.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable, Optional, Sequence

import torch

from .. import api
from ..config import SolverConfig
from ..fem import solvers
from ..fem.bc import nodes_at_plane
from ..grid import generate_grid_tet
from ..materials import lame_parameters
from ..mesh import resolve_device
from ..utils import set_verbosity

BEAM_BOX = (60.0, 20.0, 4.0)
ORACLES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "..", "data", "oracle_energies.json")
LADDER = SolverConfig(method="gmres", preconditioner="block_diagonal",
                      tolerance=1e-10, max_iterations=20000, restart=30,
                      verbose=False)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m topopteval_tpu_torch.tools.ladder_probe",
        description="Run the ladder's GMRES(30) on the generated beam.")
    ap.add_argument("scales", nargs="*", type=int, default=[8],
                    help="beam scales (default 8: 153,600 tets)")
    ap.add_argument("--rung", action="store_true",
                    help="GMRES(30) alone, not through solve_system")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if any(s < 2 or s % 2 for s in args.scales):
        ap.error("a scale must be an even number >= 2")
    return args


def beam_problem(scale: int, device) -> api.Problem:
    mesh = generate_grid_tet(25 * scale // 2, 4 * scale, scale, (0, 0, 0),
                             BEAM_BOX)
    p = api.setup_problem(mesh, dtype=torch.float64, device=device)
    api.assemble_stiffness_matrix(p, *lame_parameters(1.0, 0.3))
    api.apply_fixed_boundary(p, nodes_at_plane(mesh, 0, 0.0))
    api.apply_force(p, nodes_at_plane(mesh, 0, BEAM_BOX[0]),
                    [0.0, 0.0, -1.0])
    return p


def run(scale: int, rung: bool = False, device="cuda",
        log: Callable[[str], None] = print) -> dict:
    """One run on the scale's beam; returns the printed figures."""
    dev = resolve_device(device)
    p = beam_problem(scale, dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    if rung:
        op = p.build_operator(with_bc=True)
        M = api._build_preconditioner(op, LADDER)
        f = torch.as_tensor(p.f, dtype=p.dtype, device=dev) * op.free_mask
        sync()
        t = time.perf_counter()
        x, it, est, conv, _ = solvers._gmres_run(
            op, f, torch.zeros_like(f), LADDER.tolerance, M,
            LADDER.max_iterations, LADDER.restart, False)
        sync()
        out = {"method": "gmres alone", "iterations": it, "converged": conv,
               "estimate": est,
               "true_residual": float(torch.linalg.vector_norm(
                   f - op.matvec(x)) / torch.linalg.vector_norm(f)),
               "energy": float(op.energy(x))}
    else:
        sync()
        t = time.perf_counter()
        r = api.solve_system(p, LADDER)
        sync()
        out = {"method": r.method, "iterations": r.iterations,
               "converged": r.converged, "energy": r.energy}
    out["seconds"] = time.perf_counter() - t
    out["ms_per_iter"] = 1e3 * out["seconds"] / max(out["iterations"], 1)
    with open(ORACLES) as fh:
        ref = json.load(fh)[f"tet_beam_scale_{scale}"]
    out.update(scale=scale, dofs=p.n_dofs,
               rel_err=abs(out["energy"] - ref) / abs(ref))
    log(f"[ladder_probe] scale={scale} dofs={p.n_dofs} restart="
        f"{LADDER.restart} "
        + " ".join(f"{k}={v!r}" if isinstance(v, float) else f"{k}={v}"
                   for k, v in out.items() if k not in ("scale", "dofs")))
    return out


def main(argv: Optional[Sequence[str]] = None) -> list:
    args = parse_args(argv)
    set_verbosity(False)
    return [run(s, args.rung, args.device) for s in args.scales]


if __name__ == "__main__":
    main()
