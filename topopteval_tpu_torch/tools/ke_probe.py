"""Probe two formulations of the Tet4 Ke batch against the production
kernel (counterpart of tools/tpu_ke_probe.py).

    python -m topopteval_tpu_torch.tools.ke_probe [scale] [--device cpu]
        [--dtype float64] [--reps N]

On the generated tet beam of ``scale`` (default 16: 1,228,800 tets) it
times the production Ke kernel (``ops.ke_kernels.tet4_ke``, element-major)
and the two probe variants (``tet4_ke_cse``, ``tet4_ke_lanes``, in the
[144, Cp] lane layout) at 128, 256 and 512 elements per block, and prints
each one's ms, tets/s, largest error against the production batch in the
lane layout, and the bound: 14 values read and 144 written per element
against 531 operations.  ``--device cpu`` runs the plain versions.
"""

from __future__ import annotations

import argparse
from typing import Callable, Optional, Sequence

import torch

from ..grid import generate_grid_tet
from ..materials import lame_parameters
from ..mesh import resolve_device
from ..ops import ke_kernels as kk
from ._timing import bound_ms, device_label, time_ms

#: the function's least operations per element (chip_smoke.py itemises
#: them: geometry 51, dots 60, the 78 entries of the upper triangle 420)
FLOPS_PER_ELEMENT = 531
BEAM_BOX = (60.0, 20.0, 4.0)
DTYPES = {"float32": torch.float32, "float64": torch.float64}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m topopteval_tpu_torch.tools.ke_probe",
        description="Time the Tet4 Ke formulations on the generated beam.")
    ap.add_argument("scale", nargs="?", type=int, default=16,
                    help="beam scale: 25 s/2 x 4 s x s hexes, 6 tets each "
                         "(default 16: 1,228,800 tets)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="float32")
    ap.add_argument("--reps", type=int, default=21,
                    help="timed replays of 10 calls (median)")
    args = ap.parse_args(argv)
    if args.scale < 2 or args.scale % 2:
        ap.error("scale must be an even number >= 2")
    return args


def run(scale: int = 16, device="cuda", dtype=torch.float32, reps: int = 21,
        log: Callable[[str], None] = print) -> dict:
    """Time production and both variants; returns ``{"C", "bound_ms",
    "bound_by", "rows": [{"name", "block", "ms", "tets_per_s",
    "max_rel_err"}]}``, errors relative to the largest production entry."""
    dev = resolve_device(device)
    mesh = generate_grid_tet(25 * scale // 2, 4 * scale, scale, (0, 0, 0),
                             BEAM_BOX)
    C = mesh.n_cells
    coords = torch.as_tensor(mesh.coords, dtype=dtype, device=dev)
    conn = torch.as_tensor(mesh.conn, device=dev)
    lam, mu = lame_parameters(1.0, 0.3)
    lam_e = torch.full((C,), lam, dtype=dtype, device=dev)
    mu_e = torch.full((C,), mu, dtype=dtype, device=dev)
    item = coords.element_size()
    b_ms, b_by = bound_ms(C * (14 + 144) * item, FLOPS_PER_ELEMENT * C,
                          dtype)
    log(f"[ke_probe] {device_label(dev)}; scale {scale}: C = {C} tets, "
        f"{str(dtype).split('.')[1]}, bound {b_ms:.4f} ms ({b_by})")

    ref = kk.tet4_ke(coords, conn, lam_e, mu_e).reshape(C, 144).t()
    scale_ref = float(ref.abs().max())
    rows = []

    def report(name, block, ms, err):
        rows.append({"name": name, "block": block, "ms": ms,
                     "tets_per_s": C / (ms * 1e-3), "max_rel_err": err})
        share = (f" ({100 * b_ms / ms:.0f} % of it)" if dev.type == "cuda"
                 else "")
        log(f"{name:18s} block={block:4d}: {ms:8.4f} ms -> "
            f"{C / (ms * 1e-3):.3e} tets/s   maxerr={err:.2e}   "
            f"bound {b_ms:.4f} ms{share}")

    report("production", 128, time_ms(
        lambda: kk.tet4_ke(coords, conn, lam_e, mu_e), dev, reps), 0.0)
    del ref
    for name, fn in (("cse", kk.tet4_ke_cse), ("lanes", kk.tet4_ke_lanes)):
        for block in kk.LANE_BLOCKS:
            ct, Cp = kk.element_coords_lanes(coords, conn, block)
            lam2, mu2 = kk.pad_lanes(lam_e, Cp), kk.pad_lanes(mu_e, Cp)
            out = fn(ct, lam2, mu2, block)
            ref = kk.tet4_ke(coords, conn, lam_e, mu_e).reshape(C, 144).t()
            err = float((out[:, :C] - ref).abs().max()) / scale_ref
            del out, ref
            report(name, block, time_ms(lambda: fn(ct, lam2, mu2, block),
                                        dev, reps), err)
    return {"C": C, "bound_ms": b_ms, "bound_by": b_by, "rows": rows}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    result = run(args.scale, args.device, DTYPES[args.dtype], args.reps)
    print("KE PROBE OK")
    return result


if __name__ == "__main__":
    main()
