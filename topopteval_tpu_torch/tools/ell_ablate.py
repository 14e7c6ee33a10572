"""Ablation probe of the block-ELL matvec: where does its time go?
(counterpart of tools/tpu_bell_ablate.py)

    python -m topopteval_tpu_torch.tools.ell_ablate [scale] [--device cpu]
        [--dtype float64] [--reps N]

It assembles the generated tet beam of ``scale`` (default 8) as 3x3
blocks, orders the nodes by RCM, packs them with ``pack_ell_rows`` and
times each mode of ``ops.ell.bell_ablate`` over a replayed CUDA graph of
``reps`` launches: ``full`` (the scan-window matvec, B9a's function),
``noskip`` (no window test before a load), ``nogather`` (each slot reads
its column's chunk at its own lane), ``nofinal`` (the gather stage only)
and ``empty`` (the value stage only).  For each it prints ms per matvec,
the bytes its function must move and its bound; the last line is
``ABLATE OK``.  ``--device cpu`` runs the plain versions.
"""

from __future__ import annotations

import argparse
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..fem.bell import rcm_order
from ..fem.operator import assemble_scipy
from ..grid import generate_grid_tet
from ..materials import lame_parameters
from ..mesh import resolve_device
from ..ops import ell as el
from ._timing import bound_ms, device_label, time_ms

BEAM_BOX = (60.0, 20.0, 4.0)
DTYPES = {"float32": torch.float32, "float64": torch.float64}
#: operations per stored block of a 3x3 block times a 3-vector into 3 sums
FLOPS_PER_BLOCK = 18


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m topopteval_tpu_torch.tools.ell_ablate",
        description="Time the modes of the block-ELL ablation kernel.")
    ap.add_argument("scale", nargs="?", type=int, default=8,
                    help="beam scale: 25 s/2 x 4 s x s hexes, 6 tets each "
                         "(default 8: 153,600 tets)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="float32")
    ap.add_argument("--reps", type=int, default=200,
                    help="launches in the timed CUDA graph")
    args = ap.parse_args(argv)
    if args.scale < 2 or args.scale % 2:
        ap.error("scale must be an even number >= 2")
    if args.reps < 1:
        ap.error("reps must be >= 1")
    return args


def beam_pack(scale: int) -> tuple:
    """(pack of ``pack_ell_rows``, real blocks, nodes) of the scale-``scale``
    beam's stiffness in RCM order (float64 values): the host assembly as
    3x3 blocks, one for every node pair that shares an element."""
    mesh = generate_grid_tet(25 * scale // 2, 4 * scale, scale, (0, 0, 0),
                             BEAM_BOX)
    lam, mu = lame_parameters(1.0, 0.3)
    N, C = mesh.n_nodes, mesh.n_cells
    K = assemble_scipy(mesh, np.full(C, lam), np.full(C, mu)).tobsr(
        blocksize=(3, 3))
    K.sort_indices()
    rows = np.repeat(np.arange(N), np.diff(K.indptr))
    perm = rcm_order(rows, K.indices, N)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(N)
    r, c = inv[rows], inv[K.indices]
    order = np.lexsort((c, r))
    pk = el.pack_ell_rows(r[order], c[order], K.data[order], N, N)
    return pk, len(r), N


def mode_bytes(mode: str, nnz: int, n_rows: int, n_cols: int,
               item: int) -> tuple:
    """(bytes, operations) of the function ``mode`` computes: every input
    it depends on read once, its output written once.  ``full``,
    ``noskip`` and ``nogather`` need every real block's column and values
    and the vector; ``nofinal`` the columns of slots 0-2 and one vector
    component; ``empty`` writes zeros."""
    out = 3 * n_rows * item
    if mode == "empty":
        return out, 0
    if mode == "nofinal":
        return 3 * n_rows * 4 + n_cols * item + out, 0
    return (nnz * (4 + 9 * item) + 3 * n_cols * item + out,
            FLOPS_PER_BLOCK * nnz)


def time_modes(tensors: dict, S: int, kc: int, u: torch.Tensor, nnz: int,
               n_rows: int, reps: int,
               modes: Sequence[str] = el.ABLATE_MODES,
               log: Callable[[str], None] = print) -> dict:
    """{mode: {"ms", "bytes", "bound_ms", "bound_by", "sum"}} of each mode
    on the packed ``tensors`` (cols2, vals2, wblk, gbounds)."""
    args = (tensors["cols2"], tensors["vals2"], tensors["wblk"],
            tensors["gbounds"])
    out = {}
    for mode in modes:
        y = el.bell_ablate(mode, *args, u, S, kc)
        ms = time_ms(lambda: el.bell_ablate(mode, *args, u, S, kc),
                     u.device, reps=3, inner=reps)
        n_bytes, n_ops = mode_bytes(mode, nnz, n_rows, u.shape[1],
                                    u.element_size())
        b_ms, b_by = bound_ms(n_bytes, n_ops, u.dtype)
        out[mode] = {"ms": ms, "bytes": n_bytes, "bound_ms": b_ms,
                     "bound_by": b_by, "sum": float(y.double().sum())}
        log(f"{mode:9s}: {ms:.4f} ms/matvec  bytes={n_bytes}  bound "
            f"{b_ms:.4f} ms ({b_by})  sum={out[mode]['sum']:.6e}")
    return out


def run(scale: int = 8, device="cuda", dtype=torch.float32,
        reps: int = 200, log: Callable[[str], None] = print) -> dict:
    """Build the pack and time every mode; returns ``{"S", "kc", "Nt",
    "nnz", "pack", "tensors", "u", "modes"}``."""
    dev = resolve_device(device)
    pk, nnz, n_nodes = beam_pack(scale)
    S, kc, Np = pk["S"], pk["kc"], pk["n_rows_p"]
    log(f"[ell_ablate] {device_label(dev)}; scale {scale}: {n_nodes} "
        f"nodes, {nnz} blocks; S={S} kc={kc} Nt={Np // el.LANES} "
        f"{str(dtype).split('.')[1]}")
    tensors = {k: torch.as_tensor(pk[k], device=dev)
               for k in ("cols2", "wblk", "gbounds")}
    tensors["vals2"] = torch.as_tensor(pk["vals2"], dtype=dtype, device=dev)
    u = np.zeros((3, Np))
    u[:, :n_nodes] = np.random.default_rng(0).standard_normal((3, n_nodes))
    u = torch.as_tensor(u, dtype=dtype, device=dev)
    modes = time_modes(tensors, S, kc, u, nnz, Np, reps, log=log)
    return {"S": S, "kc": kc, "Nt": Np // el.LANES, "nnz": nnz, "pack": pk,
            "tensors": tensors, "u": u, "modes": modes}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    result = run(args.scale, args.device, DTYPES[args.dtype], args.reps)
    print("ABLATE OK")
    return result


if __name__ == "__main__":
    main()
