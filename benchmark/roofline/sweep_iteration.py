"""One lane-batched block-Jacobi PCG iteration of a design sweep
(``parallel/sweep``): the least time the work itself needs, whatever
implements it.

Bytes, a lane an iteration: the matvec's input read once and its output
written once, the element scales read once, the 3x3 block-Jacobi
inverses read once, and each PCG vector (x, r, z, p) read once and
written once; all at the lanes' width.  The mesh (coordinates and
connectivity, shared by the lanes) is read once an iteration.
Operations: 2 * 144 a Tet4 element a lane (its 12 x 12 stiffness times a
12-vector).  The larger of the two bounds, at the published peaks
(roofline/peaks.py).
"""

from __future__ import annotations

import numpy as np

from benchmark.roofline import peaks

FLOPS_PER_ELEMENT = 2 * 144


def lane_bytes(n_cells: int, n_nodes: int, itemsize: int) -> int:
    vec = 3 * n_nodes * itemsize
    return 2 * vec + n_cells * itemsize + 9 * n_nodes * itemsize + 8 * vec


def least_seconds_of(lane_iterations: int, steps: int, sizes: dict) -> float:
    C, N, item = sizes["n_cells"], sizes["n_nodes"], sizes["itemsize"]
    n_bytes = (lane_iterations * lane_bytes(C, N, item)
               + steps * (3 * N * 8 + 4 * C * 4))
    flops = lane_iterations * FLOPS_PER_ELEMENT * C
    return peaks.least_seconds(n_bytes, flops, item)


def least_seconds(iterations, sizes: dict) -> float:
    """The least seconds of one sweep call whose lanes took
    ``iterations`` steps each (a lane runs until it stops)."""
    it = np.asarray(iterations).reshape(-1)
    return least_seconds_of(int(it.sum()), int(it.max()), sizes)
