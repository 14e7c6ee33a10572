#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (topopteval_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the repository root.  Phases, each printed as one line (or a
few) and each failing the script on a failed check:

1. device: the card's name and power limit (nvidia-smi), the kernel build
   (it fails if ptxas reports a spill in any kernel);
2. kernel parity: every CUDA kernel against its plain PyTorch version on
   the card, in float64 and float32, at the shapes of the real-size run:
   B1 (tet4 apply) at the scale-8 beam, the Tet4 fixture and the scale-16
   beam, B2 (hex8 apply) at the 25,600-hex box and the SIMP Hex8 fixture,
   each with the reuse of its per-tile node lists;
3. the two bundled fixtures through import → setup → assemble → BCs →
   forced block-Jacobi CG → export, against the port's fp64 host direct
   oracle (SIMP Hex8 beam in float32, Tet4 cantilever in float64);
4. the 153,600-tet cantilever written to .vtu, read back and solved with
   the default ``solve_system`` (auto picks CG above 50k DOFs), in
   float64 against data/oracle_energies.json and in float32 through the
   refinement route;
5. kernel times at the shapes of phase 2 (CUDA events over a replayed
   CUDA graph: device time) beside their bound, the plain version (eager)
   and a ``torch.bmm`` of a precomputed Ke batch as library yardstick;
   ``eager_ms`` is the kernel called from Python, wrapper checks included;
6. where one CG iteration on the real-size beam spends its time: the
   parts timed alone (B1 and the ``RowScatterPlan`` sum of its forces
   among them), the host wall time per iteration and the device's busy
   share under ``torch.profiler``;
7. the structured-multigrid route (``preconditioner="multigrid"``) on
   generated beams: both stencil kernels against their plain version at
   three shapes and bit for bit against each other, the float32 energy of
   a converged solution through the stencil, then scales 4, 8 and 16
   (1,228,800 tets, 666,315 DOFs) in
   float64 against data/oracle_energies.json, scale 8 once more through
   the opt-in ``window`` kernel, a per-hex SIMP scale-4 beam against the
   host direct oracle, and scale 16 in float32 through the refinement
   route; the stencil kernels' times beside their bound, the plain
   version and a two-``conv3d`` library yardstick (also at the two
   coarser smoothed levels, each yardstick on its own Ke); and
   where one MG-PCG iteration at scale 16 spends its time;
8. the block-ELL multigrid route on meshes without ``structured_info``:
   the 1,228,800-tet beam written to .vtu and read back, solved in float32
   (hi/lo system operator, bf16 V-cycle copies, float64 refinement)
   against data/oracle_energies.json; the refinement's float64 B4
   launches (over ``BellSystem.matrix64``, and over |values| |u|) at its
   fine shape against their plain version, timed, with the device
   residual and floor against the host twins (the same at the scale-8
   tet10 beam's fine shape in phase 9); both block-ELL kernels against their
   plain versions at that beam's fine-operator and transfer shapes, on a
   coarse Galerkin level and on a random matrix with empty rows, each
   launched twice and bit for bit the same; the lo
   plane's effect; the scale-8 beam uniform (float64, through the disk
   cache and back) and with the benchmark SIMP density (float64, the
   skeleton from the in-process cache; its energy held to twice the
   distance from the oracle of float64 direct solves of the same system
   under two column orders); the SIMP Hex8 fixture in float32
   against the host direct oracle; the kernels' times beside their bound,
   the plain version and a cuSPARSE yardstick; and where one MG-PCG
   iteration at scale 16 spends its time;
9. quadratic elements and the stored-Ke operator: the tet10 apply (B7)
   and the Ke-batch kernels (B6 tet4, B8 hex8 and tet10) against their
   plain versions at the scale-8 tet10 beam (153,600 elements), the
   scale-16 tet4 beam and the SIMP Hex8 fixture (hex8 also at phase 2's
   25,600-hex box, timed there too), B7 also on the Tet4
   fixture at order 2 (small tiles) and a ragged cut of the beam; the
   scale-4 tet10 beam
   through ``solve_system(p)`` with no config (fp32 block-Jacobi CG under
   fp64 refinement) and the scale-2 one in fp64, against
   data/oracle_energies.json; the Tet4 fixture at
   ``interpolation_order=2`` (50,274 DOFs) in fp64 against the host
   direct solve; the scale-8 tet10 beam (666,315 DOFs) by matrix-free
   fp64 block-Jacobi PCG and by the block-ELL multigrid in fp32, which
   must agree to 1e-8; stored mode on the scale-8 tet4 and scale-4 tet10
   beams and the SIMP Hex8 fixture (against otf) and a ``with_material``
   swap; a hex20 box against the direct solve; and the three kernels'
   times beside their bound, the plain version and a ``torch.bmm``
   yardstick (B7 also at the Tet4 fixture at order 2);
10. the Galerkin voxel multigrid (``TOPOPT_MG=galerkin``) and its
   scan-window ELL kernels, B9a ``bell_window`` and B9b ``sell_window``:
   both against their plain versions on random banded triplets with empty
   rows, on a window cut by hand, on node-major strided views and at the
   scale-16 block-ELL fine operator's shapes; the Tet4 fixture in float64
   against the direct solve and the CPU iteration count of both packages;
   the 1,228,800-tet beam written to .vtu and read back, solved in float32
   through float64 refinement against data/oracle_energies.json, with the
   build seconds by phase; the kernels at that route's level-1 and level-2
   operators and transfers; their times beside their bound, the plain
   version, one cuSPARSE call and B4/B5 on the same matrix (each also held
   to its own plain version there: B4 at the level-1 operator's 58 blocks
   a row); and where one MG-PCG iteration of that route spends its time,
   B1 and the ``RowScatterPlan`` sum on its fine level among the parts,
   with B9a's calls per iteration by level;
11. T1, the Ke-formulation probe (tools/ke_probe.py, counterpart of
   tools/tpu_ke_probe.py) run as a user runs it at the scale-16 beam in
   float32 and float64, then its two kernels (``tet4_ke_cse``,
   ``tet4_ke_lanes``) against their plain version and against B6 in the
   [144, C] lane layout at 128, 256 and 512 elements per block; their
   times beside the bound, B6 and phase 9h's ``torch.bmm`` yardstick;
12. T2, the block-ELL ablation probe (tools/ell_ablate.py, counterpart of
   tools/tpu_bell_ablate.py) run at scale 8, then the five modes of its
   kernel (``bell_ablate``) against their plain versions at the scale-8
   and scale-16 fine operators, a window cut by hand to kc = 1 and the
   S = 72 Galerkin level 1 in float64 (221 KB of shared scratch), full and
   noskip also against B9a; the modes' times at the scale-16 pack;
13. the load path at full size: gravity and a uniform traction on the
   x = 60 face of the 1,228,800-tet beam (the total force exact to
   1e-12), each solved by the stencil multigrid in float64 and by the
   block-ELL route in float32 (phase 8's hierarchy), which must agree to
   1e-8; a tet10 traction (tri6 facets) on the scale-4 tet10 beam by fp64
   and fp32-refined block-Jacobi CG on B7; the backward-error fallback
   forced on the block-ELL route; and the four examples
   (topopteval_tpu_torch/examples) with their JAX twins' checks;
14. the robust solver ladder and the other readers, in float64 at
   tolerance 1e-10 with block-Jacobi: MINRES on the scale-8 beam as the
   ladder's first rung alone (iterations, wall and device ms per
   iteration, the backward error against the ladder's gate), BiCGSTAB on
   it through ``solve_system`` (the energy within 1e-8 of
   data/oracle_energies.json), the device ms of a GMRES(30) and a GMRES(200)
   iteration there, and the ladder's GMRES through ``solve_system`` on the
   12x4x1 beam (it must end in GMRES; its energy held to the host direct
   solve by the residual it leaves); MINRES in float32 under the float64
   refinement (``minres+refine``); the forced fallbacks (a GMRES budget
   too small, a wrong ``u`` that the backward-error gate must reject);
   ``solve_system_robust`` verbose, its headings and the operator's
   device residency against the allocator's figure;
   ``solve_system_adaptive`` on the generated 1,228,800-tet beam
   (stencil multigrid, float64) and ``profile_to`` around three of its
   MG-PCG iterations (the trace must name the stencil kernel); the same
   beam written as .msh (v4.1 binary, v2.2 ASCII) with named surface
   groups and imported (arrays and node sets equal to the .vtu mesh's),
   then clamped and loaded by ``select_nodes_by_set`` and solved by
   ``solve_system_adaptive`` (block-ELL multigrid, float32, phase 8's
   hierarchy from its cache file), equal to phase 8's .vtu problem under
   the same call to 1e-12; the scale-4 tet10 beam as .msh in gmsh's node
   order; the scale-8 beam through .inp, solved, and converted to .vtu;
15. the port's host library and batched design sweeps: (15a) the library
   (csrc/host/topopt_native.cpp, built with g++ in phase 1; the run fails
   if it does not build or load) with phase 8's scale-16 block-ELL float32
   build by phase (it took the library route) beside the same build with
   the library off; (15b) the monolithic block-ELL build on the scale-8
   beam from .vtu in float64: forced by the skeleton budget at nu = 0.3
   (18 iterations as phase 8's skeleton route, the two energies as close
   as their true residuals allow, both within 1e-8 of
   data/oracle_energies.json), and taken by dispatch at nu = 0
   (lam = 0), within 1e-8 of the stencil multigrid route on the generated
   beam; (15c) BASELINE config 5 at full width: 64 SIMP densities x 4 tip
   loads on the 122,880-tet 80x32x8 box through ``evaluate_design_batch``
   in float32 (every lane converged, lanes per second, iterations, device
   kernels per iteration), three sampled lanes within 1e-3 of the port's
   float64 solve of that lane, and the SIMP Hex8 fixture's batch energy
   in float64 within 1e-6 of ``solve_system_simp``;
16. multi-device solves with four shards on the card (``devices=[cuda:0]
   * 4``, one process): (16a) the halo-exchange operator at scale 16 in
   float64 and float32 against the single-device operator (matvec,
   diagonal, node blocks) and B1 on every shard against its plain
   version, with the collectives' bytes and B1's launches per matvec;
   (16b) ``solve_system(devices=)`` with multigrid in float64 on the
   scale-8 beam from .vtu: phase 8's 18 iterations and the oracle to
   1e-8, B4/B5 in the coarse chain; (16c) the same in float32 on phase
   8's scale-16 problem (its hierarchy reused) through the refinement,
   with its build split and one MG-PCG iteration's wall and device ms;
   (16d) the sharded block-Jacobi CG at scale 8 in float64 against one
   device's count, in float32 at 1e-10 through the refinement, and a
   warm start; (16e) ``evaluate_design_batch(devices=[cuda:0] * 2)``,
   the einsum and pairs routes, against one device on the same parts and
   on all at once; (16f) ``dryrun.dryrun_multichip(4)`` on the card;
   and, where the machine has several cards, the halo matvec across
   them.

The line before last is one JSON object with a record per kernel; the
last line is the run's contract line.  Imports nothing of JAX.
"""

import dataclasses
import itertools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
import types

CG_KW = dict(method="cg", preconditioner="block_diagonal", tolerance=1e-10,
             max_iterations=20000, verbose=False)

# the card's peak rates and the bound (the larger of bytes over the memory
# rate and operations over the peak rate) and the timer, shared with the
# port's probes; importing them also fails in a directory without the port
from topopteval_tpu_torch.tools._timing import (  # noqa: E402
    bound_ms, time_ms as _time_ms)

# floating-point operations per element that the function needs (add,
# sub, mul, div each 1), counted for its least formulation, not for the
# kernel's own algorithm:
#  tet4: edges x_k - x_0 9; cofactors of the edge matrix 27, det 5,
#    r = 1/(6 det) 2, lam r and mu r 2; du_k = u_k - u_0 9;
#    H = sum_k du_k (x) adj_k 45; sigma from H (tr 3, 2 mu 1, diagonal 6,
#    off-diagonal 6) 16; f_k = sigma adj_k for k = 1..3 45 and
#    f_0 = -(f_1 + f_2 + f_3) 6.  Total 166.
#  hex8, 2x2x2 Gauss: reference gradients of the 3 coordinate and the 3
#    displacement fields at all 8 points, sum-factorised over the 1-D
#    two-point rule, 108 each (648); per point the cofactors of J 27,
#    det 5, 1/det 1, lam/det and mu/det 2, H adj(J) 45, sigma 16 and
#    P = sigma adj(J)^T 45, 141 (1128 for 8 points); the transposed
#    sum-factorised reduction of P onto the nodes, 160 for each of the
#    3 components (480).  Total 2256.
#  stencil (per hex cell, through its 6 constant-gradient tets; each is a
#    Kuhn tet whose vertices follow three axis-parallel edges, so column i
#    of grad u is one edge difference over h_i): per tet the 3 edge
#    differences 9 and their scaling 9; sigma from grad u 16; one weight
#    vol*esc 1; the 3 scaled columns s_i = w sigma e_i / h_i 9; the nodal
#    forces -s_1, s_1 - s_2, s_2 - s_3, s_3 6; 12 adds onto the corners.
#    62 per tet, 372 per cell.
#  tet10 apply, 4-point rule at barycentric (b, a, a, a) and its
#    permutations: the tet10 derivatives are linear in the barycentric
#    coordinates, so the reference gradients of the coordinate and the
#    displacement fields are a part common to the 4 points plus one
#    neighbour difference per point.  Per field the common part, 3
#    columns of 3 components, 7 each (63, 126 for both); per point the
#    gradients of both fields, 27 each (54), cofactors 27, det 5,
#    s = w/det 1, tr, lam s tr, mu s, 2 mu s 6, M = H adj(J) 45,
#    S = sigma(M) s 12, P = S adj(J)^T 45, the corner-0 column of P 9, the
#    node sums' 12 products (216 a point, 864); 3 x 12 adds of the sums
#    over the points, 18 adds of the mid-edge pairs, and the 30 nodal
#    forces from the sums, 78.  Total 1122.
#  Ke batches: a_k = dN_k adj(J) unscaled, s = w/det, so that
#    Ke = sum_q s (lam a_ia a_jb + mu a_ib a_ja + mu d_ab a_i.a_j); only
#    the upper triangle (3k(3k+1)/2 entries) is computed, 5 each, plus
#    one add per a == b entry of a node pair (3 per pair i <= j), the
#    k(k+1)/2 dots a_i.a_j (5 each) and their mu s scaling (1 each).
#  tet4 Ke (constant strain, one point): edges 9, cofactors 27, det 5,
#    1/(6 det) 2, lam and mu times it 2, a_0 = -(a_1 + a_2 + a_3) 6; dots
#    50 and 10; 78 entries 390; 30 adds.  Total 531.
#  hex8 Ke, 2x2x2 Gauss: J at all 8 points from the sum-factorised
#    coordinate gradients (324); per point cofactors, det, 1/det, w/det,
#    lam s, mu s 36, a_k 15 each (120), dots 180 and 36, 300 entries 1500,
#    108 adds (1980 per point); 300 x 7 adds over the points.  Total
#    18,264.
#  tet10 Ke, 4 points: per point J 171, 36, a_k 150, dots 275 and 55,
#    465 entries 2325, 165 adds (3177); 465 x 3 adds over the points.
#    Total 14,103.
FLOPS_PER_ELEMENT = {"tet4_apply": 166, "hex8_apply": 2256,
                     "stencil_plane": 372, "stencil_window": 372,
                     "tet10_apply": 1122, "tet4_ke": 531,
                     "hex8_ke": 18264, "tet10_ke": 14103}
REPLACES = {
    "tet4_apply": "topopteval_tpu/ops/pallas_kernels.py:137",
    "hex8_apply": "topopteval_tpu/ops/pallas_kernels.py:256",
    "tet10_apply": "topopteval_tpu/ops/pallas_kernels.py:343",
    "tet4_ke": "topopteval_tpu/ops/pallas_kernels.py:71",
    # B8: _make_iso_ke_kernel (:381) and its stream twin (:425), which the
    # JAX package calls by default; one CUDA kernel ports both
    "hex8_ke": "topopteval_tpu/ops/pallas_kernels.py:425",
    "tet10_ke": "topopteval_tpu/ops/pallas_kernels.py:425",
    "stencil_plane": "topopteval_tpu/ops/pallas_stencil.py:156",
    "stencil_window": "topopteval_tpu/ops/pallas_stencil.py:97",
    "bell_matvec": "topopteval_tpu/ops/pallas_bsr.py:287",
    "sell_matvec": "topopteval_tpu/ops/pallas_bsr.py:399",
    # B9a: _bell_kernel with _grouped_gather (:76), via bell_matvec_pallas
    "bell_window": "topopteval_tpu/ops/pallas_bsr.py:119",
    # B9b: _sell_kernel, via sell_matvec_pallas
    "sell_window": "topopteval_tpu/ops/pallas_bsr.py:204",
    # T1: the probe's two kernels, run by make_variant (:71)
    "tet4_ke_cse": "tools/tpu_ke_probe.py:27",
    "tet4_ke_lanes": "tools/tpu_ke_probe.py:48",
    # T2: make_kernel(mode), run by run() (:118)
    "bell_ablate": "tools/tpu_bell_ablate.py:56",
}
SOURCE = "topopteval_tpu_torch/csrc/element_apply.cu"
STENCIL_SOURCE = "topopteval_tpu_torch/csrc/stencil_apply.cu"
BELL_SOURCE = "topopteval_tpu_torch/csrc/bell_apply.cu"
KE_SOURCE = "topopteval_tpu_torch/csrc/element_ke.cu"
ELL_SOURCE = "topopteval_tpu_torch/csrc/ell_apply.cu"
ABLATE_SOURCE = "topopteval_tpu_torch/csrc/ell_ablate.cu"
# operations per stored entry that the block-ELL functions need: a 3x3
# block times a 3-vector added into 3 sums, 9 multiplies and 9 adds; a
# scalar weight times a 3-vector into 3 sums, 6
FLOPS_PER_BLOCK = {"bell_matvec": 18, "sell_matvec": 6}
# H100 SXM L2 cache
L2_BYTES = 50 * 2 ** 20
MG_KW = dict(method="cg", preconditioner="multigrid", tolerance=1e-10,
             max_iterations=500, verbose=False)
BEAM_BOX = (60.0, 20.0, 4.0)
TOLERANCE = {"float64": 1e-12, "float32": 1e-5}


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def ell_scalar_triplets(table):
    """(rows, cols, weights) of an ``fem.multigrid.EllTable`` on the host:
    its slots with a nonzero weight."""
    import numpy as np
    Nt = table.wblk.shape[0]
    cols = table.cols2.reshape(Nt, table.S, 128).permute(0, 2, 1) \
        .reshape(-1, table.S)[:table.n_rows].cpu().numpy()
    w = table.w2.reshape(Nt, table.S, 128).permute(0, 2, 1) \
        .reshape(-1, table.S)[:table.n_rows].double().cpu().numpy()
    live = w != 0
    rows = np.repeat(np.arange(table.n_rows), table.S).reshape(cols.shape)
    return rows[live], cols[live], w[live]


# gmsh element type ids of the writers below, and gmsh's node order of
# the tet10 (its last two mid-edge nodes swapped against VTK's)
GMSH_TYPE = {"tri3": 2, "tet4": 4, "tet10": 11}
GMSH_ORDER = {"tet10": [0, 1, 2, 3, 4, 5, 6, 7, 9, 8]}


def plane_triangles(coords, axis, value):
    """Triangles (tri3 node lists) covering every node of ``coords`` on
    the plane ``x[axis] = value``, where those nodes form a full lattice
    (any face of a generated box, of its tet10 refinement too)."""
    import numpy as np
    nodes = np.flatnonzero(np.abs(coords[:, axis] - value) <= 1e-9)
    a, b = [k for k in range(3) if k != axis]
    ua, ia = np.unique(coords[nodes, a], return_inverse=True)
    ub, ib = np.unique(coords[nodes, b], return_inverse=True)
    grid = np.full((len(ua), len(ub)), -1, np.int64)
    grid[ia, ib] = nodes
    if (grid < 0).any():
        raise ValueError("the plane's nodes do not form a full lattice")
    q = np.stack([grid[:-1, :-1], grid[1:, :-1], grid[1:, 1:],
                  grid[:-1, 1:]], axis=-1).reshape(-1, 4)
    return np.concatenate([q[:, [0, 1, 2]], q[:, [0, 2, 3]]])


def write_msh22_ascii(path, coords, groups):
    """A gmsh 2.2 ASCII file: ``groups`` is a list of (dim, physical tag,
    name, element type, conn [n, k] 0-based in VTK order)."""
    import numpy as np
    with open(path, "w") as fh:
        fh.write("$MeshFormat\n2.2 0 8\n$EndMeshFormat\n$PhysicalNames\n"
                 f"{len(groups)}\n")
        for dim, tag, name, _, _ in groups:
            fh.write(f'{dim} {tag} "{name}"\n')
        fh.write(f"$EndPhysicalNames\n$Nodes\n{len(coords)}\n")
        np.savetxt(fh, np.column_stack([np.arange(1, len(coords) + 1),
                                        coords]),
                   fmt=["%d", "%.17g", "%.17g", "%.17g"])
        n_el = sum(len(g[4]) for g in groups)
        fh.write(f"$EndNodes\n$Elements\n{n_el}\n")
        eid = 1
        for dim, tag, _, etype, conn in groups:
            conn = np.asarray(conn)[:, GMSH_ORDER.get(etype, slice(None))]
            n = len(conn)
            rows = np.column_stack([
                np.arange(eid, eid + n), np.full(n, GMSH_TYPE[etype]),
                np.full(n, 2), np.full(n, tag), np.full(n, tag), conn + 1])
            np.savetxt(fh, rows, fmt="%d")
            eid += n
        fh.write("$EndElements\n")


def write_msh41_binary(path, coords, groups):
    """A gmsh 4.1 binary file (little-endian, 8-byte size_t) of the same
    ``groups``; each group is one entity carrying its physical tag."""
    import numpy as np
    u8 = "<u8"
    by_dim = {d: [g for g in groups if g[0] == d] for d in (0, 1, 2, 3)}
    lo, hi = coords.min(axis=0), coords.max(axis=0)
    with open(path, "wb") as fh:
        fh.write(b"$MeshFormat\n4.1 1 8\n")
        fh.write(np.array([1], "<i4").tobytes())
        fh.write(b"\n$EndMeshFormat\n$PhysicalNames\n")
        fh.write(f"{len(groups)}\n".encode())
        for dim, tag, name, _, _ in groups:
            fh.write(f'{dim} {tag} "{name}"\n'.encode())
        fh.write(b"$EndPhysicalNames\n$Entities\n")
        fh.write(np.array([len(by_dim[d]) for d in range(4)], u8).tobytes())
        for d in (1, 2, 3):
            for _, tag, _, _, _ in by_dim[d]:
                fh.write(np.array([tag], "<i4").tobytes())
                fh.write(np.concatenate([lo, hi]).astype("<f8").tobytes())
                fh.write(np.array([1], u8).tobytes())
                fh.write(np.array([tag], "<i4").tobytes())
                fh.write(np.array([0], u8).tobytes())
        n = len(coords)
        fh.write(b"\n$EndEntities\n$Nodes\n")
        fh.write(np.array([1, n, 1, n], u8).tobytes())
        fh.write(np.array([3, by_dim[3][0][1], 0], "<i4").tobytes())
        fh.write(np.array([n], u8).tobytes())
        fh.write(np.arange(1, n + 1, dtype=u8).tobytes())
        fh.write(np.ascontiguousarray(coords, "<f8").tobytes())
        n_el = sum(len(g[4]) for g in groups)
        fh.write(b"\n$EndNodes\n$Elements\n")
        fh.write(np.array([len(groups), n_el, 1, n_el], u8).tobytes())
        eid = 1
        for dim, tag, _, etype, conn in groups:
            conn = np.asarray(conn)[:, GMSH_ORDER.get(etype, slice(None))]
            k = len(conn)
            fh.write(np.array([dim, tag, GMSH_TYPE[etype]], "<i4").tobytes())
            fh.write(np.array([k], u8).tobytes())
            fh.write(np.column_stack([np.arange(eid, eid + k), conn + 1])
                     .astype(u8).tobytes())
            eid += k
        fh.write(b"\n$EndElements\n")


def write_inp(path, coords, conn, abaqus_type="C3D4"):
    """An Abaqus .inp file of one element section (1-based ids)."""
    import numpy as np
    with open(path, "w") as fh:
        fh.write("*HEADING\n** written by chip_smoke.py\n*NODE\n")
        np.savetxt(fh, np.column_stack([np.arange(1, len(coords) + 1),
                                        coords]),
                   fmt=["%d", "%.17g", "%.17g", "%.17g"], delimiter=", ")
        fh.write(f"*ELEMENT, TYPE={abaqus_type}, ELSET=body\n")
        np.savetxt(fh, np.column_stack([np.arange(1, len(conn) + 1),
                                        np.asarray(conn) + 1]),
                   fmt="%d", delimiter=", ")


def galerkin_phase(env):
    """Phase 10: the Galerkin voxel multigrid (``TOPOPT_MG=galerkin``) and
    its kernels, B9a ``bell_window`` and B9b ``sell_window``.  ``env``
    carries main()'s helpers (check, solve, setup, report, oracle_energy,
    time_ms, library_call, records, main_path_launches) and the inputs:
    ``fine_bsr`` (the scale-16 block-ELL fine operator's host BSR, RCM
    order, from phase 8), ``beam16`` (the scale-16 beam), ``oracle16``,
    ``fixture_path``, ``tmp`` and ``dev``."""
    import numpy as np
    import torch

    import topopteval_tpu_torch as tt
    from topopteval_tpu_torch import api as tt_api
    from topopteval_tpu_torch.fem.solvers import cg
    from topopteval_tpu_torch.ops import bell as bo
    from topopteval_tpu_torch.ops import element_kernels as ek
    from topopteval_tpu_torch.ops import ell as el

    dev, check, time_ms = env.dev, env.check, env.time_ms
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    fns = {"bell_window": (el.bell_matvec_window,
                           el.bell_matvec_window_reference),
           "sell_window": (el.sell_matvec_window,
                           el.sell_matvec_window_reference)}
    errs, inputs = {}, {}

    def packed(rows, cols, data, n_rows, n_cols, dtype):
        pk = el.pack_ell_rows(rows, cols, data, n_rows, n_cols)
        t = {k: torch.as_tensor(pk[k], device=dev)
             for k in ("cols2", "wblk", "gbounds")}
        t["vals2"] = torch.as_tensor(pk["vals2"], dtype=dtype, device=dev)
        return pk, t

    def parity(name, label, t, S, kc, u, triplets, n_real, node_major=False,
               n_rows=None):
        """One launch against the plain version on the same inputs."""
        kern, plain = fns[name]
        args = (t["cols2"], t["vals2"], t["wblk"], t["gbounds"], u, S, kc)
        kw = {"node_major": node_major, "n_rows": n_rows}
        before = el.LAUNCHES[name]
        out = kern(*args, **kw)
        again = kern(*args, **kw)
        sync()
        check(el.LAUNCHES[name] == before + 2 * on_card,
              f"{name} did not count its launches")
        check(bool(torch.equal(out, again)),
              f"{name} {label}: a repeat differs")
        ref = plain(*args, **kw)
        check(out.shape == ref.shape and bool(torch.isfinite(out).all()),
              f"{name} {label}: shape {tuple(out.shape)} or not finite")
        if not node_major and n_rows is None:
            check(bool((out[:, n_real:] == 0).all()),
                  f"{name} {label}: a pad row is not zero")
        err = float((out - ref).abs().max())
        scale = float(ref.abs().max())
        tol = TOLERANCE[str(u.dtype).split(".")[1]]
        errs[(name, label)] = err
        inputs[(name, label)] = (args, kw, triplets)
        print(f"[parity] {name} {label} layout="
              f"{'[n,3] strides ' + str(tuple(u.stride())) if node_major else '[3,n]'}"
              f" rows={n_rows or out.shape[-1]} S={S} kc={kc} "
              f"max_abs_err={err:.3e} max|plain|={scale:.3e} "
              f"rel={err / scale:.3e} (tol {tol:.0e})", flush=True)
        check(err <= tol * scale,
              f"{name} {label} disagrees with its plain version")
        return out, ref

    # 10a. random banded triplets with empty rows (every seventh), the
    # packed window and one cut by hand to kc = 1, component-major and
    # node-major views of a wider buffer; then the scale-16 fine operator
    rng = np.random.default_rng(10)
    N = 5000
    rows = rng.integers(0, N, 60000)
    rows = rows[rows % 7 != 3]
    cols = np.clip(rows + rng.integers(-300, 301, rows.size), 0, N - 1)
    data = {"bell_window": rng.standard_normal((rows.size, 3, 3)),
            "sell_window": rng.standard_normal(rows.size)}
    for name in fns:
        for dtype in (torch.float64, torch.float32):
            dname = str(dtype).split(".")[1]
            pk, t = packed(rows, cols, data[name], N, N, dtype)
            trip = (rows, cols, data[name], pk["n_rows_p"], pk["n_cols_p"])
            u = torch.as_tensor(rng.standard_normal((3, pk["n_cols_p"])),
                                dtype=dtype, device=dev)
            full, _ = parity(name, f"random_{dname}", t, pk["S"], pk["kc"],
                             u, trip, N)
            cut, _ = parity(name, f"random_cut_kc1_{dname}", t, pk["S"], 1,
                            u, trip, N)
            check(float((full - cut).abs().max()) > 0,
                  f"{name}: the cut window dropped no column")
            wide = torch.zeros((pk["n_cols_p"], 5), dtype=dtype, device=dev)
            wide[:, 1:4] = u.t()
            nm, _ = parity(name, f"random_strided_{dname}", t, pk["S"],
                           pk["kc"], wide[:, 1:4], trip, N, node_major=True,
                           n_rows=N - 3)
            check(float((nm - full[:, :N - 3].t()).abs().max())
                  <= TOLERANCE[dname] * float(full.abs().max()),
                  f"{name}: the strided layout disagrees with [3, n]")

    hb = env.fine_bsr
    n16 = len(hb["indptr"]) - 1
    f_rows = np.repeat(np.arange(n16), np.diff(hb["indptr"]))
    f_cols = np.asarray(hb["indices"], np.int64)
    f_data = np.asarray(hb["data"], np.float64).reshape(-1, 3, 3)
    t0 = time.perf_counter()
    pk16 = el.pack_ell_rows(f_rows, f_cols, f_data, n16, n16)
    print(f"[galerkin] scale-16 fine operator (block-ELL RCM order) packed "
          f"by pack_ell_rows in {time.perf_counter() - t0:.2f} s: "
          f"rows={n16} blocks={f_rows.size} S={pk16['S']} kc={pk16['kc']} "
          f"n_rows_p={pk16['n_rows_p']}", flush=True)
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split(".")[1]
        t = {k: torch.as_tensor(pk16[k], device=dev)
             for k in ("cols2", "wblk", "gbounds")}
        t["vals2"] = torch.as_tensor(pk16["vals2"], dtype=dtype, device=dev)
        trip = (f_rows, f_cols, f_data, pk16["n_rows_p"], pk16["n_cols_p"])
        u = torch.as_tensor(rng.standard_normal((3, pk16["n_cols_p"])),
                            dtype=dtype, device=dev)
        full, _ = parity("bell_window", f"fine16_{dname}", t, pk16["S"],
                         pk16["kc"], u, trip, n16)
        if dtype == torch.float32:
            nm, _ = parity("bell_window", f"fine16_nodemajor_{dname}", t,
                           pk16["S"], pk16["kc"], u.t().contiguous(), trip,
                           n16, node_major=True, n_rows=n16)
    del t, full, nm

    # 10b. the Tet4 fixture through TOPOPT_MG=galerkin in float64 against
    # the port's direct solve; the CPU tests record 111 MG-PCG iterations
    # for both packages (tests/test_torch_galerkin.py).  Its one voxel
    # level is the coarsest (a dense pseudo-inverse), so B9b carries the
    # transfer and B9a has no level to apply here
    mg_cfg = tt.SolverConfig(**MG_KW)
    os.environ["TOPOPT_MG"] = "galerkin"
    try:
        p = env.setup(tt.import_mesh(env.fixture_path), torch.float64)
        ref = env.oracle_energy(p)
        r, secs, launches = env.solve(p, mg_cfg, "sell_window")
        rel = env.report("galerkin_fixture_fp64", r, secs, launches, ref)
        info = p._mg_build_info
        print(f"[galerkin_fixture_fp64] route={info['route']} "
              f"lattice={info['lattice']} voxel_levels={info['voxel_levels']}"
              f" reach={info['reach']} probes={info['n_probes']} "
              f"level_nodes={info['level_nodes']} iterations={r.iterations} "
              f"(both packages on the CPU: 111) build_phases_s="
              + json.dumps({k: round(v, 3) for k, v in info["phases"].items()}),
              flush=True)
        check(r.converged and rel <= 1e-8,
              f"Galerkin fixture rel_err {rel:.3e} > 1e-8")
        check(r.iterations == 111,
              f"Galerkin fixture took {r.iterations} iterations, not 111")

        # 10c. the scale-16 beam through .vtu (1,228,800 tets) in float32
        # through float64 refinement, tolerance 1e-10
        path = tt.write_vtu(os.path.join(env.tmp, "beam_scale_16_g.vtu"),
                            env.beam16)
        mesh = tt.import_mesh(path)
        check(mesh.structured_info is None
              and np.array_equal(mesh.conn, env.beam16.conn),
              "scale-16 beam does not round-trip through .vtu")
        p16 = env.setup(mesh, torch.float32)
        r, secs, launches = env.solve(p16, mg_cfg, "bell_window")
        sell_launches = el.LAUNCHES["sell_window"]
        rel = env.report("galerkin_beam16_fp32", r, secs, launches,
                         env.oracle16)
        info = p16._mg_build_info
        per_it = 1e3 * r.solve_time / max(r.iterations, 1)
        print(f"[galerkin_beam16_fp32] dofs={p16.n_dofs} "
              f"tets={mesh.n_cells} lattice={info['lattice']} voxel_levels="
              f"{info['voxel_levels']} reach={info['reach']} probes="
              f"{info['n_probes']} level_nodes={info['level_nodes']} "
              f"ell_widths={info['ell_widths']} lam_max_fine="
              f"{info['lam_max_fine']:.6f} iterations={r.iterations} "
              f"refinement_passes={r.refinement_passes} "
              f"build_operator_s={r.timings['build_operator']:.3f} "
              f"build_phases_s="
              + json.dumps({k: round(v, 3) for k, v in info["phases"].items()})
              + f" solve_s={r.solve_time:.3f} wall_ms_per_iter={per_it:.4f} "
              f"refine_host_build_s="
              f"{r.timings.get('refine_host_build_seconds', 0.0):.3f} "
              f"refine_host_matvec_s="
              f"{r.timings.get('refine_host_matvec_seconds', 0.0):.3f} "
              f"bell_window_launches={launches} "
              f"sell_window_launches={sell_launches}", flush=True)
        check(r.converged and r.refinement_passes > 0,
              "scale-16 Galerkin fp32 did not converge through refinement")
        check(rel <= 1e-8, f"scale-16 Galerkin fp32 rel_err {rel:.3e}")
        check(sell_launches > 0, "sell_window was not launched by the solve")
        op_g, M_g = tt_api._get_multigrid(p16)
    finally:
        os.environ.pop("TOPOPT_MG", None)

    # 10d. the kernels at the route's own shapes: the level-1 Galerkin
    # operator (node-major, as the V-cycle calls it) and the first
    # transfers, in the solve's float32 and in float64
    check(len(M_g.levels) >= 2, "the scale-16 hierarchy has no Galerkin "
          "level above its coarsest")
    L1 = M_g.levels[1].op
    # B9a runs on every Galerkin level above the coarsest: levels 1 and 2
    # at scale 16 (36,297 and 5,225 nodes, S 72)
    g_levels = {f"level{i}": M_g.levels[i].op for i in (1, 2)
                if i < len(M_g.levels) and hasattr(M_g.levels[i].op, "cols2")}
    P0, R0 = M_g.levels[0].transfer.P, M_g.levels[0].transfer.R
    trips = {k: L.triplets() for k, L in g_levels.items()}
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split(".")[1]
        for key, L in g_levels.items():
            t = {"cols2": L.cols2, "wblk": L.wblk, "gbounds": L.gbounds,
                 "vals2": L.vals2.to(dtype)}
            n = L.n_nodes
            u = torch.as_tensor(rng.standard_normal((n, 3)), dtype=dtype,
                                device=dev)
            parity("bell_window", f"{key}_{dname}", t, L.S, L.kc, u,
                   (*trips[key], n, n), n, node_major=True, n_rows=n)
        for label, T, n_cols in (("prolong0", P0, R0.n_rows),
                                 ("restrict0", R0, P0.n_rows)):
            t = {"cols2": T.cols2, "wblk": T.wblk, "gbounds": T.gbounds,
                 "vals2": T.w2.to(dtype)}
            u = torch.as_tensor(rng.standard_normal((n_cols, 3)),
                                dtype=dtype, device=dev)
            parity("sell_window", f"{label}_{dname}", t, T.S, T.kc, u,
                   (*ell_scalar_triplets(T), T.n_rows, n_cols), T.n_rows,
                   node_major=True, n_rows=T.n_rows)

    # 10e. kernel times beside their bound, the plain version, one
    # cuSPARSE call (library) and the port's other kernel for the function
    # (B4 / B5 on block-CSR of the same triplets).  Inputs smaller than
    # the L2 are timed cold: each call reads its own copy of them.
    def bound(name, args, kw, nnz):
        """(bound_ms, bound_by, padded_ms): the bytes of the ``nnz`` real
        entries (a column index and the values of each), the vector read
        once and the output written once, against the operations of the
        real entries; ``padded_ms`` counts every slot of the packed layout
        as read instead."""
        cols2, vals, wblk, _, u, S, kc = args
        item = u.element_size()
        n_cols = u.shape[0 if kw["node_major"] else 1]
        n_rows = kw["n_rows"] or wblk.shape[0] * 128
        vectors = 3 * n_cols * item + 3 * n_rows * item
        per_entry = 9 if name == "bell_window" else 1
        real = nnz * (4 + per_entry * vals.element_size()) + vectors
        padded = (cols2.numel() * 4 + vals.numel() * vals.element_size()
                  + wblk.numel() * 4 + vectors)
        flops = FLOPS_PER_BLOCK["bell_matvec" if name == "bell_window"
                                else "sell_matvec"] * nnz
        return (*bound_ms(real, flops, u.dtype),
                bound_ms(padded, flops, u.dtype)[0])

    def nbytes(*tensors):
        return sum(t.numel() * t.element_size() for t in tensors)

    def cold(make, n_bytes, calls):
        """(fn, inner, copies): ``fn`` cycles through enough copies of its inputs
        (``make(i)`` builds the call on copy i, copy 0 the originals) that
        they span twice the card's 50 MB L2, so no call finds its operands
        left there by an earlier one; ``inner`` is the multiple of the
        copy count nearest above ``calls``, for time_ms."""
        n = max(1, -(-2 * L2_BYTES // n_bytes))
        fns = [make(i) for i in range(n)]
        nxt = itertools.cycle(fns).__next__
        return (lambda: nxt()()), n * -(-calls // n), n

    def copies(i, *tensors):
        return tensors if i == 0 else tuple(t.clone() for t in tensors)

    timed = {"bell_window": ["fine16_float32", "fine16_float64",
                             "fine16_nodemajor_float32", "level1_float32",
                             "level1_float64"]
             + [f"{k}_{d}" for k in g_levels if k != "level1"
                for d in ("float32", "float64")],
             "sell_window": ["restrict0_float32", "prolong0_float32",
                             "restrict0_float64", "prolong0_float64"]}
    for name, labels in timed.items():
        kern, plain = fns[name]
        rec = {"name": name, "route": "cuda", "source": ELL_SOURCE,
               "replaces": REPLACES[name],
               "launches": env.main_path_launches[name]}
        for i, label in enumerate(labels):
            args, kw, (rows_t, cols_t, data_t, nr, nc) = inputs[(name, label)]
            u = args[4]
            u_cm = u.t().contiguous() if kw["node_major"] else u
            A = bo.pack_csr(rows_t, cols_t, data_t, nr, nc, u.dtype, dev)
            other = bo.bell_matvec if name == "bell_window" else \
                bo.sell_matvec
            lib_name = ("bell_matvec" if name == "bell_window"
                        else "sell_matvec")
            lib = env.library_call(lib_name, A, u_cm)
            want = plain(*args, **kw)
            want_cm = want.t() if kw["node_major"] else want[:, :nr]
            got = (lib().reshape(nr, 3).t() if name == "bell_window"
                   else lib().t())
            lib_err = float((got[:, :want_cm.shape[1]] - want_cm).abs().max()
                            / want_cm.abs().max())
            b_ms, b_by, padded_ms = bound(name, args, kw, len(rows_t))
            out_bytes = nbytes(want)
            # the port's other kernel on the same matrix, held to its own
            # plain version (B4 at the Galerkin level 1: 72 blocks a row)
            o_out = other(u_cm, A)
            env.check(o_out.shape == (3, A.n_rows)
                      and bool(torch.isfinite(o_out).all()),
                      f"{lib_name} at {label}: bad output")
            o_ref = (bo.bell_matvec_reference(u_cm, A)
                     if name == "bell_window"
                     else bo.sell_matvec_reference(u_cm, A))
            o_err = float((o_out - o_ref).abs().max())
            o_tol = TOLERANCE[str(u.dtype).split(".")[1]]
            print(f"[parity] {lib_name} {label} rows={A.n_rows} nnz={A.nnz} "
                  f"max_abs_err={o_err:.3e} rel="
                  f"{o_err / float(o_ref.abs().max()):.3e} (tol {o_tol:.0e})",
                  flush=True)
            env.check(o_err <= o_tol * float(o_ref.abs().max()),
                      f"{lib_name} at {label} disagrees with its plain "
                      "version")
            del o_out, o_ref

            def make_kern(j):
                c2, v2, wb, uj = copies(j, args[0], args[1], args[2], u)
                a = (c2, v2, wb, args[3], uj, args[5], args[6])
                return lambda: kern(*a, **kw)

            def make_csr(j, call):
                ip, cc, vv, uj = copies(j, A.indptr, A.cols, A.vals, u_cm)
                return call(dataclasses.replace(A, indptr=ip, cols=cc,
                                                vals=vv), uj)

            k_bytes = nbytes(*args[:3], u) + out_bytes
            c_bytes = nbytes(A.indptr, A.cols, A.vals, u_cm) + out_bytes
            kern_cold, k_inner, k_copies = cold(make_kern, k_bytes, 10)
            lib_cold, l_inner, _ = cold(
                lambda j: make_csr(j, lambda Aj, uj: env.library_call(
                    lib_name, Aj, uj)), c_bytes, 4)
            other_cold, o_inner, _ = cold(
                lambda j: make_csr(j, lambda Aj, uj: lambda: other(uj, Aj)),
                c_bytes, 10)
            vals = {
                "ms": time_ms(kern_cold, inner=k_inner, graph=True),
                "plain_ms": time_ms(lambda: plain(*args, **kw), reps=11,
                                    inner=2),
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": time_ms(lib_cold, reps=11, inner=l_inner),
                "max_abs_err": errs[(name, label)],
                "eager_ms": time_ms(kern_cold, inner=k_inner),
                "warm_ms": time_ms(lambda: kern(*args, **kw), graph=True),
                "padded_bound_ms": padded_ms,
                ("b4_ms" if name == "bell_window" else "b5_ms"):
                    time_ms(other_cold, inner=o_inner, graph=True),
            }
            print(f"[time] {name} {label} S={args[5]} kc={args[6]} "
                  f"rows={kw['n_rows'] or args[2].shape[0] * 128} "
                  f"nnz={len(rows_t)} copies={k_copies} "
                  + " ".join(f"{k}={v}" for k, v in vals.items())
                  + f" library_rel_err={lib_err:.2e} (library: one cuSPARSE "
                  f"{'BSR' if name == 'bell_window' else 'CSR'} product; "
                  "ms, eager_ms, library_ms and b4/b5_ms cold in L2, "
                  "warm_ms the same launch replayed on one copy; bound_ms "
                  "on the real entries, padded_bound_ms on every slot)",
                  flush=True)
            check(lib_err <= 10 * TOLERANCE[str(u.dtype).split(".")[1]],
                  f"{name} {label}: the library yardstick is off by "
                  f"{lib_err:.3e}")
            if i == 0:
                rec.update(vals)
                rec["shape"] = label
            else:
                rec.update({f"{k}_{label}": v for k, v in vals.items()})
            del A
        env.records.append(rec)

    # 10f. where one MG-PCG iteration of the scale-16 route (float32)
    # spends its time, and the kernel launches per iteration
    b = torch.as_tensor(p16.f, dtype=torch.float32, device=dev) \
        * op_g.free_mask
    iters = 20
    cg(op_g, b, M=M_g, tol=0.0, maxiter=3)               # warm-up
    sync()
    el.reset_launch_counts()
    ek.reset_launch_counts()
    # B9a's calls by level, told apart by their row counts
    from topopteval_tpu_torch.fem import ell as fe
    level_of = {L.n_nodes: k for k, L in g_levels.items()}
    by_level = {}
    window = fe.bell_matvec_window

    def counted(*args, **kw):
        key = level_of.get(kw.get("n_rows"), "other")
        by_level[key] = by_level.get(key, 0) + 1
        return window(*args, **kw)

    fe.bell_matvec_window = counted
    try:
        t = time.perf_counter()
        cg(op_g, b, M=M_g, tol=0.0, maxiter=iters)
        sync()
        wall_ms = 1e3 * (time.perf_counter() - t) / iters
    finally:
        fe.bell_matvec_window = window
    # the start costs what an iteration costs: one matvec, one V-cycle
    per = {k: v / (iters + 1) for k, v in (*el.LAUNCHES.items(),
                                           *ek.LAUNCHES.items()) if v}
    print("[breakdown] galerkin_beam16_fp32 bell_window calls per "
          "iteration by level: " + json.dumps(
              {k: round(v / (iters + 1), 2) for k, v in by_level.items()})
          + " (levels: " + json.dumps({k: [L.n_nodes, L.S] for k, L in
                                       g_levels.items()}) + ")", flush=True)
    # B1 on the fine level and the RowScatterPlan sum of its forces, the
    # two halves of the fine matvec (phase 6 prints the same pair at
    # scale 8)
    dm = op_g.dmesh
    f_e = ek.tet4_apply(dm.coords, dm.conn, b, op_g.lam, op_g.mu)
    parts = {"tet4_apply": time_ms(lambda: ek.tet4_apply(
                 dm.coords, dm.conn, b, op_g.lam, op_g.mu)),
             "scatter": time_ms(lambda: op_g.plan.scatter_add(f_e)),
             "system_matvec": time_ms(lambda: op_g.matvec(b)),
             "vcycle": time_ms(lambda: M_g.apply(b), reps=11, inner=2)}
    del f_e
    device_ms, top, n_launched = env.profile(
        lambda: cg(op_g, b, M=M_g, tol=0.0, maxiter=iters), iters)
    busy = (f"{device_ms / wall_ms:.3f}" if device_ms > 0
            else "not measured")
    print(f"[breakdown] galerkin_beam16_fp32 cg_wall_ms_per_iter="
          f"{wall_ms:.4f} device_ms_per_iter={device_ms:.4f} "
          f"device_busy_share={busy} launches_per_iter="
          + json.dumps({k: round(v, 2) for k, v in per.items()})
          + " (predicted bell_window 8, sell_window 6, tet4_apply 5) "
          f"device_kernels_per_iter={n_launched:.1f} "
          + " ".join(f"{k}_ms={v:.4f}" for k, v in parts.items()),
          flush=True)
    print("[breakdown] galerkin_beam16_fp32 top device ops per iteration "
          "(ms): " + ", ".join(f"{k[:48]}={v:.4f}" for k, v in top),
          flush=True)
    for name in fns:
        check(per.get(name, 0) > 0,
              f"{name} is not launched by an MG-PCG iteration")
    return {"pk16": pk16, "nnz16": f_rows.size, "level1": L1}


def probe_phases(env):
    """Phases 11 and 12: the probes' kernels.  ``env`` carries main()'s
    helpers (check, time_ms, records, main_path_launches, dev) and the
    inputs: ``probe_scale`` (16: the scale-16 beam), ``ablate_scale`` (8),
    ``ell`` (phase 10's scale-16 fine-operator pack ``pk16`` with its real
    block count ``nnz16``, and the Galerkin level-1 operator ``level1``).

    11, T1: the tool's main path (tools/ke_probe.py at the scale-16 beam,
    float32 and float64, counts set to 0 before it), then both variants
    against their plain version and against B6 in the lane layout at the
    three block sizes.  12, T2: the tool's main path (tools/ell_ablate.py at
    scale 8), then the five modes against their plain versions at the
    scale-8 and scale-16 fine operators, a window cut by hand to kc = 1
    and the S = 72 level-1 operator in float64 (221 KB of scratch), full
    and noskip also against B9a; the modes' times at the scale-16 pack."""
    import numpy as np
    import torch

    from topopteval_tpu_torch.ops import ell as el
    from topopteval_tpu_torch.ops import ke_kernels as kk
    from topopteval_tpu_torch.tools import ell_ablate, ke_probe

    dev, check, time_ms = env.dev, env.check, env.time_ms
    on_card = dev.type == "cuda"
    f32, f64 = torch.float32, torch.float64

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def record(name):
        return next(r for r in env.records if r["name"] == name)

    # 11a. the probe, as a user runs it: counts from 0, read just after.
    # A count is of wrapper calls: a call captured into a timing graph
    # counts once, though the graph's replays run its kernel reps x inner
    # times more
    kk.reset_launch_counts()
    t0 = time.perf_counter()
    probes = {dtype: ke_probe.run(env.probe_scale, dev, dtype, log=print)
              for dtype in (f32, f64)}
    sync()
    for name in ("tet4_ke_cse", "tet4_ke_lanes"):
        env.main_path_launches[name] += kk.LAUNCHES[name]
        check(kk.LAUNCHES[name] > 0, f"{name} was not launched by the probe")
    print(f"[ke_probe] seconds={time.perf_counter() - t0:.1f} launches="
          + json.dumps({n: kk.LAUNCHES[n] for n in ("tet4_ke",
                                                    "tet4_ke_cse",
                                                    "tet4_ke_lanes")})
          + " (wrapper calls; graph replays not counted)", flush=True)

    # 11b. parity at the probe's shapes: plain version and B6
    mesh = env.beam16
    C = mesh.n_cells
    lam0, mu0 = env.lame
    errs = {}
    for dtype in (f64, f32):
        coords = torch.as_tensor(mesh.coords, dtype=dtype, device=dev)
        conn = torch.as_tensor(mesh.conn, device=dev)
        lam_e = torch.full((C,), lam0, dtype=dtype, device=dev)
        mu_e = torch.full((C,), mu0, dtype=dtype, device=dev)
        b6 = kk.tet4_ke(coords, conn, lam_e, mu_e).reshape(C, 144).t()
        tol = TOLERANCE[dname_of(dtype)]
        for block in kk.LANE_BLOCKS:
            ct, Cp = kk.element_coords_lanes(coords, conn, block)
            lam2, mu2 = kk.pad_lanes(lam_e, Cp), kk.pad_lanes(mu_e, Cp)
            ref = kk.tet4_ke_lanes_reference(ct, lam2, mu2)
            scale = float(ref.abs().max())
            for name, fn in (("tet4_ke_cse", kk.tet4_ke_cse),
                             ("tet4_ke_lanes", kk.tet4_ke_lanes)):
                out = fn(ct, lam2, mu2, block)
                sync()
                check(bool(torch.isfinite(out).all())
                      and not bool(out[:, C:].any()),
                      f"{name} block {block}: not finite or a pad lane set")
                err = float((out - ref).abs().max())
                err_b6 = float((out[:, :C] - b6).abs().max())
                errs[(name, dname_of(dtype), block)] = err
                print(f"[parity] {name} {dname_of(dtype)} block={block} C={C} "
                      f"max_abs_err={err:.3e} rel={err / scale:.3e} vs B6 "
                      f"rel={err_b6 / scale:.3e} (tol {tol:.0e})",
                      flush=True)
                check(err <= tol * scale and err_b6 <= tol * scale,
                      f"{name} {dname_of(dtype)} block {block} disagrees")
                del out
            del ct, lam2, mu2, ref
        del b6, coords
        if on_card:
            torch.cuda.empty_cache()

    # 11c. records: the probe's times (fastest block first), the plain
    # version timed on the same inputs, B6 and the torch.bmm yardstick of
    # phase 9h (the same function on the same beam)
    b6_rec = record("tet4_ke")
    for name, row_name in (("tet4_ke_cse", "cse"),
                           ("tet4_ke_lanes", "lanes")):
        rec = {"name": name, "route": "cuda", "source": KE_SOURCE,
               "replaces": REPLACES[name],
               "launches": env.main_path_launches[name]}
        for dtype, sfx in ((f32, ""), (f64, "_fp64")):
            probe = probes[dtype]
            rows = [r for r in probe["rows"] if r["name"] == row_name]
            best = min(rows, key=lambda r: r["ms"])
            coords = torch.as_tensor(mesh.coords, dtype=dtype, device=dev)
            ct, Cp = kk.element_coords_lanes(
                coords, torch.as_tensor(mesh.conn, device=dev), best["block"])
            row = torch.full((1, Cp), lam0, dtype=dtype, device=dev)
            plain_ms = time_ms(lambda: kk.tet4_ke_lanes_reference(
                ct, row, row), reps=5, inner=1)
            del ct, row, coords
            prod = next(r for r in probe["rows"] if r["name"] == "production")
            vals = {"ms": best["ms"], "block": best["block"],
                    "plain_ms": plain_ms, "bound_ms": probe["bound_ms"],
                    "bound_by": probe["bound_by"],
                    "library_ms": b6_rec["library_ms" + sfx],
                    "max_abs_err": errs[(name, dname_of(dtype), best["block"])],
                    "b6_ms": prod["ms"]}
            vals.update({f"ms_block{r['block']}": r["ms"] for r in rows})
            print(f"[time] {name} {dname_of(dtype)} C={C} " + " ".join(
                f"{k}={v}" for k, v in vals.items())
                + " (library: the torch.bmm B^T DB of phase 9h; b6_ms: "
                "production tet4_ke, element-major)", flush=True)
            rec.update({k + sfx: v for k, v in vals.items()})
        env.records.append(rec)

    # 12a. the ablation probe, as a user runs it
    el.reset_launch_counts()
    t0 = time.perf_counter()
    abl = ell_ablate.run(env.ablate_scale, dev, f32, log=print)
    sync()
    env.main_path_launches["bell_ablate"] += el.LAUNCHES["bell_ablate"]
    check(el.LAUNCHES["bell_ablate"] > 0,
          "bell_ablate was not launched by the probe")
    print(f"[ell_ablate] scale {env.ablate_scale} seconds="
          f"{time.perf_counter() - t0:.1f} launches={el.LAUNCHES['bell_ablate']}"
          f" (wrapper calls; graph replays not counted) S={abl['S']} "
          f"kc={abl['kc']} Nt={abl['Nt']} nnz={abl['nnz']}", flush=True)

    # 12b. every mode against its plain version; full and noskip also
    # against B9a; empty all zeros
    rng = np.random.default_rng(12)
    pk16 = env.ell["pk16"]
    cases = []
    for label, pk, dtypes in ((f"scale{env.ablate_scale}", abl["pack"],
                               (f32, f64)),
                              ("fine16", pk16, (f32, f64))):
        for dtype in dtypes:
            t = {k: torch.as_tensor(pk[k], device=dev)
                 for k in ("cols2", "wblk", "gbounds")}
            t["vals2"] = torch.as_tensor(pk["vals2"], dtype=dtype,
                                         device=dev)
            u = torch.as_tensor(rng.standard_normal((3, pk["n_cols_p"])),
                                dtype=dtype, device=dev)
            cases.append((f"{label}_{dname_of(dtype)}", t, u, pk["S"], pk["kc"]))
    label, t, u, S, _ = cases[-2]                   # fine16 float32
    cases.append(("fine16_cut_kc1_float32", t, u, S, 1))
    L1 = env.ell["level1"]
    cases.append(("level1_S72_float64",
                  {"cols2": L1.cols2, "wblk": L1.wblk, "gbounds": L1.gbounds,
                   "vals2": L1.vals2.to(f64)},
                  torch.as_tensor(rng.standard_normal((3, L1.n_nodes)),
                                  dtype=f64, device=dev), L1.S, L1.kc))
    abl_errs = {}
    for label, t, u, S, kc in cases:
        args = (t["cols2"], t["vals2"], t["wblk"], t["gbounds"], u, S, kc)
        b9a = el.bell_matvec_window(*args)
        tol = TOLERANCE[dname_of(u.dtype)]
        scale = float(b9a.abs().max())
        for mode in el.ABLATE_MODES:
            out = el.bell_ablate(mode, *args)
            sync()
            ref = el.bell_ablate_reference(mode, *args)
            m_scale = max(float(ref.abs().max()), 1e-300)
            err = float((out - ref).abs().max())
            abl_errs[(label, mode)] = err
            extra = ""
            ok = err <= tol * m_scale and bool(torch.isfinite(out).all())
            if mode in ("full", "noskip"):
                e9 = float((out - b9a).abs().max())
                extra = f" vs B9a rel={e9 / scale:.3e}"
                ok = ok and e9 <= tol * scale
            if mode == "empty":
                ok = ok and not bool(out.any())
            print(f"[parity] bell_ablate {mode} {label} S={S} kc={kc} "
                  f"max_abs_err={err:.3e} rel={err / m_scale:.3e}{extra} "
                  f"(tol {tol:.0e})", flush=True)
            check(ok, f"bell_ablate {mode} {label} disagrees")

    # 12c. the modes' times at the scale-16 pack, float32 and float64
    b9a_rec = record("bell_window")
    rec = {"name": "bell_ablate", "route": "cuda", "source": ABLATE_SOURCE,
           "replaces": REPLACES["bell_ablate"],
           "launches": env.main_path_launches["bell_ablate"]}
    for dtype, sfx in ((f32, ""), (f64, "_fp64")):
        label, t, u, S, kc = next(c for c in cases
                                  if c[0] == f"fine16_{dname_of(dtype)}")
        Np = t["wblk"].shape[0] * 128
        modes = ell_ablate.time_modes(t, S, kc, u, env.ell["nnz16"], Np,
                                      200, log=lambda s: print(
                                          f"[time] bell_ablate "
                                          f"{dname_of(dtype)} fine16 " + s))
        args = (t["cols2"], t["vals2"], t["wblk"], t["gbounds"], u, S, kc)
        vals = {"ms": modes["full"]["ms"],
                "plain_ms": time_ms(lambda: el.bell_ablate_reference(
                    "full", *args), reps=11, inner=2),
                "bound_ms": modes["full"]["bound_ms"],
                "bound_by": modes["full"]["bound_by"],
                "library_ms": b9a_rec["library_ms" + (
                    "_fine16_float64" if dtype == f64 else "")],
                "max_abs_err": abl_errs[(label, "full")],
                # B9a on the same inputs, timed as the modes are
                "b9a_ms": time_ms(lambda: el.bell_matvec_window(*args),
                                  reps=3, inner=200, graph=True)}
        for mode in el.ABLATE_MODES[1:]:
            vals[f"ms_{mode}"] = modes[mode]["ms"]
            vals[f"bound_ms_{mode}"] = modes[mode]["bound_ms"]
        print(f"[time] bell_ablate {dname_of(dtype)} fine16 S={S} kc={kc} "
              + " ".join(f"{k}={v}" for k, v in vals.items())
              + " (library: phase 10e's cuSPARSE BSR on the same matrix, "
              "cold in L2; the modes and b9a_ms over a graph of 200 launches "
              "on inputs larger than the L2)", flush=True)
        rec.update({k + sfx: v for k, v in vals.items()})
    env.records.append(rec)


def load_phase(env):
    """Phase 13: the load path at full size, and the examples.  ``env``
    carries main()'s helpers (check, solve, setup_bare, report) and
    inputs: ``beam16`` (the generated scale-16 beam), ``p16b`` (phase 8's
    block-ELL problem on the same beam read back from .vtu, fp32, its
    hierarchy built), ``MG``, ``CG``, ``lame``, ``dev``, ``tmp``,
    ``quad_mesh`` (the scale-4 tet4 beam) and ``fallback_box`` (the 12x4x4
    box without ``structured_info``)."""
    import numpy as np
    import torch

    import topopteval_tpu_torch as tt
    from topopteval_tpu_torch import api as tt_api
    from topopteval_tpu_torch.fem.bell import BellSystem
    from topopteval_tpu_torch.fem.solvers import cg
    from topopteval_tpu_torch.examples import (cantilever_beam,
                                               gravity_validation,
                                               imported_mesh_multigrid,
                                               simp_density_eval)

    check, solve, dev = env.check, env.solve, env.dev
    f32, f64 = torch.float32, torch.float64
    rho, g = 1.0, 9.81
    x_end = float(env.beam16.coords[:, 0].max())

    def total_force(p):
        """Sum of the load vector by component, correctly rounded
        (math.fsum): a plain running sum over 222,105 nodes drifts by
        ~1e-12 of the total by itself."""
        return np.array([math.fsum(p.f[a::3]) for a in range(3)])

    def gravity(p):
        t = time.perf_counter()
        tt.apply_gravity(p, rho, g)
        secs = time.perf_counter() - t
        return secs, total_force(p), -rho * g * float(np.prod(BEAM_BOX))

    def traction(p):
        t = time.perf_counter()
        # every node on the plane (mid-edge nodes of a tet10 included):
        # no surface extraction of the 1,228,800-tet mesh needed
        facets = tt.get_boundary_facets(
            p.mesh, tt.nodes_at_plane(p.mesh, 0, x_end))
        tt.apply_uniform_surface_traction(p, facets, [0.0, 0.0, -1.0])
        secs = time.perf_counter() - t
        return secs, total_force(p), -1.0

    # 13a/b. gravity, then a uniform traction on the x = 60 face, on the
    # 1,228,800-tet beam: the stencil multigrid in float64 (the generated
    # mesh) and the block-ELL route in float32 under float64 refinement
    # (phase 8's .vtu problem, its hierarchy reused: f is reset, the
    # material and BCs are the same)
    p_st = env.setup_bare(env.beam16, f64)
    p_bell = env.p16b
    op_bell, M_bell = tt_api._get_multigrid(p_bell)
    check(isinstance(op_bell, BellSystem),
          "the .vtu problem left the block-ELL route")

    def fp64_readings(u_il, f, fn):
        """(‖f - K u‖, eps·‖|K| |u|‖) over ‖f‖ for an interleaved answer,
        through the block-ELL system's float64 host matvec, the residual
        that the refinement tests: its true residual, and the rounding
        that a float64 matvec of that u may carry."""
        K, m = op_bell._host_csr64()
        Np = op_bell.matrix.n_rows_p
        x = op_bell.to_cm(u_il) * m
        r = f - op_bell.matvec64(x)
        a = (abs(K) @ np.abs(x.reshape(3, Np).T.reshape(-1))) \
            .reshape(Np, 3).T.reshape(-1) * m
        return (float(np.linalg.norm(r) / fn),
                float(np.finfo(np.float64).eps * np.linalg.norm(a) / fn))

    for tag, load in (("gravity", gravity), ("traction", traction)):
        results = {}
        for route, p, kernel in (("stencil_fp64", p_st, "stencil_plane"),
                                 ("bell_fp32", p_bell, "bell_matvec")):
            p.f = np.zeros(p.n_dofs)
            secs, total, want = load(p)
            err = float(np.abs(total - [0.0, 0.0, want]).max()) / abs(want)
            print(f"[load_{tag}] {route} dofs={p.n_dofs} load_build_s="
                  f"{secs:.3f} sum_f={total.tolist()} want_z={want!r} "
                  f"rel_err={err:.3e} (tol 1e-12)", flush=True)
            check(err <= 1e-12, f"{tag} total force off by {err:.3e}")
            r, s, launches = solve(p, env.MG, kernel)
            env.report(f"load_{tag}_{route}", r, s, launches, r.energy)
            results[route] = r
        # the float64 floor: both answers through the refinement's own
        # float64 matvec, and the stencil answer through the stencil's
        # float64 device operator (a fresh matvec, not the recurrence)
        r_st, r_b = results["stencil_fp64"], results["bell_fp32"]
        f64_cm = op_bell.to_cm(p_bell.f) \
            * op_bell.free_mask.double().cpu().numpy()
        fn = float(np.linalg.norm(f64_cm))
        target = env.MG.tolerance * (1.0 + fn) / fn
        res_st, round_st = fp64_readings(r_st.u, f64_cm, fn)
        res_b, round_b = fp64_readings(r_b.u, f64_cm, fn)
        op_st = tt_api._get_multigrid(p_st)[0]
        f_d = torch.as_tensor(p_st.f, dtype=f64, device=dev) \
            * op_st.free_mask
        u_d = torch.as_tensor(r_st.u, dtype=f64, device=dev) \
            * op_st.free_mask
        res_own = float(torch.linalg.vector_norm(f_d - op_st.matvec(u_d))
                        / torch.linalg.vector_norm(f_d))
        print(f"[load_{tag}] float64 true residual / |f|: stencil answer "
              f"{res_st:.3e} (its own float64 operator {res_own:.3e}), "
              f"block-ELL answer {res_b:.3e}; rounding eps|K||u|/|f| "
              f"{round_st:.3e} / {round_b:.3e}; refinement target "
              f"tol(1+|f|)/|f| = {target:.3e}", flush=True)
        if not r_b.converged:
            # a known outcome, not hidden: the refinement's target lies
            # below what a float64 matvec can resolve for this load (the
            # fp64 stencil answer, converged by its recurrence residual,
            # reads no lower).  Twelve passes instead of six show the stall
            def inner(rhs, left, tol_inner):
                res = cg(op_bell, rhs, M=M_bell, tol=tol_inner,
                         maxiter=left)
                return res.x, res.niter, res.history

            _, its, rn12, conv12, _, _ = tt_api._refined_generic(
                op_bell, inner, f64_cm, env.MG.tolerance, 5000, dev,
                max_passes=12)
            print(f"[load_{tag}] KNOWN: bell_fp32 stops at "
                  f"{r_b.residual_norm / fn:.3e} of |f| after "
                  f"{r_b.refinement_passes} passes, above the target "
                  f"{target:.3e}; with 12 passes {rn12 / fn:.3e} ({its} "
                  f"iterations, converged={conv12}): the float64 floor of "
                  f"this load, not a port fault (ROADMAP Queue C)",
                  flush=True)
            check(res_b <= res_st,
                  f"{tag} bell_fp32 ends above the float64 floor: "
                  f"{res_b:.3e} > {res_st:.3e}")
        check(r_st.converged, f"{tag} stencil_fp64 did not converge")
        energies = {route: r.energy for route, r in results.items()}
        rel = abs(energies["stencil_fp64"] - energies["bell_fp32"]) \
            / abs(energies["stencil_fp64"])
        print(f"[load_{tag}] energies " + json.dumps(energies)
              + f" rel_diff={rel:.3e} (tol 1e-08)", flush=True)
        check(rel <= 1e-8, f"{tag}: the two routes disagree by {rel:.3e}")
    del p_st, op_st, f_d, u_d

    # 13c. tet10 traction (tri6 facets) on the scale-4 tet10 beam: fp64
    # block-Jacobi CG on B7 against fp32 CG under fp64 refinement
    energies = {}
    for dtype in (f64, f32):
        p = tt.setup_problem(env.quad_mesh, interpolation_order=2,
                             dtype=dtype, device=dev)
        tt.assemble_stiffness_matrix(p, *env.lame)
        tt.apply_fixed_boundary(p, tt.nodes_at_plane(p.mesh, 0, 0.0))
        secs, total, want = traction(p)
        err = float(np.abs(total - [0.0, 0.0, want]).max())
        print(f"[load_tet10_traction] {dname_of(dtype)} dofs={p.n_dofs} "
              f"load_build_s={secs:.3f} sum_f={total.tolist()} "
              f"abs_err={err:.3e} (tol 1e-12)", flush=True)
        check(err <= 1e-12, f"tet10 traction total off by {err:.3e}")
        r, s, launches = solve(p, env.CG, "tet10_apply")
        env.report(f"load_tet10_traction_{dname_of(dtype)}", r, s, launches,
                   r.energy)
        check(r.converged, "tet10 traction solve did not converge")
        energies[dname_of(dtype)] = r.energy
    rel = abs(energies["float32"] - energies["float64"]) / energies["float64"]
    print("[load_tet10_traction] energies " + json.dumps(energies)
          + f" rel_diff={rel:.3e} (tol 1e-08)", flush=True)
    check(rel <= 1e-8, f"tet10 traction routes disagree by {rel:.3e}")

    # 13d. the forced verification fallback on the block-ELL route
    box = env.fallback_box
    p = env.setup_bare(box, f64)
    tt.apply_force(p, tt.nodes_at_plane(box, 0, 12.0), [0.0, 0.0, -1.0])
    direct = tt.solve_system(p, tt.SolverConfig(method="direct"))
    gate = tt_api._backward_error
    tt_api._backward_error = lambda *args: (1.0, 1.0)
    try:
        r = tt.solve_system(p, env.MG)
    finally:
        tt_api._backward_error = gate
    rel = abs(r.energy - direct.energy) / direct.energy
    print(f"[fallback] block-ELL route, gate forced: method={r.method} "
          f"energy={r.energy!r} direct={direct.energy!r} rel={rel:.3e} "
          f"(tol 1e-12) route={type(p._mg_cache[1]).__name__}", flush=True)
    check(r.method == "direct(verification-fallback)" and rel <= 1e-12
          and isinstance(p._mg_cache[1], BellSystem),
          "the block-ELL fallback did not return the direct energy")

    # 13e. the four examples on the card, with their JAX twins' checks
    argv = ["--device", str(dev), "--out-dir", env.tmp]
    t = time.perf_counter()
    ex = {"cantilever_beam": cantilever_beam.main(argv),
          "gravity_validation": gravity_validation.main(argv),
          "imported_mesh_multigrid": imported_mesh_multigrid.main(argv),
          "simp_density_eval": simp_density_eval.main(argv)}
    print(f"[examples] seconds={time.perf_counter() - t:.1f} " + json.dumps(
        {k: {n: v for n, v in r.items() if n != "files"}
         for k, r in ex.items()}), flush=True)
    check(ex["gravity_validation"]["error_percent"] < 5.0,
          "gravity example off Euler-Bernoulli by 5 % or more")
    im = ex["imported_mesh_multigrid"]
    check(im["converged"] and im["rel_err"] < 2e-2,
          "imported-mesh multigrid example failed its checks")
    for name in ("cantilever_beam", "simp_density_eval"):
        check(all(os.path.getsize(f) > 0 for f in ex[name]["files"]),
              f"{name} example exported an empty file")


def ladder_phase(env):
    """Phase 14a-d: the robust solver ladder on the card.  ``env`` carries
    main()'s helpers (check, solve, setup, profile) and inputs: ``beam``
    (the generated scale-8 beam), ``beams`` (generated beams by scale),
    ``oracles`` (data/oracle_energies.json) and ``dev``."""
    import contextlib
    import io

    import numpy as np
    import torch

    import topopteval_tpu_torch as tt
    from topopteval_tpu_torch import api as tt_api
    from topopteval_tpu_torch.fem import robust, solvers
    from topopteval_tpu_torch.fem.operator import assemble_scipy

    check, dev = env.check, env.dev
    f64, f32 = torch.float64, torch.float32
    LADDER_KW = dict(preconditioner="block_diagonal", tolerance=1e-10,
                     max_iterations=20000, restart=30, verbose=False)

    def rel(e, scale):
        ref = env.oracles[f"tet_beam_scale_{scale}"]
        return abs(e - ref) / abs(ref)

    def rung(p):
        """(operator, the ladder's preconditioner, masked load) of p."""
        op = p.build_operator(with_bc=True)
        M = tt_api._build_preconditioner(op, tt.SolverConfig(**LADDER_KW))
        f = torch.as_tensor(p.f, dtype=p.dtype, device=dev) * op.free_mask
        return op, M, f

    def device_ms(p, method, iters, m=None):
        """Device ms per iteration of ``iters`` iterations of the method
        (tolerance 0, so none stops early) under torch.profiler."""
        op, M, f = rung(p)
        if method == "gmres":
            fn = lambda: solvers._gmres_run(  # noqa: E731
                op, f, torch.zeros_like(f), 0.0, M, iters, m, False)
        else:
            fn = lambda: getattr(solvers, method)(  # noqa: E731
                op, f, M=M, tol=0.0, maxiter=iters)
        fn()
        ms, top, kpi = env.profile(fn, iters)
        return ms, kpi

    # -- 14a. MINRES, BiCGSTAB, GMRES in float64 ---------------------------
    beam_p = env.setup(env.beam, f64)
    check(beam_p.n_dofs == 89_991, "scale-8 beam is not 89,991 DOFs")
    ladder = {}

    # MINRES, the ladder's first rung alone: its recurrence meets the
    # tolerance while its true residual stalls at its attainable accuracy
    # (about eps·cond·|f|, above CG's); where the backward error is above
    # the gate, the ladder (as the JAX package's) returns the host direct
    # solve, a route tests/test_torch_verification_gate.py drives
    op, M, f = rung(beam_p)
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = solvers.minres(op, f, M=M, tol=1e-10, maxiter=20000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    eta, ffrac = tt_api._backward_error(op, f, res.x)
    eta_max = 100.0 * float(torch.finfo(f64).eps) + 100.0 * 1e-10 * ffrac
    true_r = float(torch.linalg.vector_norm(f - op.matvec(res.x)))
    e_rel = rel(float(op.energy(res.x)), 8)
    del op, M, f
    ms_dev, kpi = device_ms(beam_p, "minres", 50)
    ladder["minres"] = {"iterations": res.niter, "converged": res.converged,
                        "wall_ms_per_iter": 1e3 * wall / res.niter,
                        "device_ms_per_iter": ms_dev, "kernels_per_iter": kpi,
                        "backward_error": eta, "gate": eta_max}
    print(f"[ladder_minres_fp64] rung 1 alone: iterations={res.niter} "
          f"converged={res.converged} reported_residual="
          f"{res.residual_norm:.3e} true_residual={true_r:.3e} "
          f"wall_s={wall:.3f} wall_ms_per_iter={1e3 * wall / res.niter:.4f} "
          f"device_ms_per_iter={ms_dev:.4f} kernels_per_iter={kpi:.1f} "
          f"backward_error={eta:.3e} gate={eta_max:.3e} "
          f"energy_rel_err={e_rel:.3e}", flush=True)
    check(res.converged, "minres's recurrence did not converge")
    if eta <= eta_max:      # the ladder would return this iterate
        check(e_rel <= 1e-8, f"minres fp64 energy rel_err {e_rel:.3e}")
    else:
        print(f"[ladder_minres_fp64] KNOWN: backward error {eta:.3e} > gate "
              f"{eta_max:.3e}, so solve_system(method='minres') returns "
              "direct(verification-fallback) here, as the JAX package's "
              "does (ROADMAP Queue C 6)", flush=True)

    # BiCGSTAB through solve_system
    r, secs, launches = env.solve(
        beam_p, tt.SolverConfig(method="bicgstab", **LADDER_KW),
        "tet4_apply", method="bicgstab")
    ms_dev, kpi = device_ms(beam_p, "bicgstab", 50)
    e_rel = rel(r.energy, 8)
    ladder["bicgstab"] = {"iterations": r.iterations,
                          "wall_ms_per_iter": 1e3 * r.solve_time
                          / r.iterations,
                          "device_ms_per_iter": ms_dev,
                          "kernels_per_iter": kpi, "method": r.method}
    print(f"[ladder_bicgstab_fp64] solve_system: method={r.method} "
          f"iterations={r.iterations} converged={r.converged} "
          f"energy={r.energy!r} rel_err={e_rel:.3e} (tol 1e-08) "
          f"solve_s={secs:.3f} wall_ms_per_iter="
          f"{1e3 * r.solve_time / r.iterations:.4f} device_ms_per_iter="
          f"{ms_dev:.4f} kernels_per_iter={kpi:.1f} "
          f"tet4_apply_launches={launches}", flush=True)
    check(r.converged and e_rel <= 1e-8,
          f"bicgstab fp64 energy rel_err {e_rel:.3e}")

    # GMRES: the cost of an iteration at scale 8 (GMRES(30) and the
    # widened retry's m = 200); restarted GMRES(30) does not converge in
    # 20,000 iterations there nor at scale 4 (topopteval_tpu_torch/tools/
    # ladder_probe.py; ROADMAP Queue C 6)
    ms30, kpi30 = device_ms(beam_p, "gmres", 60, m=30)
    ms200, kpi200 = device_ms(beam_p, "gmres", 200, m=200)
    print(f"[ladder_gmres_fp64] scale 8 device_ms_per_iter m=30 {ms30:.4f} "
          f"({kpi30:.1f} kernels), m=200 {ms200:.4f} ({kpi200:.1f} kernels)",
          flush=True)
    del beam_p
    # the ladder's GMRES(30) through solve_system on the 12x4x1 beam (the
    # scale-8 beam's box, 390 DOFs): it must end in GMRES, not a fallback.
    # Its energy is held to the host direct solve by the residual it
    # leaves: with r = f - K u, E(u) - E* = -r.(u + u*)/2 exactly, and
    # GMRES stops on the preconditioned residual, so its energy error is
    # first order in r (about 1e-8 of E* at tolerance 1e-10 here and on
    # the beams of scale 2, in both packages: ROADMAP Queue C 6)
    p = env.setup(tt.generate_grid_tet(12, 4, 1, (0, 0, 0), BEAM_BOX), f64)
    r, secs, launches = env.solve(
        p, tt.SolverConfig(method="gmres", **LADDER_KW), "tet4_apply",
        method="gmres")
    mask = tt.free_mask_from_bcs(p.n_dofs, p.bcs)
    K = assemble_scipy(p.mesh, p.lam, p.mu, order=p.quad_order,
                       free_mask=mask)
    f = p.f * mask
    u_star = solvers.direct_solve(K, f)
    e_star = 0.5 * float(u_star @ (K @ u_star))
    u = np.asarray(r.u, dtype=np.float64) * mask
    resid = f - K @ u
    aK = abs(K)
    rounding = 64 * np.finfo(np.float64).eps * (
        abs(u) @ (aK @ abs(u)) + abs(u_star) @ (aK @ abs(u_star)))
    bound = 0.5 * np.linalg.norm(resid) * (np.linalg.norm(u)
                                           + np.linalg.norm(u_star)) \
        + rounding
    d_e = abs(r.energy - e_star)
    ladder["gmres"] = {"dofs": p.n_dofs, "iterations": r.iterations,
                       "method": r.method, "rel_err": d_e / e_star,
                       "residual_bound": bound / e_star,
                       "wall_ms_per_iter": 1e3 * r.solve_time / r.iterations,
                       "device_ms_per_iter_m30": ms30,
                       "device_ms_per_iter_m200": ms200}
    print(f"[ladder_gmres_fp64] 12x4x1 beam dofs={p.n_dofs} solve_system: "
          f"method={r.method} iterations={r.iterations} converged="
          f"{r.converged} energy={r.energy!r} direct={e_star!r} "
          f"rel_err={d_e / e_star:.3e} residual_bound={bound / e_star:.3e} "
          f"true_residual={np.linalg.norm(resid) / np.linalg.norm(f):.3e} "
          f"solve_s={secs:.3f} wall_ms_per_iter="
          f"{1e3 * r.solve_time / r.iterations:.4f} "
          f"tet4_apply_launches={launches}", flush=True)
    check(r.converged and d_e <= bound,
          f"gmres energy {d_e / e_star:.3e} off the direct solve, above "
          f"the {bound / e_star:.3e} its residual allows")
    del p, K

    # -- 14b. MINRES in float32 under the float64 refinement --------------
    p32 = env.setup(env.beam, f32)
    r, secs, launches = env.solve(
        p32, tt.SolverConfig(method="minres", **LADDER_KW), "tet4_apply",
        method="minres+refine")
    e_rel = rel(r.energy, 8)
    print(f"[ladder_minres_fp32] method={r.method} iterations="
          f"{r.iterations} passes={r.refinement_passes} converged="
          f"{r.converged} energy={r.energy!r} rel_err={e_rel:.3e} "
          f"(tol 1e-08) solve_s={secs:.3f} wall_ms_per_iter="
          f"{1e3 * r.solve_time / r.iterations:.4f} refine_host_s="
          f"{r.timings.get('refine_host_matvec_seconds', 0.0):.3f}",
          flush=True)
    check(r.converged and e_rel <= 1e-8,
          f"fp32 minres rel_err {e_rel:.3e}")
    ladder["minres_fp32"] = {"iterations": r.iterations,
                             "passes": r.refinement_passes}
    del p32

    # -- 14c. the fallbacks, forced (scale-4 beam, float64) ---------------
    p4 = env.setup(env.beams[4], f64)
    r = tt.solve_system(p4, tt.SolverConfig(**{**LADDER_KW,
                                               "method": "gmres",
                                               "max_iterations": 5}))
    e_rel = rel(r.energy, 4)
    print(f"[ladder_fallback] gmres max_iterations=5: method={r.method} "
          f"energy={r.energy!r} rel_err={e_rel:.3e}", flush=True)
    check(r.method in ("cg(fallback)", "direct(fallback)") and e_rel <= 1e-8,
          f"gmres with 5 iterations reported {r.method}")

    def wrong_u(op, f_dev, m, config):
        u = torch.ones(op.n_dofs, dtype=f_dev.dtype, device=f_dev.device)
        return u * op.free_mask, 10, 1e-12, True, None, m

    honest = robust.solve_with_krylov
    robust.solve_with_krylov = wrong_u
    try:
        r = tt.solve_system(p4, tt.SolverConfig(method="gmres",
                                                **LADDER_KW))
    finally:
        robust.solve_with_krylov = honest
    e_rel = rel(r.energy, 4)
    print(f"[ladder_fallback] solve_with_krylov returning a wrong u: "
          f"method={r.method} energy={r.energy!r} rel_err={e_rel:.3e}",
          flush=True)
    check(r.method == "direct(verification-fallback)" and e_rel <= 1e-8,
          f"the backward-error gate let a wrong u through: {r.method}")
    del p4

    # -- 14d. solve_system_robust, verbose, on the scale-8 beam -----------
    p = env.setup(env.beam, f64)
    out = io.StringIO()
    tt.set_verbosity(True)
    try:
        with contextlib.redirect_stdout(out):
            t = time.perf_counter()
            r = tt.solve_system_robust(p, tt.SolverConfig(
                method="auto", verbose=True, history=True))
            secs = time.perf_counter() - t
    finally:
        tt.set_verbosity(False)
    text = re.sub(r"\x1b\[[0-9;]*m", "", out.getvalue())
    for heading in ("PRE-SOLVE DIAGNOSTICS", "Operator device residency",
                    "FINAL ANALYSIS RESULTS"):
        check(heading in text, f"solve_system_robust printed no {heading}")
    m = re.search(r"Operator device residency .*\((\d+) bytes\); "
                  r"allocated on the device: (\d+) bytes", text)
    check(m is not None, "no residency figures in the diagnostics")
    resident, allocated = int(m.group(1)), int(m.group(2))
    e_rel = rel(r.energy, 8)
    for line in text.splitlines():
        if any(k in line for k in ("Operator device residency",
                                   "Selected method", "Iterations completed",
                                   "Status:", "Deformation energy")):
            print(f"[ladder_robust] | {line.strip()}")
    print(f"[ladder_robust] method={r.method} iterations={r.iterations} "
          f"converged={r.converged} energy={r.energy!r} rel_err={e_rel:.3e} "
          f"seconds={secs:.3f} history_len={len(r.history)} "
          f"operator_bytes={resident} allocated_bytes={allocated} "
          f"output_lines={len(text.splitlines())}", flush=True)
    check(r.method == "cg" and r.converged,
          f"solve_system_robust took {r.method}")
    check(0 < resident <= allocated,
          f"operator residency {resident} above the allocator's {allocated}")
    ladder["robust"] = {"iterations": r.iterations,
                        "operator_bytes": resident,
                        "allocated_bytes": allocated}
    return ladder


def reader_phase(env):
    """Phase 14e-g: ``solve_system_adaptive`` at full size, the GMSH and
    Abaqus readers at full size, and ``profile_to``.  ``env`` carries
    main()'s helpers (check, solve, setup) and inputs: ``beam16``,
    ``beam`` (scale 8), ``beams`` (by scale), ``p16b_mesh`` (phase 8's
    scale-16 mesh read back from .vtu), ``oracles``, ``dev``, ``tmp``."""
    import numpy as np
    import torch

    import topopteval_tpu_torch as tt
    from topopteval_tpu_torch.utils.profiling import profile_to

    check, dev, tmp = env.check, env.dev, env.tmp
    f64 = torch.float64
    x_end = BEAM_BOX[0]

    def rel(e, key):
        return abs(e - env.oracles[key]) / abs(env.oracles[key])

    # -- 14e. solve_system_adaptive on the generated scale-16 beam -------
    p_st = env.setup(env.beam16, f64)
    r, secs, launches = env.solve(p_st, None, "stencil_plane",
                                  fn=tt.solve_system_adaptive)
    e_rel = rel(r.energy, "tet_beam_scale_16")
    print(f"[adaptive_stencil_fp64] dofs={p_st.n_dofs} method={r.method} "
          f"iterations={r.iterations} converged={r.converged} "
          f"energy={r.energy!r} rel_err={e_rel:.3e} (tol 1e-08) "
          f"solve_s={secs:.3f} history_len={len(r.history)} "
          f"stencil_plane_launches={launches}", flush=True)
    check(r.converged and e_rel <= 1e-8,
          f"adaptive scale-16 rel_err {e_rel:.3e}")

    # -- 14g. profile_to around three MG-PCG iterations of 14e -----------
    cfg3 = tt.SolverConfig(**{**dataclasses.asdict(
        tt.adaptive_config(p_st.n_dofs)), "method": "cg",
        "preconditioner": "multigrid", "max_iterations": 3,
        "verbose": False, "history": False})
    t = time.perf_counter()
    with profile_to(os.path.join(tmp, "trace")) as prof:
        r3 = tt.solve_system(p_st, cfg3)
    with open(prof.path) as fh:
        trace = fh.read()
    names = sorted(set(re.findall(r'"name":\s*"([^"]*stencil[^"]*)"',
                                  trace)))
    print(f"[profile_to] {prof.path} bytes={len(trace)} iterations="
          f"{r3.iterations} seconds={time.perf_counter() - t:.3f} "
          f"stencil_events={names[:4]}", flush=True)
    check(os.path.exists(prof.path) and r3.iterations == 3,
          "profile_to wrote no trace of three iterations")
    check(any("stencil_plane_kernel" in n for n in names),
          "the trace does not name the stencil kernel")
    del p_st, r3, trace

    # -- 14f. the scale-16 beam as .msh (v4.1 binary, v2.2 ASCII) --------
    beam16 = env.beam16
    groups = [(2, 1, "clamped", "tri3",
               plane_triangles(beam16.coords, 0, 0.0)),
              (2, 2, "loaded", "tri3",
               plane_triangles(beam16.coords, 0, x_end)),
              (3, 3, "body", "tet4", beam16.conn)]
    meshes = {}
    for name, writer in (("beam16_v41_binary.msh", write_msh41_binary),
                         ("beam16_v22_ascii.msh", write_msh22_ascii)):
        path = os.path.join(tmp, name)
        t = time.perf_counter()
        writer(path, beam16.coords, groups)
        write_s = time.perf_counter() - t
        t = time.perf_counter()
        mesh = tt.import_mesh(path)
        import_s = time.perf_counter() - t
        print(f"[msh_beam16] {name} bytes={os.path.getsize(path)} "
              f"write_s={write_s:.3f} import_s={import_s:.3f} "
              f"nodesets={sorted(mesh.nodesets)}", flush=True)
        check(np.array_equal(mesh.coords, env.p16b_mesh.coords)
              and np.array_equal(mesh.conn, env.p16b_mesh.conn),
              f"{name} does not round-trip the scale-16 beam")
        for side, x in (("clamped", 0.0), ("loaded", x_end)):
            check(np.array_equal(tt.select_nodes_by_set(mesh, side),
                                 tt.nodes_at_plane(beam16, 0, x)),
                  f"{name}: node set {side} is not the x = {x} plane")
        os.remove(path)
        meshes[name] = mesh
    # the two imports hold the same arrays (checked above), so one solve
    # stands for both: the v4.1 import, clamped and loaded by its node
    # sets, builds the block-ELL hierarchy (float64) and saves it; phase
    # 8's .vtu mesh under the same call loads it by the hash of mesh,
    # material, BCs and dtype
    mesh = meshes["beam16_v41_binary.msh"]
    p = tt.setup_problem(mesh, dtype=f64)
    tt.assemble_stiffness_matrix(p, *env.lame)
    tt.apply_fixed_boundary(p, tt.select_nodes_by_set(mesh, "clamped"))
    tt.apply_force(p, tt.select_nodes_by_set(mesh, "loaded"),
                   [0.0, 0.0, -1.0])
    os.environ["TOPOPT_MG_CACHE_DIR"] = os.path.join(tmp, "mg_cache")
    try:
        r, secs, launches = env.solve(p, None, "bell_matvec",
                                      fn=tt.solve_system_adaptive)
        p_vtu = env.setup(env.p16b_mesh, f64)
        r_vtu, secs_vtu, _ = env.solve(p_vtu, None, "bell_matvec",
                                       fn=tt.solve_system_adaptive)
    finally:
        os.environ["TOPOPT_MG_CACHE_DIR"] = "off"
    d_vtu = abs(r.energy - r_vtu.energy) / abs(r_vtu.energy)
    e_rel = rel(r.energy, "tet_beam_scale_16")
    cached = (p_vtu._mg_build_info or {}).get("cached", False)
    print(f"[msh_beam16] .msh route: method={r.method} iterations="
          f"{r.iterations} energy={r.energy!r} rel_err={e_rel:.3e} "
          f"(tol 1e-08) solve_s={secs:.3f} build_operator_s="
          f"{r.timings['build_operator']:.3f} bell_matvec_launches="
          f"{launches}; .vtu route: iterations={r_vtu.iterations} "
          f"energy={r_vtu.energy!r} rel_to_vtu={d_vtu:.3e} (tol 1e-12) "
          f"solve_s={secs_vtu:.3f} hierarchy_cached={cached}", flush=True)
    check(cached, "the .vtu problem did not find the .msh one's hierarchy")
    check(r.converged and d_vtu <= 1e-12 and e_rel <= 1e-8,
          "the .msh beam's energy is off the .vtu route or the oracle")
    del meshes, mesh, p, p_vtu

    # the scale-4 tet10 beam as v4.1 binary in gmsh's node order
    quad = env.beams[4].to_quadratic()
    path = os.path.join(tmp, "tet10_scale4.msh")
    write_msh41_binary(path, quad.coords,
                       [(3, 1, "body", "tet10", quad.conn)])
    t = time.perf_counter()
    mesh = tt.import_mesh(path)
    import_s = time.perf_counter() - t
    check(mesh.element_type == "tet10"
          and np.array_equal(mesh.conn, quad.conn),
          "the tet10 .msh was not read back into VTK order")
    p = env.setup(mesh, f64)
    r, secs, launches = env.solve(p, env.CG, "tet10_apply")
    e_rel = rel(r.energy, "tet10_beam_scale_4")
    print(f"[msh_tet10] dofs={p.n_dofs} import_s={import_s:.3f} "
          f"method={r.method} iterations={r.iterations} energy={r.energy!r} "
          f"rel_err={e_rel:.3e} (tol 1e-08) solve_s={secs:.3f} "
          f"tet10_apply_launches={launches}", flush=True)
    check(r.converged and e_rel <= 1e-8, f"tet10 .msh rel_err {e_rel:.3e}")
    del p, mesh

    # the scale-8 beam through .inp: read, solve, and convert to .vtu
    beam = env.beam
    path = os.path.join(tmp, "beam8.inp")
    write_inp(path, beam.coords, beam.conn)
    t = time.perf_counter()
    mesh = tt.read_inp_mesh(path)
    import_s = time.perf_counter() - t
    check(np.array_equal(mesh.coords, beam.coords)
          and np.array_equal(mesh.conn, beam.conn),
          ".inp does not round-trip the scale-8 beam")
    p = env.setup(mesh, f64)
    r, secs, launches = env.solve(p, env.CG, "tet4_apply")
    e_rel = rel(r.energy, "tet_beam_scale_8")
    t = time.perf_counter()
    ok = tt.inp_to_vtu(path, os.path.join(tmp, "beam8_from_inp"),
                       verbose=False)
    back = tt.read_vtu_mesh(os.path.join(tmp, "beam8_from_inp.vtu"))
    convert_s = time.perf_counter() - t
    print(f"[inp_beam8] import_s={import_s:.3f} method={r.method} "
          f"iterations={r.iterations} energy={r.energy!r} rel_err="
          f"{e_rel:.3e} (tol 1e-08) solve_s={secs:.3f} inp_to_vtu={ok} "
          f"convert_and_read_s={convert_s:.3f}", flush=True)
    check(r.converged and e_rel <= 1e-8, f".inp beam rel_err {e_rel:.3e}")
    check(ok and np.array_equal(back.coords, beam.coords)
          and np.array_equal(back.conn, beam.conn),
          "inp_to_vtu does not round-trip the scale-8 beam")


def host_library_phase(env):
    """15a/15b: phase 8's scale-16 block-ELL build by phase with the host
    library and without it, then the monolithic block-ELL build on the
    scale-8 beam from .vtu in float64, forced at nu = 0.3 and taken by
    dispatch at nu = 0.  ``env.p16b`` is phase 8's problem (its
    hierarchy took the library route, ``env.info16`` its build record),
    ``env.bell8`` phase 8's skeleton-route result at scale 8 (float64),
    ``env.mesh8`` the scale-8 beam read back from .vtu and
    ``env.beam`` the generated one."""
    import numpy as np
    import torch

    import topopteval_tpu_torch as tt
    from topopteval_tpu_torch import api as tt_api
    from topopteval_tpu_torch.fem import bell as fb
    from topopteval_tpu_torch.fem.operator import assemble_scipy
    from topopteval_tpu_torch.io import native

    check, dev = env.check, env.dev
    keys = ("unit_operator", "values_matvec", "rap_chain", "coarse_pinv")
    os.environ["TOPOPT_MG_CACHE_DIR"] = "off"

    def by_phase(info):
        merged = {**info.get("skeleton_phases", {}), **info["phases"]}
        return {k: merged.get(k) for k in keys}

    def total(info):
        return round(info.get("skeleton_seconds", 0.0)
                     + info["value_seconds"], 3)

    # -- 15a. the scale-16 block-ELL build, library on and off -------------
    p = env.p16b
    lib = env.info16
    mask = tt.free_mask_from_bcs(p.n_dofs, p.bcs)
    with native.use_native(False):
        sys_np, _, plain = fb.build_bell_multigrid(
            p.mesh, p.lam, p.mu, free_mask=mask, dtype=p.dtype,
            order=p.quad_order, device=dev)
    check(plain["host_library"] is False and lib["host_library"] is True,
          "the two scale-16 builds did not take the two host routes")
    hb_lib = tt_api._get_multigrid(p)[0].host_bsr
    hb_np = sys_np.host_bsr
    same = all(np.array_equal(hb_lib[k], hb_np[k])
               for k in ("indptr", "indices"))
    a, b = np.asarray(hb_lib["data"]), np.asarray(hb_np["data"])
    diff = float(np.abs(a - b).max() / np.abs(b).max()) if same else np.inf
    print(f"[host_library] scale-16 block-ELL fp32 build "
          f"({p.mesh.n_cells} tets), seconds by phase: library "
          f"{json.dumps(by_phase(lib))} total {total(lib)}; NumPy/scipy "
          f"{json.dumps(by_phase(plain))} total {total(plain)}", flush=True)
    print(f"[host_library] skeleton phases: library "
          f"{json.dumps(lib['skeleton_phases'])} NumPy/scipy "
          f"{json.dumps(plain['skeleton_phases'])}; value phases: library "
          f"{json.dumps(lib['phases'])} NumPy/scipy "
          f"{json.dumps(plain['phases'])}; fine operator: same pattern "
          f"{same}, max |library - NumPy| / max |NumPy| = {diff:.3e} "
          f"(tol 1e-12)", flush=True)
    check(same and diff <= 1e-12,
          "the library and NumPy builds of the scale-16 operator differ")
    del sys_np, hb_np, a, b

    # -- 15b. the monolithic build, scale 8, float64 ------------------------
    f64 = torch.float64
    mesh8 = env.mesh8
    p = env.setup(mesh8, f64)
    mask = tt.free_mask_from_bcs(p.n_dofs, p.bcs)
    t = time.perf_counter()
    system, mg, info = fb.build_bell_multigrid(
        p.mesh, p.lam, p.mu, free_mask=mask, dtype=f64, order=p.quad_order,
        device=dev, skel_max_bytes=0)
    build_s = time.perf_counter() - t
    check(info["route"] == "monolithic",
          "skel_max_bytes=0 did not force the monolithic build")
    # hand the hierarchy to solve_system as its own build would
    p._mg_cache = (tt_api._material_fingerprint(p), system, mg)
    p._mg_build_info = info
    r, secs, launches = env.solve(p, env.MG, "bell_matvec")
    rel = env.report("mono_beam8_fp64_forced", r, secs, launches,
                     env.oracles["tet_beam_scale_8"])
    # two solves stopped at 1e-10 of |f| differ in energy by up to what
    # their true residuals allow: E(u) - E* = -r.(u + u*)/2 ~ -r.u each
    K = assemble_scipy(p.mesh, p.lam, p.mu, order=p.quad_order,
                       free_mask=mask)
    fm = p.f * mask

    def bound(res):
        return abs(float((fm - K @ res.u) @ res.u)) / abs(res.energy)

    skel = env.bell8
    d = abs(r.energy - skel.energy) / abs(skel.energy)
    gate = max(1e-10, bound(r) + bound(skel))
    print(f"[mono_beam8_fp64_forced] build_s={build_s:.2f} "
          f"level_nodes={info['level_nodes']} phases="
          f"{json.dumps(info['phases'])}; skeleton route (phase 8): "
          f"iterations={skel.iterations} energy={skel.energy!r}; energy "
          f"rel_diff={d:.3e}, the two residuals' bound {bound(r):.3e} + "
          f"{bound(skel):.3e} (gate {gate:.3e})", flush=True)
    check(r.converged and r.iterations == 18 and skel.iterations == 18,
          f"monolithic scale-8 fp64: {r.iterations} iterations, the "
          f"skeleton route {skel.iterations} (18 expected)")
    check(d <= gate and rel <= 1e-8,
          f"monolithic scale-8 fp64: rel_diff {d:.3e} (gate {gate:.3e}), "
          f"rel_err {rel:.3e}")
    del p, system, mg, K

    lam0, mu0 = tt.lame_parameters(1.0, 0.0)
    energies = {}
    for tag, mesh, kernel in (("mono_beam8_nu0_fp64", mesh8, "bell_matvec"),
                              ("stencil_beam8_nu0_fp64", env.beam,
                               "stencil_plane")):
        p = tt.setup_problem(mesh, dtype=f64, device=dev)
        tt.assemble_stiffness_matrix(p, lam0, mu0)
        tt.apply_fixed_boundary(p, tt.nodes_at_plane(p.mesh, 0, 0.0))
        tt.apply_force(p, tt.nodes_at_plane(p.mesh, 0, 60.0),
                       [0.0, 0.0, -1.0])
        t = time.perf_counter()
        r, secs, launches = env.solve(p, env.MG, kernel)
        energies[tag] = r.energy
        env.report(tag, r, secs, launches, r.energy)
        check(r.converged, f"{tag} did not converge")
        if kernel == "bell_matvec":
            info = p._mg_build_info
            print(f"[{tag}] route={info['route']} level_nodes="
                  f"{info['level_nodes']} build_s={info['value_seconds']} "
                  f"phases={json.dumps(info['phases'])}", flush=True)
            check(info["route"] == "monolithic",
                  "nu = 0 did not take the monolithic build")
        del p
    d = (abs(energies["mono_beam8_nu0_fp64"]
             - energies["stencil_beam8_nu0_fp64"])
         / abs(energies["stencil_beam8_nu0_fp64"]))
    print(f"[mono_beam8_nu0_fp64] against the stencil route: rel_diff="
          f"{d:.3e} (tol 1e-8)", flush=True)
    check(d <= 1e-8, f"nu = 0: the two routes differ by {d:.3e}")


def sweep_phase(env):
    """15c: BASELINE config 5 at full width through
    ``evaluate_design_batch`` in float32 (``env.dims`` hexes over
    (6, 2, 1), ``env.B`` densities, 4 loads), three sampled lanes against
    the port's float64 block-Jacobi CG of the same lane, and the SIMP Hex8
    fixture's batch in float64 against ``solve_system_simp``."""
    import numpy as np
    import torch

    import topopteval_tpu_torch as tt
    from topopteval_tpu_torch.parallel import sweep

    check, dev = env.check, env.dev
    f32, f64 = torch.float32, torch.float64

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    # the case of tools/bench_sweep.build_case, rebuilt with the port
    mesh = tt.generate_grid_tet(*env.dims, (0, 0, 0), (6.0, 2.0, 1.0))
    p = tt.setup_problem(mesh, dtype=f32, device=dev)
    tt.assemble_stiffness_matrix(p, *tt.lame_parameters(1.0, 0.3))
    tt.apply_fixed_boundary(p, tt.nodes_at_plane(mesh, 0, 0.0))
    tip = tt.nodes_at_plane(mesh, 0, 6.0)
    tt.apply_force(p, tip, [0.0, 0.0, -1.0])
    material = tt.create_simp_material_model(1.0, 0.3, 1e-9, 3.0)
    B, L = env.B, 4
    rng = np.random.default_rng(0)
    dens = rng.uniform(0.05, 1.0, (B, mesh.n_cells))
    dens[:, : mesh.n_cells // 4] = 1.0          # stiff load path
    loads = np.zeros((L, mesh.n_dofs))
    dirs = [(0, 0, -1.0), (0, -1.0, 0), (1.0, 0, 0), (0, 0.7, -0.7)]
    for j in range(L):
        for c, v in enumerate(dirs[j % 4]):
            loads[j, tip * 3 + c] = v / tip.size
    sync()
    t = time.perf_counter()
    e, it, cv = tt.evaluate_design_batch(p, dens, loads, material=material,
                                         tol=1e-6, maxiter=20000)
    sync()
    sweep_s = time.perf_counter() - t
    print(f"[sweep] {mesh.n_cells} tets, {B}x{L} lanes float32 tol 1e-6: "
          f"seconds={sweep_s:.3f} lanes_per_s={B * L / sweep_s:.3f} "
          f"converged={int(cv.sum())}/{cv.size} iterations median="
          f"{float(np.median(it))} min={int(it.min())} max={int(it.max())} "
          f"lane_iterations_total={int(it.sum())}", flush=True)
    check(cv.all(), f"{int((~cv).sum())} sweep lanes did not converge")

    # the iterations of one call on all lanes, as the sweep runs them
    # (pairs, GEMM form): a 40-iteration call less a 20-iteration one, so
    # that the set-up (block inverses, the closing energy) cancels
    mask = tt.free_mask_from_bcs(p.n_dofs, p.bcs)
    kernel = sweep.SweepKernel.build(mesh, 0.3, mask, dtype=f32,
                                     full_ke=True, device=dev)
    bi, lj = np.divmod(np.arange(B * L), L)
    esc = torch.as_tensor(material.youngs_modulus(dens)[bi], dtype=f32,
                          device=dev)
    f_lanes = torch.as_tensor(loads[lj], dtype=f32, device=dev)

    def run(n):
        return sweep.sweep_compliance_pairs(kernel, esc, f_lanes, tol=0.0,
                                            maxiter=n)

    def wall(n):
        sync()
        t = time.perf_counter()
        run(n)
        sync()
        return time.perf_counter() - t

    run(2)
    wall_ms = 1e3 * (wall(40) - wall(20)) / 20
    d40, top, k40 = env.profile(lambda: run(40), 1)
    d20, _, k20 = env.profile(lambda: run(20), 1)
    device_ms, per_iter = (d40 - d20) / 20, (k40 - k20) / 20
    busy = f"{device_ms / wall_ms:.3f}" if device_ms > 0 else "not measured"
    print(f"[sweep] one iteration on {B * L} lanes: wall_ms={wall_ms:.3f} "
          f"device_ms={device_ms:.3f} device_busy_share={busy} "
          f"device_kernels_per_iteration={per_iter:.1f} lanes_per_chunk="
          f"{min(B * L, kernel.lanes_that_fit())} bytes_per_lane="
          f"{kernel.bytes_per_lane()}; top of the 40-iteration call (ms): "
          + ", ".join(f"{k[:40]}={v:.3f}" for k, v in top[:6]), flush=True)
    del kernel, esc, f_lanes

    # three sampled lanes against the port's float64 solve of that lane
    errs = []
    for b, j in ((0, 0), (B // 2, 1), (B - 1, 3)):
        q = tt.setup_problem(mesh, dtype=f64, device=dev)
        tt.assemble_stiffness_matrix_simp(q, material, dens[b])
        tt.apply_fixed_boundary(q, tt.nodes_at_plane(mesh, 0, 0.0))
        q.f = loads[j].copy()
        r = tt.solve_system(q, env.CG)
        rel = abs(e[b, j] - r.energy) / abs(r.energy)
        errs.append(rel)
        print(f"[sweep] lane ({b},{j}): float32 sweep {float(e[b, j])!r} "
              f"({it[b, j]} iterations), float64 CG {r.energy!r} "
              f"({r.iterations} iterations, converged {r.converged}) "
              f"rel_err={rel:.3e} (tol 1e-3)", flush=True)
        check(r.converged and rel <= 1e-3,
              f"sweep lane ({b},{j}) off the float64 solve by {rel:.3e}")
        del q

    # the SIMP Hex8 fixture, float64 (tests/test_end_to_end.py:214-222)
    simp = tt.simp_beam(env.simp_path, dtype=f64, device=dev)
    density = tt.extract_cell_density(env.simp_path)
    t = time.perf_counter()
    e1, it1, cv1 = tt.evaluate_design_batch(simp, density[None], tol=1e-10,
                                            maxiter=20000, dtype=f64)
    secs = time.perf_counter() - t
    ref = tt.solve_system_simp(simp)
    rel = abs(e1[0, 0] - ref.energy) / abs(ref.energy)
    print(f"[sweep] SIMP Hex8 fixture float64 tol 1e-10: {float(e1[0, 0])!r} "
          f"({it1[0, 0]} iterations, {secs:.2f} s) against "
          f"solve_system_simp {ref.energy!r} ({ref.method}) rel_err="
          f"{rel:.3e} (tol 1e-6)", flush=True)
    check(cv1.all() and rel <= 1e-6,
          f"SIMP fixture batch off solve_system_simp by {rel:.3e}")
    print("[sweep] " + json.dumps({
        "lanes_per_s": B * L / sweep_s, "iterations_median":
        float(np.median(it)), "oracle_rel_errs": errs,
        "simp_fixture_rel_err": rel}), flush=True)


def sharded_phase(env):
    """16: multi-device solves with ``env.shards`` (4 shards on the card):
    the halo operator at scale 16 against the single-device operator and
    B1 on every shard against its plain version (16a); the sharded MG-PCG
    in float64 on the scale-8 beam from .vtu, which must take phase 8's
    count (16b), and in float32 under the refinement on phase 8's
    scale-16 problem, its hierarchy reused (16c); the sharded block-Jacobi
    CG at scale 8 in float64, float32 refined and warm-started (16d); the
    data-parallel sweep over two shards (16e); the dry run (16f).  Prints
    every number beside ``env.smi``, the card's name and power limit, and
    returns a summary."""
    import numpy as np
    import torch

    import topopteval_tpu_torch as tt
    from topopteval_tpu_torch import api as tt_api
    from topopteval_tpu_torch import dryrun
    from topopteval_tpu_torch.fem.operator import StiffnessOperator
    from topopteval_tpu_torch.fem.solvers import cg
    from topopteval_tpu_torch.ops import bell as bo
    from topopteval_tpu_torch.ops import element_kernels as ek
    from topopteval_tpu_torch.parallel import collectives
    from topopteval_tpu_torch.parallel import sweep as sweep_mod
    from topopteval_tpu_torch.parallel.halo import HaloShardedOperator
    from topopteval_tpu_torch.parallel.halo_mg import build_halo_multigrid
    from topopteval_tpu_torch.parallel.sharding import build_device_mesh

    check, dev, smi = env.check, env.dev, env.smi
    f32, f64 = torch.float32, torch.float64
    shards = env.shards
    S = len(shards)
    dm = build_device_mesh(devices=shards)
    summary = {"card": smi, "shards": S}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def sharded(x0=None):
        return lambda p, c: tt.solve_system(p, c, x0=x0, devices=shards)

    def rel_max(a, ref):
        return float(np.abs(a - ref).max() / np.abs(ref).max())

    # -- 16a. the halo operator at scale 16, float64 and float32 ------------
    p16 = env.p16b
    mesh16 = p16.mesh
    mask16 = tt.free_mask_from_bcs(p16.n_dofs, p16.bcs)
    rng = np.random.default_rng(16)
    u = rng.standard_normal(mesh16.n_dofs)
    for dt in (f64, f32):
        dn = str(dt).split(".")[1]
        tol = TOLERANCE[dn]
        t = time.perf_counter()
        hop = HaloShardedOperator.build(mesh16, p16.lam, p16.mu, dm,
                                        free_mask=mask16, dtype=dt)
        sync()
        build_s = time.perf_counter() - t
        op = StiffnessOperator.build(
            mesh16.device(dt, dev), p16.lam, p16.mu,
            free_mask=torch.as_tensor(mask16, dtype=dt, device=dev))
        u_l = hop.to_local(u)
        u_d = torch.as_tensor(u, dtype=dt, device=dev)
        ek.reset_launch_counts()
        collectives.reset_moved()
        f_h = hop.matvec(u_l)
        sync()
        b1 = ek.LAUNCHES["tet4_apply"]
        moved = dict(collectives.MOVED)
        err = rel_max(hop.from_local(f_h),
                      op.matvec(u_d).double().cpu().numpy())
        err_d = rel_max(hop.from_local(hop.diagonal()),
                        op.diagonal().double().cpu().numpy())
        blocks = torch.cat(hop.node_blocks_raw()).double().cpu().numpy()
        err_b = rel_max(blocks[hop.plan.perm],
                        op.node_blocks_raw().double().cpu().numpy())
        # B1 on every shard's own inputs against its plain version
        err_b1 = 0.0
        for sh in hop.shards:
            x = torch.as_tensor(rng.standard_normal(3 * sh.coords.shape[0]),
                                dtype=dt, device=dev)
            out = ek.tet4_apply(sh.coords, sh.conn, x, sh.lam, sh.mu)
            ref = ek.tet4_apply_reference(sh.coords, sh.conn, x, sh.lam,
                                          sh.mu)
            err_b1 = max(err_b1, float((out - ref).abs().max()
                                       / ref.abs().max()))
        item = torch.tensor([], dtype=dt).element_size()
        full = 3 * mesh16.n_nodes * item
        ms_halo = env.time_ms(lambda: hop.matvec(u_l), graph=True)
        ms_one = env.time_ms(lambda: op.matvec(u_d), graph=True)
        ms_halo_eager = env.time_ms(lambda: hop.matvec(u_l))
        ms_one_eager = env.time_ms(lambda: op.matvec(u_d))
        print(f"[sharded] 16a halo operator {dn} scale 16 ({mesh16.n_cells} "
              f"tets, {S} shards on {shards[0]}): build_s={build_s:.3f} "
              f"n_boundary={hop.plan.n_boundary} ns_max={hop.ns_max} "
              f"nbs_max={hop.nbs_max} B1_launches_per_matvec={b1} "
              f"all_gather_bytes={moved['all_gather'] * item} "
              f"psum_bytes={moved['psum'] * item} full_vector_bytes={full} "
              f"(ratio {moved['all_gather'] * item / full:.4f}); against the "
              f"single-device operator: matvec {err:.3e} diagonal "
              f"{err_d:.3e} node_blocks {err_b:.3e}; per-shard B1 against "
              f"its plain version {err_b1:.3e} (tol {tol:.0e}); matvec "
              f"device_ms halo={ms_halo:.4f} single={ms_one:.4f}, eager "
              f"halo={ms_halo_eager:.4f} single={ms_one_eager:.4f} | {smi}",
              flush=True)
        check(b1 == S, f"16a: {b1} B1 launches in one {S}-shard matvec")
        check(moved["all_gather"] == moved["psum"]
              == S * hop.nbs_max * 3, f"16a: collectives moved {moved}")
        check(max(err, err_d, err_b, err_b1) <= tol,
              f"16a {dn}: the halo operator is off by "
              f"{max(err, err_d, err_b, err_b1):.3e}")
        summary[f"halo_{dn}"] = {
            "n_boundary": hop.plan.n_boundary, "ns_max": hop.ns_max,
            "nbs_max": hop.nbs_max, "collective_bytes": moved["psum"] * item,
            "full_vector_bytes": full, "build_s": build_s,
            "matvec_ms": ms_halo, "single_matvec_ms": ms_one,
            "matvec_eager_ms": ms_halo_eager,
            "single_matvec_eager_ms": ms_one_eager, "max_rel_err": max(
                err, err_d, err_b, err_b1)}
        del hop, op, u_l, u_d, f_h
        torch.cuda.empty_cache()

    # -- 16b. sharded MG-PCG, float64, the scale-8 beam from .vtu -----------
    mesh8 = env.vtu_round_trip(env.beam, env.tmp, "beam_scale_8_shards.vtu")
    p8 = env.setup(mesh8, f64)
    oracle8 = env.oracles["tet_beam_scale_8"]
    r, secs, launches = env.solve(p8, env.MG, "tet4_apply",
                                  method="cg(multigrid,sharded)",
                                  fn=sharded())
    b4, b5 = bo.LAUNCHES["bell_matvec"], bo.LAUNCHES["sell_matvec"]
    rel = env.report("sharded_mg8_fp64", r, secs, launches, oracle8)
    want = env.bell8.iterations
    print(f"[sharded] 16b iterations={r.iterations} single_device={want} "
          f"B4_launches={b4} B5_launches={b5} timings="
          f"{json.dumps({k: round(v, 3) for k, v in r.timings.items()})} "
          f"| {smi}", flush=True)
    check(b4 > 0 and b5 > 0, "16b: the coarse chain did not run B4 and B5")
    if r.iterations != want:
        hist = dataclasses.replace(env.MG, history=True)
        one = tt.solve_system(env.setup(mesh8, f64), hist)
        many = sharded()(env.setup(mesh8, f64), hist)
        print(f"[sharded] 16b residual histories: single {one.history!r} "
              f"sharded {many.history!r}", flush=True)
    check(r.iterations == want,
          f"16b: {r.iterations} sharded iterations, {want} on one device")
    check(r.converged and rel <= 1e-8, f"16b: rel_err {rel:.3e}")
    summary["mg8_fp64"] = {"iterations": r.iterations, "rel_err": rel,
                           "solve_s": secs}

    # -- 16c. sharded MG-PCG, float32 refined, scale 16 ----------------------
    p16.f = np.zeros(p16.n_dofs)
    tt.apply_force(p16, tt.nodes_at_plane(mesh16, 0, 60.0), [0.0, 0.0, -1.0])
    r, secs, launches = env.solve(p16, env.MG, "tet4_apply",
                                  method="cg(multigrid,sharded)",
                                  fn=sharded())
    rel = env.report("sharded_mg16_fp32", r, secs, launches,
                     env.oracles["tet_beam_scale_16"])
    check(r.converged and rel <= 1e-8, f"16c: rel_err {rel:.3e}")
    # one MG-PCG iteration of the sharded solve: a 20-iteration call less
    # a 10-iteration one, so that the set-up cancels
    hier = tt_api._bell_hierarchy(p16, mask16)
    hop, hmg, _ = build_halo_multigrid(mesh16, p16.lam, p16.mu, dm,
                                       free_mask=mask16, dtype=f32,
                                       hierarchy=hier)
    rhs = hop.to_local(p16.f * mask16) * hop.free_mask

    def run(n):
        cg(hop, rhs, M=hmg, tol=0.0, maxiter=n)

    def wall(n):
        sync()
        t = time.perf_counter()
        run(n)
        sync()
        return time.perf_counter() - t

    run(2)
    wall_ms = 1e3 * (wall(20) - wall(10)) / 10
    d20, top, k20 = env.profile(lambda: run(20), 1)
    d10, _, k10 = env.profile(lambda: run(10), 1)
    device_ms, per_iter = (d20 - d10) / 10, (k20 - k10) / 10
    busy = f"{device_ms / wall_ms:.3f}" if device_ms > 0 else "not measured"
    timings = r.timings
    print(f"[sharded] 16c scale 16 float32: solve_s={secs:.3f} iterations="
          f"{r.iterations} passes={r.refinement_passes} build_operator_s="
          f"{timings['build_operator']:.3f} (hierarchy "
          f"{timings['build_operator/hierarchy']:.3f}, halo "
          f"{timings['build_operator/halo']:.3f}) "
          f"refine_host_matvec_s="
          f"{timings.get('refine_host_matvec_seconds', 0.0):.3f}; one "
          f"MG-PCG iteration: wall_ms={wall_ms:.3f} device_ms="
          f"{device_ms:.3f} device_busy_share={busy} "
          f"device_kernels_per_iteration={per_iter:.1f}; top of the "
          f"20-iteration call (ms): "
          + ", ".join(f"{k[:40]}={v:.3f}" for k, v in top[:6])
          + f" | {smi}", flush=True)
    summary["mg16_fp32"] = {
        "iterations": r.iterations, "rel_err": rel, "solve_s": secs,
        "build_hierarchy_s": timings["build_operator/hierarchy"],
        "build_halo_s": timings["build_operator/halo"],
        "wall_ms_per_iteration": wall_ms,
        "device_ms_per_iteration": device_ms,
        "kernels_per_iteration": per_iter}
    del hop, hmg, rhs, hier
    torch.cuda.empty_cache()

    # -- 16d. sharded block-Jacobi CG, scale 8 ---------------------------------
    cg8 = dataclasses.replace(env.CG, tolerance=1e-8)
    one, _, _ = env.solve(p8, cg8, "tet4_apply", method="cg")
    cold, secs, launches = env.solve(p8, cg8, "tet4_apply",
                                     method="cg(sharded)", fn=sharded())
    rel = env.report("sharded_bj8_fp64", cold, secs, launches, oracle8)
    print(f"[sharded] 16d block-Jacobi float64 tol 1e-8: sharded "
          f"{cold.iterations} iterations, single device {one.iterations} "
          f"(gap {cold.iterations - one.iterations}) | {smi}", flush=True)
    check(cold.converged and rel <= 1e-6, f"16d fp64: rel_err {rel:.3e}")
    p8f = env.setup(mesh8, f32)
    r, secs, launches = env.solve(p8f, env.CG, "tet4_apply",
                                  method="cg(sharded)", fn=sharded())
    rel32 = env.report("sharded_bj8_fp32_refined", r, secs, launches,
                       oracle8)
    check(r.converged and rel32 <= 1e-8, f"16d fp32: rel_err {rel32:.3e}")
    warm, secs, _ = env.solve(p8, cg8, "tet4_apply", method="cg(sharded)",
                              fn=sharded(x0=cold.u))
    bound = max(2, cold.iterations // 10)
    print(f"[sharded] 16d warm start from the cold answer: "
          f"{warm.iterations} iterations (at most {bound}) solve_s="
          f"{secs:.3f} | {smi}", flush=True)
    check(warm.converged and warm.iterations <= bound,
          f"16d: the warm start took {warm.iterations} iterations")
    summary["bj8"] = {"fp64_iterations": cold.iterations,
                      "single_iterations": one.iterations,
                      "fp64_rel_err": rel, "fp32_rel_err": rel32,
                      "warm_iterations": warm.iterations}

    # -- 16e. the sweep over a 2-shard data axis --------------------------------
    # A lane's rounding depends on how many lanes run beside it
    # (parallel/sweep.py).  Each route's sharded run, 8 densities a shard,
    # is held to one device running the same parts (1e-12, equal counts)
    # and to one device's run of all 16 at once (1e-12); the counts that
    # move against the latter must be the ones that one device's same
    # parts move too: the witness that the width, not the split, moves
    # them.
    mesh4 = tt.generate_grid_tet(50, 16, 4, (0, 0, 0), BEAM_BOX)
    p4 = env.setup(mesh4, f64)
    B = 16
    dens = np.random.default_rng(4).uniform(0.7, 1.0, (B, mesh4.n_cells))
    loads = np.zeros((2, p4.n_dofs))
    loads[0] = p4.f
    loads[1, 1::3] = p4.f[2::3]                 # the tip load along y
    kw = dict(tol=1e-10, maxiter=20000, dtype=f64)
    real_split = sweep_mod.shard_sweep_inputs

    def timed(fn):
        sync()
        t = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t

    def sharded(**extra):
        calls = []

        def spy(dmesh, e, f):
            out = real_split(dmesh, e, f)
            calls.append([part.shape[0] for part in out[0]])
            return out

        sweep_mod.shard_sweep_inputs = spy
        try:
            out, sec = timed(lambda: tt.evaluate_design_batch(
                p4, dens, loads, devices=[dev, dev], **extra, **kw))
        finally:
            sweep_mod.shard_sweep_inputs = real_split
        return out, sec, calls

    def halves(**extra):
        parts = [tt.evaluate_design_batch(p4, d, loads, **extra, **kw)
                 for d in (dens[:B // 2], dens[B // 2:])]
        return tuple(np.concatenate([q[i] for q in parts])
                     for i in range(3))

    legs = {}
    for route, extra in (("einsum", {"lane_chunk": B}), ("pairs", {})):
        (e1, it1, cv1), one_s = timed(lambda: tt.evaluate_design_batch(
            p4, dens, loads, **extra, **kw))
        e1c, it1c, _ = (tt.evaluate_design_batch(
            p4, dens, loads, lane_chunk=B // 2, **kw)
            if route == "einsum" else halves())
        (e2, it2, cv2), two_s, calls = sharded(**extra)
        rel = float(np.abs(e2 - e1).max() / np.abs(e1).max())
        rel_c = float(np.abs(e2 - e1c).max() / np.abs(e1c).max())
        moved, moved_c = it1 != it2, it1 != it1c
        print(f"[sharded] 16e sweep {route} route, {B}x2 lanes float64 on "
              f"{mesh4.n_cells} tets: one device, all at once {one_s:.3f} "
              f"s; two data shards {two_s:.3f} s (split {calls}); against "
              f"one device on the same parts: max rel diff {rel_c:.3e}, "
              f"equal iterations {bool(np.array_equal(it1c, it2))}; "
              f"against all at once: max rel diff {rel:.3e} (tol 1e-12), "
              f"{int(moved.sum())} of {it1.size} counts moved by at most "
              f"{int(np.abs(it1 - it2).max())} (median "
              f"{float(np.median(it1))}); one device on the same parts "
              f"moves {int(moved_c.sum())}, the same ones "
              f"{bool(np.array_equal(moved, moved_c))} | {smi}", flush=True)
        check(calls == [[B // 2, B // 2]] and cv1.all() and cv2.all(),
              f"16e {route}: the sweep did not split over the data axis "
              f"({calls}), or a lane did not converge")
        check(rel_c <= 1e-12 and np.array_equal(it1c, it2),
              f"16e {route}: sharded sweep off one device's same parts by "
              f"{rel_c:.3e}, or its counts differ")
        check(rel <= 1e-12,
              f"16e {route}: sharded sweep off all at once by {rel:.3e}")
        check(np.array_equal(moved, moved_c),
              f"16e {route}: the split moves other counts than the width")
        legs[route] = {"rel_diff": rel, "rel_diff_same_parts": rel_c,
                       "counts_moved": int(moved.sum()),
                       "counts_moved_same_parts": int(moved_c.sum()),
                       "one_s": one_s, "two_s": two_s}
    summary["sweep"] = legs

    # -- 16f. the dry run with shards on the card -------------------------------
    out = dryrun.dryrun_multichip(S, dev)
    print(f"[sharded] 16f dryrun_multichip({S}) on {dev}: "
          f"{json.dumps(out)} | {smi}", flush=True)
    summary["dryrun"] = out

    # an extra leg across real devices, where the machine has several
    n_cards = torch.cuda.device_count() if dev.type == "cuda" else 1
    if n_cards > 1:
        cards = [torch.device("cuda", i) for i in range(min(n_cards, S))]
        hop = HaloShardedOperator.build(mesh8, p8.lam, p8.mu,
                                        build_device_mesh(devices=cards),
                                        free_mask=tt.free_mask_from_bcs(
                                            p8.n_dofs, p8.bcs), dtype=f64)
        u8 = rng.standard_normal(mesh8.n_dofs)
        ref = p8.build_operator().matvec(torch.as_tensor(
            u8, dtype=f64, device=dev)).cpu().numpy()
        err = rel_max(hop.from_local(hop.matvec(hop.to_local(u8))), ref)
        print(f"[sharded] halo matvec over {len(cards)} cards against one: "
              f"{err:.3e} (tol 1e-12) | {smi}", flush=True)
        check(err <= 1e-12, f"halo matvec across cards off by {err:.3e}")
    return summary


def dname_of(dtype):
    return str(dtype).split(".")[1]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, repo)
    import numpy as np

    import topopteval_tpu_torch as tt
    from topopteval_tpu_torch import _build
    from topopteval_tpu_torch import api as tt_api
    from topopteval_tpu_torch.fem.operator import assemble_scipy
    from topopteval_tpu_torch.fem.solvers import direct_solve
    from topopteval_tpu_torch.ops import bell as bo
    from topopteval_tpu_torch.ops import element_kernels as ek
    from topopteval_tpu_torch.ops import ell as el
    from topopteval_tpu_torch.ops import ke_kernels as kk
    from topopteval_tpu_torch.ops import stencil as st
    from topopteval_tpu_torch.ops.elements import element_stiffness

    tt.set_verbosity(False)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    CG = tt.SolverConfig(**CG_KW)
    kernel_fns = {"tet4_apply": (ek.tet4_apply, ek.tet4_apply_reference),
                  "hex8_apply": (ek.hex8_apply, ek.hex8_apply_reference)}
    main_path_launches = {name: 0 for name in (*ek.LAUNCHES, *st.LAUNCHES,
                                               *bo.LAUNCHES, *kk.LAUNCHES,
                                               *el.LAUNCHES)}

    # -- 1. device + build -------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[device] {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}",
          flush=True)
    t0 = time.perf_counter()
    built = _build.build()
    print(f"[build] {time.perf_counter() - t0:.1f} s "
          + ", ".join(f"{n}.cu {s:.1f} s" for n, s in built.items()),
          flush=True)
    # 15a (first half): the host library, built here so that every host
    # build below takes it; no silent fallback on this path
    from topopteval_tpu_torch.io import native as host_native
    host_build_s = _build.build_host()
    host_lib = host_native.load_native()
    check(host_lib is not None,
          f"the host library does not load: {host_native.LOAD_ERROR}")
    print(f"[host_library] {os.path.relpath(_build.host_target(), repo)} "
          f"version={host_lib.topopt_version()} "
          f"build_s={host_build_s:.2f} (g++ {' '.join(_build.HOST_FLAGS)})",
          flush=True)
    for name, report in _build.PTXAS_REPORT.items():
        for line in report.splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "spill")):
                print(f"[build] {name}: {line.strip()}")
            spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                               r"spill loads", line)
            check(spills is None or spills.groups() == ("0", "0"),
                  f"{name}.cu: ptxas reports a spill: {line.strip()}")

    # -- 2. kernel parity at the real-size shapes ----------------------------
    # B1 at the Tet4 fixture (gmsh order), the scale-8 beam and the scale-16
    # beam (1,228,800 tets, the Galerkin route's fine level); B2 at the
    # SIMP Hex8 fixture and the 25,600-hex box with SIMP lam, mu.  The
    # first shape of each is the one the kernels line reports unsuffixed.
    beam = tt.generate_grid_tet(100, 32, 8, (0, 0, 0), (60, 20, 4))
    beam16 = tt.generate_grid_tet(200, 64, 16, (0, 0, 0), BEAM_BOX)
    box = tt.generate_grid_hex(100, 32, 8, (0, 0, 0), (60, 20, 4))
    lam0, mu0 = tt.lame_parameters(1.0, 0.3)
    simp_material = tt.create_simp_material_model(1.0, 0.3, 1e-8, 3.0)
    box_lam, box_mu = simp_material.lame(
        tt.models.vfrac04_density_for(box))     # per-element SIMP values
    data = os.path.join(repo, "data")
    simp_path = os.path.join(data, "beam_vfrac_04_Raw.vtu")
    simp_mesh = tt.import_mesh(simp_path)
    tet4_fixture = tt.import_mesh(os.path.join(
        data, "beam_linear_volume_mesh.vtu"))

    def uniform(mesh):
        return (mesh, np.full(mesh.n_cells, lam0), np.full(mesh.n_cells, mu0))

    shapes = {"tet4_apply": {"beam8": uniform(beam),
                             "fixture": uniform(tet4_fixture),
                             "beam16": uniform(beam16)},
              "hex8_apply": {"box": (box, box_lam, box_mu),
                             "simp_fixture": (simp_mesh, *simp_material.lame(
                                 tt.extract_cell_density(simp_path)))}}
    u_np = {(name, label): np.random.default_rng(0).standard_normal(m.n_dofs)
            for name, per in shapes.items() for label, (m, _, _) in per.items()}

    def inputs(name, dtype, label):
        m, lam, mu = shapes[name][label]
        return (torch.as_tensor(m.coords, dtype=dtype, device=dev),
                torch.as_tensor(m.conn, device=dev),
                torch.as_tensor(u_np[(name, label)], dtype=dtype, device=dev),
                torch.as_tensor(lam, dtype=dtype, device=dev),
                torch.as_tensor(mu, dtype=dtype, device=dev))

    errs = {}
    for name, (kern, plain) in kernel_fns.items():
        for label in shapes[name]:
            out_p64 = None
            for dtype in (torch.float64, torch.float32):
                dname = str(dtype).split(".")[1]
                args = inputs(name, dtype, label)
                out_k = kern(*args)
                torch.cuda.synchronize()
                out_p = plain(*args)
                check(out_k.shape == out_p.shape,
                      f"{name} shape {out_k.shape}")
                check(bool(torch.isfinite(out_k).all()), f"{name} not finite")
                err = float((out_k - out_p).abs().max())
                scale = float(out_p.abs().max())
                errs[(name, label, dname)] = err
                tiles = ek.element_tiles(args[1])
                # how far the float32 plain version itself lies from float64
                own = ""
                if out_p64 is not None:
                    gap = float((out_p.double() - out_p64).abs().max())
                    own = (" plain_fp32_vs_fp64="
                           f"{gap / float(out_p64.abs().max()):.3e}")
                print(f"[parity] {name} {label} {dname} C={args[1].shape[0]} "
                      f"tile={tiles.tile} max_nodes={tiles.max_nodes} "
                      f"reuse={tiles.reuse:.3f} max_abs_err={err:.3e} "
                      f"max|plain|={scale:.3e} rel={err / scale:.3e} "
                      f"(tol {TOLERANCE[dname]:.0e}){own}", flush=True)
                check(err <= TOLERANCE[dname] * scale,
                      f"{name} {label} {dname} disagrees with its plain "
                      "version")
                out_p64 = out_p.double() if dtype == torch.float64 else None
                del args, out_k, out_p
            del out_p64
            torch.cuda.empty_cache()
    print("[parity] errors " + json.dumps(
        {f"{name} {label}": {
            "max_abs_err_fp64": errs[(name, label, "float64")],
            "max_abs_err_fp32": errs[(name, label, "float32")]}
         for name in kernel_fns for label in shapes[name]}), flush=True)

    def solve(problem, config, kernel, method="cg", fn=None):
        """One main-path solve: counts set to 0 just before, read after.
        ``fn`` is the entry point (``tt.solve_system`` by default); the
        reported method must be ``method`` unless that is None."""
        ek.reset_launch_counts()
        st.reset_launch_counts()
        bo.reset_launch_counts()
        kk.reset_launch_counts()
        el.reset_launch_counts()
        fn = fn or tt.solve_system
        t = time.perf_counter()
        result = fn(problem, config) if config is not None else fn(problem)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        launches = {**ek.LAUNCHES, **st.LAUNCHES, **bo.LAUNCHES,
                    **kk.LAUNCHES, **el.LAUNCHES}
        for n, c in launches.items():
            main_path_launches[n] += c
        check(launches[kernel] > 0, f"{kernel} was not launched by the solve")
        check(method is None or result.method == method,
              f"solve took route {result.method!r}, not {method}")
        check(np.all(np.isfinite(result.u)), "non-finite displacements")
        check(np.all(np.isfinite(result.von_mises)), "non-finite von Mises")
        return result, seconds, launches[kernel]

    def setup(mesh, dtype, density=None, order=1, mode="otf"):
        p = tt.setup_problem(mesh, interpolation_order=order, dtype=dtype,
                             mode=mode)
        if density is None:
            tt.assemble_stiffness_matrix(p, lam0, mu0)
        else:
            tt.assemble_stiffness_matrix_simp(p, simp_material, density)
        tt.apply_fixed_boundary(p, tt.nodes_at_plane(p.mesh, 0, 0.0))
        tt.apply_force(p, tt.nodes_at_plane(p.mesh, 0, 60.0),
                       [0.0, 0.0, -1.0])
        return p

    def oracle_energy(p):
        mask = tt.free_mask_from_bcs(p.n_dofs, p.bcs)
        K = assemble_scipy(p.mesh, p.lam, p.mu, order=p.quad_order,
                           free_mask=mask)
        u = direct_solve(K, p.f * mask)
        return 0.5 * float(u @ (K @ u))

    def report(tag, r, seconds, launches, ref):
        rel = abs(r.energy - ref) / abs(ref)
        print(f"[{tag}] method={r.method} iterations={r.iterations} "
              f"converged={r.converged} "
              f"refinement_passes={r.refinement_passes} "
              f"energy={r.energy!r} rel_err={rel:.3e} "
              f"solve_s={seconds:.3f} "
              f"ms_per_iter={1e3 * r.solve_time / max(r.iterations, 1):.4f} "
              f"launches={launches} max_vm={r.max_von_mises:.6e}",
              flush=True)
        return rel

    # -- 3. bundled fixtures on the device CG route ---------------------------
    with tempfile.TemporaryDirectory() as tmp:
        for tag, fname, dtype, kernel, simp_on in (
                ("simp_hex8_fp32", "beam_vfrac_04_Raw.vtu", torch.float32,
                 "hex8_apply", True),
                ("cantilever_tet4_fp64", "beam_linear_volume_mesh.vtu",
                 torch.float64, "tet4_apply", False)):
            path = os.path.join(data, fname)
            mesh = tt.import_mesh(path)
            density = tt.extract_cell_density(path) if simp_on else None
            p = setup(mesh, dtype, density)
            ref = oracle_energy(p)
            r, secs, launches = solve(p, CG, kernel)
            rel = report(tag, r, secs, launches, ref)
            check(r.converged, f"{tag} did not converge")
            check(rel <= 1e-8, f"{tag} energy rel_err {rel:.3e} > 1e-8")
            out = tt.export_results(r, p, os.path.join(tmp, tag))
            check(os.path.getsize(out) > 0, f"{tag} export is empty")

        # -- 4. real size: 153,600 tets through .vtu ---------------------
        path = tt.write_vtu(os.path.join(tmp, "beam_scale_8.vtu"), beam)
        mesh = tt.import_mesh(path)
        check(np.array_equal(mesh.coords, beam.coords)
              and np.array_equal(mesh.conn, beam.conn),
              "scale-8 beam does not round-trip through .vtu")
        with open(os.path.join(data, "oracle_energies.json")) as fh:
            ref = json.load(fh)["tet_beam_scale_8"]
        beam_problems = {}
        for tag, dtype in (("beam8_fp64", torch.float64),
                           ("beam8_fp32", torch.float32)):
            p = setup(mesh, dtype)
            beam_problems[tag] = p
            check(p.n_dofs == 89_991, f"scale-8 beam has {p.n_dofs} dofs")
            r, secs, launches = solve(p, None, "tet4_apply")
            rel = report(tag, r, secs, launches, ref)
            if dtype == torch.float64:
                block_jacobi_iterations = r.iterations
                check(r.converged, "scale-8 fp64 solve did not converge")
                check(rel <= 1e-8, f"scale-8 fp64 rel_err {rel:.3e} > 1e-8")

    # -- 5. kernel times ----------------------------------------------------
    def time_ms(fn, reps=21, inner=10, graph=False):
        """Median per-call ms over ``reps`` batches of ``inner`` calls
        (tools/_timing.time_ms on the card: CUDA events, the batch
        replayed from a CUDA graph with ``graph``)."""
        return _time_ms(fn, dev, reps=reps, inner=inner, graph=graph)

    records = []
    for name, (kern, plain) in kernel_fns.items():
        rec = {"name": name, "route": "cuda", "source": SOURCE,
               "replaces": REPLACES[name],
               "launches": main_path_launches[name]}
        for i, label in enumerate(shapes[name]):
            for dtype in (torch.float32, torch.float64):
                dname = str(dtype).split(".")[1]
                args = inputs(name, dtype, label)
                coords, conn, u, lam, mu = args
                C, k = conn.shape
                item = coords.element_size()
                nbytes = (coords.numel() * item + conn.numel() * 4
                          + u.numel() * item + 2 * C * item
                          + C * k * 3 * item)
                b_ms, b_by = bound_ms(nbytes, FLOPS_PER_ELEMENT[name] * C,
                                      dtype)
                etype = "tet4" if k == 4 else "hex8"
                ke = element_stiffness(coords[conn.long()], lam, mu, etype, 2)
                ue = u.reshape(-1, 3)[conn.long()].reshape(C, 3 * k, 1)
                vals = {
                    "ms": time_ms(lambda: kern(*args), graph=True),
                    "plain_ms": time_ms(lambda: plain(*args), reps=21,
                                        inner=2),
                    "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": time_ms(lambda: torch.bmm(ke, ue),
                                          graph=True),
                    "max_abs_err": errs[(name, label, dname)],
                    "eager_ms": time_ms(lambda: kern(*args)),
                }
                del ke, ue, args
                torch.cuda.empty_cache()
                print(f"[time] {name} {label} {dname} C={C} " + " ".join(
                    f"{key}={val}" for key, val in vals.items()), flush=True)
                sfx = ("" if dtype == torch.float32 else "_fp64") \
                    + ("" if i == 0 else f"_{label}")
                rec.update({f"{key}{sfx}": val for key, val in vals.items()})
                if i == 0 and dtype == torch.float32:
                    rec["dtype"] = "float32"
                    rec["shape"] = label
        records.append(rec)

    # -- 6. where one CG iteration's time goes (real-size beam) -----------
    from topopteval_tpu_torch.fem.solvers import apply_preconditioner, cg
    for tag, p in beam_problems.items():
        op = p.build_operator()
        M = tt_api._build_preconditioner(op, CG)
        b = torch.as_tensor(p.f, dtype=p.dtype, device=dev) * op.free_mask
        dm = op.dmesh
        f_e = ek.tet4_apply(dm.coords, dm.conn, b, op.lam, op.mu)
        parts = {
            "tet4_apply": time_ms(
                lambda: ek.tet4_apply(dm.coords, dm.conn, b, op.lam, op.mu)),
            "scatter": time_ms(lambda: op.plan.scatter_add(f_e)),
            "matvec": time_ms(lambda: op.matvec(b)),
            "precond": time_ms(lambda: apply_preconditioner(M, b)),
            "dot_fp64": time_ms(lambda: torch.dot(b.double(), b.double())),
        }
        iters = 200
        cg(op, b, M=M, tol=0.0, maxiter=10)            # warm-up
        torch.cuda.synchronize()
        t = time.perf_counter()
        cg(op, b, M=M, tol=0.0, maxiter=iters)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t) / iters
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            cg(op, b, M=M, tol=0.0, maxiter=iters)
            torch.cuda.synchronize()
        # kernel rows only: an op row (aten::bmm) repeats its kernels' time
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]

        def dev_us(e):
            return e.self_device_time_total

        device_ms = sum(dev_us(e) for e in kernels) / 1e3 / iters
        top = sorted(kernels, key=dev_us, reverse=True)[:6]
        busy = (f"{device_ms / wall_ms:.3f}" if device_ms > 0
                else "not measured")
        print(f"[breakdown] {tag} cg_wall_ms_per_iter={wall_ms:.4f} "
              f"device_ms_per_iter={device_ms:.4f} device_busy_share={busy} "
              + " ".join(f"{k}_ms={v:.4f}" for k, v in parts.items()),
              flush=True)
        print(f"[breakdown] {tag} top device ops per iteration (ms): "
              + ", ".join(f"{e.key[:48]}={dev_us(e) / 1e3 / iters:.4f}"
                          for e in top), flush=True)

    # -- 7. structured multigrid: stencil kernels and the full-size beam ----
    stencil_fns = {"stencil_plane": "plane", "stencil_window": "window"}
    with open(os.path.join(repo, "data", "oracle_energies.json")) as fh:
        oracles = json.load(fh)

    def stencil_args(dims, dtype, simp, seed=0):
        """((u, esc, ke, dims), the cell table) on the card for a box of
        BEAM_BOX."""
        nx, ny, nz = dims
        rng = np.random.default_rng(seed)
        op = tt.StructuredStiffnessOperator.build(
            nx, ny, nz, (0, 0, 0), BEAM_BOX, lam0, mu0,
            escale=rng.uniform(0.1, 1.0, (nz, ny, nx)) if simp else None,
            dtype=dtype)
        u = torch.as_tensor(rng.standard_normal(op.n_dofs), dtype=dtype,
                            device=dev)
        return (u, op.escale, op.ke, dims), op.table

    # 7a. parity at the scale-16 lattice, its coarsest smoothed level and
    # an odd box where every boundary case occurs; each kernel also
    # repeats its own output bit for bit.  The two kernels compute the
    # same cell forces and sum every node in the same order: they give
    # the same bits
    stencil_errs = {}
    for dims in ((200, 64, 16), (50, 16, 4), (7, 5, 3)):
        for dtype in (torch.float64, torch.float32):
            dname = str(dtype).split(".")[1]
            for simp in (False, True):
                args, table = stencil_args(dims, dtype, simp)
                out_p = st.stencil_matvec_reference(*args)
                scale = float(out_p.abs().max())
                outs = {}
                for name, kernel in stencil_fns.items():
                    before = st.LAUNCHES[name]
                    outs[name] = st.stencil_matvec(*args, kernel=kernel,
                                                   table=table)
                    again = st.stencil_matvec(*args, kernel=kernel,
                                              table=table)
                    torch.cuda.synchronize()
                    check(st.LAUNCHES[name] == before + 2,
                          f"{name} did not count its launches")
                    check(bool(torch.equal(outs[name], again)),
                          f"{name} {dname} {dims}: a repeat differs")
                    check(bool(torch.isfinite(outs[name]).all()),
                          f"{name} not finite")
                    err = float((outs[name] - out_p).abs().max())
                    if dims == (200, 64, 16) and not simp:
                        stencil_errs[(name, dname)] = err
                    print(f"[parity] {name} {dname} dims={dims} "
                          f"esc={'random' if simp else 'none'} "
                          f"max_abs_err={err:.3e} max|plain|={scale:.3e} "
                          f"rel={err / scale:.3e} "
                          f"(tol {TOLERANCE[dname]:.0e})", flush=True)
                    check(err <= TOLERANCE[dname] * scale,
                          f"{name} {dname} {dims} disagrees with its plain "
                          "version")
                gap = float((outs["stencil_plane"]
                             - outs["stencil_window"]).abs().max())
                bit_equal = bool(torch.equal(outs["stencil_plane"],
                                             outs["stencil_window"]))
                print(f"[parity] plane vs window {dname} dims={dims} "
                      f"esc={'random' if simp else 'none'} "
                      f"max_abs_diff={gap:.3e} bit_equal={bit_equal}",
                      flush=True)
                check(bit_equal, f"plane and window differ at {dims} {dname}")

    def beam_problem(scale, dtype, escale=None):
        mesh = tt.generate_grid_tet(25 * scale // 2, 4 * scale, scale,
                                    (0, 0, 0), BEAM_BOX)
        p = setup(mesh, dtype)
        if escale is not None:      # per-hex scale, x-major hex order
            e_t = np.repeat(escale.transpose(2, 1, 0).reshape(-1), 6)
            p.lam, p.mu = p.lam * e_t, p.mu * e_t
        return p

    MG = tt.SolverConfig(**MG_KW)
    mg_results = {}
    for scale in (4, 8, 16):
        p = beam_problem(scale, torch.float64)
        r, secs, launches = solve(p, MG, "stencil_plane")
        rel = report(f"mg_beam{scale}_fp64", r, secs, launches,
                     oracles[f"tet_beam_scale_{scale}"])
        print(f"[mg_beam{scale}_fp64] dofs={p.n_dofs} tets={p.mesh.n_cells} "
              f"levels={len(tt_api._get_multigrid(p)[1].levels) + 1} "
              f"build_operator_s={r.timings['build_operator']:.3f} "
              f"postprocess_s={r.timings['postprocess']:.3f}", flush=True)
        check(r.converged, f"scale-{scale} multigrid did not converge")
        check(rel <= 1e-8, f"scale-{scale} multigrid rel_err {rel:.3e}")
        mg_results[scale] = (p, r)
    check(mg_results[16][0].n_dofs == 666_315
          and mg_results[16][0].mesh.n_cells == 1_228_800,
          "scale-16 beam is not the 1,228,800-tet / 666,315-DOF box")
    print(f"[mg_beam8_fp64] iterations multigrid="
          f"{mg_results[8][1].iterations} block_jacobi="
          f"{block_jacobi_iterations} (phase 4, the same beam)", flush=True)

    # 7b. the float32 cancellation check: the converged float64 scale-4
    # solution, cast to float32, through the float32 stencil.  Tolerance
    # 1e-4: the difference form leaves the float32 rounding of K u against
    # u, which the plain version and the kernel both read at 1e-5 to 3e-5
    # here; summing raw Ke*u instead is off by more than 1e-2.
    p4, r4 = mg_results[4]
    op32 = tt.StructuredStiffnessOperator.build(
        50, 16, 4, (0, 0, 0), BEAM_BOX, lam0, mu0,
        free_mask=tt.free_mask_from_bcs(p4.n_dofs, p4.bcs),
        dtype=torch.float32)
    u32 = torch.as_tensor(r4.u, dtype=torch.float32, device=dev)
    before = st.LAUNCHES["stencil_plane"]
    e32 = float(op32.energy(u32))
    check(st.LAUNCHES["stencil_plane"] == before + 1,
          "the float32 energy did not go through stencil_plane")
    m32 = op32.free_mask
    e32_plain = 0.5 * float(torch.dot(u32.double(), (
        m32 * st.stencil_matvec_reference(m32 * u32, None, op32.ke,
                                          op32.dims)).double()))
    ref = oracles["tet_beam_scale_4"]
    rel = abs(e32 - ref) / ref
    print(f"[fp32_energy] 0.5 u^T K u through stencil_plane fp32 = {e32!r} "
          f"(plain version {e32_plain!r}, rel_err "
          f"{abs(e32_plain - ref) / ref:.3e}) oracle tet_beam_scale_4 = "
          f"{ref!r} rel_err={rel:.3e} (tol 1e-04)", flush=True)
    check(rel <= 1e-4, f"float32 stencil energy rel_err {rel:.3e} > 1e-4")

    # 7c. scale 8 through the opt-in z-blocked kernel: same solve
    os.environ["TOPOPT_STENCIL_KERNEL"] = "window"
    try:
        p = beam_problem(8, torch.float64)
        r, secs, launches = solve(p, MG, "stencil_window")
    finally:
        del os.environ["TOPOPT_STENCIL_KERNEL"]
    rel = report("mg_beam8_fp64_window", r, secs, launches,
                 oracles["tet_beam_scale_8"])
    check(r.converged and rel <= 1e-8, "scale-8 window solve failed")
    check(r.iterations == mg_results[8][1].iterations,
          "window and plane solves took different iteration counts")

    # 7d. SIMP on the hex grid: seeded per-hex scale in [0.2, 1], scale 4
    esc4 = np.random.default_rng(4).uniform(0.2, 1.0, (4, 16, 50))
    p = beam_problem(4, torch.float64, escale=esc4)
    ref = oracle_energy(p)
    r, secs, launches = solve(p, MG, "stencil_plane")
    rel = report("mg_beam4_simp_fp64", r, secs, launches, ref)
    check(tt_api._get_multigrid(p)[0].escale is not None,
          "the SIMP beam did not take the per-hex scale branch")
    check(r.converged, "scale-4 SIMP multigrid did not converge")
    check(rel <= 1e-8, f"scale-4 SIMP multigrid rel_err {rel:.3e}")

    # 7e. scale 16 in float32 at tolerance 1e-10: the refinement route
    p = beam_problem(16, torch.float32)
    r, secs, launches = solve(p, MG, "stencil_plane")
    rel = report("mg_beam16_fp32", r, secs, launches,
                 oracles["tet_beam_scale_16"])
    print(f"[mg_beam16_fp32] host fp64 residual twin: build_s="
          f"{r.timings['refine_host_build_seconds']:.3f} matvecs_s="
          f"{r.timings['refine_host_matvec_seconds']:.3f} of solve_s="
          f"{r.solve_time:.3f}", flush=True)
    if r.converged:
        check(rel <= 1e-8, f"scale-16 fp32 rel_err {rel:.3e} > 1e-8")
    else:
        print("[mg_beam16_fp32] DID NOT CONVERGE: reported, not hidden",
              flush=True)
    del p, r

    # 7f. stencil kernel times at the scale-16 shape, uniform material
    # (what the main path gives them); the per-hex-scale variant beside it
    conv_w = {}

    def two_conv(u, esc, ke, dims):
        """Library yardstick: gather conv with Ke in the weights, times
        esc, scatter conv (cuDNN, TF32 off)."""
        nx, ny, nz = dims
        w1, w2 = conv_w[u.dtype]
        u5 = u.reshape(1, nz + 1, ny + 1, nx + 1, 3).permute(0, 4, 1, 2, 3)
        f = torch.nn.functional.conv3d(u5, w1)
        if esc is not None:
            f = f * esc[None, None]
        out = torch.nn.functional.conv3d(f, w2, padding=1)
        return out.permute(0, 2, 3, 4, 1).reshape(-1)

    def conv_weights(ke, dtype):
        w1 = np.zeros((24, 3, 2, 2, 2))
        w2 = np.zeros((3, 24, 2, 2, 2))
        for j, (ozj, oyj, oxj) in enumerate(st.CORNER_OFFSETS):
            for a in range(3):
                w2[a, j * 3 + a, 1 - ozj, 1 - oyj, 1 - oxj] = 1.0
                for k, (ozk, oyk, oxk) in enumerate(st.CORNER_OFFSETS):
                    for b in range(3):
                        w1[j * 3 + a, b, ozk, oyk, oxk] = ke[j * 3 + a,
                                                             k * 3 + b]
        return (torch.as_tensor(w1, dtype=dtype, device=dev),
                torch.as_tensor(w2, dtype=dtype, device=dev))

    dims16 = (200, 64, 16)
    ke16 = tt_api._get_multigrid(mg_results[16][0])[0]._hex_ke()
    for dtype in (torch.float32, torch.float64):
        conv_w[dtype] = conv_weights(ke16, dtype)
    n_cells = dims16[0] * dims16[1] * dims16[2]
    for name, kernel in stencil_fns.items():
        rec = {"name": name, "route": "cuda", "source": STENCIL_SOURCE,
               "replaces": REPLACES[name],
               "launches": main_path_launches[name]}
        for dtype in (torch.float32, torch.float64):
            dname = str(dtype).split(".")[1]
            for simp in (False, True):
                args, table = stencil_args(dims16, dtype, simp)
                u, esc = args[0], args[1]
                item = u.element_size()
                nbytes = (2 * u.numel() + (n_cells if simp else 0)) * item
                b_ms, b_by = bound_ms(
                    nbytes, FLOPS_PER_ELEMENT[name] * n_cells, dtype)
                lib = two_conv(*args)
                plain = st.stencil_matvec_reference(*args)
                lib_err = float((lib - plain).abs().max()
                                / plain.abs().max())
                check(lib_err <= 10 * TOLERANCE[dname],
                      f"two-conv yardstick is off by {lib_err:.3e} {dname}")
                vals = {
                    "ms": time_ms(lambda: st.stencil_matvec(
                        *args, kernel=kernel, table=table), graph=True),
                    "plain_ms": time_ms(
                        lambda: st.stencil_matvec_reference(*args),
                        reps=11, inner=2),
                    "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": time_ms(lambda: two_conv(*args), reps=11,
                                          inner=4),
                    "max_abs_err": stencil_errs[(name, dname)],
                    "eager_ms": time_ms(lambda: st.stencil_matvec(
                        *args, kernel=kernel, table=table)),
                }
                print(f"[time] {name} {dname} dims={dims16} "
                      f"esc={'random' if simp else 'none'} " + " ".join(
                          f"{key}={val}" for key, val in vals.items())
                      + f" library_rel_err={lib_err:.2e}", flush=True)
                if simp:
                    continue        # the record is the main path's shape
                if dtype == torch.float32:
                    rec.update(vals)
                    rec["dtype"] = "float32"
                else:
                    rec.update({f"{key}_fp64": val
                                for key, val in vals.items()})
        # the coarser smoothed levels of the scale-16 hierarchy, each with
        # the two-conv yardstick on its own Ke
        for dims in ((100, 32, 8), (50, 16, 4)):
            cells = dims[0] * dims[1] * dims[2]
            for dtype in (torch.float32, torch.float64):
                dname = str(dtype).split(".")[1]
                args, table = stencil_args(dims, dtype, False)
                conv_w[dtype] = conv_weights(args[2].cpu().numpy(), dtype)
                plain = st.stencil_matvec_reference(*args)
                lib_err = float((two_conv(*args) - plain).abs().max()
                                / plain.abs().max())
                check(lib_err <= 10 * TOLERANCE[dname],
                      f"two-conv yardstick at {dims} is off by "
                      f"{lib_err:.3e} {dname}")
                b_ms, b_by = bound_ms(
                    2 * args[0].numel() * args[0].element_size(),
                    FLOPS_PER_ELEMENT[name] * cells, dtype)
                vals = {
                    "ms": time_ms(lambda: st.stencil_matvec(
                        *args, kernel=kernel, table=table), graph=True),
                    "plain_ms": time_ms(
                        lambda: st.stencil_matvec_reference(*args),
                        reps=11, inner=2),
                    "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": time_ms(lambda: two_conv(*args), reps=11,
                                          inner=4),
                    "eager_ms": time_ms(lambda: st.stencil_matvec(
                        *args, kernel=kernel, table=table)),
                }
                print(f"[time] {name} {dname} dims={dims} esc=none "
                      + " ".join(f"{key}={val}" for key, val in vals.items())
                      + f" library_rel_err={lib_err:.2e}", flush=True)
                sfx = "x".join(map(str, dims)) + (
                    "" if dtype == torch.float32 else "_fp64")
                rec.update({f"{key}_{sfx}": val for key, val in vals.items()})
            for dtype in (torch.float32, torch.float64):
                conv_w[dtype] = conv_weights(ke16, dtype)
        records.append(rec)

    # 7g. where one MG-PCG iteration at scale 16 spends its time
    p16 = mg_results[16][0]
    op, M = tt_api._get_multigrid(p16)
    b = torch.as_tensor(p16.f, dtype=p16.dtype, device=dev) * op.free_mask
    iters = 20
    cg(op, b, M=M, tol=0.0, maxiter=3)                # warm-up
    torch.cuda.synchronize()
    st.reset_launch_counts()
    t = time.perf_counter()
    cg(op, b, M=M, tol=0.0, maxiter=iters)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t) / iters
    # the start costs what an iteration costs: one matvec, one V-cycle
    per_iter = st.LAUNCHES["stencil_plane"] / (iters + 1)
    parts = {
        "matvec": time_ms(lambda: op.matvec(b)),
        "vcycle": time_ms(lambda: M.apply(b), reps=11, inner=2),
        "dot_fp64": time_ms(lambda: torch.dot(b.double(), b.double())),
    }
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        cg(op, b, M=M, tol=0.0, maxiter=iters)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / iters
    n_launched = sum(e.count for e in kernels) / iters
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:8]
    busy = (f"{device_ms / wall_ms:.3f}" if device_ms > 0
            else "not measured")
    print(f"[breakdown] mg_beam16_fp64 cg_wall_ms_per_iter={wall_ms:.4f} "
          f"device_ms_per_iter={device_ms:.4f} device_busy_share={busy} "
          f"stencil_launches_per_iter={per_iter:.2f} "
          f"device_kernels_per_iter={n_launched:.1f} "
          + " ".join(f"{k}_ms={v:.4f}" for k, v in parts.items()),
          flush=True)
    print("[breakdown] mg_beam16_fp64 top device ops per iteration (ms): "
          + ", ".join(f"{e.key[:48]}={e.self_device_time_total / 1e3 / iters:.4f}"
                      for e in top), flush=True)

    # -- 8. block-ELL multigrid on meshes without structured_info ---------
    from topopteval_tpu_torch.fem import bell as fb

    def vtu_round_trip(mesh, tmp, name):
        """``mesh`` written to .vtu and read back: an imported mesh, with
        no ``structured_info``, so multigrid takes the block-ELL route."""
        back = tt.import_mesh(tt.write_vtu(os.path.join(tmp, name), mesh))
        check(back.structured_info is None
              and np.array_equal(back.coords, mesh.coords)
              and np.array_equal(back.conn, mesh.conn),
              f"{name} does not round-trip through .vtu")
        return back

    def bell_report(tag, p, r, secs, launches, ref, energy=None):
        """report() plus the block-ELL build record; the route must be
        the block-ELL one and both of its kernels must have launched."""
        op = tt_api._get_multigrid(p)[0]
        check(isinstance(op, fb.BellSystem),
              f"{tag} did not take the block-ELL route")
        check(bo.LAUNCHES["sell_matvec"] > 0,
              f"{tag}: sell_matvec was not launched by the solve")
        info = p._mg_build_info
        rel = report(tag, r, secs, launches, ref)
        if energy is not None:
            rel = abs(energy - ref) / abs(ref)
            print(f"[{tag}] energy 0.5*u.f={energy!r} rel_err={rel:.3e} "
                  f"(the oracle's definition)", flush=True)
        indptr = op.matrix.A.indptr
        print(f"[{tag}] dofs={p.n_dofs} cells={p.mesh.n_cells} "
              f"levels={info['n_levels']} "
              f"level_nodes={info.get('level_nodes')} "
              f"fine_blocks={info['fine_blocks']} max_blocks_per_row="
              f"{int((indptr[1:] - indptr[:-1]).max())} "
              f"sell_launches={bo.LAUNCHES['sell_matvec']} "
              f"cached={info.get('cached')} "
              f"skeleton_cached={info.get('skeleton_cached')} "
              f"build_operator_s={r.timings['build_operator']:.3f} "
              f"device_bytes={info['device_bytes']} "
              f"skeleton_phases={info.get('skeleton_phases')} "
              f"value_phases={info.get('phases')} "
              f"refine_host_matvec_s="
              f"{r.timings.get('refine_host_matvec_seconds', 0.0):.3f}",
              flush=True)
        return rel, info

    def bell_bound(name, A, lo, u):
        """(bound_ms, bound_by): bytes of every input read once and the
        output written once, against the operations the function needs."""
        nnz = A.nnz
        nbytes = (A.indptr.numel() * 4 + nnz * 4
                  + A.vals.numel() * A.vals.element_size()
                  + (0 if lo is None else lo.numel() * lo.element_size())
                  + u.numel() * u.element_size()
                  + 3 * A.n_rows * u.element_size())
        flops = FLOPS_PER_BLOCK[name] * nnz * (1 if lo is None else 2)
        return bound_ms(nbytes, flops, u.dtype)

    def refine_b4(tag, p, r):
        """The float64 refinement's launches at a block-ELL solve's fine
        shape (``BellSystem.matrix64``): B4 in float64 and over |values|
        |u|, each launched twice, counted, and held to its plain version;
        the device residual and floor against the host twins; both
        launches' times beside their bound."""
        system = tt_api._get_multigrid(p)[0]
        check(r.device_residuals > 0,
              f"{tag}: the refinement's residuals did not run on the card")
        A = system.matrix64
        check(A.vals.dtype == torch.float64
              and A.cols is system.matrix.A.cols,
              f"{tag}: matrix64 is not the fine structure in float64")
        rng = np.random.default_rng(21)
        u = torch.as_tensor(rng.standard_normal((3, A.n_cols)), device=dev)
        for absolute in (False, True):
            label = f"{tag} fine_fp64{'_abs' if absolute else ''}"
            before = bo.LAUNCHES["bell_matvec"]
            out, again = (bo.bell_matvec(u, A, absolute=absolute)
                          for _ in range(2))
            torch.cuda.synchronize()
            check(bo.LAUNCHES["bell_matvec"] == before + 2,
                  f"{label}: bell_matvec did not count its launches")
            check(bool(torch.equal(out, again)), f"{label}: a repeat differs")
            ref = bo.bell_matvec_reference(u, A, absolute=absolute)
            err, scale = float((out - ref).abs().max()), float(ref.abs().max())
            b_ms, b_by = bell_bound("bell_matvec", A, None, u)
            ms = time_ms(lambda: bo.bell_matvec(u, A, absolute=absolute),
                         graph=True)
            print(f"[refine_b4] {label} rows={A.n_rows} nnz={A.nnz} "
                  f"lanes={bo.bell_lanes(A.n_rows, A.nnz)} launches=2 "
                  f"repeat_identical=True max_abs_err={err:.3e} "
                  f"rel={err / scale:.3e} (tol {TOLERANCE['float64']:.0e}) "
                  f"ms={ms} bound_ms={b_ms} bound_by={b_by}", flush=True)
            check(err <= TOLERANCE["float64"] * scale,
                  f"{label} disagrees with its plain version")
        oracle = system.device_residual()
        x = rng.standard_normal(3 * system.matrix.n_rows_p)
        kx = system.matvec64(x)
        f = rng.standard_normal(x.size) * np.abs(kx).max()
        want = f - kx
        r_d, _ = oracle.residual64(torch.as_tensor(f, device=dev),
                                   torch.as_tensor(x, device=dev))
        res_rel = float(np.linalg.norm(r_d.cpu().numpy() - want)
                        / np.linalg.norm(want))
        floor_h = system.residual_floor64(x)
        floor_rel = abs(oracle.residual_floor64(torch.as_tensor(
            x, device=dev)) - floor_h) / floor_h
        print(f"[refine_b4] {tag} device residual against matvec64: "
              f"rel={res_rel:.3e} (tol 1e-14); floor against "
              f"residual_floor64: rel={floor_rel:.3e} (tol 1e-12); solve "
              f"device_residuals={r.device_residuals} refinement_passes="
              f"{r.refinement_passes}", flush=True)
        check(res_rel <= 1e-14, f"{tag}: the device residual is off "
              f"matvec64 by {res_rel:.3e}")
        check(floor_rel <= 1e-12, f"{tag}: the device floor is off "
              f"residual_floor64 by {floor_rel:.3e}")

    MG_SIMP = tt.SolverConfig(**{**MG_KW, "max_iterations": 5000})
    with tempfile.TemporaryDirectory() as tmp:
        # 8a. the 1,228,800-tet beam through .vtu, float32, block-ELL route
        os.environ["TOPOPT_MG_CACHE_DIR"] = "off"
        mesh = vtu_round_trip(
            tt.generate_grid_tet(200, 64, 16, (0, 0, 0), BEAM_BOX), tmp,
            "beam_scale_16.vtu")
        check(mesh.n_cells == 1_228_800 and mesh.n_dofs == 666_315,
              "scale-16 .vtu beam is not 1,228,800 tets / 666,315 DOFs")
        p16b = setup(mesh, torch.float32)
        r, secs, launches = solve(p16b, MG, "bell_matvec")
        rel, info16 = bell_report("bell_beam16_fp32", p16b, r, secs,
                                  launches, oracles["tet_beam_scale_16"])
        check(info16["host_library"] is True,
              "the scale-16 block-ELL build did not take the host library")
        check(r.converged, "scale-16 block-ELL fp32 did not converge")
        check(rel <= 1e-8, f"scale-16 block-ELL fp32 rel_err {rel:.3e}")
        op16, M16 = tt_api._get_multigrid(p16b)
        refine_b4("bell_beam16_fp32", p16b, r)
        del mesh, r

        # 8b. kernel parity at the real shapes: the scale-16 fine operator
        # (float32 with its lo plane, the bf16 V-cycle copy, the float64
        # values), the first coarse Galerkin level, the first transfers,
        # and a random matrix with empty rows
        Np16 = op16.matrix.n_rows_p
        hb = op16.host_bsr
        A_hi, lo16 = op16.matrix.A, op16.matrix.vals_lo
        A64 = bo.BlockCSR.from_numpy(
            fb._pad_indptr(hb["indptr"], Np16), hb["indices"],
            np.asarray(hb["data"]).reshape(-1, 9), Np16, torch.float64, dev)
        A_bf = M16.levels[0].op.A
        C1 = M16.levels[1].op.A
        P0, R0 = M16.levels[0].transfer.P, M16.levels[0].transfer.R
        rng = np.random.default_rng(16)
        rows = rng.integers(0, 5000, 60000)
        rows = rows[rows % 7 != 3]              # every seventh row empty
        cols = np.clip(rows + rng.integers(-300, 301, rows.size), 0, 4999)
        rnd = bo.pack_csr(rows, cols, rng.standard_normal((rows.size, 3, 3)),
                          5000, 5000, torch.float64, dev)
        rnd_t = bo.pack_csr(rows, cols, rng.standard_normal(rows.size),
                            5000, 5000, torch.float64, dev)

        def as_type(A, dtype):
            return A.with_vals(A.vals.to(dtype))

        f32, f64 = torch.float32, torch.float64
        cases = [  # (kernel, label, matrix, lo plane, vector dtype)
            ("bell_matvec", "fine_fp32_lo", A_hi, lo16, f32),
            ("bell_matvec", "fine_fp32", A_hi, None, f32),
            ("bell_matvec", "fine_bf16", A_bf, None, f32),
            ("bell_matvec", "fine_fp64", A64, None, f64),
            ("bell_matvec", "coarse1_bf16", C1, None, f32),
            ("bell_matvec", "coarse1_fp32", as_type(C1, f32), None, f32),
            ("bell_matvec", "coarse1_fp64", as_type(C1, f64), None, f64),
            ("bell_matvec", "random_fp64", rnd, None, f64),
            ("bell_matvec", "random_fp32", as_type(rnd, f32), None, f32),
            ("bell_matvec", "random_bf16", as_type(rnd, torch.bfloat16),
             None, f32),
            ("sell_matvec", "prolong0_bf16", P0, None, f32),
            ("sell_matvec", "prolong0_fp64", as_type(P0, f64), None, f64),
            ("sell_matvec", "restrict0_bf16", R0, None, f32),
            ("sell_matvec", "restrict0_fp32", as_type(R0, f32), None, f32),
            ("sell_matvec", "restrict0_fp64", as_type(R0, f64), None, f64),
            ("sell_matvec", "random_fp64", rnd_t, None, f64),
            ("sell_matvec", "random_bf16", as_type(rnd_t, torch.bfloat16),
             None, f32),
        ]
        bell_errs = {}
        bell_inputs = {}
        for name, label, A, lo, vdt in cases:
            u = torch.as_tensor(rng.standard_normal((3, A.n_cols)),
                                dtype=vdt, device=dev)
            bell_inputs[(name, label)] = (A, lo, u)
            before = bo.LAUNCHES[name]
            if name == "bell_matvec":
                out, again = (bo.bell_matvec(u, A, lo) for _ in range(2))
                torch.cuda.synchronize()
                ref = bo.bell_matvec_reference(u, A, lo)
            else:
                out, again = (bo.sell_matvec(u, A) for _ in range(2))
                torch.cuda.synchronize()
                ref = bo.sell_matvec_reference(u, A)
            check(bo.LAUNCHES[name] == before + 2,
                  f"{name} did not count its launches")
            check(bool(torch.equal(out, again)),
                  f"{name} {label}: a repeat differs")
            check(bool(torch.isfinite(out).all()), f"{name} {label} not finite")
            empty = A.indptr[1:] == A.indptr[:-1]
            check(bool((out[:, empty] == 0).all()),
                  f"{name} {label}: an empty row is not zero")
            err = float((out - ref).abs().max())
            scale = float(ref.abs().max())
            tol = TOLERANCE[str(vdt).split(".")[1]]
            bell_errs[(name, label)] = err
            lanes = (bo.bell_lanes if name == "bell_matvec"
                     else bo.sell_lanes)(A.n_rows, A.nnz)
            print(f"[parity] {name} {label} rows={A.n_rows} nnz={A.nnz} "
                  f"lanes={lanes} repeat_identical=True "
                  f"empty_rows={int(empty.sum())} max_abs_err={err:.3e} "
                  f"max|plain|={scale:.3e} rel={err / scale:.3e} "
                  f"(tol {tol:.0e})", flush=True)
            check(err <= tol * scale,
                  f"{name} {label} disagrees with its plain version")

        # 8c. the lo plane moves the output: on a rigid translation the hi
        # terms cancel to float32 rounding, and split - hi must equal the
        # lo plane's own product
        u = torch.zeros((3, Np16), dtype=f32, device=dev)
        n16 = op16.n_nodes
        u[0, :n16], u[1, :n16], u[2, :n16] = 1.0, -0.5, 0.25
        split = bo.bell_matvec(u, A_hi, lo16).double()
        hi = bo.bell_matvec(u, A_hi).double()
        lo_only = bo.bell_matvec(u, A_hi.with_vals(lo16)).double()
        exact = bo.bell_matvec(u.double(), A64)
        moved = float((split - hi).abs().max())
        rel_lo = float((split - hi - lo_only).norm() / lo_only.norm())
        print(f"[lo_plane] rigid translation on the scale-16 fine operator: "
              f"max|out(hi,lo)-out(hi)|={moved:.3e} "
              f"|out(hi,lo)-out(hi)-out(lo)|/|out(lo)|={rel_lo:.3e} (tol "
              f"1e-3); distance to the float64 product: split "
              f"{float((split - exact).norm()):.3e}, hi only "
              f"{float((hi - exact).norm()):.3e}", flush=True)
        check(moved > 0.0, "the lo plane does not move the output")
        check(rel_lo <= 1e-3, f"lo plane: out(hi,lo)-out(hi) is off out(lo) "
              f"by {rel_lo:.3e}")

        # 8d. the scale-8 beam through .vtu: uniform (float64, writes the
        # disk cache), the benchmark SIMP density on the same mesh and BCs
        # (float64, skeleton from the in-process cache), then the uniform
        # problem again (loads the disk cache)
        os.environ["TOPOPT_MG_CACHE_DIR"] = os.path.join(tmp, "mg_cache")
        mesh8 = vtu_round_trip(beam, tmp, "beam_scale_8.vtu")
        p8 = setup(mesh8, torch.float64)
        r8, secs, launches = solve(p8, MG, "bell_matvec")
        rel, info = bell_report("bell_beam8_fp64", p8, r8, secs, launches,
                                oracles["tet_beam_scale_8"])
        check(r8.converged and rel <= 1e-8,
              f"scale-8 block-ELL fp64 rel_err {rel:.3e}")
        check(info["cached"] is False and info["skeleton_cached"] is False,
              "scale-8 block-ELL build was not a cold build")
        bell8 = r8
        p8s = setup(mesh8, torch.float64, tt.models.bench_simp_density(
            100, 32, 8))
        r, secs, launches = solve(p8s, MG_SIMP, "bell_matvec")
        e_uf = 0.5 * float(r.u @ p8s.f)
        rel, info = bell_report("bell_simp8_fp64", p8s, r, secs, launches,
                                oracles["simp_beam_scale_8"], e_uf)
        check(info["skeleton_cached"] is True,
              "the SIMP solve did not reuse the skeleton")
        check(r.converged, "scale-8 SIMP block-ELL did not converge")
        # At 1e-8 contrast float64 fixes this energy only to about 1e-4:
        # the tip nodes sit in void (u near 1e8), so the rounding of one
        # solve leaves a relative residual near eps * |K| |u| / |f| ~ 1e-4
        # whatever the solver, and the energy moves with it.  The oracle
        # is one such solve (the JAX package's SuperLU, column order
        # COLAMD).  Here the port's matrix of the same problem is solved
        # under two column orders: how far those energies lie from the
        # oracle is the reach of float64 on this system, and the multigrid
        # energy is held to twice that reach, never looser than 1e-8 would
        # be where the direct solves agree (tests/test_torch_simp_oracle.py
        # makes the same check at scale 2 on the JAX package's matrix).
        from scipy.sparse.linalg import splu
        mask = tt.free_mask_from_bcs(p8s.n_dofs, p8s.bcs)
        K8 = assemble_scipy(p8s.mesh, p8s.lam, p8s.mu,
                            free_mask=mask).tocsc()
        f8 = p8s.f * mask
        ref = oracles["simp_beam_scale_8"]

        def rel_residual(u):
            return float(np.linalg.norm(f8 - K8 @ u) / np.linalg.norm(f8))

        reach = 0.0
        for spec in ("COLAMD", "MMD_AT_PLUS_A"):
            t = time.perf_counter()
            u_d = splu(K8, permc_spec=spec).solve(f8)
            e_d = 0.5 * float(u_d @ p8s.f)
            reach = max(reach, abs(e_d - ref) / ref)
            print(f"[bell_simp8_fp64] port host direct solve ({spec}) "
                  f"0.5*u.f={e_d!r} rel_err_vs_oracle="
                  f"{abs(e_d - ref) / ref:.3e} multigrid_vs_direct="
                  f"{abs(e_uf - e_d) / e_d:.3e} rel_residual="
                  f"{rel_residual(u_d):.3e} direct_s="
                  f"{time.perf_counter() - t:.1f}", flush=True)
        gate = max(1e-8, 2.0 * reach)
        print(f"[bell_simp8_fp64] float64 reach {reach:.3e}; multigrid "
              f"rel_err {rel:.3e}, rel_residual {rel_residual(r.u):.3e}, "
              f"gate {gate:.3e}", flush=True)
        check(rel <= gate, f"scale-8 SIMP block-ELL rel_err {rel:.3e} > "
              f"{gate:.3e} (twice the direct solves' reach)")
        del u_d, K8, f8, mask
        p8r = setup(mesh8, torch.float64)
        r, secs, launches = solve(p8r, MG, "bell_matvec")
        rel, info = bell_report("bell_beam8_fp64_reload", p8r, r, secs,
                                launches, oracles["tet_beam_scale_8"])
        check(info["cached"] is True, "scale-8 hierarchy was not reloaded")
        check(r.iterations == r8.iterations
              and abs(r.energy - r8.energy) <= 1e-12 * r8.energy,
              "the reloaded hierarchy solves differently")
        os.environ["TOPOPT_MG_CACHE_DIR"] = "off"
        del p8, p8s, p8r, mesh8

        # 8e. the SIMP Hex8 fixture, float32, block-ELL route (hex8,
        # quad_order 2), against the host direct oracle
        path = os.path.join(data, "beam_vfrac_04_Raw.vtu")
        mesh = tt.import_mesh(path)
        p = setup(mesh, torch.float32, tt.extract_cell_density(path))
        ref = oracle_energy(p)
        r, secs, launches = solve(p, MG_SIMP, "bell_matvec")
        rel, _ = bell_report("bell_simp_hex8_fp32", p, r, secs, launches,
                             ref)
        check(r.converged and rel <= 1e-8,
              f"SIMP Hex8 block-ELL fp32 rel_err {rel:.3e}")
        del p, mesh

    # 8f. block-ELL kernel times at the scale-16 shapes (bell_bound above)
    def library_call(name, A, u):
        """One PyTorch call computing the same function (cuSPARSE): a BSR
        (3x3 blocks) or CSR matrix times node-major vectors."""
        vals = A.vals if A.vals.dtype != torch.bfloat16 else A.vals.float()
        if name == "bell_matvec":
            S = torch.sparse_bsr_tensor(
                A.indptr, A.cols, vals.reshape(-1, 3, 3),
                size=(3 * A.n_rows, 3 * A.n_cols))
            x = u.to(vals.dtype).t().reshape(-1, 1).contiguous()
        else:
            S = torch.sparse_csr_tensor(A.indptr, A.cols, vals,
                                        size=(A.n_rows, A.n_cols))
            x = u.to(vals.dtype).t().contiguous()
        return lambda: S @ x

    timed = {"bell_matvec": ["fine_fp32_lo", "fine_bf16", "fine_fp64"],
             "sell_matvec": ["restrict0_bf16", "prolong0_bf16",
                             "restrict0_fp64", "prolong0_fp64"]}
    for name, labels in timed.items():
        kern = bo.bell_matvec if name == "bell_matvec" else \
            (lambda u, A, lo=None: bo.sell_matvec(u, A))
        plain = bo.bell_matvec_reference if name == "bell_matvec" else \
            (lambda u, A, lo=None: bo.sell_matvec_reference(u, A))
        rec = {"name": name, "route": "cuda", "source": BELL_SOURCE,
               "replaces": REPLACES[name],
               "launches": main_path_launches[name]}
        for i, label in enumerate(labels):
            A, lo, u = bell_inputs[(name, label)]
            b_ms, b_by = bell_bound(name, A, lo, u)
            lib = library_call(name, A, u)
            lib_out = lib()
            want = (plain(u, A, lo) if lo is None or name != "bell_matvec"
                    else bo.bell_matvec_reference(u, A))
            got = (lib_out.reshape(A.n_rows, 3).t() if name == "bell_matvec"
                   else lib_out.t())
            lib_err = float((got.to(want.dtype) - want).abs().max()
                            / want.abs().max())
            vals = {
                "ms": time_ms(lambda: kern(u, A, lo), graph=True),
                "plain_ms": time_ms(lambda: plain(u, A, lo), reps=11,
                                    inner=2),
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": time_ms(lib, reps=11, inner=4),
                "max_abs_err": bell_errs[(name, label)],
                "eager_ms": time_ms(lambda: kern(u, A, lo)),
            }
            print(f"[time] {name} {label} rows={A.n_rows} nnz={A.nnz} "
                  + " ".join(f"{k}={v}" for k, v in vals.items())
                  + f" library_rel_err={lib_err:.2e} (library: one "
                  f"{'BSR' if name == 'bell_matvec' else 'CSR'} product"
                  + (", hi plane only" if lo is not None else "") + ")",
                  flush=True)
            if i == 0:
                rec.update(vals)
                rec["shape"] = label
            else:
                rec.update({f"{k}_{label}": v for k, v in vals.items()})
        records.append(rec)

    # 8g. where one MG-PCG iteration at scale 16 (float32) spends its time
    b = torch.as_tensor(op16.to_cm(p16b.f), dtype=torch.float32,
                        device=dev) * op16.free_mask
    iters = 20
    cg(op16, b, M=M16, tol=0.0, maxiter=3)                # warm-up
    torch.cuda.synchronize()
    bo.reset_launch_counts()
    t = time.perf_counter()
    cg(op16, b, M=M16, tol=0.0, maxiter=iters)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t) / iters
    # the start costs what an iteration costs: one matvec, one V-cycle
    per_b4 = bo.LAUNCHES["bell_matvec"] / (iters + 1)
    per_b5 = bo.LAUNCHES["sell_matvec"] / (iters + 1)
    parts = {
        "system_matvec": time_ms(lambda: op16.matvec(b)),
        "vcycle": time_ms(lambda: M16.apply(b), reps=11, inner=2),
    }
    with torch.profiler.profile(activities=acts) as prof:
        cg(op16, b, M=M16, tol=0.0, maxiter=iters)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / iters
    n_launched = sum(e.count for e in kernels) / iters
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:8]
    busy = (f"{device_ms / wall_ms:.3f}" if device_ms > 0
            else "not measured")
    print(f"[breakdown] bell_beam16_fp32 cg_wall_ms_per_iter={wall_ms:.4f} "
          f"device_ms_per_iter={device_ms:.4f} device_busy_share={busy} "
          f"bell_matvec_launches_per_iter={per_b4:.2f} (predicted 13) "
          f"sell_matvec_launches_per_iter={per_b5:.2f} (predicted 6) "
          f"device_kernels_per_iter={n_launched:.1f} "
          + " ".join(f"{k}_ms={v:.4f}" for k, v in parts.items()),
          flush=True)
    print("[breakdown] bell_beam16_fp32 top device ops per iteration (ms): "
          + ", ".join(f"{e.key[:48]}={e.self_device_time_total / 1e3 / iters:.4f}"
                      for e in top), flush=True)

    # -- 9. quadratic elements and the stored-Ke operator ------------------
    # 9a. the three kernels against their plain versions at the shapes the
    # main path gives them: B7 on the scale-8 tet10 beam, the Ke kernels
    # as ops/elements.element_stiffness calls them (the gathered batch as
    # its own node table, an identity conn): B6 on the scale-16 tet4 beam,
    # B8 on the scale-8 tet10 beam and the SIMP Hex8 fixture
    def quad_beam(scale):
        """The scale-``scale`` beam made quadratic (tet10), as
        tools/oracle_energy.py makes the tet10 oracles."""
        return tt.generate_grid_tet(25 * scale // 2, 4 * scale, scale,
                                    (0, 0, 0), BEAM_BOX).to_quadratic()

    quad8 = quad_beam(8)
    check(quad8.n_cells == 153_600 and quad8.n_dofs == 666_315,
          "the scale-8 tet10 beam is not 153,600 elements / 666,315 DOFs")
    hex_path = os.path.join(data, "beam_vfrac_04_Raw.vtu")
    hexfix = tt.import_mesh(hex_path)
    hex_density = tt.extract_cell_density(hex_path)
    hex_lam, hex_mu = simp_material.lame(hex_density)
    quad_fns = {"tet10_apply": (ek.tet10_apply, ek.tet10_apply_reference),
                "tet4_ke": (kk.tet4_ke, kk.tet4_ke_reference),
                "tet10_ke": (kk.tet10_ke, kk.tet10_ke_reference),
                "hex8_ke": (kk.hex8_ke, kk.hex8_ke_reference)}
    quad_meshes = {"tet10_apply": (quad8, lam0, mu0),
                   "tet4_ke": (beam16, lam0, mu0),
                   "tet10_ke": (quad8, lam0, mu0),
                   "hex8_ke": (hexfix, hex_lam, hex_mu)}
    # hex8_ke also at phase 2's 25,600-hex box with SIMP lam, mu (the
    # fixture's bound is close to a launch's time)
    quad_extra = {"hex8_ke": {"box": (box, box_lam, box_mu)}}
    u_quad8 = np.random.default_rng(9).standard_normal(quad8.n_dofs)

    def quad_inputs(name, dtype, shape=None):
        m, lam, mu = shape or quad_meshes[name]
        C, k = m.conn.shape

        def t(a):
            return torch.as_tensor(np.array(np.broadcast_to(a, (C,))),
                                   dtype=dtype, device=dev)

        if name == "tet10_apply":
            return (torch.as_tensor(m.coords, dtype=dtype, device=dev),
                    torch.as_tensor(m.conn, device=dev),
                    torch.as_tensor(u_quad8, dtype=dtype, device=dev),
                    t(lam), t(mu))
        coords = torch.as_tensor(m.coords[m.conn].reshape(-1, 3),
                                 dtype=dtype, device=dev)
        conn = torch.arange(C * k, dtype=torch.int32,
                            device=dev).reshape(C, k)
        return coords, conn, t(lam), t(mu)

    counts_of = {"tet10_apply": ek.LAUNCHES, "tet4_ke": kk.LAUNCHES,
                 "tet10_ke": kk.LAUNCHES, "hex8_ke": kk.LAUNCHES}
    quad_errs = {}
    quad_cases = [(name, "", None) for name in quad_fns] + [
        (name, label, shape) for name, extra in quad_extra.items()
        for label, shape in extra.items()]
    for name, label, shape in quad_cases:
        kern, plain = quad_fns[name]
        for dtype in (torch.float64, torch.float32):
            dname = str(dtype).split(".")[1]
            args = quad_inputs(name, dtype, shape)
            before = counts_of[name][name]
            out_k = kern(*args)
            torch.cuda.synchronize()
            check(counts_of[name][name] == before + 1,
                  f"{name} did not count its launch")
            out_p = plain(*args)
            check(out_k.shape == out_p.shape, f"{name} shape {out_k.shape}")
            check(bool(torch.isfinite(out_k).all()), f"{name} not finite")
            err = float((out_k - out_p).abs().max())
            scale = float(out_p.abs().max())
            quad_errs[(name, label, dname)] = err
            note = ""
            if name != "tet10_apply":
                # each Ke kernel repeats its bits; the hex8 / tet10 one
                # writes each block's transpose, so its Ke is exactly
                # symmetric
                again = kern(*args)
                check(bool(torch.equal(out_k, again)),
                      f"{name} {label} {dname}: a repeat differs")
                sym = bool(torch.equal(out_k, out_k.transpose(1, 2)))
                check(sym or name == "tet4_ke",
                      f"{name} {label} {dname}: Ke is not symmetric")
                note = f" symmetric={sym}"
                del again
            print(f"[parity] {name} {label or 'main'} {dname} "
                  f"C={args[1].shape[0]} max_abs_err={err:.3e} "
                  f"max|plain|={scale:.3e} rel={err / scale:.3e} "
                  f"(tol {TOLERANCE[dname]:.0e})" + note, flush=True)
            check(err <= TOLERANCE[dname] * scale,
                  f"{name} {label} {dname} disagrees with its plain version")
            del out_k, out_p, args
    # B7 on a small batch, the Tet4 fixture at order 2 (8,121 elements,
    # tiles of 32), in float64: its sliver elements leave the float32
    # plain version itself uncertain at ~2e-5 of the largest force (the
    # earlier four-thread kernel was 2.2e-5 from it there); and a ragged
    # cut of the beam (tiles of 64) in both types
    fix2 = tt.import_mesh(os.path.join(
        data, "beam_linear_volume_mesh.vtu")).to_quadratic()
    for label, m, C, dtypes in (
            ("fixture_order2", fix2, fix2.n_cells, (torch.float64,)),
            ("beam8_ragged", quad8, 17_003, (torch.float64, torch.float32))):
        u_m = np.random.default_rng(11).standard_normal(m.n_dofs)
        for dtype in dtypes:
            dname = str(dtype).split(".")[1]
            args = (torch.as_tensor(m.coords, dtype=dtype, device=dev),
                    torch.as_tensor(m.conn[:C], device=dev),
                    torch.as_tensor(u_m, dtype=dtype, device=dev),
                    torch.full((C,), lam0, dtype=dtype, device=dev),
                    torch.full((C,), mu0, dtype=dtype, device=dev))
            out_k = ek.tet10_apply(*args)
            torch.cuda.synchronize()
            out_p = ek.tet10_apply_reference(*args)
            err = float((out_k - out_p).abs().max())
            scale = float(out_p.abs().max())
            print(f"[parity] tet10_apply {label} {dname} C={C} "
                  f"tile={ek.element_tiles(args[1]).tile} max_abs_err={err:.3e}"
                  f" rel={err / scale:.3e} (tol {TOLERANCE[dname]:.0e})",
                  flush=True)
            check(err <= TOLERANCE[dname] * scale,
                  f"tet10_apply {label} {dname} disagrees with its plain "
                  "version")
            del out_k, out_p, args
    del fix2
    torch.cuda.empty_cache()

    # 9b. the scale-4 tet10 beam through solve_system(p), no config: auto
    # takes fp32 block-Jacobi CG under fp64 host refinement above 50k DOFs
    p = setup(tt.generate_grid_tet(50, 16, 4, (0, 0, 0), BEAM_BOX),
              torch.float32, order=2)
    check(p.mesh.element_type == "tet10" and p.n_dofs == 89_991,
          f"scale-4 tet10 beam has {p.n_dofs} DOFs")
    r, secs, launches = solve(p, None, "tet10_apply")
    rel = report("tet10_beam4_fp32", r, secs, launches,
                 oracles["tet10_beam_scale_4"])
    check(r.converged and r.refinement_passes > 0,
          "scale-4 tet10 fp32 did not converge through refinement")
    check(rel <= 1e-8, f"scale-4 tet10 fp32 rel_err {rel:.3e} > 1e-8")

    # 9c. the scale-2 tet10 beam in fp64 (block-Jacobi CG forced: 13,005
    # DOFs would go to the direct solve)
    p = setup(tt.generate_grid_tet(25, 8, 2, (0, 0, 0), BEAM_BOX),
              torch.float64, order=2)
    r, secs, launches = solve(p, CG, "tet10_apply")
    rel = report("tet10_beam2_fp64", r, secs, launches,
                 oracles["tet10_beam_scale_2"])
    check(r.converged and rel <= 1e-8,
          f"scale-2 tet10 fp64 rel_err {rel:.3e} > 1e-8")

    # 9d. the Tet4 cantilever fixture at interpolation_order=2, fp64 cold
    # CG, against the port's host direct solve
    p = setup(tt.import_mesh(os.path.join(
        data, "beam_linear_volume_mesh.vtu")), torch.float64, order=2)
    check(p.n_dofs == 50_274, f"tet10 fixture has {p.n_dofs} DOFs")
    t = time.perf_counter()
    ref = oracle_energy(p)
    direct_s = time.perf_counter() - t
    r, secs, launches = solve(p, CG, "tet10_apply")
    rel = report("tet10_fixture_fp64", r, secs, launches, ref)
    print(f"[tet10_fixture_fp64] iterations={r.iterations} (JAX package, "
          f"tests/test_end_to_end.py:181: 10987) host_direct_s="
          f"{direct_s:.1f}", flush=True)
    check(r.converged and rel <= 1e-8,
          f"tet10 fixture rel_err {rel:.3e} > 1e-8")

    # 9e. full width: the scale-8 tet10 beam, 666,315 DOFs, by two
    # independent routes that must agree to 1e-8 (the oracle file has no
    # tet10_beam_scale_8): matrix-free fp64 block-Jacobi PCG on B7, and the
    # block-ELL multigrid in fp32 (B4/B5, hi/lo, fp64 refinement)
    os.environ["TOPOPT_MG_CACHE_DIR"] = "off"
    p = setup(quad8, torch.float64)
    r_bj, secs, launches = solve(p, CG, "tet10_apply")
    report("tet10_beam8_fp64_bj", r_bj, secs, launches, r_bj.energy)
    print(f"[tet10_beam8_fp64_bj] dofs={p.n_dofs} build_operator_s="
          f"{r_bj.timings['build_operator']:.3f} solve_s="
          f"{r_bj.solve_time:.3f}", flush=True)
    check(r_bj.converged, "scale-8 tet10 block-Jacobi did not converge")
    p32 = setup(quad8, torch.float32)
    r_mg, secs, launches = solve(p32, MG, "bell_matvec")
    rel, _ = bell_report("tet10_beam8_fp32_mg", p32, r_mg, secs, launches,
                         r_bj.energy)
    print(f"[tet10_beam8] energies block_jacobi_fp64={r_bj.energy!r} "
          f"multigrid_fp32={r_mg.energy!r} rel_diff={rel:.3e} (tol 1e-08); "
          f"iterations {r_bj.iterations} / {r_mg.iterations}", flush=True)
    check(r_mg.converged and rel <= 1e-8,
          f"scale-8 tet10 routes disagree by {rel:.3e}")
    refine_b4("tet10_beam8_fp32_mg", p32, r_mg)
    del p, p32, r_bj, r_mg
    tt_api._SKEL_RAM_CACHE.clear()

    # 9f. stored mode: the Ke batch built once by B6 / B8, the matvec a
    # batched product
    p = setup(beam, torch.float64, mode="stored")
    r, secs, launches = solve(p, None, "tet4_ke")
    rel = report("stored_beam8_tet4_fp64", r, secs, launches,
                 oracles["tet_beam_scale_8"])
    check(r.converged and rel <= 1e-8, f"stored tet4 rel_err {rel:.3e}")
    p = setup(tt.generate_grid_tet(50, 16, 4, (0, 0, 0), BEAM_BOX),
              torch.float64, order=2, mode="stored")
    r, secs, launches = solve(p, None, "tet10_ke")
    rel = report("stored_beam4_tet10_fp64", r, secs, launches,
                 oracles["tet10_beam_scale_4"])
    check(r.converged and rel <= 1e-8, f"stored tet10 rel_err {rel:.3e}")
    p_s = setup(hexfix, torch.float64, hex_density, mode="stored")
    r_s, secs, launches = solve(p_s, CG, "hex8_ke")
    p_o = setup(hexfix, torch.float64, hex_density)
    r_o, secs_o, launches_o = solve(p_o, CG, "hex8_apply")
    rel = report("stored_simp_hex8_fp64", r_s, secs, launches, r_o.energy)
    report("otf_simp_hex8_fp64", r_o, secs_o, launches_o, r_o.energy)
    check(r_s.converged and rel <= 1e-10,
          f"stored and otf SIMP Hex8 differ by {rel:.3e} > 1e-10")
    op = p_s.build_operator()
    kk.reset_launch_counts()
    op2 = op.with_material(0.5 * op.lam, 0.5 * op.mu)
    torch.cuda.synchronize()
    swap_launches = {n: kk.LAUNCHES[n] for n in ("tet4_ke", "hex8_ke",
                                                 "tet10_ke")}
    u = torch.as_tensor(np.random.default_rng(5).standard_normal(
        p_s.n_dofs), device=dev)
    swap_err = float((op2.matvec_raw(u) - 0.5 * op.matvec_raw(u)).abs().max()
                     / (0.5 * op.matvec_raw(u)).abs().max())
    print(f"[stored] with_material swap: Ke launches {swap_launches} "
          f"(one hex8_ke expected), |K(0.5 E) u - 0.5 K u|/|0.5 K u|="
          f"{swap_err:.3e}", flush=True)
    check(swap_launches == {"tet4_ke": 0, "hex8_ke": 1, "tet10_ke": 0},
          "with_material did not cost exactly one Ke launch")
    check(swap_err <= 1e-12, "with_material did not rebuild the Ke batch")
    del p, p_s, p_o, op, op2

    # 9g. a small hex20 box (3x3x3 rule, the batched plain route on the
    # card in both packages): CG against the host direct solve
    p = setup(tt.generate_grid_hex(12, 4, 2, (0, 0, 0), BEAM_BOX),
              torch.float64, order=2)
    check(p.mesh.element_type == "hex20" and p.quad_order == 3,
          "the hex20 box did not take the 3x3x3 rule")
    rd = tt.solve_system(p, tt.SolverConfig(method="direct"))
    t = time.perf_counter()
    rc = tt.solve_system(p, CG)
    rel = abs(rc.energy - rd.energy) / abs(rd.energy)
    print(f"[hex20_box_fp64] dofs={p.n_dofs} cg_iterations={rc.iterations} "
          f"energy={rc.energy!r} direct={rd.energy!r} rel_err={rel:.3e} "
          f"solve_s={time.perf_counter() - t:.3f}", flush=True)
    check(rc.method == "cg" and rc.converged and rel <= 1e-8,
          f"hex20 CG rel_err {rel:.3e} > 1e-8")

    # 9h. kernel times at the 9a shapes, beside their bound, the plain
    # version and a library call: for B7 a torch.bmm of the stored Ke
    # batch; for B6/B8 a torch.bmm of the per-point B^T and w det D B
    # (the product only, not the sum over points)
    from topopteval_tpu_torch.ops.elements import physical_gradients

    def voigt_pair(coords_e, lam, mu, element_type, order):
        """(B^T [C q, 3k, 6], w det D B [C q, 6, 3k]) per point."""
        g, wdet = physical_gradients(coords_e, element_type, order)
        C, q, k, _ = g.shape
        B = g.new_zeros((C, q, 6, k, 3))
        for a in range(3):
            B[:, :, a, :, a] = g[..., a]
        for row, (a, b) in enumerate(((0, 1), (1, 2), (0, 2)), start=3):
            B[:, :, row, :, a] = g[..., b]
            B[:, :, row, :, b] = g[..., a]
        B = B.reshape(C, q, 6, 3 * k)
        D = g.new_zeros((C, 6, 6))
        D[:, :3, :3] = lam[:, None, None]
        for a in range(3):
            D[:, a, a] += 2.0 * mu
            D[:, 3 + a, 3 + a] = mu
        DB = wdet[..., None, None] * torch.matmul(D[:, None], B)
        return (B.transpose(-1, -2).reshape(C * q, 3 * k, 6).contiguous(),
                DB.reshape(C * q, 6, 3 * k).contiguous())

    etype_of = {"tet4_ke": ("tet4", 1), "hex8_ke": ("hex8", 2),
                "tet10_ke": ("tet10", 2), "tet10_apply": ("tet10", 2)}
    quad_recs = {}
    for name, label, shape in quad_cases:
        kern, plain = quad_fns[name]
        rec = quad_recs.setdefault(name, {
            "name": name, "route": "cuda",
            "source": SOURCE if name == "tet10_apply" else KE_SOURCE,
            "replaces": REPLACES[name],
            "launches": main_path_launches[name]})
        for dtype in (torch.float32, torch.float64):
            dname = str(dtype).split(".")[1]
            args = quad_inputs(name, dtype, shape)
            coords, conn, lam, mu = args[0], args[1], args[-2], args[-1]
            C, k = conn.shape
            item = coords.element_size()
            etype, order = etype_of[name]
            table = (0 if etype == "tet4" or name == "tet10_apply" else
                     ek.rule_table(etype, dtype, dev).numel() * item)
            out_vals = C * k * 3 if name == "tet10_apply" else C * 9 * k * k
            nbytes = (coords.numel() * item + conn.numel() * 4
                      + 2 * C * item + table + out_vals * item
                      + (args[2].numel() * item if name == "tet10_apply"
                         else 0))
            b_ms, b_by = bound_ms(nbytes, FLOPS_PER_ELEMENT[name] * C, dtype)
            if name == "tet10_apply":
                ke = kk.tet10_ke(coords, conn, lam, mu)
                ue = args[2].reshape(-1, 3)[conn.long()].reshape(C, 30, 1)
                lib_args = (ke, ue)
                lib_out = torch.bmm(ke, ue).reshape(C, 10, 3)
                want = plain(*args)
            else:
                lib_args = voigt_pair(coords[conn.long()], lam, mu, etype,
                                      order)
                lib_out = torch.bmm(*lib_args).reshape(
                    C, -1, 3 * k, 3 * k).sum(1)
                want = plain(*args)
            lib_err = float((lib_out - want).abs().max() / want.abs().max())
            check(lib_err <= 10 * TOLERANCE[dname],
                  f"{name} library yardstick is off by {lib_err:.3e}")
            del lib_out, want
            vals = {
                "ms": time_ms(lambda: kern(*args), graph=True),
                "plain_ms": time_ms(lambda: plain(*args), reps=11, inner=2),
                "bound_ms": b_ms, "bound_by": b_by,
                # a few products per graph: each allocates its output
                "library_ms": time_ms(lambda: torch.bmm(*lib_args),
                                      inner=4, graph=True),
                "max_abs_err": quad_errs[(name, label, dname)],
                "eager_ms": time_ms(lambda: kern(*args)),
            }
            del lib_args, args
            torch.cuda.empty_cache()
            print(f"[time] {name} {label or 'main'} {dname} C={C} "
                  + " ".join(f"{key}={val}" for key, val in vals.items())
                  + f" library_rel_err={lib_err:.2e}", flush=True)
            # the main shape's float32 keys are unsuffixed
            sfx = ("" if dtype == torch.float32 else "_fp64") + (
                f"_{label}" if label else "")
            rec.update({f"{key}{sfx}": val for key, val in vals.items()})
            if not sfx:
                rec["dtype"] = "float32"
    records.extend(quad_recs.values())
    for name in quad_fns:
        check(main_path_launches[name] > 0,
              f"{name} was not launched on the main path")

    # 9i. B7 at the Tet4 fixture at order 2 (8,121 elements, tiles of 32):
    # the kernel beside its bound, the plain version and the torch.bmm of
    # the stored Ke batch, as at the beam
    fix2 = tt.import_mesh(os.path.join(
        data, "beam_linear_volume_mesh.vtu")).to_quadratic()
    rec = next(r for r in records if r["name"] == "tet10_apply")
    u_f = np.random.default_rng(11).standard_normal(fix2.n_dofs)
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split(".")[1]
        C = fix2.n_cells
        args = (torch.as_tensor(fix2.coords, dtype=dtype, device=dev),
                torch.as_tensor(fix2.conn, device=dev),
                torch.as_tensor(u_f, dtype=dtype, device=dev),
                torch.full((C,), lam0, dtype=dtype, device=dev),
                torch.full((C,), mu0, dtype=dtype, device=dev))
        item = args[0].element_size()
        nbytes = (args[0].numel() * item + args[1].numel() * 4
                  + args[2].numel() * item + 2 * C * item + 30 * C * item)
        b_ms, b_by = bound_ms(nbytes, FLOPS_PER_ELEMENT["tet10_apply"] * C,
                              dtype)
        ke = kk.tet10_ke(args[0], args[1], args[3], args[4])
        ue = args[2].reshape(-1, 3)[args[1].long()].reshape(C, 30, 1)
        vals = {
            "ms": time_ms(lambda: ek.tet10_apply(*args), graph=True),
            "plain_ms": time_ms(lambda: ek.tet10_apply_reference(*args),
                                reps=11, inner=2),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(lambda: torch.bmm(ke, ue), inner=4,
                                  graph=True),
            "eager_ms": time_ms(lambda: ek.tet10_apply(*args)),
        }
        del ke, ue, args
        print(f"[time] tet10_apply fixture_order2 {dname} C={C} "
              + " ".join(f"{key}={val}" for key, val in vals.items()),
              flush=True)
        sfx = ("" if dtype == torch.float32 else "_fp64") + "_fixture_order2"
        rec.update({f"{key}{sfx}": val for key, val in vals.items()})
    del fix2

    # -- 10. the Galerkin voxel multigrid (TOPOPT_MG=galerkin): B9a, B9b ----
    def profile(fn, iters):
        """(device ms per iteration, the top device ops [(name, ms per
        iteration)], device kernels per iteration) of ``fn`` under
        torch.profiler."""
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        device_ms = sum(e.self_device_time_total
                        for e in kernels) / 1e3 / iters
        top = sorted(kernels, key=lambda e: e.self_device_time_total,
                     reverse=True)[:8]
        return (device_ms, [(e.key, e.self_device_time_total / 1e3 / iters)
                            for e in top],
                sum(e.count for e in kernels) / iters)

    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        ell_inputs = galerkin_phase(types.SimpleNamespace(
            dev=dev, check=check, solve=solve, setup=setup, report=report,
            oracle_energy=oracle_energy, time_ms=time_ms,
            library_call=library_call, records=records, profile=profile,
            main_path_launches=main_path_launches, fine_bsr=op16.host_bsr,
            beam16=beam16, oracle16=oracles["tet_beam_scale_16"],
            fixture_path=os.path.join(data, "beam_linear_volume_mesh.vtu"),
            tmp=tmp))
    for name in ("bell_window", "sell_window"):
        check(main_path_launches[name] > 0,
              f"{name} was not launched on the main path")

    # -- 11./12. the probes' kernels: T1 (Ke formulations), T2 (ablation) --
    torch.cuda.empty_cache()
    probe_phases(types.SimpleNamespace(
        dev=dev, check=check, time_ms=time_ms, records=records,
        main_path_launches=main_path_launches, probe_scale=16,
        ablate_scale=8, ell=ell_inputs, beam16=beam16, lame=(lam0, mu0)))
    del ell_inputs

    # -- 13. the load path at full size, the fallback, the examples --------
    def setup_bare(mesh, dtype):
        """Uniform material, clamped at x = 0, no load yet."""
        p = tt.setup_problem(mesh, dtype=dtype)
        tt.assemble_stiffness_matrix(p, lam0, mu0)
        tt.apply_fixed_boundary(p, tt.nodes_at_plane(p.mesh, 0, 0.0))
        return p

    torch.cuda.empty_cache()
    box = tt.generate_grid_tet(12, 4, 4, (0, 0, 0), (12.0, 4.0, 4.0))
    box.structured_info = None
    with tempfile.TemporaryDirectory() as tmp:
        load_phase(types.SimpleNamespace(
            dev=dev, check=check, solve=solve, setup_bare=setup_bare,
            report=report, beam16=beam16, p16b=p16b, MG=MG, CG=CG,
            lame=(lam0, mu0), tmp=tmp, fallback_box=box,
            quad_mesh=tt.generate_grid_tet(50, 16, 4, (0, 0, 0), BEAM_BOX)))
    for name in ("tet4_ke_cse", "tet4_ke_lanes", "bell_ablate"):
        check(main_path_launches[name] > 0,
              f"{name} was not launched on the main path")

    # -- 14. the robust ladder, solve_system_adaptive, the readers ---------
    torch.cuda.empty_cache()
    t14 = time.perf_counter()
    beams = {4: tt.generate_grid_tet(50, 16, 4, (0, 0, 0), BEAM_BOX),
             8: beam, 16: beam16}
    ladder = ladder_phase(types.SimpleNamespace(
        dev=dev, check=check, solve=solve, setup=setup, profile=profile,
        beam=beam, beams=beams, oracles=oracles))
    print("[ladder] " + json.dumps(ladder), flush=True)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        reader_phase(types.SimpleNamespace(
            dev=dev, check=check, solve=solve, setup=setup, CG=CG,
            beam=beam, beam16=beam16, beams=beams, p16b_mesh=p16b.mesh,
            oracles=oracles, lame=(lam0, mu0), tmp=tmp))
    print(f"[phase14] seconds={time.perf_counter() - t14:.1f}", flush=True)

    # -- 15. the host library, the monolithic build, design sweeps ----------
    torch.cuda.empty_cache()
    t15 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        host_library_phase(types.SimpleNamespace(
            dev=dev, check=check, solve=solve, setup=setup, report=report,
            MG=MG, p16b=p16b, info16=info16, bell8=bell8, beam=beam,
            oracles=oracles, mesh8=vtu_round_trip(beam, tmp,
                                                  "beam_scale_8.vtu")))
    torch.cuda.empty_cache()
    sweep_phase(types.SimpleNamespace(
        dev=dev, check=check, profile=profile, CG=CG, simp_path=simp_path,
        dims=(80, 32, 8), B=64))
    print(f"[phase15] seconds={time.perf_counter() - t15:.1f}", flush=True)

    # -- 16. multi-device solves: four shards on the card ------------------
    torch.cuda.empty_cache()
    t16 = time.perf_counter()
    os.environ["TOPOPT_MG_CACHE_DIR"] = "off"
    with tempfile.TemporaryDirectory() as tmp:
        sharded = sharded_phase(types.SimpleNamespace(
            dev=dev, check=check, solve=solve, setup=setup, report=report,
            profile=profile, time_ms=time_ms, MG=MG, CG=CG, p16b=p16b,
            bell8=bell8, beam=beam, oracles=oracles, smi=smi, tmp=tmp,
            vtu_round_trip=vtu_round_trip,
            shards=[torch.device("cuda", 0)] * 4))
    print("[sharded] " + json.dumps(sharded), flush=True)
    del p16b
    print(f"[phase16] seconds={time.perf_counter() - t16:.1f}", flush=True)

    print(f"[device] {smi}")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
