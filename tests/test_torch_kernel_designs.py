"""Host-side pieces of the Hopper designs of the tet10 apply (B7) and the
block-SpMV (B4), on the CPU.

The kernels themselves run only on the card (tests/test_torch_cuda.py).
Here their arithmetic and partitions are emulated in NumPy, in the
kernels' order, and held to the plain versions and to the JAX package:

- B7 forms du/dxi and the forces from the rule's barycentric values
  (``ops/element_kernels.tet10_rule``) and J from the dN table, which
  the source carries as literals: both against ``element_tables``; the
  emulated formulation against the port's plain version and the JAX
  einsum route (float64, 1e-12 of the largest entry) on curved elements
  with C = 1, C under one tile and a ragged last tile, and in float32
  against the plain version in float32 (the card's 1e-5) on the scale-2
  beam, whose coordinates reach 60; the per-tile node lists the kernel
  gathers from, and their cache;
- B4 gives each row ``bell_lanes`` lanes in tiles of BELL_THREADS / lanes
  rows and stages a tile's blocks in chunks of 512: the emulated sum
  against ``bell_matvec_reference`` and scipy on empty rows, rows longer
  than a chunk, a coarse-level-like matrix (72 blocks a row) and row
  counts that are not a multiple of the tile; in float32 the order, and
  so every bit, does not depend on the chunk;
- B9b gives W warps a block of 32 rows, warp w summing slots w, w + W,
  ... in batches of SELL_SLOTS, the W partial sums added in warp order:
  the emulated sum, reading u through its strides as the kernel does,
  against ``sell_matvec_window_reference`` and scipy at S 8 and 48 with
  every W, empty rows, a window cut to kc = 1, columns at or past the
  vector's end, 997 rows and both layouts; in float32 the bits do not
  depend on how the rows are split into blocks, only on S and W;
- the A/B tool's ablation edits apply to this tree's sources (its tet4
  and hex8 designs: tests/test_torch_element_designs.py; B3's:
  tests/test_torch_stencil_designs.py).
"""

import math
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from topopteval_tpu.ops import elements as jax_elements
import topopteval_tpu_torch as tt
from topopteval_tpu_torch import _build
from topopteval_tpu_torch.ops import bell
from topopteval_tpu_torch.ops import element_kernels as ek
from topopteval_tpu_torch.ops import ell
from topopteval_tpu_torch.ops.elements import QUADRATURE, element_tables
from topopteval_tpu_torch.tools import kernel_ab

tt.set_verbosity(False)
torch.set_num_threads(1)

#: mid-edge node of each edge in VTK order, and the node n(i, q) of
#: csrc/element_apply.cu tet10_node: corner i where i == q, else the
#: mid-edge node of edge {i, q}
EDGES = ((0, 1), (1, 2), (0, 2), (0, 3), (1, 3), (2, 3))


def tet10_node(i, q):
    return i if i == q else 4 + EDGES.index(tuple(sorted((i, q))))


# ---------------------------------------------------------------------------
# B7
# ---------------------------------------------------------------------------


def test_tet10_rule_is_the_element_table():
    a, b, w = ek.tet10_rule()
    pts, wts = QUADRATURE[("tet", 2)]
    _, dN, w_table = element_tables("tet10", 2)
    assert b == pytest.approx(1.0 - 3.0 * a, abs=0)
    np.testing.assert_allclose(pts, [[a, a, a], [b, a, a], [a, b, a],
                                     [a, a, b]], rtol=0, atol=1e-16)
    np.testing.assert_allclose(ek.tet10_barycentric_grad(a, b), dN, rtol=0,
                               atol=1e-15)
    np.testing.assert_array_equal(w_table, np.full(4, w))
    assert w == pytest.approx(1.0 / 24.0, rel=1e-15)


def test_tet10_node_pairs_each_edge_once():
    seen = {}
    for q in range(4):
        for i in range(4):
            n = tet10_node(i, q)
            assert (n == i) == (i == q)
            if i != q:
                seen.setdefault(n, set()).add((i, q))
    # every mid-edge node is reached from both of its corners
    assert {n: sorted(v) for n, v in seen.items()} == {
        4 + k: sorted({(i, j), (j, i)}) for k, (i, j) in enumerate(EDGES)}


def emulate_tet10(coords, conn, u, lam, mu, dtype=np.float64):
    """csrc/element_apply.cu tet10_element in NumPy, in the kernel's order
    of operations (FMAs aside), in ``dtype``: J from the dN table summed
    over the nodes in order, du/dxi and the forces from the barycentric
    values."""
    a_, b_, w_ = ek.tet10_rule()
    ca, cb, cd, w = (dtype(4 * a_ - 1), dtype(4 * a_), dtype(4 * (b_ - a_)),
                     dtype(w_))
    _, dN, _ = element_tables("tet10", 2)
    dN = dN.astype(dtype)
    x = coords.astype(dtype)[conn]
    uu = u.astype(dtype).reshape(-1, 3)[conn]
    lam, mu = lam.astype(dtype), mu.astype(dtype)
    # D[:, b, a], differences of neighbouring nodes first
    Du = np.stack([
        ca * (uu[:, 1] - uu[:, 0]) + cb * ((uu[:, 5] - uu[:, 6])
                                           + (uu[:, 8] - uu[:, 7])),
        ca * (uu[:, 2] - uu[:, 0]) + cb * ((uu[:, 5] - uu[:, 4])
                                           + (uu[:, 9] - uu[:, 7])),
        ca * (uu[:, 3] - uu[:, 0]) + cb * ((uu[:, 8] - uu[:, 4])
                                           + (uu[:, 9] - uu[:, 6]))], 1)
    C = x.shape[0]
    Ts = np.zeros((C, 4, 3), dtype)
    Rc = np.zeros((C, 4, 3), dtype)
    Re = np.zeros((C, 6, 3), dtype)
    for q in range(4):
        J = np.zeros((C, 3, 3), dtype)
        for k in range(10):
            J += x[:, k, :, None] * dN[q, k][None, None, :]
        H = np.stack([Du[:, b] + cd * (uu[:, tet10_node(b + 1, q)]
                                       - uu[:, tet10_node(0, q)])
                      for b in range(3)], 2)
        j = lambda r, c: J[:, r, c]                      # noqa: E731
        A = j(1, 1) * j(2, 2) - j(1, 2) * j(2, 1)
        B = j(0, 2) * j(2, 1) - j(0, 1) * j(2, 2)
        Cc = j(0, 1) * j(1, 2) - j(0, 2) * j(1, 1)
        det = j(0, 0) * A + j(1, 0) * B + j(2, 0) * Cc
        adj = np.stack([
            np.stack([A, B, Cc], 1),
            np.stack([j(1, 2) * j(2, 0) - j(1, 0) * j(2, 2),
                      j(0, 0) * j(2, 2) - j(0, 2) * j(2, 0),
                      j(0, 2) * j(1, 0) - j(0, 0) * j(1, 2)], 1),
            np.stack([j(1, 0) * j(2, 1) - j(1, 1) * j(2, 0),
                      j(0, 1) * j(2, 0) - j(0, 0) * j(2, 1),
                      j(0, 0) * j(1, 1) - j(0, 1) * j(1, 0)], 1)], 1)
        s = np.where(det == 0, dtype(0), w / np.where(det == 0, 1, det))
        M = H @ adj
        ls = lam * s * np.trace(M, axis1=1, axis2=2)
        S = ls[:, None, None] * np.eye(3, dtype=dtype) \
            + (mu * s)[:, None, None] * (M + M.transpose(0, 2, 1))
        P = S @ adj.transpose(0, 2, 1)
        Q = np.concatenate([-P.sum(2)[:, None], P.transpose(0, 2, 1)], 1)
        Ts += Q
        for i in range(4):
            if i == q:
                Rc[:, i] = cd * Q[:, i]
            else:
                Re[:, tet10_node(i, q) - 4] += cd * Q[:, i]
    f = np.empty((C, 10, 3), dtype)
    for i in range(4):
        f[:, i] = ca * Ts[:, i] + Rc[:, i]
    for k, (i, j) in enumerate(EDGES):
        f[:, 4 + k] = cb * (Ts[:, i] + Ts[:, j]) + Re[:, k]
    return f


def _curved(nx, ny, nz, seed):
    """A curved tet10 box (mid-edge nodes moved off their edges) with
    per-element materials."""
    rng = np.random.default_rng(seed)
    mesh = tt.generate_grid_tet(nx, ny, nz, (0, 0, 0),
                                (2.0 * nx, 1.5 * ny, 1.0 * nz)).to_quadratic()
    coords = mesh.coords + rng.uniform(-0.1, 0.1, mesh.coords.shape)
    C = mesh.n_cells
    return (coords, mesh.conn.astype(np.int32),
            rng.standard_normal(mesh.n_dofs), rng.uniform(0.1, 2.0, C),
            rng.uniform(0.1, 2.0, C))


@pytest.mark.parametrize("n_cells", [1, 20, 133])
def test_tet10_formulation_matches_plain_and_jax(n_cells):
    """C = 1, C under one tile of 32, and 133 (a ragged last tile of every
    tile size the kernel takes)."""
    coords, conn, u, lam, mu = _curved(6, 3, 2, seed=n_cells)
    conn, lam, mu = conn[:n_cells], lam[:n_cells], mu[:n_cells]
    got = emulate_tet10(coords, conn, u, lam, mu)
    plain = ek.tet10_apply_reference(*(torch.from_numpy(a) for a in (
        coords, conn, u, lam, mu))).numpy()
    f_jax = np.asarray(jax_elements.apply_element_stiffness(
        jnp.asarray(coords[conn]), jnp.asarray(u.reshape(-1, 3)[conn]),
        jnp.asarray(lam), jnp.asarray(mu), "tet10", 2))
    scale = np.abs(plain).max()
    assert np.abs(got - plain).max() <= 1e-12 * scale
    assert np.abs(got - f_jax).max() <= 1e-12 * scale


def test_tet10_formulation_degenerate_element_adds_nothing():
    """det == 0 at a point: the point contributes no force (w det = 0), as
    in the plain version's guard."""
    coords, conn, u, lam, mu = _curved(2, 1, 1, seed=5)
    flat = coords.copy()
    flat[conn[0], 2] = 0.0                    # element 0 flattened: det 0
    got = emulate_tet10(flat, conn[:1], u, lam[:1], mu[:1])
    plain = ek.tet10_apply_reference(*(torch.from_numpy(a) for a in (
        flat, conn[:1], u, lam[:1], mu[:1]))).numpy()
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, plain, rtol=0,
                               atol=1e-12 * max(np.abs(plain).max(), 1.0))


def test_tet10_formulation_float32_within_card_tolerance():
    """The scale-2 tet10 beam (coordinates to 60) in float32: the
    formulation stays within the card's 1e-5 of the plain version run in
    float32 on the same inputs.  J comes from the table on absolute
    coordinates, as in the plain version: their float32 rounding of J
    (the largest term) is then the same."""
    mesh = tt.generate_grid_tet(25, 8, 2, (0, 0, 0),
                                (60.0, 20.0, 4.0)).to_quadratic()
    rng = np.random.default_rng(7)
    C = mesh.n_cells
    args = (mesh.coords.astype(np.float32), mesh.conn.astype(np.int32),
            rng.standard_normal(mesh.n_dofs).astype(np.float32),
            np.full(C, 0.5769, np.float32), np.full(C, 0.3846, np.float32))
    plain32 = ek.tet10_apply_reference(*(torch.from_numpy(a)
                                         for a in args)).numpy()
    got32 = emulate_tet10(*args, dtype=np.float32)
    assert np.abs(got32 - plain32).max() <= 1e-5 * np.abs(plain32).max()


def test_tet10_table_in_source_is_element_tables():
    """csrc/element_apply.cu carries element_tables("tet10", 2) dN as
    literals: entry for entry, as NumPy rounds them."""
    text = open(os.path.join(_build.CSRC_DIR, "element_apply.cu")).read()
    body = text[text.index("#define TET10_DN_TABLE {"):]
    body = body[:body.index("\n}\n")]
    nums = [float(v) for v in re.findall(
        r"-?\d+\.\d+(?:e[-+]\d+)?", body.replace("\\", ""))]
    _, dN, _ = element_tables("tet10", 2)
    assert len(nums) == 120
    np.testing.assert_array_equal(np.array(nums), dN.reshape(-1))


def test_tet10_tiles_name_the_conn():
    """Each tile lists its distinct nodes once, sorted, padded with -1;
    the local ids give conn back; tiles of 32 below two 64-element tiles
    per SM of the card (the tile lists of every element kernel:
    tests/test_torch_element_designs.py)."""
    m = tt.generate_grid_tet(7, 3, 2, (0, 0, 0),
                             (7.0, 3.0, 2.0)).to_quadratic()
    conn = torch.as_tensor(m.conn.astype(np.int32))
    for tile in (32, 64):
        t = ek.element_tiles_of(conn, tile)
        C = conn.shape[0]
        assert t.tile == tile and t.nodes.shape == (-(-C // tile),
                                                    t.max_nodes)
        assert t.lconn.dtype == torch.int16
        rows = torch.arange(C) // tile
        assert torch.equal(t.nodes[rows[:, None], t.lconn.long()], conn)
        for r, tile_nodes in enumerate(t.nodes):
            live = tile_nodes[tile_nodes >= 0]
            assert torch.equal(live, torch.unique(
                conn[r * tile:(r + 1) * tile]).to(torch.int32))
            assert bool((tile_nodes[live.numel():] == -1).all())
        assert t.max_nodes == max(int((n >= 0).sum()) for n in t.nodes)
    assert ek.element_tiles(conn).tile == ek.TILES[10][1]


def test_tet10_tiles_cache_follows_the_tensor():
    m = tt.generate_grid_tet(3, 2, 2, (0, 0, 0),
                             (3.0, 2.0, 2.0)).to_quadratic()
    conn = torch.as_tensor(m.conn.astype(np.int32))
    first = ek.element_tiles(conn)
    assert ek.element_tiles(conn) is first
    conn[0, :2] = conn[0, :2].flip(0)          # written in place: rebuilt
    again = ek.element_tiles(conn)
    assert again is not first
    rows = torch.arange(conn.shape[0]) // again.tile
    assert torch.equal(again.nodes[rows[:, None], again.lconn.long()], conn)
    twin = conn.clone()                        # another tensor: its own
    assert ek.element_tiles(twin) is not again


# ---------------------------------------------------------------------------
# B4
# ---------------------------------------------------------------------------

CHUNK = 512                     # csrc/bell_apply.cu BELL_CHUNK


def emulate_bell(u, indptr, cols, vals, lanes, chunk=CHUNK, lo=None):
    """csrc/bell_apply.cu bell_matvec in NumPy: tiles of BELL_THREADS /
    lanes rows, each tile's blocks visited chunk by chunk, lane l of row
    r summing blocks indptr[r] + l, + l + lanes, ... in order, then a xor
    butterfly over the lanes; the lo plane summed apart and added once.
    Returns (out [3, n_rows], visits [nnz]: how often each block was
    summed)."""
    dtype = u.dtype
    n_rows = len(indptr) - 1
    R = bell.BELL_THREADS // lanes
    out = np.zeros((3, n_rows), dtype)
    visits = np.zeros(len(cols), np.int64)
    for r0 in range(0, n_rows, R):
        J0, J1 = indptr[r0], indptr[min(r0 + R, n_rows)]
        acc = np.zeros((R, lanes, 2, 3), dtype)
        nxt = {(t, l): (indptr[r0 + t] + l if r0 + t < n_rows else J1)
               for t in range(R) for l in range(lanes)}
        for jc in range(J0, J1, chunk):
            jn = min(jc + chunk, J1)
            for t in range(R):
                if r0 + t >= n_rows:
                    continue
                end = min(indptr[r0 + t + 1], jn)
                for l in range(lanes):
                    j = nxt[(t, l)]
                    while j < end:
                        x = u[:, cols[j]]
                        for p, plane in enumerate((vals, lo)):
                            if plane is None:
                                continue
                            v = plane[j].astype(dtype)
                            acc[t, l, p] += (v[0::3] * x[0] + v[1::3] * x[1]
                                             + v[2::3] * x[2])
                        visits[j] += 1
                        j += lanes
                    nxt[(t, l)] = j
        off = lanes // 2
        while off:
            acc = acc + acc[:, np.arange(lanes) ^ off]
            off //= 2
        rows = np.arange(r0, min(r0 + R, n_rows))
        out[:, rows] = (acc[:len(rows), 0, 0] + acc[:len(rows), 0, 1]).T
    return out, visits


def _matrix(n_rows, n_cols, per_row, seed, empty_every=0):
    rng = np.random.default_rng(seed)
    counts = rng.poisson(per_row, n_rows)
    if empty_every:
        counts[::empty_every] = 0
    rows = np.repeat(np.arange(n_rows), counts)
    cols = (rows * n_cols // n_rows
            + rng.integers(-40, 41, rows.size)).clip(0, n_cols - 1)
    rows, cols = np.unique(np.stack([rows, cols]), axis=1)
    indptr, cols, vals = bell.csr_arrays(
        rows, cols, rng.standard_normal((rows.size, 3, 3)), n_rows)
    return indptr, cols, vals


@pytest.mark.parametrize("case,n_rows,per_row,empty_every", [
    ("empty_rows", 301, 9.0, 5),        # every fifth row empty
    ("fine_like", 211, 14.4, 0),        # 211 is no multiple of any tile
    ("coarse_like", 77, 72.0, 0),       # 16 lanes, 16 rows a tile
    ("long_rows", 40, 700.0, 0),        # rows longer than a chunk
])
def test_bell_partition_reproduces_plain_version(case, n_rows, per_row,
                                                 empty_every):
    indptr, cols, vals = _matrix(n_rows, 2 * n_rows, per_row, seed=n_rows,
                                 empty_every=empty_every)
    lanes = bell.bell_lanes(n_rows, len(cols))
    rng = np.random.default_rng(1)
    u = rng.standard_normal((3, 2 * n_rows))
    lo = rng.standard_normal(vals.shape) * 1e-8
    got, visits = emulate_bell(u, indptr, cols, vals, lanes, lo=lo)
    assert np.all(visits == 1)          # every block summed exactly once
    A = bell.BlockCSR.from_numpy(indptr, cols, vals, 2 * n_rows,
                                 torch.float64, "cpu")
    ref = bell.bell_matvec_reference(torch.from_numpy(u), A,
                                     torch.from_numpy(lo)).numpy()
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= 1e-12 * scale
    bsr = sp.bsr_matrix((vals.reshape(-1, 3, 3) + lo.reshape(-1, 3, 3),
                         cols, indptr), shape=(3 * n_rows, 6 * n_rows))
    scipy_out = (bsr @ u.T.reshape(-1)).reshape(n_rows, 3).T
    assert np.abs(got - scipy_out).max() <= 1e-12 * scale
    empty = indptr[1:] == indptr[:-1]
    assert np.all(got[:, empty] == 0)


def test_bell_order_does_not_depend_on_the_chunk():
    """In float32 every bit of the emulated sum is the same for chunks of
    512 and of 7 blocks: the order is fixed by the lanes alone."""
    indptr, cols, vals = _matrix(90, 90, 30.0, seed=3)
    u = np.random.default_rng(2).standard_normal((3, 90)).astype(np.float32)
    lanes = bell.bell_lanes(90, len(cols))
    a, _ = emulate_bell(u, indptr, cols, vals.astype(np.float32), lanes)
    b, _ = emulate_bell(u, indptr, cols, vals.astype(np.float32), lanes,
                        chunk=7)
    assert np.array_equal(a, b)


def test_bell_lanes_follow_the_row_length():
    assert bell.bell_lanes(222_208, 3_192_009) == 4       # fine level
    assert bell.bell_lanes(36_297, 72 * 36_297) == 16     # S = 72
    assert bell.bell_lanes(1000, 0) == 2
    assert bell.bell_lanes(0, 0) == 2
    assert bell.bell_lanes(10, 10_000) == 32
    for avg in (1, 5, 9, 14.4, 20, 40, 72, 130, 500):
        g = bell.bell_lanes(1000, int(avg * 1000))
        assert g in (2, 4, 8, 16, 32)
        assert bell.BELL_THREADS % g == 0
        if 8 <= avg <= 128:
            assert abs(math.log2(avg / bell.LANE_BLOCKS / g)) <= 0.5 + 1e-9


# ---------------------------------------------------------------------------
# B9b
# ---------------------------------------------------------------------------


def emulate_sell(pk, w2, u, S, kc, n_rows, node_major, W, block_rows=32):
    """csrc/ell_apply.cu sell_window in NumPy: blocks of ``block_rows``
    rows (32 in the kernel), one a lane; warp w of W sums slots w, w + W,
    ... of its row in batches of SELL_SLOTS (columns outside the window
    or at or past n_cols add zero); the W sums are added in warp order.
    ``u`` is read through its strides as the kernel reads it."""
    cols2 = pk["cols2"]
    wblk = pk["wblk"]
    flat = torch.empty(0, dtype=u.dtype).set_(u.untyped_storage()).numpy()
    offset = u.storage_offset()
    u_cs, u_ns, n_cols = ell._strides(u, node_major)
    dt = w2.dtype
    out = np.zeros((n_rows, 3), dt)
    for r0 in range(0, n_rows, block_rows):
        n = np.arange(r0, min(r0 + block_rows, n_rows))
        t, lane = n // ell.LANES, n % ell.LANES
        lo = wblk[t].astype(np.int64) * ell.LANES
        hi = np.minimum(lo + kc * ell.LANES, n_cols)
        parts = []
        for w in range(W):
            acc = np.zeros((n.size, 3), dt)
            for s0 in range(w, S, W * ell.SELL_SLOTS):
                for k in range(ell.SELL_SLOTS):
                    s = s0 + k * W
                    if s >= S:
                        continue
                    c = cols2[t * S + s, lane].astype(np.int64)
                    wt = w2[t * S + s, lane]
                    inb = (c >= lo) & (c < hi)
                    cc = np.where(inb, c, 0)
                    for a in range(3):
                        x = np.where(inb, flat[offset + cc * u_ns + a * u_cs],
                                     0).astype(dt)
                        acc[:, a] = acc[:, a] + wt * x
            parts.append(acc)
        total = parts[0]
        for v in range(1, W):
            total = total + parts[v]
        out[n] = total
    return out if node_major else out.T.copy()


def _sell_pack(per_row, n=997, n_cols=4000, seed=3):
    """``per_row`` banded columns a row, every eleventh row empty."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), per_row)
    cols = rows * 4 + np.tile(np.arange(per_row), n) * 3 \
        + rng.integers(0, 3, rows.size)
    live = rows % 11 != 5
    rows, cols = rows[live], np.minimum(cols[live], n_cols - 1)
    w = rng.standard_normal(rows.size)
    return ell.pack_ell_rows(rows, cols, w, n, n_cols), (rows, cols, w)


@pytest.mark.parametrize("node_major", [False, True],
                         ids=["component_major", "node_major"])
@pytest.mark.parametrize("cut", [False, True], ids=["packed", "kc1"])
@pytest.mark.parametrize("per_row", [8, 48], ids=["S8", "S48"])
def test_sell_warps_reproduce_plain_version(per_row, cut, node_major):
    pk, (rows, cols, w) = _sell_pack(per_row)
    S = pk["S"]
    kc = 1 if cut else pk["kc"]
    n_cols = pk["n_cols_p"] - 300          # some columns at or past the end
    rng = np.random.default_rng(5)
    u_np = rng.standard_normal((3, n_cols))
    if node_major:                  # a [n, 3] view of a wider buffer
        wide = torch.zeros((n_cols, 5), dtype=torch.float64)
        wide[:, 1:4] = torch.from_numpy(u_np.T)
        u = wide[:, 1:4]
    else:
        u = torch.from_numpy(u_np)
    tens = [torch.from_numpy(pk[k]) for k in ("cols2", "vals2", "wblk",
                                              "gbounds")]
    kw = {"node_major": node_major, "n_rows": 997}
    ref = ell.sell_matvec_window_reference(*tens, u, S, kc, **kw).numpy()
    scale = np.abs(ref).max()
    for W in ell.SELL_WARPS:
        got = emulate_sell(pk, pk["vals2"], u, S, kc, 997, node_major, W)
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= 1e-12 * scale
    if not cut:                     # scipy on the columns the vector has
        keep = cols < n_cols
        P = sp.csr_matrix((w[keep], (rows[keep], cols[keep])),
                          shape=(997, n_cols))
        sci = (P @ u_np.T)
        sci = sci if node_major else sci.T
        assert np.abs(got - sci).max() <= 1e-12 * scale
    else:                           # the cut window drops columns
        full = ell.sell_matvec_window_reference(*tens, u, S, pk["kc"], **kw)
        assert np.abs(full.numpy() - ref).max() > 0
    empty = np.arange(997) % 11 == 5
    assert np.all((ref[empty] if node_major else ref[:, empty]) == 0)


def test_sell_order_depends_on_warps_not_on_blocks():
    """In float32 every bit of the emulated sum is the same for blocks of
    32, 64 or 128 rows: the order of a row's sum is fixed by S and W."""
    pk, _ = _sell_pack(48, n=300)
    w32 = pk["vals2"].astype(np.float32)
    u = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (3, pk["n_cols_p"])).astype(np.float32))
    outs = {}
    for W in (1, 8):
        runs = [emulate_sell(pk, w32, u, pk["S"], pk["kc"], 300, False, W,
                             block_rows=r) for r in (32, 64, 128)]
        for other in runs[1:]:
            assert np.array_equal(runs[0], other)
        outs[W] = runs[0]
    # another W is another order: float32 bits move, the value does not
    assert not np.array_equal(outs[1], outs[8])
    assert np.abs(outs[1] - outs[8]).max() <= 1e-5 * np.abs(outs[1]).max()


def test_sell_warps_follow_the_slots():
    assert ell.sell_warps(8) == 1           # the prolongation
    assert ell.sell_warps(16) == 2
    assert ell.sell_warps(24) == 4 and ell.sell_warps(32) == 4
    assert ell.sell_warps(48) == 8          # the restriction
    assert ell.sell_warps(72) == 8          # two batches a warp
    for S in range(8, 200, 8):
        W = ell.sell_warps(S)
        assert W in ell.SELL_WARPS
        assert W == ell.SELL_WARPS[-1] or W * ell.SELL_SLOTS >= S


def test_sell_wrapper_on_the_cpu_is_the_plain_version():
    """On a CPU tensor the wrapper returns the plain version's result,
    bit for bit, and counts no launch (S 48, node-major)."""
    pk, _ = _sell_pack(48, n=300)
    tens = [torch.from_numpy(pk[k]) for k in ("cols2", "vals2", "wblk",
                                              "gbounds")]
    u = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (pk["n_cols_p"], 3)))
    ell.reset_launch_counts()
    kw = {"node_major": True, "n_rows": 300}
    out = ell.sell_matvec_window(*tens, u, pk["S"], pk["kc"], **kw)
    assert torch.equal(out, ell.sell_matvec_window_reference(
        *tens, u, pk["S"], pk["kc"], **kw))
    assert out.shape == (300, 3)
    assert ell.LAUNCHES["sell_window"] == 0


# ---------------------------------------------------------------------------
# the build helper and the A/B tool
# ---------------------------------------------------------------------------


def test_build_names_other_sources_by_their_text(tmp_path):
    a = tmp_path / "a.cu"
    a.write_text("// one\n")
    b = tmp_path / "b.cu"
    b.write_text("// two\n")
    ta, tb = _build._target("x", str(a)), _build._target("x", str(b))
    assert ta != tb and os.path.dirname(ta) == _build.BUILD_DIR
    assert _build._target("x", str(a)) == ta
    assert _build.build([]) == {}      # nothing to build: no nvcc needed


@pytest.mark.parametrize("group", ["element", "stencil", "csr", "window"])
def test_ablation_edits_apply_to_this_tree(group):
    src = kernel_ab.ABLATED_SOURCE[group]
    text = open(os.path.join(_build.CSRC_DIR, f"{src}.cu")).read()
    variants = [v for (tree, v) in kernel_ab.ABLATION_SETS[group]
                if tree == "current"]
    assert variants
    for (tree, variant), edits in kernel_ab.ABLATION_SETS[group].items():
        if tree == "current":
            out = kernel_ab.ablated_source(text, edits)
            assert out != text
    with pytest.raises(ValueError):
        kernel_ab.ablated_source(text, [("no such line", "x")])
    if group == "stencil":
        assert set(kernel_ab.STENCIL_TILES) <= set(variants)
