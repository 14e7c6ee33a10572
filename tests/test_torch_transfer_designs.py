"""Host-side pieces of the Hopper designs of the CSR transfer (B5,
``sell_matvec``) and the scan-window block matvec (B9a, ``bell_window``),
on the CPU.

The kernels themselves run only on the card (tests/test_torch_cuda.py).
Here their partitions are emulated in NumPy, in the kernels' order, and
held to the port's plain versions and to the JAX package's kernels run as
its own tests run them (tests/test_bell.py: ``sell_matvec_aligned`` and
``bell_matvec_pallas`` with ``interpret=True``), 1e-13 of the largest
entry in float64:

- B5 is csr_matvec_kernel (csrc/bell_apply.cu) over a body of one
  weight: G = ``sell_lanes`` lanes a row in tiles of BELL_THREADS / G
  rows, a tile's entries staged in chunks of 2,048, lane l of row r
  summing entries indptr[r] + l, + l + G, ... in order (in batches of
  eight, which move no bit), then a xor butterfly over the lanes; cases: empty rows, rows longer than a chunk,
  the transfers' widths, a row count no tile divides.  In float32 the
  bits do not depend on the chunk or on the rows a tile holds, only on
  the matrix; at G = 1 they are the entry-order sum of the earlier
  one-thread kernel;
- B9a is window_kernel (csrc/ell_apply.cu) over a body of 3x3 blocks: W
  = ``window_warps(S, n_rows)`` warps for every 32 rows, warp w summing
  slots w, w + W, ... in batches of SELL_SLOTS, the W partial sums added
  in warp order; cases: S 72 (no multiple of 8 W), S 16, empty rows, a
  window cut to kc = 1, columns at or past the vector's end, strided
  [N, 3] views.  In float32 the bits depend on S and W, not on the rows
  a block holds;
- the lane and warp rules at the routes' row lengths, and the constants
  emulated here against the sources; the A/B tool's ablation edits of
  both sources (tests/test_torch_kernel_designs.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from topopteval_tpu.ops import pallas_bsr as jax_bsr
from topopteval_tpu_torch.ops import bell
from topopteval_tpu_torch.ops import ell

torch.set_num_threads(1)

CHUNK = 2048                    # csrc/bell_apply.cu Weight::CHUNK
ILP = 8                         # csrc/bell_apply.cu Weight::ILP


# ---------------------------------------------------------------------------
# B5
# ---------------------------------------------------------------------------


def emulate_csr(u, indptr, cols, w, lanes, chunk=CHUNK,
                threads=bell.BELL_THREADS):
    """csrc/bell_apply.cu csr_matvec_kernel over Weight in NumPy: tiles of
    threads / lanes rows, each tile's entries visited chunk by chunk, lane
    l of row r summing entries indptr[r] + l, + l + lanes, ... in order
    (out[a] += w u[a]) in batches of ILP that a chunk's end may cut, then
    a xor butterfly over the lanes.  Returns
    (out [3, n_rows], visits [nnz]: how often each entry was summed)."""
    dtype = u.dtype
    n_rows = len(indptr) - 1
    R = threads // lanes
    out = np.zeros((3, n_rows), dtype)
    visits = np.zeros(len(cols), np.int64)
    for r0 in range(0, n_rows, R):
        J0, J1 = indptr[r0], indptr[min(r0 + R, n_rows)]
        acc = np.zeros((R, lanes, 3), dtype)
        nxt = {(t, l): indptr[r0 + t] + l
               for t in range(R) if r0 + t < n_rows for l in range(lanes)}
        for jc in range(J0, J1, chunk):
            jn = min(jc + chunk, J1)
            for (t, l), j in nxt.items():
                end = min(indptr[r0 + t + 1], jn)
                while j < end:          # a batch of up to ILP entries
                    for k in range(ILP):
                        jj = j + k * lanes
                        if jj >= end:
                            break
                        acc[t, l] = (acc[t, l]
                                     + dtype.type(w[jj]) * u[:, cols[jj]])
                        visits[jj] += 1
                    j += lanes * min(ILP, -(-(end - j) // lanes))
                nxt[(t, l)] = j
        off = lanes // 2
        while off:
            acc = acc + acc[:, np.arange(lanes) ^ off]
            off //= 2
        rows = np.arange(r0, min(r0 + R, n_rows))
        out[:, rows] = acc[:len(rows), 0].T
    return out, visits


def _transfer(n_rows, n_cols, per_row, seed, empty_every=0):
    """CSR arrays of a random transfer: ~per_row distinct columns a row
    near its diagonal position, every ``empty_every``-th row empty."""
    rng = np.random.default_rng(seed)
    counts = np.minimum(rng.poisson(per_row, n_rows), n_cols)
    if empty_every:
        counts[::empty_every] = 0
    rows = np.repeat(np.arange(n_rows), counts)
    first = (np.arange(n_rows) * n_cols // n_rows
             + rng.integers(0, 20, n_rows))
    cols = (np.repeat(first, counts) + np.arange(rows.size)
            - np.repeat(np.cumsum(counts) - counts, counts)) % n_cols
    w = rng.standard_normal(rows.size)
    indptr, cols, w = bell.csr_arrays(rows, cols, w, n_rows)
    return indptr, cols, w


def _jax_aligned(indptr, cols, w, n_rows, n_cols, u):
    """The JAX package's B5 kernel (``sell_matvec_aligned``) in interpret
    mode, as tests/test_bell.py:181 runs it: [3, n_rows]."""
    rows = np.repeat(np.arange(n_rows), np.diff(indptr))
    pp = jax_bsr.pack_ell_aligned(rows, cols, w, n_rows, n_cols, group=8)
    uc = np.zeros((3, pp["n_cols_p"]))
    uc[:, :n_cols] = u
    out = jax_bsr.sell_matvec_aligned(
        jnp.asarray(pp["cols2"]), jnp.asarray(pp["vals2"]),
        jnp.asarray(pp["cmeta"]), jnp.asarray(uc), pp["S"], interpret=True)
    return np.asarray(out)[:, :n_rows]


@pytest.mark.parametrize("case,n_rows,n_cols,per_row,empty_every,chunk", [
    ("empty_rows", 301, 200, 9.0, 5, CHUNK),        # every fifth row empty
    ("restrict_like", 333, 1900, 34.0, 0, CHUNK),   # 8 lanes, 32 rows a tile
    ("prolong_like", 1301, 230, 5.6, 0, CHUNK),     # 1 lane, 256 rows a tile
    # rows longer than a chunk: the chunk cut to 64 entries (the JAX
    # kernel takes minutes in interpret mode at rows of 2,048; the chunk
    # moves no bit, test_csr_order_depends_on_the_matrix_not_the_chunk...)
    ("long_rows", 40, 700, 150.0, 0, 64),
])
def test_csr_lanes_reproduce_plain_version_and_jax(case, n_rows, n_cols,
                                                   per_row, empty_every,
                                                   chunk):
    indptr, cols, w = _transfer(n_rows, n_cols, per_row, seed=n_rows,
                                empty_every=empty_every)
    lanes = bell.sell_lanes(n_rows, len(cols))
    u = np.random.default_rng(1).standard_normal((3, n_cols))
    got, visits = emulate_csr(u, indptr, cols, w, lanes, chunk)
    if case == "long_rows":
        assert lanes == 32 and np.diff(indptr).min() > chunk
    assert np.all(visits == 1)          # every entry summed exactly once
    T = bell.BlockCSR.from_numpy(indptr, cols, w, n_cols, torch.float64,
                                 "cpu")
    ref = bell.sell_matvec_reference(torch.from_numpy(u), T).numpy()
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= 1e-13 * scale
    jax_out = _jax_aligned(indptr, cols, w, n_rows, n_cols, u)
    assert np.abs(got - jax_out).max() <= 1e-13 * scale
    P = sp.csr_matrix((w, cols, indptr), shape=(n_rows, n_cols))
    assert np.abs(got - (P @ u.T).T).max() <= 1e-13 * scale
    empty = indptr[1:] == indptr[:-1]
    assert np.all(got[:, empty] == 0)
    # every lane count sums the same function
    for g in (1, 2, 4, 32):
        other, _ = emulate_csr(u, indptr, cols, w, g, chunk)
        assert np.abs(other - ref).max() <= 1e-13 * scale


def test_csr_order_depends_on_the_matrix_not_the_chunk_or_tile():
    """In float32 every bit of the emulated sum is the same for chunks of
    2,048 and of 7 entries, and for tiles of 256 / G and 64 / G rows: the
    order is fixed by the matrix (and G) alone.  At G = 1 it is the entry
    order of the earlier one-thread kernel; at G = 8 another order."""
    indptr, cols, w = _transfer(300, 1500, 34.0, seed=4)
    w = w.astype(np.float32)
    u = np.random.default_rng(2).standard_normal((3, 1500)).astype(
        np.float32)
    lanes = bell.sell_lanes(300, len(cols))
    assert lanes == 8
    a, _ = emulate_csr(u, indptr, cols, w, lanes)
    for chunk, threads in ((7, 256), (2048, 64), (100, 32)):
        b, _ = emulate_csr(u, indptr, cols, w, lanes, chunk, threads)
        assert np.array_equal(a, b)
    serial = np.zeros((3, 300), np.float32)
    for r in range(300):
        for j in range(indptr[r], indptr[r + 1]):
            serial[:, r] = serial[:, r] + w[j] * u[:, cols[j]]
    one, _ = emulate_csr(u, indptr, cols, w, 1, chunk=13)
    assert np.array_equal(one, serial)
    assert not np.array_equal(a, serial)
    assert np.abs(a - serial).max() <= 1e-5 * np.abs(serial).max()


def test_sell_lanes_follow_the_row_length():
    assert bell.sell_lanes(36_352, 1_240_625) == 8      # R0, scale 16
    assert bell.sell_lanes(222_208, 1_240_625) == 1     # P0, scale 16
    assert bell.sell_lanes(1000, 0) == 1
    assert bell.sell_lanes(0, 0) == 1
    assert bell.sell_lanes(10, 100_000) == 32
    for avg in (1, 3, 5.6, 9, 20, 34, 72, 130):
        g = bell.sell_lanes(1000, int(avg * 1000))
        assert g in (1, 2, 4, 8, 16, 32)
        assert bell.BELL_THREADS % g == 0
        # one lane below LANE_WEIGHTS weights a row, else bell_lanes
        if avg < bell.LANE_WEIGHTS:
            assert g == 1
        else:
            assert g == bell.bell_lanes(1000, int(avg * 1000))


def test_sell_wrapper_on_the_cpu_is_the_plain_version():
    """On a CPU tensor B5's wrapper returns the plain version's result,
    bit for bit, in every vector/weight type, and counts no launch."""
    indptr, cols, w = _transfer(300, 500, 34.0, seed=8, empty_every=7)
    u = np.random.default_rng(3).standard_normal((3, 500))
    bell.reset_launch_counts()
    for vec, vals in ((torch.float64, torch.float64),
                      (torch.float32, torch.float32),
                      (torch.float32, torch.bfloat16)):
        T = bell.BlockCSR.from_numpy(indptr, cols, w, 500, vals, "cpu")
        uu = torch.as_tensor(u, dtype=vec)
        out = bell.sell_matvec(uu, T)
        assert out.dtype == vec and out.shape == (3, 300)
        assert torch.equal(out, bell.sell_matvec_reference(uu, T))
    assert bell.LAUNCHES["sell_matvec"] == 0


# ---------------------------------------------------------------------------
# B9a
# ---------------------------------------------------------------------------


def emulate_window(pk, vals2, u, S, kc, n_rows, node_major, W,
                   block_rows=32):
    """csrc/ell_apply.cu window_kernel over Block in NumPy: groups of
    ``block_rows`` rows (32 in the kernel), one a lane; warp w of W sums
    slots w, w + W, ... of its row in batches of SELL_SLOTS (columns
    outside the window or at or past n_cols add zero), each slot's nine
    plane values as a0 += v0 x + v1 y + v2 z, ...; the W sums are added
    in warp order.  ``u`` is read through its strides as the kernel
    reads it."""
    cols2, wblk = pk["cols2"], pk["wblk"]
    flat = torch.empty(0, dtype=u.dtype).set_(u.untyped_storage()).numpy()
    offset = u.storage_offset()
    u_cs, u_ns, n_cols = ell._strides(u, node_major)
    dt = vals2.dtype
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
                    inb = (c >= lo) & (c < hi)
                    cc = np.where(inb, c, 0)
                    x = [np.where(inb, flat[offset + cc * u_ns + b * u_cs],
                                  0).astype(dt) for b in range(3)]
                    v = [vals2[(9 * t + p) * S + s, lane] for p in range(9)]
                    for a in range(3):
                        acc[:, a] = acc[:, a] + (v[3 * a] * x[0]
                                                 + v[3 * a + 1] * x[1]
                                                 + v[3 * a + 2] * x[2])
            parts.append(acc)
        total = parts[0]
        for v in range(1, W):
            total = total + parts[v]
        out[n] = total
    return out if node_major else out.T.copy()


def _block_pack(per_row, n=997, n_cols=4000, seed=3):
    """``per_row`` banded 3x3 blocks a row, every eleventh row empty; the
    columns of the last rows reach past n_cols - 300."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), per_row)
    cols = rows * 4 + np.tile(np.arange(per_row), n) * 3 \
        + rng.integers(0, 3, rows.size)
    live = rows % 11 != 5
    rows, cols = rows[live], np.minimum(cols[live], n_cols - 1)
    blocks = rng.standard_normal((rows.size, 3, 3))
    return ell.pack_ell_rows(rows, cols, blocks, n, n_cols), (rows, cols,
                                                              blocks)


@pytest.mark.parametrize("node_major", [False, True],
                         ids=["component_major", "node_major"])
@pytest.mark.parametrize("cut", [False, True], ids=["packed", "kc1"])
@pytest.mark.parametrize("per_row", [16, 72], ids=["S16", "S72"])
def test_window_warps_reproduce_plain_version_and_jax(per_row, cut,
                                                      node_major):
    pk, (rows, cols, blocks) = _block_pack(per_row, n=301)
    S = pk["S"]
    assert S == per_row
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
    kw = {"node_major": node_major, "n_rows": 301}
    ref = ell.bell_matvec_window_reference(*tens, u, S, kc, **kw).numpy()
    scale = np.abs(ref).max()
    W = ell.window_warps(S, 301)
    for warps in sorted({1, 4, W, 16}):
        got = emulate_window(pk, pk["vals2"], u, S, kc, 301, node_major,
                             warps)
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= 1e-13 * scale
    # the JAX package's kernel reads [3, n_cols_p] with the tail zeroed
    uc = np.zeros((3, pk["n_cols_p"]))
    uc[:, :n_cols] = u_np
    jax_out = np.asarray(jax_bsr.bell_matvec_pallas(
        *(jnp.asarray(pk[k]) for k in ("cols2", "vals2", "wblk",
                                       "gbounds")),
        jnp.asarray(uc), S, kc, interpret=True))[:, :301]
    got = emulate_window(pk, pk["vals2"], u, S, kc, 301, node_major, W)
    got_cm = got.T if node_major else got
    assert np.abs(got_cm - jax_out).max() <= 1e-13 * scale
    if not cut:                     # scipy on the columns the vector has
        keep = cols < n_cols
        r, c, b = rows[keep], cols[keep], blocks[keep]
        K = sp.coo_matrix(
            (b.reshape(-1),
             ((3 * r[:, None, None] + np.arange(3)[None, :, None])
              .repeat(3, 2).reshape(-1),
              (3 * c[:, None, None] + np.arange(3)[None, None, :])
              .repeat(3, 1).reshape(-1))),
            shape=(3 * 301, 3 * n_cols)).tocsr()
        sci = (K @ u_np.T.reshape(-1)).reshape(301, 3).T
        assert np.abs(got_cm - sci).max() <= 1e-13 * scale
    else:                           # the cut window drops columns
        full = ell.bell_matvec_window_reference(*tens, u, S, pk["kc"], **kw)
        assert np.abs(full.numpy() - ref).max() > 0
    empty = np.arange(301) % 11 == 5
    assert np.all((ref[empty] if node_major else ref[:, empty]) == 0)


def test_window_order_depends_on_warps_not_on_blocks():
    """In float32 every bit of the emulated sum is the same for groups of
    32, 64 or 128 rows: the order of a row's sum is fixed by S and W."""
    pk, _ = _block_pack(72, n=200)
    v32 = pk["vals2"].astype(np.float32)
    u = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (3, pk["n_cols_p"])).astype(np.float32))
    outs = {}
    for W in (1, 8):
        runs = [emulate_window(pk, v32, u, pk["S"], pk["kc"], 200, False, W,
                               block_rows=r) for r in (32, 64, 128)]
        for other in runs[1:]:
            assert np.array_equal(runs[0], other)
        outs[W] = runs[0]
    # another W is another order: float32 bits move, the value does not
    assert not np.array_equal(outs[1], outs[8])
    assert np.abs(outs[1] - outs[8]).max() <= 1e-5 * np.abs(outs[1]).max()


def test_window_warps_at_the_galerkin_widths():
    """The Galerkin levels of the scale-16 beam are packed at S 72: level
    1 (36,297 rows) takes four warps for every 32 rows, one wave of the
    card's warps, 18 slots a warp; level 2 (5,225 rows, 164 groups) the
    most, 16, 4.5 slots a warp.  Few slots take one warp; the rule never
    exceeds a wave unless a warp would hold more than SELL_SLOTS slots."""
    assert ell.window_warps(72, 36_297) == 4
    assert ell.window_warps(72, 5_225) == 16
    assert ell.window_warps(8, 222_105) == 1 and ell.window_warps(8, 10) == 1
    assert ell.window_warps(16, 997) == 2
    for S in range(8, 200, 8):
        for n in (10, 997, 5_225, 36_297, 300_000):
            W = ell.window_warps(S, n)
            assert W in ell.WINDOW_WARPS
            groups = -(-n // 32)
            # the fewest that reach a wave or a warp's SELL_SLOTS slots
            ok = [w for w in ell.WINDOW_WARPS
                  if groups * w >= ell.CARD_WARPS or w * ell.SELL_SLOTS >= S]
            assert W == (ok[0] if ok else ell.WINDOW_WARPS[-1])


def test_window_wrapper_on_the_cpu_is_the_plain_version():
    """On a CPU tensor B9a's wrapper returns the plain version's result,
    bit for bit, and counts no launch (S 72, node-major)."""
    pk, _ = _block_pack(72, n=300)
    tens = [torch.from_numpy(pk[k]) for k in ("cols2", "vals2", "wblk",
                                              "gbounds")]
    u = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (pk["n_cols_p"], 3)))
    ell.reset_launch_counts()
    kw = {"node_major": True, "n_rows": 300}
    out = ell.bell_matvec_window(*tens, u, pk["S"], pk["kc"], **kw)
    assert torch.equal(out, ell.bell_matvec_window_reference(
        *tens, u, pk["S"], pk["kc"], **kw))
    assert out.shape == (300, 3)
    assert ell.LAUNCHES["bell_window"] == 0


def test_emulated_constants_are_the_sources():
    """The batch, chunk, slots and warp counts emulated here and chosen by
    the wrappers are the ones the CUDA sources compile."""
    import os
    import re
    from topopteval_tpu_torch import _build
    src = open(os.path.join(_build.CSRC_DIR, "bell_apply.cu")).read()
    assert f"NV = 1, CHUNK = {CHUNK}, ILP = {ILP};" in src
    assert f"BELL_THREADS = {bell.BELL_THREADS};" in src
    lanes = [int(g) for g in re.findall(r"CSR_LANES\((\d+)\)\n", src)]
    assert lanes == [1, 2, 4, 8, 16, 32]
    src = open(os.path.join(_build.CSRC_DIR, "ell_apply.cu")).read()
    assert f"SLOTS = {ell.SELL_SLOTS};" in src
    warps = [int(w) for w in re.findall(r"WINDOW_WARPS\((\d+)\)\n", src)]
    assert tuple(warps) == ell.WINDOW_WARPS
    assert set(ell.SELL_WARPS) <= set(warps)
