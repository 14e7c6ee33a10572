"""The port's scan-window ELL layer against the JAX package's, on the CPU in
float64: the same seeded inputs go through both.

- ``ops/ell.pack_ell_rows``: arrays equal to the JAX package's
  ``pack_ell_rows`` (dtype and value) on the triplets of tests/test_bell.py
  (the random BSR and the random transfer), and on rows with empty runs;
- the plain versions of kernels B9a and B9b (``bell_matvec_window``,
  ``sell_matvec_window`` on CPU tensors) against the JAX package's
  ``bell_matvec_pallas`` / ``sell_matvec_pallas`` in interpret mode and
  against scipy, with the packed window and with a window cut by hand that
  drops columns (1e-12: float64 sums in two orders);
- node-major strided views against the component-major layout (bit for
  bit: the same sums);
- ``fem/ell.ELLBlockOperator`` against the JAX package's on the matrices
  of tests/test_unstructured_mg.py:63-101: ``matvec``, constrained
  ``matvec``, ``node_blocks_raw``, ``diagonal``, the ``to_scipy_bsr``
  round trip and ``to_dense_constrained`` (1e-12).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from topopteval_tpu.fem.ell import ELLBlockOperator as JaxELL
from topopteval_tpu.ops import pallas_bsr as jax_bsr
from topopteval_tpu_torch.fem.ell import ELLBlockOperator
from topopteval_tpu_torch.ops import ell

torch.set_num_threads(1)


def _random_bsr(N=300, nnzb=2500, band=40, seed=0):
    """tests/test_bell.py's random block matrix."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, N, nnzb)
    cols = np.clip(rows + rng.integers(-band, band + 1, nnzb), 0, N - 1)
    blocks = rng.standard_normal((nnzb, 3, 3))
    K = sp.coo_matrix(
        (blocks.reshape(-1),
         ((3 * rows[:, None, None] + np.arange(3)[None, :, None])
          .repeat(3, 2).reshape(-1),
          (3 * cols[:, None, None] + np.arange(3)[None, None, :])
          .repeat(3, 1).reshape(-1))),
        shape=(3 * N, 3 * N)).tocsr()
    return rows, cols, blocks, K


def _random_transfer(N=300, Nc=150, nnz=1200, seed=2):
    """tests/test_bell.py's random scalar transfer."""
    rng = np.random.default_rng(seed)
    prow = rng.integers(0, N, nnz)
    pcol = np.clip(prow // 2 + rng.integers(-10, 11, nnz), 0, Nc - 1)
    w = rng.standard_normal(nnz)
    P = sp.coo_matrix((w, (prow, pcol)), shape=(N, Nc)).tocsr()
    return prow, pcol, w, P, rng


def _tensors(pk):
    return tuple(torch.as_tensor(pk[k])
                 for k in ("cols2", "vals2", "wblk", "gbounds"))


def _assert_same_pack(ours, ref):
    assert set(ours) == set(ref)
    for key in ref:
        a, b = np.asarray(ours[key]), np.asarray(ref[key])
        assert a.dtype == b.dtype, key
        np.testing.assert_array_equal(a, b, err_msg=key)


@pytest.mark.parametrize("case", ["block", "scalar", "empty_rows"])
def test_pack_ell_rows_equals_jax(case):
    if case == "block":
        rows, cols, data, _ = _random_bsr()
        n_rows = n_cols = 300
    elif case == "scalar":
        rows, cols, data, _, _ = _random_transfer()
        n_rows, n_cols = 300, 150
    else:           # leading, inner and trailing empty rows; a 2nd tile
        rows, cols, data, _ = _random_bsr(N=300, nnzb=900, band=5, seed=4)
        keep = (rows >= 7) & (rows % 5 != 0) & (rows < 250)
        rows, cols, data = rows[keep], cols[keep], data[keep]
        n_rows, n_cols = 300, 300
    ours = ell.pack_ell_rows(rows, cols, data, n_rows, n_cols)
    _assert_same_pack(ours, jax_bsr.pack_ell_rows(rows, cols, data, n_rows,
                                                  n_cols))
    assert ours["S"] % ell.GROUP == 0
    assert np.all(ours["wblk"] + ours["kc"] <= ours["n_cols_p"] // ell.LANES)


@pytest.mark.parametrize("cut", [False, True], ids=["packed", "cut_window"])
def test_bell_window_plain_matches_jax_interpret_and_scipy(cut):
    N = 300
    rows, cols, blocks, K = _random_bsr()
    pk = ell.pack_ell_rows(rows, cols, blocks, N, N)
    Np = pk["n_rows_p"]
    rng = np.random.default_rng(1)
    u = np.zeros((3, Np))
    u[:, :N] = rng.standard_normal((3, N))
    kc = 1 if cut else pk["kc"]
    ours = ell.bell_matvec_window(*_tensors(pk), torch.as_tensor(u),
                                  pk["S"], kc).numpy()
    ref = np.asarray(jax_bsr.bell_matvec_pallas(
        jnp.asarray(pk["cols2"]), jnp.asarray(pk["vals2"]),
        jnp.asarray(pk["wblk"]), jnp.asarray(pk["gbounds"]),
        jnp.asarray(u), pk["S"], kc, interpret=True))
    assert ours.shape == ref.shape == (3, Np)
    assert np.all(ours[:, N:] == 0.0)               # pad rows
    np.testing.assert_allclose(ours, ref, rtol=1e-12, atol=1e-12)
    truth = (K @ u[:, :N].T.reshape(-1)).reshape(N, 3).T
    if cut:     # kc = 1 drops columns: the full product differs
        assert np.abs(ours[:, :N] - truth).max() > 1.0
    else:       # the packed window cuts nothing: scipy's product
        np.testing.assert_allclose(ours[:, :N], truth, rtol=1e-12,
                                   atol=1e-12)
        np.testing.assert_allclose(ours, np.asarray(
            jax_bsr.bell_matvec_reference(
                jnp.asarray(pk["cols2"]), jnp.asarray(pk["vals2"]),
                jnp.asarray(u), pk["S"])), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("cut", [False, True], ids=["packed", "cut_window"])
def test_sell_window_plain_matches_jax_interpret_and_scipy(cut):
    N, Nc = 300, 150
    prow, pcol, w, P, rng = _random_transfer()
    pp = ell.pack_ell_rows(prow, pcol, w, N, Nc)
    uc = np.zeros((3, pp["n_cols_p"]))
    uc[:, :Nc] = rng.standard_normal((3, Nc))
    kc = 1 if cut else pp["kc"]
    ours = ell.sell_matvec_window(*_tensors(pp), torch.as_tensor(uc),
                                  pp["S"], kc).numpy()
    ref = np.asarray(jax_bsr.sell_matvec_pallas(
        jnp.asarray(pp["cols2"]), jnp.asarray(pp["vals2"]),
        jnp.asarray(pp["wblk"]), jnp.asarray(pp["gbounds"]),
        jnp.asarray(uc), pp["S"], kc, interpret=True))
    assert ours.shape == ref.shape == (3, pp["n_rows_p"])
    np.testing.assert_allclose(ours, ref, rtol=1e-12, atol=1e-12)
    truth = np.stack([P @ uc[a, :Nc] for a in range(3)])
    if cut:
        assert np.abs(ours[:, :N] - truth).max() > 1.0
    else:
        np.testing.assert_allclose(ours[:, :N], truth, rtol=1e-12,
                                   atol=1e-12)


@pytest.mark.parametrize("block", [True, False], ids=["bell", "sell"])
def test_window_node_major_views_equal_component_major(block):
    """A node-major [n, 3] view of a wider buffer (strides (5, 1)) and a
    cut row count give the component-major result's rows, bit for bit."""
    if block:
        rows, cols, data, _ = _random_bsr()
        n_cols = 300
    else:
        rows, cols, data, _, _ = _random_transfer()
        n_cols = 150
    pk = ell.pack_ell_rows(rows, cols, data, 300, n_cols)
    fn = ell.bell_matvec_window if block else ell.sell_matvec_window
    u = torch.as_tensor(np.random.default_rng(5).standard_normal(
        (3, n_cols)))
    wide = torch.zeros((n_cols, 5), dtype=torch.float64)
    wide[:, 1:4] = u.t()
    for kc in (pk["kc"], 1):
        cm = fn(*_tensors(pk), u, pk["S"], kc)
        nm = fn(*_tensors(pk), wide[:, 1:4], pk["S"], kc, node_major=True,
                n_rows=297)
        assert nm.shape == (297, 3)
        assert torch.equal(nm, cm[:, :297].t())
    assert not any(ell.LAUNCHES.values())      # the CPU launches nothing


def test_window_wrappers_reject_what_the_kernels_do_not_take():
    rows, cols, data, _ = _random_bsr()
    pk = ell.pack_ell_rows(rows, cols, data, 300, 300)
    c2, v2, wb, gb = _tensors(pk)
    u = torch.zeros((3, 384), dtype=torch.float64)
    with pytest.raises(TypeError):
        ell.bell_matvec_window(c2, v2, wb, gb, u.float(), pk["S"], pk["kc"])
    with pytest.raises(ValueError, match="values must be"):
        ell.sell_matvec_window(c2, v2, wb, gb, u, pk["S"], pk["kc"])
    with pytest.raises(ValueError, match=r"\[n, 3\]"):
        ell.bell_matvec_window(c2, v2, wb, gb, u, pk["S"], pk["kc"],
                               node_major=True)
    with pytest.raises(ValueError, match="n_rows"):
        ell.bell_matvec_window(c2, v2, wb, gb, u, pk["S"], pk["kc"],
                               n_rows=385)


# ---------------------------------------------------------------------------
# ELLBlockOperator (tests/test_unstructured_mg.py:63-101)
# ---------------------------------------------------------------------------


def _random_block_spd(n, seed=0):
    rng = np.random.default_rng(seed)
    A = sp.random(3 * n, 3 * n, density=0.1, random_state=rng.integers(1e6))
    return (A + A.T + sp.eye(3 * n) * 10).tocsr()


@pytest.mark.parametrize("n,seed,n_fixed", [(17, 0, 0), (9, 2, 6),
                                            (150, 3, 9)])
def test_ell_operator_matches_jax(n, seed, n_fixed):
    A = _random_block_spd(n, seed)
    mask = np.ones(3 * n)
    mask[:n_fixed] = 0.0
    ours = ELLBlockOperator.from_scipy_bsr(A, mask, torch.float64,
                                           device="cpu")
    ref = JaxELL.from_scipy_bsr(A, mask, jnp.float64)
    x = np.random.default_rng(seed + 1).standard_normal(3 * n)
    m = mask
    expect = m * (A @ (m * x)) + (1 - m) * x
    got = ours.matvec(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, expect, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got, np.asarray(ref.matvec(jnp.asarray(x))),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(ours.matvec_raw(torch.as_tensor(x)).numpy(),
                               A @ x, rtol=1e-12, atol=1e-12)
    blocks = ours.node_blocks_raw().numpy()
    np.testing.assert_allclose(blocks, np.asarray(ref.node_blocks_raw()),
                               atol=1e-12)
    dense = A.toarray()
    for i in range(n):
        np.testing.assert_allclose(blocks[i], dense[3 * i:3 * i + 3,
                                                    3 * i:3 * i + 3],
                                   atol=1e-12)
    np.testing.assert_allclose(ours.diagonal().numpy(),
                               np.asarray(ref.diagonal()), atol=1e-12)
    back = ours.to_scipy_bsr()
    np.testing.assert_allclose(back.toarray(), dense, atol=1e-12)
    np.testing.assert_allclose(back.toarray(), ref.to_scipy_bsr().toarray(),
                               atol=1e-12)
    np.testing.assert_allclose(ours.to_dense_constrained(),
                               ref.to_dense_constrained(), atol=1e-12)
    # the layout is pack_ell_rows of the stored blocks
    assert ours.S % ell.GROUP == 0 and ours.n_dofs == 3 * n


def test_ell_operator_from_block_rows_drops_sentinels():
    """JAX's [N, D] rows with sentinel N: the same operator, and the
    packed layout holds only the real blocks."""
    rng = np.random.default_rng(7)
    N, D = 40, 6
    cols = rng.integers(0, N + 1, (N, D))            # N = sentinel
    cols[:, 0] = np.arange(N)
    blocks = rng.standard_normal((N, D, 3, 3))
    mask = np.ones(3 * N)
    ours = ELLBlockOperator.from_block_rows(cols, blocks, mask,
                                            torch.float64, device="cpu")
    ref = JaxELL.from_block_rows(cols, blocks, mask, jnp.float64)
    x = rng.standard_normal(3 * N)
    np.testing.assert_allclose(ours.matvec(torch.as_tensor(x)).numpy(),
                               np.asarray(ref.matvec(jnp.asarray(x))),
                               rtol=1e-12, atol=1e-12)
    r, c, b = ours.triplets()
    assert r.size == int((cols < N).sum())
    assert np.all(c < N)
