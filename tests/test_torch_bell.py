"""The port's block-ELL multigrid against the JAX package's, on the CPU in
float64 unless stated: the same seeded inputs go through both.

- the block-CSR packer and the plain versions of the two kernels
  (``bell_matvec_reference``, ``sell_matvec_reference``) against scipy
  and against the JAX package's twins on its chunk-aligned ELL layout, on
  the random BSR of tests/test_bell.py (N=300), with the hi/lo split and
  bf16 values;
- ``build_voxel_transfer``: equal arrays;
- the hierarchy build (skeleton and value pass) on a 12x4x4 tet box
  without ``structured_info``, on the imported Tet4 cantilever fixture and
  on the SIMP Hex8 fixture: permutation,
  masks, Chebyshev bounds, block inverses, the coarse pseudo-inverse and
  every level's operator.

The port's V-cycle on a hierarchy the JAX package built and saved is in
tests/test_torch_bell_solve.py, which keeps this file under 40 s.

Both packages run with their host libraries switched off, on their
NumPy/scipy fallbacks, so both build the same hierarchy from the same
arithmetic; the same comparison with both libraries on is in
tests/test_torch_bell_legacy.py.  Tolerances are stated where they are
used.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import threadpoolctl
import scipy.sparse as sp
import torch

from topopteval_tpu.fem import bell as jax_bell
from topopteval_tpu.fem import multigrid as jax_mg
from topopteval_tpu.fem.bc import free_mask_from_bcs as jax_free_mask
from topopteval_tpu.fem.bc import nodes_at_plane as jax_nodes_at_plane
from topopteval_tpu.io import native as jax_native
from topopteval_tpu.io.vtu import read_cell_density as jax_read_density
from topopteval_tpu.io.vtu import read_vtu_mesh as jax_read_vtu
from topopteval_tpu.materials import SIMPMaterial, lame_parameters
from topopteval_tpu.models import beams as jax_beams
from topopteval_tpu.ops import pallas_bsr as jax_bsr
import topopteval_tpu_torch as tt
from topopteval_tpu_torch.io import native as port_native
from topopteval_tpu_torch.fem import bell as port_bell
from topopteval_tpu_torch.fem import multigrid as port_mg
from topopteval_tpu_torch.ops import bell as ops_bell

tt.set_verbosity(False)
# these tests work on small tensors: one intra-op thread each, so that
# test processes running side by side do not fight over the cores
torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """The host build's dense eigensolves and sparse products run in
    OpenBLAS: one thread here too, for the same reason."""
    with threadpoolctl.threadpool_limits(1):
        yield

LAM, MU = lame_parameters(1.0, 0.3)


@pytest.fixture
def no_native(monkeypatch):
    """Both packages on their NumPy/scipy host build (the port's host
    library switched off too: the two builds agree only to rounding)."""
    monkeypatch.setattr(jax_native, "_LIB", None)
    monkeypatch.setattr(jax_native, "_TRIED", True)
    with port_native.use_native(False):
        yield


def _random_bsr(N=300, nnzb=2500, band=40, seed=0):
    """tests/test_bell.py's random banded BSR (duplicates included)."""
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


def _jax_bell(rows, cols, blocks, N, u, vals_dtype=None):
    pk = jax_bsr.pack_ell_aligned(rows, cols, blocks, N, N)
    vals = jnp.asarray(pk["vals2"], vals_dtype)
    return np.asarray(jax_bsr.bell_matvec_reference(
        jnp.asarray(pk["cols2"]), vals, jnp.asarray(u), pk["S"]), np.float64)


# ---------------------------------------------------------------------------
# packer and plain versions of the kernels
# ---------------------------------------------------------------------------


def test_packer_sorts_triplets_into_row_compressed_form():
    rows, cols, blocks, K = _random_bsr()
    indptr, c, v = ops_bell.csr_arrays(rows, cols, blocks, 300)
    assert indptr[0] == 0 and indptr[-1] == len(rows) and c.dtype == np.int32
    assert v.shape == (len(rows), 9)
    r = np.repeat(np.arange(300), np.diff(indptr))
    assert np.all((np.diff(r) > 0) | ((np.diff(r) == 0) & (np.diff(c) >= 0)))
    K2 = sp.bsr_matrix((v.reshape(-1, 3, 3), c, indptr), shape=K.shape)
    assert abs(K2 - K).max() <= 1e-15 * abs(K).max()


@pytest.mark.parametrize("split", [False, True], ids=["hi", "hi_lo"])
def test_bell_matvec_reference_matches_scipy_and_jax(split):
    N = 300
    rows, cols, blocks, K = _random_bsr(N)
    Np = ops_bell.pad_rows(N)
    u = np.zeros((3, Np))
    u[:, :N] = np.random.default_rng(1).standard_normal((3, N))
    truth = (K @ u[:, :N].T.reshape(-1)).reshape(N, 3).T
    A = ops_bell.pack_csr(rows, cols, blocks, Np, Np, torch.float64,
                          device="cpu")
    lo = None
    ref = _jax_bell(rows, cols, blocks, N, u)
    if split:
        lo_blocks = _random_bsr(N, seed=7)[2] * 1e-3
        lo = ops_bell.pack_csr(rows, cols, lo_blocks, Np, Np,
                               torch.float64, device="cpu").vals
        truth = truth + _jax_bell(rows, cols, lo_blocks, N, u)[:, :N]
        ref = ref + _jax_bell(rows, cols, lo_blocks, N, u)
    # the wrapper takes a lo plane in float32 only (the kernel's one split
    # instantiation); the plain version takes it in any dtype
    ours = ops_bell.bell_matvec_reference(torch.as_tensor(u), A, lo).numpy()
    if not split:
        assert np.array_equal(
            ops_bell.bell_matvec(torch.as_tensor(u), A).numpy(), ours)
    assert ours.shape == (3, Np)
    assert np.all(ours[:, N:] == 0.0)          # padding rows are empty
    np.testing.assert_allclose(ours[:, :N], truth, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(ours, ref, rtol=1e-12, atol=1e-12)


def test_bell_matvec_reference_bf16_values_match_jax():
    """bf16 values under float32 vectors are widened before the multiply,
    in both packages: 1e-5 of the largest entry (float32 sums in two
    orders; the bf16 values are the same bits)."""
    N = 300
    rows, cols, blocks, _ = _random_bsr(N)
    Np = ops_bell.pad_rows(N)
    u = np.random.default_rng(3).standard_normal((3, Np)).astype(np.float32)
    A = ops_bell.pack_csr(rows, cols, blocks, Np, Np, torch.bfloat16,
                          device="cpu")
    ours = ops_bell.bell_matvec(torch.as_tensor(u), A)
    assert ours.dtype == torch.float32
    ref = _jax_bell(rows, cols, blocks, N, u, jnp.bfloat16)
    err = np.abs(ours.double().numpy() - ref).max() / np.abs(ref).max()
    assert err < 1e-5


@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16])
def test_sell_matvec_reference_matches_scipy_and_jax(dtype):
    N, Nc, nnz = 300, 150, 1200
    rng = np.random.default_rng(2)
    prow = rng.integers(0, N, nnz)
    pcol = np.clip(prow // 2 + rng.integers(-10, 11, nnz), 0, Nc - 1)
    w = rng.standard_normal(nnz)
    P = sp.coo_matrix((w, (prow, pcol)), shape=(N, Nc)).tocsr()
    Np, ncp = ops_bell.pad_rows(N), ops_bell.pad_rows(Nc)
    uc = np.zeros((3, ncp))
    uc[:, :Nc] = rng.standard_normal((3, Nc))
    T = ops_bell.pack_csr(prow, pcol, w, Np, ncp, dtype, device="cpu")
    vec_dtype = torch.float64 if dtype == torch.float64 else torch.float32
    ours = ops_bell.sell_matvec(torch.as_tensor(uc, dtype=vec_dtype), T)
    pp = jax_bsr.pack_ell_aligned(prow, pcol, w, N, Nc)
    ref = np.asarray(jax_bsr.sell_matvec_reference(
        jnp.asarray(pp["cols2"]),
        jnp.asarray(pp["vals2"], jnp.bfloat16 if dtype == torch.bfloat16
                    else jnp.float64),
        jnp.asarray(uc, np.float32 if dtype == torch.bfloat16
                    else np.float64),
        pp["S"], pp["n_rows_p"]), np.float64)
    ours = ours.double().numpy()
    if dtype == torch.float64:
        truth = np.stack([P @ uc[a, :Nc] for a in range(3)])
        np.testing.assert_allclose(ours[:, :N], truth, rtol=1e-12,
                                   atol=1e-12)
        np.testing.assert_allclose(ours, ref, rtol=1e-12, atol=1e-12)
    else:
        assert np.abs(ours - ref).max() <= 1e-5 * np.abs(ref).max()


def test_wrappers_reject_what_the_kernels_do_not_take():
    rows, cols, blocks, _ = _random_bsr(40, 200, 5)
    A = ops_bell.pack_csr(rows, cols, blocks, 128, 128, torch.float64,
                          device="cpu")
    u = torch.zeros((3, 128), dtype=torch.float64)
    with pytest.raises(TypeError):
        ops_bell.bell_matvec(u.float(), A)
    with pytest.raises(TypeError, match="lo plane"):
        ops_bell.bell_matvec(u, A, A.vals)
    with pytest.raises(ValueError, match=r"\[3, 128\]"):
        ops_bell.bell_matvec(u[:, :64], A)
    with pytest.raises(ValueError, match="scalar"):
        ops_bell.sell_matvec(u, A)


def test_pack_csr_defaults_to_the_card(monkeypatch):
    """Like every entry point of the port, ``pack_csr`` puts its matrix on
    the card unless the caller asks for the CPU: without CUDA it raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rows, cols, blocks, _ = _random_bsr(40, 200, 5)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ops_bell.pack_csr(rows, cols, blocks, 128, 128, torch.float64)
    A = ops_bell.pack_csr(rows, cols, blocks, 128, 128, torch.float64,
                          device="cpu")
    assert A.device.type == "cpu"


# ---------------------------------------------------------------------------
# hierarchy build
# ---------------------------------------------------------------------------


def test_voxel_transfer_equals_jax():
    coords = np.random.default_rng(5).uniform(-1.0, 2.0, (400, 3))
    lo, hi = coords.min(axis=0), coords.max(axis=0)
    ours = port_mg.build_voxel_transfer(coords, lo, hi, (5, 3, 4))
    ref = jax_mg.build_voxel_transfer(coords, lo, hi, (5, 3, 4))
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


def _box_case():
    mesh = jax_beams.generate_grid_tet(12, 4, 4, (0, 0, 0), (12.0, 4.0, 4.0))
    mesh.structured_info = None
    lam = np.full(mesh.n_cells, LAM)
    mu = np.full(mesh.n_cells, MU)
    fixed = jax_nodes_at_plane(mesh, 0, 0.0)
    return mesh, lam, mu, fixed


def _tet4_fixture_case():
    """The imported Tet4 cantilever fixture, clamped as ``cantilever_beam``
    clamps it (its min-x plane)."""
    import os
    from topopteval_tpu_torch.models.density import VFRAC04_FIXTURE
    mesh = jax_read_vtu(os.path.join(os.path.dirname(VFRAC04_FIXTURE),
                                     "beam_linear_volume_mesh.vtu"))
    lam = np.full(mesh.n_cells, LAM)
    mu = np.full(mesh.n_cells, MU)
    fixed = jax_nodes_at_plane(mesh, 0, float(mesh.coords[:, 0].min()))
    return mesh, lam, mu, fixed


def _hex8_case():
    from topopteval_tpu_torch.models.density import VFRAC04_FIXTURE
    mesh = jax_read_vtu(VFRAC04_FIXTURE)
    lam, mu = SIMPMaterial(1.0, 0.3, 1e-8, 3.0).lame(
        jax_read_density(VFRAC04_FIXTURE))
    fixed = jax_nodes_at_plane(mesh, 0, 0.0)
    return mesh, np.asarray(lam), np.asarray(mu), fixed


def _close(ours, ref, rtol):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert ours.shape == ref.shape
    assert np.abs(ours - ref).max() <= rtol * np.abs(ref).max()


_CASES = {"box_12x4x4": (_box_case, 4000, 1),
          "tet4_fixture": (_tet4_fixture_case, 1500, 2),
          "hex8_fixture": (_hex8_case, 1500, 2)}


@pytest.mark.parametrize("case", list(_CASES))
def test_hierarchy_equals_jax(case, no_native):
    """The two fixtures are built with a coarsest level of at most 1,500
    DOFs (three levels; the default 4,000 gives two and a dense eigensolve
    of 2,304 DOFs for the Tet4 cantilever and 3,672 for the Hex8 beam in
    each package, which would dominate this file's time)."""
    from topopteval_tpu.fem.bc import DirichletBC
    make, max_coarse_dofs, n_smoothed = _CASES[case]
    mesh, lam, mu, fixed = make()
    kw = dict(order=2, max_coarse_dofs=max_coarse_dofs)
    mask = jax_free_mask(mesh.n_dofs, [DirichletBC.fixed(fixed)])
    sys_j, mg_j, _ = jax_bell.build_bell_multigrid(
        mesh, lam, mu, free_mask=mask, dtype=jnp.float64, **kw)
    pmesh = tt.Mesh(mesh.coords, mesh.conn, mesh.element_type)
    sys_p, mg_p, info = port_bell.build_bell_multigrid(
        pmesh, lam, mu, free_mask=mask, dtype=torch.float64, device="cpu",
        **kw)
    assert len(mg_p.levels) == n_smoothed
    assert info["skeleton_cached"] is False
    np.testing.assert_array_equal(sys_p.perm, sys_j.perm)
    assert len(mg_p.levels) == len(mg_j.levels)
    rng = np.random.default_rng(9)
    for Lp, Lj in zip(mg_p.levels, mg_j.levels):
        np.testing.assert_array_equal(Lp.op.free_mask.numpy(),
                                      np.asarray(Lj.op.free_mask))
        np.testing.assert_allclose(Lp.lam_max, Lj.lam_max, rtol=1e-12)
        _close(Lp.binv9.numpy(), Lj.binv9, 1e-10)
        u = rng.standard_normal(Lp.op.n_dofs)
        _close(Lp.op.matvec(torch.as_tensor(u)).numpy(),
               Lj.op.matvec(jnp.asarray(u)), 1e-10)
        uc = rng.standard_normal((3, Lp.transfer.P.n_cols))
        _close(Lp.transfer.prolong(torch.as_tensor(uc)).numpy(),
               Lj.transfer.prolong(jnp.asarray(uc)), 1e-12)
        uf = rng.standard_normal((3, Lp.op.n_rows_p))
        _close(Lp.transfer.restrict(torch.as_tensor(uf)).numpy(),
               Lj.transfer.restrict(jnp.asarray(uf)), 1e-12)
    _close(mg_p.coarse_inv.numpy(), mg_j.coarse_inv, 1e-10)
    u = rng.standard_normal(sys_p.n_dofs)
    _close(sys_p.matvec(torch.as_tensor(u)).numpy(),
           sys_j.matvec(jnp.asarray(u)), 1e-10)
    np.testing.assert_allclose(sys_p.matvec64(u), sys_j.matvec64(u),
                               rtol=1e-12, atol=1e-12 * np.abs(u).max())
