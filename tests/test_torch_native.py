"""The port's host library (csrc/host/topopt_native.cpp through
topopteval_tpu_torch/io/native.py), built here with g++, against the JAX
package's ``io.native`` on its own library and against the NumPy/scipy
fallbacks, for all five entry points: element gradients, block values
from the gradient factorization, the scalar-P RAP on a frozen pattern,
the unit-Ke planes and the surface faces.  Also ``use_native`` and
``host_ftz`` (which must restore the thread's previous MXCSR).

The two libraries are compiled from the same source, so they agree to
rounding (atol 1e-13 of the largest entry, as tests/test_native.py holds
the JAX package's library to its fallbacks); the fallbacks sum in another
order and are held to the same tolerance.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from topopteval_tpu.io import native as jax_native
import topopteval_tpu_torch as tt
from topopteval_tpu_torch import _build
from topopteval_tpu_torch.fem import bell
from topopteval_tpu_torch.io import native
from topopteval_tpu_torch.mesh import FACE_TABLES
from topopteval_tpu_torch.ops.elements import element_tables

tt.set_verbosity(False)
torch.set_num_threads(1)

LAM, MU = tt.lame_parameters(1.0, 0.3)


@pytest.fixture(scope="module")
def lib():
    lib = native.load_native()
    assert lib is not None, native.LOAD_ERROR
    return lib


@pytest.fixture(scope="module")
def jax_lib():
    lib = jax_native.native_v2()
    if lib is None or lib.topopt_version() < 4:
        pytest.skip("the JAX package's native library is not built")
    return lib


def _box_tet():
    mesh = tt.generate_grid_tet(6, 3, 3, (0, 0, 0), (6.0, 3.0, 3.0))
    mesh.structured_info = None
    return mesh


def _hex():
    return tt.generate_grid_hex(4, 3, 2, (0, 0, 0), (4.0, 3.0, 2.0))


def _close(ours, ref, rtol=1e-13):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert ours.shape == ref.shape
    assert np.abs(ours - ref).max() <= rtol * np.abs(ref).max()


def test_library_builds_into_the_build_directory(lib):
    assert lib.topopt_version() == 4
    target = _build.host_target()
    assert target.startswith(_build.HOST_BUILD_DIR)
    assert _build.build_host() == 0.0          # built once, then reused
    assert native.native_available()


def test_use_native_switches_every_entry_point_off(lib):
    mesh = _box_tet()
    with native.use_native(False):
        assert native.load_native() is None and not native.native_available()
        assert native.extract_surface_faces_native(
            mesh.conn, np.asarray(FACE_TABLES["tet4"])) is None
        assert native.blocks_from_g_native(
            np.zeros((1, 1, 4, 3)), np.zeros((1, 1)), np.zeros(1, np.int32),
            np.zeros(1, np.uint16), np.array([0, 1]), np.ones(1),
            np.ones(1)) is None
        assert native.element_gradients_native(
            mesh.coords, mesh.conn, *element_tables("tet4", 1)[1:],
            np.empty((mesh.n_cells, 1, 4, 3)),
            np.empty((mesh.n_cells, 1))) is False
    assert native.load_native() is lib


@pytest.mark.parametrize("element_type,order", [("tet4", 1), ("hex8", 2),
                                                ("tet10", 2)])
def test_element_gradients_three_ways(lib, jax_lib, element_type, order):
    mesh = _hex() if element_type == "hex8" else _box_tet()
    if element_type == "tet10":
        mesh = mesh.to_quadratic()
    _, dN, w = element_tables(element_type, order)
    C, k = mesh.conn.shape
    q = dN.shape[0]
    out = {}
    for tag, fn in (("port", native.element_gradients_native),
                    ("jax", jax_native.element_gradients_native)):
        g, wd = np.empty((C, q, k, 3)), np.empty((C, q))
        assert fn(mesh.coords, mesh.conn, dN, w, g, wd)
        out[tag] = g, wd
    g, wd = np.empty((C, q, k, 3)), np.empty((C, q))
    bell._host_gradients(mesh, np.asarray(dN, np.float64),
                         np.asarray(w, np.float64), g, wd)
    for tag in ("port", "jax"):
        _close(out[tag][0], g)
        _close(out[tag][1], wd)
    np.testing.assert_array_equal(out["port"][0], out["jax"][0])


@pytest.fixture(scope="module")
def skeleton():
    mesh = _box_tet()
    mask = tt.free_mask_from_bcs(mesh.n_dofs, [tt.DirichletBC.fixed(
        tt.nodes_at_plane(mesh, 0, 0.0))])
    with native.use_native(False):
        return bell.build_bell_skeleton(mesh, mask, max_coarse_dofs=400)


def test_blocks_from_g_three_ways(lib, jax_lib, skeleton):
    rng = np.random.default_rng(0)
    C = int(skeleton["n_cells"])
    lam, mu = rng.uniform(0.1, 2.0, C), rng.uniform(0.1, 1.0, C)
    args = (skeleton["g"], skeleton["wdet"], skeleton["elem_sorted"],
            skeleton["ij_sorted"], skeleton["grp_indptr"], lam, mu)
    ours = native.blocks_from_g_native(*args)
    theirs = jax_native.blocks_from_g_native(*args)
    with native.use_native(False):
        plain = bell._skel_blocks(skeleton, lam, mu)
    assert ours.shape == plain.shape == (skeleton["cols_d"].shape[0], 9)
    _close(ours, plain)
    np.testing.assert_array_equal(ours, theirs)
    # the inputs as the library must not see them: int64 elements, int32
    # ij, a strided g; the binding converts them
    strided = np.repeat(skeleton["g"], 2, axis=0)[::2]
    again = native.blocks_from_g_native(
        strided, skeleton["wdet"], skeleton["elem_sorted"].astype(np.int64),
        skeleton["ij_sorted"].astype(np.int32), skeleton["grp_indptr"],
        lam, mu)
    np.testing.assert_array_equal(again, ours)


def _rap_inputs(skeleton, li=0):
    C = int(skeleton["n_cells"])
    blocks = bell._skel_blocks(skeleton, np.full(C, LAM), np.full(C, MU))
    N = int(skeleton["n_nodes"])
    A = sp.bsr_matrix((blocks.reshape(-1, 3, 3),
                       skeleton["cols_d"].astype(np.int64),
                       skeleton["bsr_indptr"]), shape=(3 * N, 3 * N))
    n_c = int(skeleton[f"C{li}_n"])
    return A, (A.indptr, A.indices, A.data.reshape(-1, 9),
               skeleton[f"Pn{li}_indptr"], skeleton[f"Pn{li}_indices"],
               skeleton[f"Pn{li}_data"], skeleton[f"PTn{li}_indptr"],
               skeleton[f"PTn{li}_indices"], skeleton[f"PTn{li}_data"],
               skeleton[f"C{li}_bsr_indptr"], skeleton[f"C{li}_cols_d"],
               N, n_c)


def test_bsr_rap_scalar_three_ways(lib, jax_lib, skeleton):
    A, args = _rap_inputs(skeleton)
    ours = native.bsr_rap_scalar_native(*args)
    theirs = jax_native.bsr_rap_scalar_native(*args)
    N, n_c = args[-2:]
    P = sp.bsr_matrix((skeleton["P0_data"], skeleton["P0_indices"],
                       skeleton["P0_indptr"]), shape=(3 * N, 3 * n_c))
    PT = sp.bsr_matrix((skeleton["PT0_data"], skeleton["PT0_indices"],
                        skeleton["PT0_indptr"]), shape=(3 * n_c, 3 * N))
    ref = PT @ (A @ P)
    ref.sort_indices()
    np.testing.assert_array_equal(ref.indices, skeleton["C0_cols_d"])
    _close(ours, ref.data)
    np.testing.assert_array_equal(ours, theirs)


def test_bsr_rap_scalar_rejects_a_pattern_it_leaves(lib, skeleton):
    _, args = _rap_inputs(skeleton)
    args = list(args)
    indptr, cols = args[9].copy(), args[10]
    # drop the last block of the first row from the frozen pattern
    keep = np.ones(cols.shape[0], bool)
    keep[indptr[1] - 1] = False
    indptr[1:] -= 1
    args[9], args[10] = indptr, cols[keep]
    with pytest.raises(ValueError, match="frozen"):
        native.bsr_rap_scalar_native(*args)


def test_unit_ke_planes_match_the_numpy_unit_blocks(lib, jax_lib):
    mesh = _box_tet()
    _, dN, w = element_tables("tet4", 1)
    C, k = mesh.conn.shape
    ours = np.empty((18, C * k * k))
    theirs = np.empty_like(ours)
    assert native.unit_ke_cm_native(mesh.coords, mesh.conn, dN, w, ours)
    assert jax_native.unit_ke_cm_native(mesh.coords, mesh.conn, dN, w,
                                        theirs)
    (_, kl, km), = bell._host_ke_blocks_unit(mesh, 2)
    plain = np.concatenate([kl.transpose(3, 4, 0, 1, 2).reshape(9, -1),
                            km.transpose(3, 4, 0, 1, 2).reshape(9, -1)])
    _close(ours, plain)
    np.testing.assert_array_equal(ours, theirs)
    # the destination map writes each raw contribution to its column
    dest = np.random.default_rng(1).permutation(C * k * k).astype(np.int32)
    moved = np.empty_like(ours)
    assert native.unit_ke_cm_native(mesh.coords, mesh.conn, dN, w, moved,
                                    dest)
    np.testing.assert_array_equal(moved[:, dest], ours)


@pytest.mark.parametrize("element_type", ["tet4", "hex8", "tet10"])
def test_surface_faces_both_ways(lib, jax_lib, element_type):
    mesh = _hex() if element_type == "hex8" else _box_tet()
    if element_type == "tet10":
        mesh = mesh.to_quadratic()
    faces = np.asarray(FACE_TABLES[element_type])
    ours = native.extract_surface_faces_native(mesh.conn, faces)
    np.testing.assert_array_equal(
        ours, jax_native.extract_surface_faces_native(mesh.conn, faces))
    with_lib = tt.extract_surface(mesh)
    with native.use_native(False):
        plain = tt.extract_surface(mesh)
    for field in ("surface_nodes", "is_surface", "face_cells", "face_local",
                  "face_conn"):
        np.testing.assert_array_equal(getattr(with_lib, field),
                                      getattr(plain, field))
    np.testing.assert_array_equal(
        ours, plain.face_cells * faces.shape[0] + plain.face_local)


def _mxcsr(lib):
    cur = lib.topopt_set_ftz(0)
    lib.topopt_restore_csr(cur)
    return cur


def test_host_ftz_restores_the_previous_mxcsr(lib):
    FTZ_DAZ = (1 << 15) | (1 << 6)
    tiny = np.array([1e-310])
    start = _mxcsr(lib)
    try:
        lib.topopt_set_ftz(0)
        off = _mxcsr(lib)
        assert off & FTZ_DAZ == 0
        assert (tiny * 1.0)[0] == 1e-310           # subnormals kept
        with native.host_ftz():
            assert _mxcsr(lib) == off | FTZ_DAZ
            assert (tiny * 1.0)[0] == 0.0          # and flushed
        assert _mxcsr(lib) == off
        assert (tiny * 1.0)[0] == 1e-310
        lib.topopt_set_ftz(1)
        on = _mxcsr(lib)
        with native.host_ftz():
            assert _mxcsr(lib) == on
        assert _mxcsr(lib) == on
        with native.use_native(False), native.host_ftz():
            assert _mxcsr(lib) == on               # a no-op without it
    finally:
        lib.topopt_restore_csr(start)
