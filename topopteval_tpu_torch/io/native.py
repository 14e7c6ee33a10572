"""ctypes bindings for the port's host library (counterpart of
``topopteval_tpu/io/native.py``).

The library is ``csrc/host/topopt_native.cpp``, built with g++ at first use
by :func:`.._build.build_host` into ``build/native/``.  Every entry point
keeps the JAX package's fallback contract: it returns ``False`` or
``None`` when the library is unavailable (no compiler, a failed build, or
switched off by :func:`use_native`), and the caller takes its NumPy/scipy
path.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Optional

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_ENABLED = True
#: why the last attempt to build or load the library failed (None: it did not)
LOAD_ERROR: Optional[str] = None

_D = ctypes.POINTER(ctypes.c_double)
_I32 = ctypes.POINTER(ctypes.c_int32)
_I64 = ctypes.POINTER(ctypes.c_int64)
_U16 = ctypes.POINTER(ctypes.c_uint16)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.topopt_version.restype = ctypes.c_int
    lib.topopt_extract_surface_faces.restype = ctypes.c_int64
    lib.topopt_extract_surface_faces.argtypes = [
        _I32, ctypes.c_int64, ctypes.c_int32, _I32, ctypes.c_int32,
        ctypes.c_int32, _I64]
    lib.topopt_set_ftz.restype = ctypes.c_uint32
    lib.topopt_set_ftz.argtypes = [ctypes.c_int32]
    lib.topopt_restore_csr.restype = None
    lib.topopt_restore_csr.argtypes = [ctypes.c_uint32]
    lib.topopt_unit_ke_cm_dest.restype = None
    lib.topopt_unit_ke_cm_dest.argtypes = [
        _D, _I32, ctypes.c_int64, ctypes.c_int32, _D, _D, ctypes.c_int32,
        _D, ctypes.c_int64, _I32]
    lib.topopt_element_gradients.restype = None
    lib.topopt_element_gradients.argtypes = [
        _D, _I32, ctypes.c_int64, ctypes.c_int32, _D, _D, ctypes.c_int32,
        _D, _D]
    lib.topopt_blocks_from_g.restype = None
    lib.topopt_blocks_from_g.argtypes = [
        _D, _D, ctypes.c_int32, ctypes.c_int32, _I32, _U16, _I64,
        ctypes.c_int64, _D, _D, _D]
    lib.topopt_bsr_rap_scalar.restype = ctypes.c_int32
    lib.topopt_bsr_rap_scalar.argtypes = [
        ctypes.c_int64, ctypes.c_int64, _I64, _I32, _D, _I64, _I32, _D,
        _I64, _I32, _D, _I64, _I32, _D]
    return lib


def load_native() -> Optional[ctypes.CDLL]:
    """The library, built if needed; None if it is switched off or cannot
    be built or loaded (the reason is in :data:`LOAD_ERROR`)."""
    global _LIB, _TRIED, LOAD_ERROR
    if not _ENABLED:
        return None
    if _TRIED:
        return _LIB
    _TRIED = True
    from .. import _build
    try:
        _build.build_host()
        _LIB = _bind(ctypes.CDLL(_build.host_target()))
        LOAD_ERROR = None
    except (OSError, RuntimeError, AttributeError) as e:
        _LIB = None
        LOAD_ERROR = f"{type(e).__name__}: {e}"
    return _LIB


def native_available() -> bool:
    return load_native() is not None


@contextlib.contextmanager
def use_native(enabled: bool = True):
    """Switch the library on or off inside the block (off: every entry
    point returns its fallback value), for tests and comparisons of the
    two host builds."""
    global _ENABLED
    prev = _ENABLED
    _ENABLED = bool(enabled)
    try:
        yield
    finally:
        _ENABLED = prev


@contextlib.contextmanager
def host_ftz():
    """Flush-to-zero and denormals-are-zero on inside the block, the
    previous MXCSR restored after it.  SIMP values reach ~1e-9 of E0, and
    their products in the hierarchy's RAP and eigensolves fall into the
    float64 subnormal range, where hardware assists are slow; magnitudes
    below 1e-308 carry no meaning here.

    MXCSR is per thread: this covers the calling thread only, which runs
    NumPy's element-wise loops, scipy's sparse products and the library's
    own entry points.  Threads started elsewhere (OpenBLAS/LAPACK workers
    in the dense eigensolve, PyTorch's intra-op pool) keep their own
    setting.  A no-op when the library is unavailable."""
    lib = load_native()
    if lib is None:
        yield
        return
    # NumPy reads its float limits on first use and warns if subnormals
    # flush: read them before FTZ goes on
    for t in (np.float32, np.float64):
        np.finfo(t).smallest_subnormal
    prev = lib.topopt_set_ftz(1)
    try:
        yield
    finally:
        lib.topopt_restore_csr(prev)


def _ptr(a, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def _check_out(name: str, a: np.ndarray, shape, dtype=np.float64) -> None:
    """The library writes ``a`` through a raw pointer: it must be a
    C-contiguous array of ``shape`` and ``dtype``."""
    if not (isinstance(a, np.ndarray) and a.flags.c_contiguous
            and a.dtype == dtype and a.shape == tuple(shape)):
        raise ValueError(f"{name} must be a C-contiguous {np.dtype(dtype)} "
                         f"array of shape {tuple(shape)}")


def unit_ke_cm_native(coords: np.ndarray, conn: np.ndarray,
                      dn: np.ndarray, w: np.ndarray,
                      out: np.ndarray,
                      dest: Optional[np.ndarray] = None) -> bool:
    """Fill the [18, n_cells*k*k] component-major unit-Ke planes (kl in
    rows 0-8, km in 9-17; ``fem/bell._host_ke_blocks_unit`` semantics);
    ``dest`` maps each raw contribution to its output column.  False if
    the library is unavailable."""
    lib = load_native()
    if lib is None:
        return False
    C, k = conn.shape
    coords = np.ascontiguousarray(coords, np.float64)
    conn = np.ascontiguousarray(conn, np.int32)
    dn = np.ascontiguousarray(dn, np.float64)
    w = np.ascontiguousarray(w, np.float64)
    _check_out("out", out, (18, C * k * k))
    if dest is not None:
        dest = np.ascontiguousarray(dest, np.int32)
        if dest.shape != (C * k * k,):
            raise ValueError(f"dest must have {C * k * k} entries")
        dp = _ptr(dest, ctypes.c_int32)
    else:
        dp = _I32()
    lib.topopt_unit_ke_cm_dest(
        _ptr(coords, ctypes.c_double), _ptr(conn, ctypes.c_int32),
        ctypes.c_int64(C), ctypes.c_int32(k),
        _ptr(dn, ctypes.c_double), _ptr(w, ctypes.c_double),
        ctypes.c_int32(dn.shape[0]),
        _ptr(out, ctypes.c_double), ctypes.c_int64(out.shape[1]), dp)
    return True


def element_gradients_native(coords: np.ndarray, conn: np.ndarray,
                             dn: np.ndarray, w: np.ndarray,
                             g_out: np.ndarray,
                             wdet_out: np.ndarray) -> bool:
    """Physical gradients g [C, q, k, 3] and quadrature weights wdet [C, q]
    into the given float64 arrays (``fem/bell._host_gradients``
    semantics: identity Jacobian, zero weight for degenerate cells).
    False if the library is unavailable."""
    lib = load_native()
    if lib is None:
        return False
    C, k = conn.shape
    nqp = dn.shape[0]
    coords = np.ascontiguousarray(coords, np.float64)
    conn = np.ascontiguousarray(conn, np.int32)
    dn = np.ascontiguousarray(dn, np.float64)
    w = np.ascontiguousarray(w, np.float64)
    _check_out("g_out", g_out, (C, nqp, k, 3))
    _check_out("wdet_out", wdet_out, (C, nqp))
    lib.topopt_element_gradients(
        _ptr(coords, ctypes.c_double), _ptr(conn, ctypes.c_int32),
        ctypes.c_int64(C), ctypes.c_int32(k),
        _ptr(dn, ctypes.c_double), _ptr(w, ctypes.c_double),
        ctypes.c_int32(nqp),
        _ptr(g_out, ctypes.c_double), _ptr(wdet_out, ctypes.c_double))
    return True


def blocks_from_g_native(g: np.ndarray, wdet: np.ndarray,
                         elem: np.ndarray, ij: np.ndarray,
                         indptr: np.ndarray, lam: np.ndarray,
                         mu: np.ndarray) -> Optional[np.ndarray]:
    """Deduplicated block values [nnzb, 9] (row-major 3x3) of a material
    from the gradient factorization and the sorted contribution list
    (``elem`` int32, ``ij`` uint16, ``indptr`` int64; converted and made
    C-contiguous here, since the library reads raw memory).  None if the
    library is unavailable."""
    lib = load_native()
    if lib is None:
        return None
    C, nqp, k, _ = g.shape
    g = np.ascontiguousarray(g, np.float64)
    wdet = np.ascontiguousarray(wdet, np.float64)
    elem = np.ascontiguousarray(elem, np.int32)
    ij = np.ascontiguousarray(ij, np.uint16)
    indptr = np.ascontiguousarray(indptr, np.int64)
    lam = np.ascontiguousarray(np.broadcast_to(lam, (C,)), np.float64)
    mu = np.ascontiguousarray(np.broadcast_to(mu, (C,)), np.float64)
    nnzb = indptr.shape[0] - 1
    out = np.empty((nnzb, 9), np.float64)
    lib.topopt_blocks_from_g(
        _ptr(g, ctypes.c_double), _ptr(wdet, ctypes.c_double),
        ctypes.c_int32(nqp), ctypes.c_int32(k),
        _ptr(elem, ctypes.c_int32), _ptr(ij, ctypes.c_uint16),
        _ptr(indptr, ctypes.c_int64), ctypes.c_int64(nnzb),
        _ptr(lam, ctypes.c_double), _ptr(mu, ctypes.c_double),
        _ptr(out, ctypes.c_double))
    return out


def bsr_rap_scalar_native(A_indptr, A_indices, A_data,
                          P_indptr, P_indices, P_w,
                          PT_indptr, PT_indices, PT_w,
                          out_indptr, out_indices,
                          n_f: int, n_c: int) -> Optional[np.ndarray]:
    """A_c = P^T A P for a 3x3-block A and a scalar P on a frozen output
    pattern: the [nnz_out, 3, 3] block values, or None if the library is
    unavailable.  Raises ValueError if the product has a block outside
    the pattern (the caller's ``SkeletonMismatch``).  Runs under
    :func:`host_ftz`."""
    lib = load_native()
    if lib is None:
        return None
    A_indptr = np.ascontiguousarray(A_indptr, np.int64)
    A_indices = np.ascontiguousarray(A_indices, np.int32)
    A_data = np.ascontiguousarray(A_data, np.float64)
    P_indptr = np.ascontiguousarray(P_indptr, np.int64)
    P_indices = np.ascontiguousarray(P_indices, np.int32)
    P_w = np.ascontiguousarray(P_w, np.float64)
    PT_indptr = np.ascontiguousarray(PT_indptr, np.int64)
    PT_indices = np.ascontiguousarray(PT_indices, np.int32)
    PT_w = np.ascontiguousarray(PT_w, np.float64)
    out_indptr = np.ascontiguousarray(out_indptr, np.int64)
    out_indices = np.ascontiguousarray(out_indices, np.int32)
    out = np.empty((out_indices.shape[0], 3, 3), np.float64)
    with host_ftz():
        rc = lib.topopt_bsr_rap_scalar(
            ctypes.c_int64(n_f), ctypes.c_int64(n_c),
            _ptr(A_indptr, ctypes.c_int64), _ptr(A_indices, ctypes.c_int32),
            _ptr(A_data, ctypes.c_double),
            _ptr(P_indptr, ctypes.c_int64), _ptr(P_indices, ctypes.c_int32),
            _ptr(P_w, ctypes.c_double),
            _ptr(PT_indptr, ctypes.c_int64),
            _ptr(PT_indices, ctypes.c_int32), _ptr(PT_w, ctypes.c_double),
            _ptr(out_indptr, ctypes.c_int64),
            _ptr(out_indices, ctypes.c_int32), _ptr(out, ctypes.c_double))
    if rc != 0:
        raise ValueError("RAP produced a column outside the frozen "
                         "coarse pattern")
    return out


def extract_surface_faces_native(conn: np.ndarray, face_table: np.ndarray
                                 ) -> Optional[np.ndarray]:
    """Sorted flat surface-face indices (cell * n_faces + local face), or
    None if the library is unavailable."""
    lib = load_native()
    if lib is None:
        return None
    conn = np.ascontiguousarray(conn, np.int32)
    ft = np.ascontiguousarray(face_table, np.int32)
    C, k = conn.shape
    nf, fk = ft.shape
    out = np.empty(C * nf, np.int64)
    n = lib.topopt_extract_surface_faces(
        _ptr(conn, ctypes.c_int32), ctypes.c_int64(C), ctypes.c_int32(k),
        _ptr(ft, ctypes.c_int32), ctypes.c_int32(nf), ctypes.c_int32(fk),
        _ptr(out, ctypes.c_int64))
    return out[:n].copy()
