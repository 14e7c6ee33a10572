"""Block-sparse matvecs of the block-ELL multigrid hierarchy (counterpart
of ``topopteval_tpu/ops/pallas_bsr.py``).

Matrices are plain row-compressed: :class:`BlockCSR` holds ``indptr``
[n_rows+1] and ``cols`` [nnz] (int32, columns sorted within each row) and
``vals``, either 3x3 blocks [nnz, 9] (row-major, entry 3a+b couples output
component a to input component b) or scalar weights [nnz].  Vectors are
component-major [3, n], as in the JAX package, so masks, block inverses and
coarse inverses compare array for array.  The JAX package's chunk-aligned
ELL layout (``ell_layout_aligned``) is a TPU lane-gather device and is not
carried over: at 1.23M tets it pads rows of at most 15 blocks to 88 slots.

- ``bell_matvec(u_cm, A, vals_lo=None)``: out[a, n] = sum_j sum_b
  A.vals[j, 3a+b] u[b, A.cols[j]] over the blocks j of row n, with an
  optional second value plane ``vals_lo`` summed separately and added once
  per output (the float32 hi/lo split of float64 values);
- ``sell_matvec(u_cm, T)``: out[a, n] = sum_j T.vals[j] u[a, T.cols[j]],
  the prolongation and restriction.

Values may be bf16 under float32 vectors; they are widened before the
multiply.  On a CUDA tensor each call launches its hand-written kernel of
``csrc/bell_apply.cu`` or raises; it never falls back.  On a CPU tensor it
runs ``*_reference``, the plain PyTorch version, which is also what the
kernels are held against on the card.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Optional

import numpy as np
import torch

from .. import _build
from ..mesh import resolve_device

#: kernel launches per wrapper; only a launch of the CUDA kernel counts
LAUNCHES = {"bell_matvec": 0, "sell_matvec": 0}

#: threads of a bell_matvec / sell_matvec block (csrc/bell_apply.cu
#: BELL_THREADS): a block takes BELL_THREADS / lanes consecutive rows
BELL_THREADS = 256
#: entries a lane sums in sequence, aimed at on average (bell_matvec's
#: blocks, sell_matvec's weights)
LANE_BLOCKS = 4
#: sell_matvec: rows of fewer weights than this on average take one lane
LANE_WEIGHTS = 8

#: row padding of the component-major vectors (the JAX package's lane
#: width, kept so both packages' [3, Np] arrays have one shape)
LANES = 128


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def pad_rows(n: int) -> int:
    """Rows of the padded component-major space: n rounded up to 128."""
    return -(-max(n, 1) // LANES) * LANES


@dataclasses.dataclass(frozen=True)
class BlockCSR:
    """Row-compressed matrix with 3x3 blocks ([nnz, 9] ``vals``) or scalar
    weights ([nnz] ``vals``) on one device."""

    indptr: torch.Tensor    # [n_rows + 1] int32
    cols: torch.Tensor      # [nnz] int32, sorted within each row
    vals: torch.Tensor      # [nnz, 9] or [nnz]
    n_cols: int

    @property
    def n_rows(self) -> int:
        return self.indptr.shape[0] - 1

    @property
    def nnz(self) -> int:
        return self.cols.shape[0]

    @property
    def block(self) -> bool:
        return self.vals.dim() == 2

    @property
    def device(self) -> torch.device:
        return self.vals.device

    @staticmethod
    def from_numpy(indptr, cols, vals, n_cols: int, dtype,
                   device) -> "BlockCSR":
        return BlockCSR(
            torch.as_tensor(np.asarray(indptr, np.int32), device=device),
            torch.as_tensor(np.asarray(cols, np.int32), device=device),
            torch.as_tensor(np.ascontiguousarray(vals), dtype=dtype,
                            device=device),
            int(n_cols))

    def with_vals(self, vals: torch.Tensor) -> "BlockCSR":
        return dataclasses.replace(self, vals=vals)

    def rows(self) -> torch.Tensor:
        """Row id of every entry [nnz] (int64), for the plain versions."""
        counts = (self.indptr[1:] - self.indptr[:-1]).long()
        return torch.repeat_interleave(
            torch.arange(self.n_rows, device=self.indptr.device), counts)


def bell_lanes(n_rows: int, nnz: int) -> int:
    """Lanes that sum one row in ``bell_matvec``'s kernel: the power of two
    nearest to (blocks per row) / LANE_BLOCKS, from 2 to 32 (4 at 14.4
    blocks a row, 16 at 72).  Lane l of row r sums blocks indptr[r] + l,
    + l + lanes, ... in order; a xor butterfly over the lanes adds the
    partial sums, so the order depends on the matrix only."""
    avg = nnz / max(n_rows, 1)
    lanes = 2 ** round(math.log2(max(avg / LANE_BLOCKS, 1.0)))
    return min(max(lanes, 2), 32)


def sell_lanes(n_rows: int, nnz: int) -> int:
    """Lanes that sum one row in ``sell_matvec``'s kernel: one for rows of
    fewer than LANE_WEIGHTS weights on average (the prolongation's ~5.6
    at scale 16; the row is then summed in entry order, as the plain
    version does), else :func:`bell_lanes`' count (8 on the restriction's
    ~34: a lane's four or five weights in one batch)."""
    if nnz < LANE_WEIGHTS * max(n_rows, 1):
        return 1
    return bell_lanes(n_rows, nnz)


def csr_arrays(rows, cols, data, n_rows: int):
    """Sorted-triplet packer: (rows, cols, data) -> (indptr int64 [n_rows+1],
    cols int32 [nnz], data [nnz, ...]) ordered by (row, col).  Duplicates
    are kept as they are (callers pass deduplicated triplets)."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    data = np.asarray(data)
    order = np.lexsort((cols, rows))
    if not np.array_equal(order, np.arange(order.shape[0])):
        rows, cols, data = rows[order], cols[order], data[order]
    indptr = np.zeros(n_rows + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=n_rows), out=indptr[1:])
    if data.ndim == 3:
        data = data.reshape(-1, 9)
    return indptr, cols.astype(np.int32), data


def pack_csr(rows, cols, data, n_rows: int, n_cols: int, dtype=None,
             device="cuda") -> BlockCSR:
    """:func:`csr_arrays` straight to a :class:`BlockCSR` on ``device``
    (the card unless the caller asks for the CPU)."""
    device = resolve_device(device)
    indptr, cols, data = csr_arrays(rows, cols, data, n_rows)
    dtype = dtype or torch.from_numpy(np.zeros(0, data.dtype)).dtype
    return BlockCSR.from_numpy(indptr, cols, data, n_cols, dtype, device)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


_SUFFIX = {(torch.float32, torch.float32): "f32",
           (torch.float32, torch.bfloat16): "f32_bf16",
           (torch.float64, torch.float64): "f64"}


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built ``csrc/bell_apply.cu`` with its C signatures declared."""
    lib = _build.load("bell_apply")
    for suffix in set(_SUFFIX.values()):
        fn = getattr(lib, f"bell_matvec_{suffix}")
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn = getattr(lib, f"sell_matvec_{suffix}")
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.bell_apply_error_string.argtypes = [ctypes.c_int]
    lib.bell_apply_error_string.restype = ctypes.c_char_p
    return lib


def _check(name: str, u_cm: torch.Tensor, A: BlockCSR, block: bool,
           vals_lo: Optional[torch.Tensor]) -> str:
    """Validate the inputs; returns the C entry point's type suffix."""
    if A.block != block:
        raise ValueError(f"{name}: {'3x3-block' if block else 'scalar'} "
                         f"values expected, got shape {tuple(A.vals.shape)}")
    suffix = _SUFFIX.get((u_cm.dtype, A.vals.dtype))
    if suffix is None:
        raise TypeError(f"{name}: vectors {u_cm.dtype} with values "
                        f"{A.vals.dtype} are not supported (float32 with "
                        "float32 or bfloat16, float64 with float64)")
    if tuple(u_cm.shape) != (3, A.n_cols):
        raise ValueError(f"{name}: u must be [3, {A.n_cols}], got "
                         f"{tuple(u_cm.shape)}")
    if A.indptr.dtype != torch.int32 or A.cols.dtype != torch.int32:
        raise TypeError(f"{name}: indptr and cols must be int32")
    tensors = [("u", u_cm), ("indptr", A.indptr), ("cols", A.cols),
               ("vals", A.vals)]
    if vals_lo is not None:
        if suffix != "f32":
            raise TypeError(f"{name}: the lo plane is taken with float32 "
                            "values and vectors only")
        if vals_lo.dtype != A.vals.dtype or vals_lo.shape != A.vals.shape:
            raise ValueError(f"{name}: vals_lo must match vals in shape and "
                             "dtype")
        tensors.append(("vals_lo", vals_lo))
    for label, t in tensors:
        if t.device != u_cm.device:
            raise ValueError(f"{name}: {label} is on {t.device}, u on "
                             f"{u_cm.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
    return suffix


def _launch(name: str, suffix: str, args, A: BlockCSR, u_cm: torch.Tensor,
            extra=()) -> torch.Tensor:
    out = torch.empty((3, A.n_rows), dtype=u_cm.dtype, device=u_cm.device)
    lib = _library()
    stream = torch.cuda.current_stream(u_cm.device).cuda_stream
    err = getattr(lib, f"{name}_{suffix}")(
        *args, u_cm.data_ptr(), out.data_ptr(), A.n_rows, A.n_cols, *extra,
        stream)
    if err != 0:
        msg = lib.bell_apply_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"({msg})")
    if A.n_rows:                # no rows: nothing launched
        LAUNCHES[name] += 1
    return out


def bell_matvec(u_cm: torch.Tensor, A: BlockCSR,
                vals_lo: Optional[torch.Tensor] = None) -> torch.Tensor:
    """3x3-block SpMV on component-major vectors: [3, n_cols] ->
    [3, n_rows] (see the module docstring)."""
    suffix = _check("bell_matvec", u_cm, A, True, vals_lo)
    if u_cm.device.type == "cpu":
        return bell_matvec_reference(u_cm, A, vals_lo)
    if u_cm.device.type != "cuda":
        raise ValueError(f"bell_matvec: no kernel for device {u_cm.device}")
    args = (A.indptr.data_ptr(), A.cols.data_ptr(), A.vals.data_ptr(),
            None if vals_lo is None else vals_lo.data_ptr())
    return _launch("bell_matvec", suffix, args, A, u_cm,
                   (bell_lanes(A.n_rows, A.nnz),))


def sell_matvec(u_cm: torch.Tensor, T: BlockCSR) -> torch.Tensor:
    """Scalar-weight transfer on component-major vectors: [3, n_cols] ->
    [3, n_rows]."""
    suffix = _check("sell_matvec", u_cm, T, False, None)
    if u_cm.device.type == "cpu":
        return sell_matvec_reference(u_cm, T)
    if u_cm.device.type != "cuda":
        raise ValueError(f"sell_matvec: no kernel for device {u_cm.device}")
    args = (T.indptr.data_ptr(), T.cols.data_ptr(), T.vals.data_ptr())
    return _launch("sell_matvec", suffix, args, T, u_cm,
                   (sell_lanes(T.n_rows, T.nnz),))


# ---------------------------------------------------------------------------
# Plain PyTorch versions: gather, the per-block products in the kernels'
# order, and a sum per row (index_add_ in entry order)
# ---------------------------------------------------------------------------


def _block_terms(u_cm: torch.Tensor, A: BlockCSR, vals: torch.Tensor):
    g = u_cm[:, A.cols.long()]                               # [3, nnz]
    v = vals.to(u_cm.dtype)
    return torch.stack([v[:, 3 * a] * g[0] + v[:, 3 * a + 1] * g[1]
                        + v[:, 3 * a + 2] * g[2] for a in range(3)])


def bell_matvec_reference(u_cm: torch.Tensor, A: BlockCSR,
                          vals_lo: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    rows = A.rows()
    out = u_cm.new_zeros((3, A.n_rows)).index_add_(
        1, rows, _block_terms(u_cm, A, A.vals))
    if vals_lo is not None:
        out = out + u_cm.new_zeros((3, A.n_rows)).index_add_(
            1, rows, _block_terms(u_cm, A, vals_lo))
    return out


def sell_matvec_reference(u_cm: torch.Tensor, T: BlockCSR) -> torch.Tensor:
    terms = T.vals.to(u_cm.dtype)[None, :] * u_cm[:, T.cols.long()]
    return u_cm.new_zeros((3, T.n_rows)).index_add_(1, T.rows(), terms)
