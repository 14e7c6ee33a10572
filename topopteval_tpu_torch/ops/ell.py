"""Scan-window ELL matvecs (counterpart of the row-slot half of
``topopteval_tpu/ops/pallas_bsr.py``: ``pack_ell_rows``,
``bell_matvec_pallas`` and ``sell_matvec_pallas``).

The layout is the JAX package's, array for array.  Rows are grouped in
tiles of ``LANES`` = 128; every row of a tile has ``S`` slots (a multiple
of ``GROUP``), and slot ``s`` of row ``n = 128 t + l`` sits at lane ``l``:

    cols2   [Nt*S, 128]   int32  cols2[t*S + s, l] = column of that slot
    vals2   [Nt*9*S, 128]        3x3 blocks, plane-major: row (9t + 3a+b)*S + s
    w2      [Nt*S, 128]          scalar weights, slot-major (same as cols2)
    wblk    [Nt]          int32  the tile's window base, in 128-column chunks
    gbounds [Nt, 1, 2*S/GROUP]   per-group chunk ranges (accepted, not read)

A tile reads only the ``kc`` chunks from ``wblk[t]`` on: a column outside
``[128 wblk[t], 128 (wblk[t] + kc))`` contributes zero, as on the TPU.  On
``pack_ell_rows`` output the window covers every column, so the mask cuts
nothing there.

- ``bell_matvec_window``: out[a, n] = sum_s sum_b vals[n, s, 3a+b] u[b, cols[n, s]]
- ``sell_matvec_window``: out[a, n] = sum_s w[n, s] u[a, cols[n, s]]

Vectors are component-major [3, n_cols] (the JAX layout) or, with
``node_major=True``, node-major [n_cols, 3] (the multigrid V-cycle's
layout); any strides are taken, so neither needs a transpose.  On a CUDA
tensor each call launches its hand-written kernel of ``csrc/ell_apply.cu``
or raises; it never falls back.  On a CPU tensor it runs the plain PyTorch
version (``*_reference``), which is also what the kernels are held
against on the card.

``bell_ablate`` is the kernel of the block-ELL ablation probe
(tools/ell_ablate.py, the counterpart of tools/tpu_bell_ablate.py): B9a's
matvec split into a gather stage and a value stage that meet in a
shared-memory scratch, in five modes that leave out one part each
(``ABLATE_MODES``; csrc/ell_ablate.cu says what each computes).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from .. import _build

#: kernel launches per wrapper; only a launch of the CUDA kernel counts
LAUNCHES = {"bell_window": 0, "sell_window": 0, "bell_ablate": 0}
#: the ablation probe's modes, in the order of csrc/ell_ablate.cu's Mode
ABLATE_MODES = ("full", "noskip", "nogather", "nofinal", "empty")

LANES = 128
GROUP = 8          # pack_ell_rows pads S to a multiple of this
#: bell_window, sell_window: slots a warp keeps in flight
#: (csrc/ell_apply.cu SLOTS), the warps for every 32 rows that
#: ``sell_warps`` chooses from, and those that ``window_warps`` chooses
#: from (the C entry points take all five)
SELL_SLOTS = 8
SELL_WARPS = (1, 2, 4, 8)
WINDOW_WARPS = (1, 2, 4, 8, 16)
#: warps the card holds at once at 32 an SM (132 SMs, H100 SXM): one wave
#: of ``bell_window``'s blocks
CARD_WARPS = 132 * 32


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def sell_warps(S: int) -> int:
    """Warps for every 32 rows of ``sell_window`` for rows of ``S``
    slots: the fewest of ``SELL_WARPS`` that leave each warp at most
    ``SELL_SLOTS`` slots, else the most (8 for the restriction's S 48, 1
    for the prolongation's S 8)."""
    for w in SELL_WARPS:
        if w * SELL_SLOTS >= S:
            return w
    return SELL_WARPS[-1]


def window_warps(S: int, n_rows: int) -> int:
    """Warps for every 32 rows of ``bell_window`` for ``n_rows`` rows of
    ``S`` slots: the fewest of ``WINDOW_WARPS`` that put CARD_WARPS warps
    on the card or leave each warp at most ``SELL_SLOTS`` slots (4 at the
    Galerkin route's level 1, 36,297 rows of S 72: one wave; 16 at its
    level 2, 5,225 rows).  More warps than a wave only add rounds of
    part-filled batches."""
    groups = _cdiv(max(n_rows, 1), 32)
    for w in WINDOW_WARPS:
        if groups * w >= CARD_WARPS or w * SELL_SLOTS >= S:
            return w
    return WINDOW_WARPS[-1]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


# ---------------------------------------------------------------------------
# Host-side packing: (rows, cols, data) triplets -> the device layouts
# ---------------------------------------------------------------------------


def pack_ell_rows(rows: np.ndarray, cols: np.ndarray, data: np.ndarray,
                  n_rows: int, n_cols: int) -> dict:
    """Sort triplets into fixed-width ELL rows + lane-major arrays (the
    JAX package's ``pack_ell_rows``, array for array).

    ``data`` is [nnz, 3, 3] (block) or [nnz] (scalar).  Entries within a
    row are sorted by column; S is padded to a multiple of GROUP.  A pad
    slot repeats the row's last real column with zero data; an empty row
    forward-fills from the nearest preceding row that has entries.

    Returns dict with cols2, vals2 (plane-major for blocks, slot-major for
    scalars), wblk, gbounds, S, kc, n_rows_p, n_cols_p.
    """
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    order = np.lexsort((cols, rows))
    rows, cols, data = rows[order], cols[order], np.asarray(data)[order]
    counts = np.bincount(rows, minlength=n_rows)
    S = max(int(counts.max()) if n_rows else 1, 1)
    S = _cdiv(S, GROUP) * GROUP
    Np = _cdiv(max(n_rows, 1), LANES) * LANES
    Nt = Np // LANES
    block = data.ndim == 3

    cols_full = np.zeros((Np, S), np.int64)
    vals_full = np.zeros((Np, S, 3, 3) if block else (Np, S), data.dtype)
    starts = np.cumsum(counts) - counts
    slot = np.arange(rows.size) - np.repeat(starts, counts)
    cols_full[rows, slot] = cols
    vals_full[rows, slot] = data
    counts_p = np.zeros(Np, np.int64)
    counts_p[:n_rows] = counts
    last_col = cols_full[np.arange(Np), np.maximum(counts_p - 1, 0)]
    last_real = np.where(counts_p > 0, np.arange(Np), -1)
    np.maximum.accumulate(last_real, out=last_real)
    fill = np.where(last_real >= 0, last_col[np.maximum(last_real, 0)], 0)
    pad_mask = np.arange(S)[None, :] >= counts_p[:, None]
    cols_full = np.where(pad_mask, fill[:, None], cols_full)

    # the tile's window; clamped so that kc chunks from wblk stay inside
    # the padded source (a clamped window still covers the tile's span)
    ct = cols_full.reshape(Nt, LANES * S)
    wblk = ct.min(axis=1) // LANES
    kc = int(np.max(ct.max(axis=1) // LANES - wblk)) + 1 if Nt else 1
    n_cols_p = _cdiv(max(n_cols, 1), LANES) * LANES
    kc = min(kc, n_cols_p // LANES)
    wblk = np.minimum(wblk, n_cols_p // LANES - kc)

    ng = S // GROUP
    cg = cols_full.reshape(Nt, LANES, ng, GROUP)
    glo = cg.min(axis=(1, 3)) // LANES - wblk[:, None]
    ghi = cg.max(axis=(1, 3)) // LANES - wblk[:, None]
    gbounds = np.stack([np.clip(glo, 0, kc - 1), np.clip(ghi, 0, kc - 1)],
                       axis=2).reshape(Nt, 1, 2 * ng).astype(np.int32)

    cols2 = cols_full.reshape(Nt, LANES, S).transpose(0, 2, 1) \
        .reshape(Nt * S, LANES).astype(np.int32)
    if block:
        vals2 = vals_full.reshape(Nt, LANES, S, 9) \
            .transpose(0, 3, 2, 1).reshape(Nt * 9 * S, LANES)
    else:
        vals2 = vals_full.reshape(Nt, LANES, S).transpose(0, 2, 1) \
            .reshape(Nt * S, LANES)
    return {"cols2": np.ascontiguousarray(cols2),
            "vals2": np.ascontiguousarray(vals2),
            "wblk": wblk.astype(np.int32), "gbounds": gbounds,
            "S": S, "kc": kc, "n_rows_p": Np, "n_cols_p": n_cols_p}


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built ``csrc/ell_apply.cu`` with its C signatures declared."""
    lib = _build.load("ell_apply")
    for name in ("bell_window", "sell_window"):
        for suffix in _SUFFIX.values():
            fn = getattr(lib, f"{name}_{suffix}")
            fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                           + [ctypes.c_longlong] * 4
                           + [ctypes.c_int, ctypes.c_void_p])
            fn.restype = ctypes.c_int
    lib.ell_apply_error_string.argtypes = [ctypes.c_int]
    lib.ell_apply_error_string.restype = ctypes.c_char_p
    return lib


def _strides(u: torch.Tensor, node_major: bool):
    """(component stride, node stride, n_cols) of a [3, n] or [n, 3]
    vector."""
    if u.dim() != 2 or u.shape[1 if node_major else 0] != 3:
        raise ValueError(f"u must be {'[n, 3]' if node_major else '[3, n]'}"
                         f", got {tuple(u.shape)}")
    if node_major:
        return u.stride(1), u.stride(0), u.shape[0]
    return u.stride(0), u.stride(1), u.shape[1]


def _check(name: str, cols2, vals, wblk, u, S: int, kc: int,
           node_major: bool, n_rows: Optional[int]) -> int:
    """Validate the inputs; returns the number of output rows."""
    Nt = wblk.shape[0]
    planes = 9 if name == "bell_window" else 1
    if tuple(cols2.shape) != (Nt * S, LANES):
        raise ValueError(f"{name}: cols2 must be [{Nt * S}, {LANES}], got "
                         f"{tuple(cols2.shape)}")
    if tuple(vals.shape) != (Nt * planes * S, LANES):
        raise ValueError(f"{name}: values must be [{Nt * planes * S}, "
                         f"{LANES}], got {tuple(vals.shape)}")
    if cols2.dtype != torch.int32 or wblk.dtype != torch.int32:
        raise TypeError(f"{name}: cols2 and wblk must be int32")
    if u.dtype not in _SUFFIX or vals.dtype != u.dtype:
        raise TypeError(f"{name}: vectors {u.dtype} with values "
                        f"{vals.dtype} are not supported (float32 or "
                        "float64, both the same)")
    if kc < 1:
        raise ValueError(f"{name}: kc must be >= 1, got {kc}")
    _strides(u, node_major)
    rows = Nt * LANES if n_rows is None else int(n_rows)
    if not 0 <= rows <= Nt * LANES:
        raise ValueError(f"{name}: n_rows={rows} outside [0, {Nt * LANES}]")
    for label, t in (("cols2", cols2), ("values", vals), ("wblk", wblk)):
        if t.device != u.device:
            raise ValueError(f"{name}: {label} is on {t.device}, u on "
                             f"{u.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
    return rows


def _apply(name: str, cols2, vals, wblk, u, S: int, kc: int,
           node_major: bool, n_rows: Optional[int]) -> torch.Tensor:
    rows = _check(name, cols2, vals, wblk, u, S, kc, node_major, n_rows)
    if u.device.type == "cpu":
        return _window_reference(name, cols2, vals, wblk, u, S, kc,
                                 node_major, rows)
    if u.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {u.device}")
    out = torch.empty((rows, 3) if node_major else (3, rows),
                      dtype=u.dtype, device=u.device)
    u_cs, u_ns, n_cols = _strides(u, node_major)
    o_cs, o_ns, _ = _strides(out, node_major)
    lib = _library()
    stream = torch.cuda.current_stream(u.device).cuda_stream
    warps = (window_warps(S, rows) if name == "bell_window"
             else sell_warps(S))
    with torch.cuda.device(u.device):
        err = getattr(lib, f"{name}_{_SUFFIX[u.dtype]}")(
            cols2.data_ptr(), vals.data_ptr(), wblk.data_ptr(),
            u.data_ptr(), out.data_ptr(), S, kc, wblk.shape[0], rows,
            n_cols, u_cs, u_ns, o_cs, o_ns, warps, stream)
    if err != 0:
        msg = lib.ell_apply_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"({msg})")
    if rows:                    # no rows: nothing launched
        LAUNCHES[name] += 1
    return out


def bell_matvec_window(cols2: torch.Tensor, vals2: torch.Tensor,
                       wblk: torch.Tensor, gbounds: torch.Tensor,
                       u: torch.Tensor, S: int, kc: int, *,
                       node_major: bool = False,
                       n_rows: Optional[int] = None) -> torch.Tensor:
    """3x3-block ELL matvec: [3, n_cols] -> [3, n_rows] (or [n, 3] ->
    [n_rows, 3] with ``node_major``).  ``n_rows`` defaults to every row of
    the tiles, pad rows included (they come out 0).  ``gbounds`` is
    accepted for the JAX signature and not read, as on the TPU.  The
    kernel takes :func:`window_warps` warps for every 32 rows."""
    del gbounds
    return _apply("bell_window", cols2, vals2, wblk, u, S, kc, node_major,
                  n_rows)


def sell_matvec_window(cols2: torch.Tensor, w2: torch.Tensor,
                       wblk: torch.Tensor, gbounds: torch.Tensor,
                       u: torch.Tensor, S: int, kc: int, *,
                       node_major: bool = False,
                       n_rows: Optional[int] = None) -> torch.Tensor:
    """Scalar-weight ELL apply (the transfers P and P^T), in the layouts of
    :func:`bell_matvec_window`; the kernel takes :func:`sell_warps` of S
    warps for every 32 rows."""
    del gbounds
    return _apply("sell_window", cols2, w2, wblk, u, S, kc, node_major,
                  n_rows)


# ---------------------------------------------------------------------------
# Plain PyTorch versions: the masked window gather, the per-slot products
# in the kernels' order, and a sum over the slots
# ---------------------------------------------------------------------------


def _window_reference(name: str, cols2, vals, wblk, u, S: int, kc: int,
                      node_major: bool, n_rows: int) -> torch.Tensor:
    Nt = wblk.shape[0]
    n_cols = u.shape[0 if node_major else 1]
    cols = cols2.reshape(Nt, S, LANES).long()
    lo = wblk.long()[:, None, None] * LANES
    inb = (cols >= lo) & (cols < lo + kc * LANES) & (cols < n_cols)
    idx = torch.where(inb, cols, 0).reshape(-1)
    if node_major:      # whole rows gathered, components last
        g = u.index_select(0, idx).reshape(Nt, S, LANES, 3)
        g = torch.where(inb[..., None], g, u.new_zeros(()))
        comp = [g[..., b] for b in range(3)]
    else:
        g = u.index_select(1, idx).reshape(3, Nt, S, LANES)
        g = torch.where(inb, g, u.new_zeros(()))
        comp = [g[b] for b in range(3)]
    if name == "bell_window":
        v = vals.reshape(Nt, 9, S, LANES)
        out = [(v[:, 3 * a] * comp[0] + v[:, 3 * a + 1] * comp[1]
                + v[:, 3 * a + 2] * comp[2]).sum(dim=1) for a in range(3)]
    elif node_major:
        return (vals.reshape(Nt, S, LANES, 1) * g).sum(dim=1).reshape(
            Nt * LANES, 3)[:n_rows]
    else:
        out = (vals.reshape(Nt, S, LANES) * g).sum(dim=2)
        return out.reshape(3, Nt * LANES)[:, :n_rows].contiguous()
    if node_major:
        return torch.stack(out, dim=-1).reshape(Nt * LANES, 3)[:n_rows]
    return torch.stack(out).reshape(3, Nt * LANES)[:, :n_rows].contiguous()


def bell_matvec_window_reference(cols2, vals2, wblk, gbounds, u, S: int,
                                 kc: int, *, node_major: bool = False,
                                 n_rows: Optional[int] = None
                                 ) -> torch.Tensor:
    """Plain version of :func:`bell_matvec_window` on any device."""
    del gbounds
    rows = _check("bell_window", cols2, vals2, wblk, u, S, kc, node_major,
                  n_rows)
    return _window_reference("bell_window", cols2, vals2, wblk, u, S, kc,
                             node_major, rows)


def sell_matvec_window_reference(cols2, w2, wblk, gbounds, u, S: int,
                                 kc: int, *, node_major: bool = False,
                                 n_rows: Optional[int] = None
                                 ) -> torch.Tensor:
    """Plain version of :func:`sell_matvec_window` on any device."""
    del gbounds
    rows = _check("sell_window", cols2, w2, wblk, u, S, kc, node_major,
                  n_rows)
    return _window_reference("sell_window", cols2, w2, wblk, u, S, kc,
                             node_major, rows)


# ---------------------------------------------------------------------------
# The ablation probe's kernel (csrc/ell_ablate.cu)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _ablate_library() -> ctypes.CDLL:
    """The built ``csrc/ell_ablate.cu`` with its C signatures declared."""
    lib = _build.load("ell_ablate")
    for suffix in _SUFFIX.values():
        fn = getattr(lib, f"ell_ablate_{suffix}")
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                       + [ctypes.c_int] * 5 + [ctypes.c_longlong,
                                               ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.ell_ablate_scratch_limit.restype = ctypes.c_int
    lib.ell_ablate_error_string.argtypes = [ctypes.c_int]
    lib.ell_ablate_error_string.restype = ctypes.c_char_p
    return lib


def _check_ablate(mode: str, cols2, vals2, wblk, u, S: int, kc: int) -> None:
    if mode not in ABLATE_MODES:
        raise ValueError(f"bell_ablate: mode must be one of {ABLATE_MODES}, "
                         f"got {mode!r}")
    _check("bell_window", cols2, vals2, wblk, u, S, kc, False, None)
    if S < 3:
        raise ValueError(f"bell_ablate: S={S} < 3 (nofinal writes slots "
                         "0-2)")
    if u.stride(1) != 1:
        raise ValueError("bell_ablate: u must be [3, n] with unit node "
                         "stride")


def bell_ablate(mode: str, cols2: torch.Tensor, vals2: torch.Tensor,
                wblk: torch.Tensor, gbounds: torch.Tensor, u: torch.Tensor,
                S: int, kc: int) -> torch.Tensor:
    """One mode of the ablation probe on the ``pack_ell_rows`` layout: u
    [3, n_cols] -> out [3, Nt*128] (pad rows included).  ``full`` and
    ``noskip`` compute :func:`bell_matvec_window`; ``gbounds`` is accepted
    for the TPU tool's signature and not read."""
    del gbounds
    _check_ablate(mode, cols2, vals2, wblk, u, S, kc)
    if u.device.type == "cpu":
        return _ablate_reference(mode, cols2, vals2, wblk, u, S, kc)
    if u.device.type != "cuda":
        raise ValueError(f"bell_ablate: no kernel for device {u.device}")
    lib = _ablate_library()
    scratch = 3 * S * LANES * u.element_size()
    limit = lib.ell_ablate_scratch_limit()
    if scratch > limit:
        raise ValueError(f"bell_ablate: the gather scratch of S={S} slots "
                         f"takes {scratch} bytes of shared memory a block "
                         f"({u.dtype}); this card allows {limit}")
    Nt = wblk.shape[0]
    rows = Nt * LANES
    out = torch.empty((3, rows), dtype=u.dtype, device=u.device)
    stream = torch.cuda.current_stream(u.device).cuda_stream
    with torch.cuda.device(u.device):
        err = getattr(lib, f"ell_ablate_{_SUFFIX[u.dtype]}")(
            ABLATE_MODES.index(mode), cols2.data_ptr(), vals2.data_ptr(),
            wblk.data_ptr(), u.data_ptr(), out.data_ptr(), S, kc, Nt, rows,
            u.shape[1], u.stride(0), stream)
    if err != 0:
        msg = lib.ell_ablate_error_string(err).decode()
        raise RuntimeError(f"bell_ablate kernel launch failed: CUDA error "
                           f"{err} ({msg})")
    if rows:
        LAUNCHES["bell_ablate"] += 1
    return out


def bell_ablate_reference(mode: str, cols2, vals2, wblk, gbounds, u,
                          S: int, kc: int) -> torch.Tensor:
    """Plain version of :func:`bell_ablate` on any device."""
    del gbounds
    _check_ablate(mode, cols2, vals2, wblk, u, S, kc)
    return _ablate_reference(mode, cols2, vals2, wblk, u, S, kc)


def _ablate_reference(mode: str, cols2, vals2, wblk, u, S: int,
                      kc: int) -> torch.Tensor:
    """Each mode's formula: the masked gather of ``full`` (``noskip``
    gathers the same values), the column's chunk at the row's own lane
    (``nogather``) or zeros (``empty``); then slots 0-2 of component 0
    (``nofinal``) or the value stage."""
    Nt = wblk.shape[0]
    n_cols = u.shape[1]
    cols = cols2.reshape(Nt, S, LANES).long()
    lo = wblk.long()[:, None, None] * LANES
    inb = (cols >= lo) & (cols < lo + kc * LANES) & (cols < n_cols)
    if mode == "nogather":
        lane = torch.arange(LANES, device=u.device)
        cols = cols - cols % LANES + lane
        inb = inb & (cols < n_cols)
    if mode == "empty":
        g = u.new_zeros((3, Nt, S, LANES))
    else:
        g = u.index_select(1, torch.where(inb, cols, 0).reshape(-1))
        g = torch.where(inb, g.reshape(3, Nt, S, LANES), u.new_zeros(()))
    if mode == "nofinal":
        return g[0, :, :3].permute(1, 0, 2).reshape(3, Nt * LANES) \
            .contiguous()
    v = vals2.reshape(Nt, 9, S, LANES)
    out = [(v[:, 3 * a] * g[0] + v[:, 3 * a + 1] * g[1]
            + v[:, 3 * a + 2] * g[2]).sum(dim=1) for a in range(3)]
    return torch.stack(out).reshape(3, Nt * LANES)
