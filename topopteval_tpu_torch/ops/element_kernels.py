"""Fused element-apply kernels (counterpart of
``topopteval_tpu/ops/pallas_kernels.py``'s tet4, hex8 and tet10 applies).

``tet4_apply``, ``hex8_apply`` and ``tet10_apply`` compute
f_e = Ke(coords, lam, mu) @ u_e for every element without forming Ke,
gathering each element's node rows themselves:

    coords [N,3], conn [C,k] int32, u [3N], lam [C], mu [C]  ->  f_e [C,k,3]

On a CUDA tensor each launches its hand-written kernel from
``csrc/element_apply.cu`` (built with nvcc on first use) or raises; it
never falls back.  On a CPU tensor it runs its plain PyTorch version
(``*_reference`` below: the gather plus ``apply_element_stiffness``),
which is also what the kernels are held against on the card.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import weakref

import numpy as np
import torch

from .. import _build
from .elements import QUADRATURE, apply_element_stiffness, element_tables

#: kernel launches per wrapper; only a launch of the CUDA kernel counts
LAUNCHES = {"tet4_apply": 0, "hex8_apply": 0, "tet10_apply": 0}

_NODES = {"tet4_apply": 4, "hex8_apply": 8, "tet10_apply": 10}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built ``csrc/element_apply.cu`` with its C signatures declared."""
    lib = _build.load("element_apply")
    for name in _NODES:
        for suffix in ("f32", "f64"):
            fn = getattr(lib, f"{name}_{suffix}")
            if name == "tet10_apply":
                # coords, tile nodes, lconn, u, lam, mu, out, C, tile,
                # max_nodes, then the rule's (a, b, w) by value
                fn.argtypes = [ctypes.c_void_p] * 7 + [
                    ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                    *[ctypes.c_double] * 3, ctypes.c_void_p]
            else:
                fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong,
                                                       ctypes.c_void_p]
            fn.restype = ctypes.c_int
    lib.element_apply_error_string.argtypes = [ctypes.c_int]
    lib.element_apply_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def rule_table(element_type: str, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    """The order-2 rule of ``element_type`` as one flat tensor on
    ``device``: dN [nqp, k, 3] from ``element_tables``, then w [nqp].  The
    isoparametric Ke kernels (ops/ke_kernels.py) load it instead of
    carrying the numbers."""
    _, dN, w = element_tables(element_type, 2)
    flat = torch.cat([torch.as_tensor(dN, dtype=torch.float64).reshape(-1),
                      torch.as_tensor(w, dtype=torch.float64)])
    return flat.to(dtype=dtype, device=device)


def tet10_barycentric_grad(a: float, b: float) -> np.ndarray:
    """dN [4, 10, 3] of the tet10 shape functions at the four points of
    the symmetric rule, point q at barycentric coordinates L_q = b and
    L_i = a for i != q, from the derivatives the tet10 kernel uses:
    (4 L_i - 1) grad L_i at corner i and 4 (L_i grad L_j + L_j grad L_i)
    at the mid-edge node of edge {i, j}."""
    grad_L = np.array([[-1.0, -1.0, -1.0], [1.0, 0.0, 0.0],
                       [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]])
    edges = ((0, 1), (1, 2), (2, 0), (0, 3), (1, 3), (2, 3))
    dN = np.empty((4, 10, 3))
    for q in range(4):
        L = np.full(4, a)
        L[q] = b
        for i in range(4):
            dN[q, i] = (4.0 * L[i] - 1.0) * grad_L[i]
        for n, (i, j) in enumerate(edges):
            dN[q, 4 + n] = 4.0 * (L[i] * grad_L[j] + L[j] * grad_L[i])
    return dN


@functools.lru_cache(maxsize=None)
def tet10_rule() -> tuple:
    """(a, b, w): the order-2 tet rule of ``ops/elements.QUADRATURE`` as
    the tet10 kernel takes it, point q at L_q = b, L_i = a (i != q), every
    weight w.  Raises unless ``element_tables("tet10", 2)`` is that rule,
    since the kernel forms dN from a and b instead of reading the table."""
    pts, _ = QUADRATURE[("tet", 2)]
    _, dN, wts = element_tables("tet10", 2)
    a = float(pts[0][0])
    b = 1.0 - 3.0 * a
    if not (np.allclose(dN, tet10_barycentric_grad(a, b), rtol=0,
                        atol=1e-14) and np.all(wts == wts[0])):
        raise ValueError("the tet10 rule is not the symmetric 4-point rule "
                         "the tet10 kernel assumes")
    return a, b, float(wts[0])


@dataclasses.dataclass(frozen=True)
class Tet10Tiles:
    """The tet10 kernel's view of a conn [C, 10]: tiles of ``tile``
    consecutive elements, each with its distinct nodes.

    ``nodes`` [n_tiles, max_nodes] int32 holds tile t's distinct node ids,
    sorted, then -1; ``lconn`` [C, 10] int16 gives each element's nodes as
    positions in its tile's list.  The kernel gathers each distinct node
    row once per tile (about 3.3 times fewer rows than conn names on a
    tet10 beam at 64 elements a tile), neighbouring rows together."""

    tile: int
    nodes: torch.Tensor
    lconn: torch.Tensor
    max_nodes: int


#: elements per tet10 tile (csrc/element_apply.cu instantiates both): 64,
#: or 32 when tiles of 64 would not give every SM of the card two
TET10_TILE = 64
TET10_SMALL_TILE = 32


def tet10_tiles_of(conn: torch.Tensor, tile: int) -> Tet10Tiles:
    """Build :class:`Tet10Tiles` for ``conn`` on its device."""
    C, k = conn.shape
    dev = conn.device
    n_tiles = -(-C // tile)
    t_of = torch.arange(C, device=dev) // tile
    span = int(conn.max()) + 1 if C else 1
    key = (t_of[:, None] * span + conn.long()).reshape(-1)
    uniq, inv = torch.unique(key, sorted=True, return_inverse=True)
    t_uniq = uniq // span
    counts = torch.bincount(t_uniq, minlength=n_tiles)
    start = torch.cumsum(counts, 0) - counts
    max_nodes = int(counts.max()) if C else 0
    nodes = torch.full((n_tiles, max_nodes), -1, dtype=torch.int32,
                       device=dev)
    pos = torch.arange(uniq.numel(), device=dev) - start[t_uniq]
    nodes[t_uniq, pos] = (uniq % span).to(torch.int32)
    lconn = inv.reshape(C, k) - start[t_of][:, None]
    return Tet10Tiles(tile, nodes, lconn.to(torch.int16), max_nodes)


#: Tet10Tiles of the conn tensors seen last, keyed by tensor identity and
#: checked against a weak reference, the data pointer and the version
_TILES: "collections.OrderedDict" = collections.OrderedDict()


def tet10_tiles(conn: torch.Tensor) -> Tet10Tiles:
    """:func:`tet10_tiles_of` for ``conn``, built once per conn tensor
    (the operator passes the same one every matvec) and rebuilt when the
    tensor is written in place."""
    hit = _TILES.get(id(conn))
    if hit is not None:
        ref, ptr, version, tiles = hit
        if ref() is conn and ptr == conn.data_ptr() \
                and version == conn._version:
            _TILES.move_to_end(id(conn))
            return tiles
    sms = (torch.cuda.get_device_properties(conn.device).multi_processor_count
           if conn.is_cuda else 132)
    tile = TET10_TILE if conn.shape[0] >= 2 * sms * TET10_TILE \
        else TET10_SMALL_TILE
    tiles = tet10_tiles_of(conn, tile)
    _TILES[id(conn)] = (weakref.ref(conn), conn.data_ptr(), conn._version,
                        tiles)
    while len(_TILES) > 8:
        _TILES.popitem(last=False)
    return tiles


def check_inputs(name: str, k: int, coords, conn, **per_node_or_cell):
    """Validate a kernel's (coords [N,3], conn [C,k] int32, ...) inputs:
    one float dtype, one device, contiguous, the right shapes.  ``u`` is
    [3N]; every other keyword is per element [C].  Returns (N, C)."""
    dtype = coords.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: float32 or float64 expected, got {dtype}")
    for label, t in per_node_or_cell.items():
        if t.dtype != dtype:
            raise TypeError(f"{name}: {label} is {t.dtype}, coords {dtype}")
    if conn.dtype != torch.int32:
        raise TypeError(f"{name}: conn must be int32, got {conn.dtype}")
    for label, t in (("coords", coords), ("conn", conn),
                     *per_node_or_cell.items()):
        if t.device != coords.device:
            raise ValueError(f"{name}: {label} is on {t.device}, coords on "
                             f"{coords.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
    N = coords.shape[0]
    C = conn.shape[0]
    if coords.shape != (N, 3) or conn.shape != (C, k):
        raise ValueError(f"{name}: coords [N,3] and conn [C,{k}] expected, "
                         f"got {tuple(coords.shape)}, {tuple(conn.shape)}")
    for label, t in per_node_or_cell.items():
        want = (3 * N,) if label == "u" else (C,)
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: {label} of shape {list(want)} "
                             f"expected, got {tuple(t.shape)}")
    return N, C


def _launch(name: str, coords, conn, u, lam, mu) -> torch.Tensor:
    k = _NODES[name]
    _, C = check_inputs(name, k, coords, conn, u=u, lam=lam, mu=mu)
    if k % 4 == 0 and conn.data_ptr() % 16:
        raise ValueError(f"{name}: conn must be 16-byte aligned")
    dtype = coords.dtype
    out = torch.empty((C, k, 3), dtype=dtype, device=coords.device)
    lib = _library()
    fn = getattr(lib, f"{name}_{'f32' if dtype == torch.float32 else 'f64'}")
    stream = torch.cuda.current_stream(coords.device).cuda_stream
    if name == "tet10_apply":
        t = tet10_tiles(conn)
        err = fn(coords.data_ptr(), t.nodes.data_ptr(), t.lconn.data_ptr(),
                 u.data_ptr(), lam.data_ptr(), mu.data_ptr(), out.data_ptr(),
                 C, t.tile, t.max_nodes, *tet10_rule(), stream)
    else:
        err = fn(coords.data_ptr(), conn.data_ptr(), u.data_ptr(),
                 lam.data_ptr(), mu.data_ptr(), out.data_ptr(), C, stream)
    if err != 0:
        msg = lib.element_apply_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"({msg})")
    if C:                       # an empty batch launches nothing
        LAUNCHES[name] += 1
    return out


def _dispatch(name, reference, coords, conn, u, lam, mu) -> torch.Tensor:
    if coords.device.type == "cpu":
        return reference(coords, conn, u, lam, mu)
    if coords.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {coords.device}")
    return _launch(name, coords, conn, u, lam, mu)


def tet4_apply(coords, conn, u, lam, mu) -> torch.Tensor:
    """Fused Tet4 apply (exact 1-point rule: constant strain)."""
    return _dispatch("tet4_apply", tet4_apply_reference, coords, conn, u,
                     lam, mu)


def hex8_apply(coords, conn, u, lam, mu) -> torch.Tensor:
    """Fused Hex8 apply, 2x2x2 Gauss (reference rule
    FiniteElementAnalysis.jl:163)."""
    return _dispatch("hex8_apply", hex8_apply_reference, coords, conn, u,
                     lam, mu)


def tet10_apply(coords, conn, u, lam, mu) -> torch.Tensor:
    """Fused Tet10 apply, isoparametric with the 4-point order-2 rule (the
    reference's quadratic path, FiniteElementAnalysis.jl:160-168)."""
    return _dispatch("tet10_apply", tet10_apply_reference, coords, conn, u,
                     lam, mu)


# ---------------------------------------------------------------------------
# Plain PyTorch versions: the gather, then the batched strain route of
# ops/elements.apply_element_stiffness
# ---------------------------------------------------------------------------


def _gather(coords, conn, u):
    idx = conn.long()
    return coords[idx], u.reshape(-1, 3)[idx]


def tet4_apply_reference(coords, conn, u, lam, mu) -> torch.Tensor:
    # constant strain: the 1-point rule (weight 1/6, so w*det = V) is exact
    x, ue = _gather(coords, conn, u)
    return apply_element_stiffness(x, ue, lam, mu, "tet4", order=1)


def hex8_apply_reference(coords, conn, u, lam, mu) -> torch.Tensor:
    # 2x2x2 Gauss, all weights 1
    x, ue = _gather(coords, conn, u)
    return apply_element_stiffness(x, ue, lam, mu, "hex8", order=2)


def tet10_apply_reference(coords, conn, u, lam, mu) -> torch.Tensor:
    # the 4-point rule; J varies over a curved element, point by point
    x, ue = _gather(coords, conn, u)
    return apply_element_stiffness(x, ue, lam, mu, "tet10", order=2)
