"""Element-stiffness (Ke batch) kernels (counterpart of the Ke half of
``topopteval_tpu/ops/pallas_kernels.py``).

``tet4_ke``, ``hex8_ke`` and ``tet10_ke`` compute the isotropic element
stiffness of every element, gathering each element's node rows
themselves:

    coords [N,3], conn [C,k] int32, lam [C], mu [C]  ->  Ke [C,3k,3k]

``tet4_ke`` uses the exact 1-point rule (constant strain); ``hex8_ke`` and
``tet10_ke`` the order-2 rule of ``element_tables`` (2x2x2 Gauss, 4
points), read from a table argument.  On a CUDA tensor each launches its
hand-written kernel from ``csrc/element_ke.cu`` (built with nvcc on first
use) or raises; it never falls back.  On a CPU tensor it runs its plain
PyTorch version (``*_reference``: the gather plus the batched plain
``element_stiffness``), which is also what the kernels are held against
on the card.  The solve path keeps Ke element-major.

The probe variants of the Ke-formulation probe (tools/ke_probe.py, the
counterpart of tools/tpu_ke_probe.py) compute ``tet4_ke``'s function in
the TPU kernels' lane layout, from pre-gathered coordinates:

    ct [12, Cp], lam2 [1, Cp], mu2 [1, Cp]  ->  Ke [144, Cp] (entry-major)

``tet4_ke_cse`` (common subexpressions in shared memory, then one entry a
thread) and ``tet4_ke_lanes`` (one element a thread, 144 coalesced
stores); ``element_coords_lanes`` builds their inputs.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .element_kernels import check_inputs, rule_table
from .elements import element_stiffness

#: kernel launches per wrapper; only a launch of the CUDA kernel counts
LAUNCHES = {"tet4_ke": 0, "hex8_ke": 0, "tet10_ke": 0, "tet4_ke_cse": 0,
            "tet4_ke_lanes": 0}
#: elements per block of the probe variants (the TPU probe's 512, 1024 and
#: 2048-lane blocks)
LANE_BLOCKS = (128, 256, 512)

_NODES = {"tet4_ke": 4, "hex8_ke": 8, "tet10_ke": 10}
#: wrappers whose kernel reads its rule's dN and w from a table argument
_TABLE_RULE = {"hex8_ke": "hex8", "tet10_ke": "tet10"}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built ``csrc/element_ke.cu`` with its C signatures declared."""
    lib = _build.load("element_ke")
    for name in _NODES:
        n_ptr = 6 if name in _TABLE_RULE else 5
        for suffix in ("f32", "f64"):
            fn = getattr(lib, f"{name}_{suffix}")
            fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_longlong,
                                                       ctypes.c_void_p]
            fn.restype = ctypes.c_int
    for name in ("tet4_ke_cse", "tet4_ke_lanes"):
        for suffix in ("f32", "f64"):
            fn = getattr(lib, f"{name}_{suffix}")
            fn.argtypes = [ctypes.c_void_p] * 4 + [
                ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
    lib.element_ke_error_string.argtypes = [ctypes.c_int]
    lib.element_ke_error_string.restype = ctypes.c_char_p
    return lib


def _launch(name: str, coords, conn, lam, mu) -> torch.Tensor:
    k = _NODES[name]
    _, C = check_inputs(name, k, coords, conn, lam=lam, mu=mu)
    dtype = coords.dtype
    out = torch.empty((C, 3 * k, 3 * k), dtype=dtype, device=coords.device)
    lib = _library()
    fn = getattr(lib, f"{name}_{'f32' if dtype == torch.float32 else 'f64'}")
    stream = torch.cuda.current_stream(coords.device).cuda_stream
    ptrs = [coords.data_ptr(), conn.data_ptr(), lam.data_ptr(),
            mu.data_ptr()]
    if name in _TABLE_RULE:
        ptrs.append(rule_table(_TABLE_RULE[name], dtype,
                               coords.device).data_ptr())
    with torch.cuda.device(coords.device):
        err = fn(*ptrs, out.data_ptr(), C, stream)
    if err != 0:
        msg = lib.element_ke_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"({msg})")
    if C:                       # an empty batch launches nothing
        LAUNCHES[name] += 1
    return out


def _dispatch(name, reference, coords, conn, lam, mu) -> torch.Tensor:
    if coords.device.type == "cpu":
        return reference(coords, conn, lam, mu)
    if coords.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {coords.device}")
    return _launch(name, coords, conn, lam, mu)


def tet4_ke(coords, conn, lam, mu) -> torch.Tensor:
    """Tet4 Ke batch [C,12,12] (exact 1-point rule: constant strain)."""
    return _dispatch("tet4_ke", tet4_ke_reference, coords, conn, lam, mu)


def hex8_ke(coords, conn, lam, mu) -> torch.Tensor:
    """Hex8 Ke batch [C,24,24], 2x2x2 Gauss."""
    return _dispatch("hex8_ke", hex8_ke_reference, coords, conn, lam, mu)


def tet10_ke(coords, conn, lam, mu) -> torch.Tensor:
    """Tet10 Ke batch [C,30,30], isoparametric 4-point rule."""
    return _dispatch("tet10_ke", tet10_ke_reference, coords, conn, lam, mu)


# ---------------------------------------------------------------------------
# The probe variants: Ke in the lane layout [144, Cp]
# ---------------------------------------------------------------------------


def element_coords_lanes(coords, conn, block: int):
    """(ct [12, Cp], Cp) from node coordinates [N, 3] and conn [C, 4]: the
    gathered coordinates of each element down a column (row 3k+a is node
    k's coordinate a), zero-padded to Cp, the next multiple of ``block``
    (tools/tpu_ke_probe.py:116-120)."""
    C = conn.shape[0]
    Cp = -(-C // block) * block
    ct = coords.new_zeros((12, Cp))
    ct[:, :C] = coords[conn.long()].reshape(C, 12).t()
    return ct, Cp


def pad_lanes(values, Cp: int):
    """A per-element vector [C] as the zero-padded lane row [1, Cp]."""
    out = values.new_zeros((1, Cp))
    out[0, :values.shape[0]] = values
    return out


def _check_lanes(name: str, ct, lam2, mu2, block: int) -> int:
    if block not in LANE_BLOCKS:
        raise ValueError(f"{name}: block must be one of {LANE_BLOCKS}, got "
                         f"{block}")
    if ct.dim() != 2 or ct.shape[0] != 12:
        raise ValueError(f"{name}: ct must be [12, Cp], got "
                         f"{tuple(ct.shape)}")
    Cp = ct.shape[1]
    if Cp % block:
        raise ValueError(f"{name}: Cp={Cp} is not a multiple of block="
                         f"{block} (pad with element_coords_lanes)")
    for label, t in (("lam2", lam2), ("mu2", mu2)):
        if tuple(t.shape) != (1, Cp):
            raise ValueError(f"{name}: {label} must be [1, {Cp}], got "
                             f"{tuple(t.shape)}")
        if t.dtype != ct.dtype or t.device != ct.device:
            raise ValueError(f"{name}: {label} is {t.dtype} on {t.device}, "
                             f"ct {ct.dtype} on {ct.device}")
    if ct.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: {ct.dtype} is not supported (float32 or "
                        "float64)")
    return Cp


def _lanes(name: str, ct, lam2, mu2, block: int) -> torch.Tensor:
    Cp = _check_lanes(name, ct, lam2, mu2, block)
    if ct.device.type == "cpu":
        return tet4_ke_lanes_reference(ct, lam2, mu2)
    if ct.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {ct.device}")
    ct, lam2, mu2 = ct.contiguous(), lam2.contiguous(), mu2.contiguous()
    out = torch.empty((144, Cp), dtype=ct.dtype, device=ct.device)
    lib = _library()
    fn = getattr(lib, f"{name}_{'f32' if ct.dtype == torch.float32 else 'f64'}")
    stream = torch.cuda.current_stream(ct.device).cuda_stream
    with torch.cuda.device(ct.device):
        err = fn(ct.data_ptr(), lam2.data_ptr(), mu2.data_ptr(),
                 out.data_ptr(), Cp, block, stream)
    if err != 0:
        msg = lib.element_ke_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"({msg})")
    if Cp:
        LAUNCHES[name] += 1
    return out


def tet4_ke_cse(ct, lam2, mu2, block: int = 256) -> torch.Tensor:
    """Tet4 Ke batch in the lane layout [144, Cp], the common
    subexpressions (lam V g, mu V g, mu V g_i . g_j) in a shared tile."""
    return _lanes("tet4_ke_cse", ct, lam2, mu2, block)


def tet4_ke_lanes(ct, lam2, mu2, block: int = 256) -> torch.Tensor:
    """Tet4 Ke batch in the lane layout [144, Cp], one element a thread."""
    return _lanes("tet4_ke_lanes", ct, lam2, mu2, block)


#: the kernel of each element type (ops/elements.element_stiffness picks
#: from here for the rules ``has_ke_kernel`` names)
KE_KERNELS = {"tet4": tet4_ke, "hex8": hex8_ke, "tet10": tet10_ke}


# ---------------------------------------------------------------------------
# Plain PyTorch versions: the gather, then the batched einsum route
# ---------------------------------------------------------------------------


def tet4_ke_reference(coords, conn, lam, mu) -> torch.Tensor:
    return element_stiffness(coords[conn.long()], lam, mu, "tet4", order=1,
                             use_kernel=False)


def hex8_ke_reference(coords, conn, lam, mu) -> torch.Tensor:
    return element_stiffness(coords[conn.long()], lam, mu, "hex8", order=2,
                             use_kernel=False)


def tet10_ke_reference(coords, conn, lam, mu) -> torch.Tensor:
    return element_stiffness(coords[conn.long()], lam, mu, "tet10",
                             order=2, use_kernel=False)


def tet4_ke_lanes_reference(ct, lam2, mu2) -> torch.Tensor:
    """Plain version of both probe variants, which compute the same values
    (they differ in where the common subexpressions live and how the
    [144, Cp] tile is stored): the probe kernels' arithmetic, one lane row
    per entry."""
    x = list(ct)
    e = [[x[3 * (i + 1) + a] - x[a] for a in range(3)] for i in range(3)]
    c0 = e[1][1] * e[2][2] - e[1][2] * e[2][1]
    c1 = e[1][2] * e[2][0] - e[1][0] * e[2][2]
    c2 = e[1][0] * e[2][1] - e[1][1] * e[2][0]
    det = e[0][0] * c0 + e[0][1] * c1 + e[0][2] * c2
    inv_det = 1.0 / torch.where(det == 0, torch.ones_like(det), det)
    adj = [[c0, e[0][2] * e[2][1] - e[0][1] * e[2][2],
            e[0][1] * e[1][2] - e[0][2] * e[1][1]],
           [c1, e[0][0] * e[2][2] - e[0][2] * e[2][0],
            e[0][2] * e[1][0] - e[0][0] * e[1][2]],
           [c2, e[0][1] * e[2][0] - e[0][0] * e[2][1],
            e[0][0] * e[1][1] - e[0][1] * e[1][0]]]
    g = [[adj[a][i] * inv_det for a in range(3)] for i in range(3)]
    g = [[-(g[0][a] + g[1][a] + g[2][a]) for a in range(3)]] + g
    vol = det / 6.0
    lv, mv = lam2[0] * vol, mu2[0] * vol
    lg = [[lv * g[i][a] for a in range(3)] for i in range(4)]
    mg = [[mv * g[i][a] for a in range(3)] for i in range(4)]
    rows = []
    for i in range(4):
        for a in range(3):
            for j in range(4):
                md = mg[i][0] * g[j][0] + mg[i][1] * g[j][1] \
                    + mg[i][2] * g[j][2]
                for b in range(3):
                    v = lg[i][a] * g[j][b] + mg[i][b] * g[j][a]
                    rows.append(v + md if a == b else v)
    return torch.stack(rows)


#: the cse variant's plain version (the same values)
tet4_ke_cse_reference = tet4_ke_lanes_reference
