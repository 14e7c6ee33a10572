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

import ctypes
import functools

import torch

from .. import _build
from .elements import apply_element_stiffness, element_tables

#: kernel launches per wrapper; only a launch of the CUDA kernel counts
LAUNCHES = {"tet4_apply": 0, "hex8_apply": 0, "tet10_apply": 0}

_NODES = {"tet4_apply": 4, "hex8_apply": 8, "tet10_apply": 10}
#: wrappers whose kernel reads its rule's dN and w from a table argument
_TABLE_RULE = {"tet10_apply": "tet10"}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built ``csrc/element_apply.cu`` with its C signatures declared."""
    lib = _build.load("element_apply")
    for name in _NODES:
        n_ptr = 7 if name in _TABLE_RULE else 6
        for suffix in ("f32", "f64"):
            fn = getattr(lib, f"{name}_{suffix}")
            fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_longlong,
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
    isoparametric kernels load it instead of carrying the numbers."""
    _, dN, w = element_tables(element_type, 2)
    flat = torch.cat([torch.as_tensor(dN, dtype=torch.float64).reshape(-1),
                      torch.as_tensor(w, dtype=torch.float64)])
    return flat.to(dtype=dtype, device=device)


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
    ptrs = [coords.data_ptr(), conn.data_ptr(), u.data_ptr(),
            lam.data_ptr(), mu.data_ptr()]
    if name in _TABLE_RULE:
        ptrs.append(rule_table(_TABLE_RULE[name], dtype,
                               coords.device).data_ptr())
    err = fn(*ptrs, out.data_ptr(), C, stream)
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
