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
on the card.  The TPU kernels' ``transpose_out=False`` layout ([ek², C],
element on lanes) has no counterpart: Ke stays element-major.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .element_kernels import check_inputs, rule_table
from .elements import element_stiffness

#: kernel launches per wrapper; only a launch of the CUDA kernel counts
LAUNCHES = {"tet4_ke": 0, "hex8_ke": 0, "tet10_ke": 0}

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
