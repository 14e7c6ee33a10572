"""Fused stencil matvec on structured boxes (counterpart of
``topopteval_tpu/ops/pallas_stencil.py``).

``stencil_matvec`` computes y = K_raw u on an (nx, ny, nz)-cell box of
6-tet hexes without any connectivity: with the flat DOF vector numbered
dof = ((z*NY + y)*NX + x)*3 + a over the (NZ, NY, NX) node lattice,

    y[n, a] = sum over the <= 8 cells c that touch node n, n being corner j
              of c:  esc[c] * sum_k sum_b Ke[3j+a, 3k+b] (u[node_k(c), b] - u[n, b])

``ke`` is the assembled 24x24 hex stiffness in VTK corner-major order
(``StructuredStiffnessOperator._hex_ke``); ``esc`` is an optional per-hex
Young's-modulus scale grid [nz, ny, nx] (``None`` means 1).  Subtracting
the output node's own value is exact, because the rows of Ke sum to zero
over the corners (rigid-body translation), and it keeps float32 accurate:
the kernel then sums differences of neighbouring values (gradients), not
large terms that cancel.

The same function, cell by cell through the hex's six tets (the split of
grid.py, each with constant gradients g [6, 4, 3] and volume vol [6]).
On a box the six tets are the paths from corner 0 to corner 6 along the
three axes in each order, so each tet's gradient field is its path's
three edges over their lengths, and g reduces to 1/dx, 1/dy, 1/dz:
``table`` is :func:`cell_table`, [1/dx, 1/dy, 1/dz, vol*lam, vol*mu] in
the working dtype.

On a CUDA tensor the call launches one of the two hand-written kernels of
``csrc/stencil_apply.cu`` or raises; it never falls back:

- ``plane``  (default) the six-tet cell form from ``table``: a block
  marches an x-y tile of cells along z (the counterpart of the per-plane
  ``_stencil_kernel``); ``table`` is required;
- ``window`` the Ke form: a block stages a z-blocked tile of ``u`` and its
  halo in shared memory first (the counterpart of ``_window_kernel``);
  opt-in through ``kernel="window"`` or ``TOPOPT_STENCIL_KERNEL=window``.

On a CPU tensor it runs ``stencil_matvec_reference``, the plain PyTorch
version, which is also what the kernels are held against on the card.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Optional, Sequence

import numpy as np
import torch

from .. import _build
from ..grid import _TET_SPLIT

#: kernel launches per wrapper; only a launch of the CUDA kernel counts
LAUNCHES = {"stencil_plane": 0, "stencil_window": 0}

KERNELS = ("plane", "window")

#: hex corner offsets in (iz, iy, ix), VTK order (matches grid.py)
CORNER_OFFSETS = ((0, 0, 0), (0, 0, 1), (0, 1, 1), (0, 1, 0),
                  (1, 0, 0), (1, 0, 1), (1, 1, 1), (1, 1, 0))
#: the plane kernel's cell table: 1/dx, 1/dy, 1/dz, vol*lam, vol*mu
#: (csrc/stencil_apply.cu NT)
CELL_TABLE = 5
#: grid._TET_SPLIT's tets as paths 0 -> P1 -> P2 -> 6 along axes (x 0,
#: y 1, z 2): (P1, P2, axes), in the split's order
TET_PATHS = (((1, 2), (0, 1, 2)), ((3, 2), (1, 0, 2)), ((3, 7), (1, 2, 0)),
             ((4, 7), (2, 1, 0)), ((4, 5), (2, 0, 1)), ((1, 5), (0, 2, 1)))


def path_gradients(inv_h) -> np.ndarray:
    """The gradients g [6, 4, 3] of the six path tets of a box whose
    cells have 1/dx, 1/dy, 1/dz = ``inv_h``: vertex 0 -e_A/h_A, P1
    e_A/h_A - e_B/h_B, P2 e_B/h_B - e_C/h_C, corner 6 e_C/h_C."""
    g = np.zeros((6, 4, 3))
    for t, (_, axes) in enumerate(TET_PATHS):
        s = [np.eye(3)[ax] * inv_h[ax] for ax in axes]
        g[t] = [-s[0], s[0] - s[1], s[1] - s[2], s[2]]
    return g


def cell_table(g, vol, lam: float, mu: float, dtype=torch.float64,
               device="cpu") -> torch.Tensor:
    """The plane kernel's per-level table [CELL_TABLE] from the six tets'
    gradients g [6, 4, 3] (vertex order of grid._TET_SPLIT) and volumes
    vol [6]: 1/dx, 1/dy, 1/dz, vol*lam, vol*mu, in float64 on the host,
    then cast.  Raises unless g is the six path tets of one box of equal
    volumes, the only tets the kernel computes."""
    g = np.asarray(g, np.float64).reshape(6, 4, 3)
    vol = np.asarray(vol, np.float64).reshape(6)
    inv_h = np.abs(g).reshape(-1, 3).max(axis=0)
    want = path_gradients(inv_h)
    scale = float(inv_h.max())
    for t, ((p1, p2), _) in enumerate(TET_PATHS):
        # the path tet's vertices, in the split's order
        path = [0, p1, p2, 6]
        perm = [path.index(int(v)) for v in _TET_SPLIT[t]]
        if not np.abs(g[t] - want[t][perm]).max() <= 1e-12 * scale:
            raise ValueError("cell_table: the gradients are not the six "
                             "path tets of a box")
    if not np.abs(vol - vol[0]).max() <= 1e-12 * abs(vol[0]):
        raise ValueError("cell_table: the six tets differ in volume")
    table = np.array([*inv_h, vol[0] * float(lam), vol[0] * float(mu)])
    return torch.as_tensor(table, dtype=dtype, device=device)


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def kernel_choice(kernel: Optional[str] = None) -> str:
    """``kernel`` if given, else ``TOPOPT_STENCIL_KERNEL`` (default
    ``plane``)."""
    choice = (kernel or os.environ.get("TOPOPT_STENCIL_KERNEL", "plane")
              ).lower()
    if choice not in KERNELS:
        raise ValueError(f"stencil kernel must be one of {KERNELS}, got "
                         f"{choice!r}")
    return choice


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built ``csrc/stencil_apply.cu`` with its C signatures declared."""
    lib = _build.load("stencil_apply")
    for name in LAUNCHES:
        for suffix in ("f32", "f64"):
            fn = getattr(lib, f"{name}_{suffix}")
            # the plane kernel also takes its z chunk (0: its own choice)
            fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                           + [ctypes.c_int] * (name == "stencil_plane")
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
    lib.stencil_plane_chunk.argtypes = [ctypes.c_int] * 4
    lib.stencil_plane_chunk.restype = ctypes.c_int
    lib.stencil_apply_error_string.argtypes = [ctypes.c_int]
    lib.stencil_apply_error_string.restype = ctypes.c_char_p
    return lib


def _check(u, esc, ke, dims, table=None) -> None:
    nx, ny, nz = dims
    if min(nx, ny, nz) < 1:
        raise ValueError(f"stencil_matvec: dims must be positive, got {dims}")
    if u.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"stencil_matvec: float32 or float64 expected, got "
                        f"{u.dtype}")
    n_dofs = 3 * (nx + 1) * (ny + 1) * (nz + 1)
    if u.numel() != n_dofs:
        raise ValueError(f"stencil_matvec: u has {u.numel()} entries, the "
                         f"{dims} box {n_dofs} DOFs")
    if tuple(ke.shape) != (24, 24):
        raise ValueError(f"stencil_matvec: ke must be [24, 24], got "
                         f"{tuple(ke.shape)}")
    if table is not None and tuple(table.shape) != (CELL_TABLE,):
        raise ValueError(f"stencil_matvec: table must be [{CELL_TABLE}], "
                         f"got {tuple(table.shape)}")
    if esc is not None and tuple(esc.shape) != (nz, ny, nx):
        raise ValueError(f"stencil_matvec: esc must be [nz, ny, nx] = "
                         f"{(nz, ny, nx)}, got {tuple(esc.shape)}")
    for label, t in (("ke", ke), ("esc", esc), ("table", table)):
        if t is None:
            continue
        if t.dtype != u.dtype:
            raise TypeError(f"stencil_matvec: {label} is {t.dtype}, u "
                            f"{u.dtype}")
        if t.device != u.device:
            raise ValueError(f"stencil_matvec: {label} is on {t.device}, u "
                             f"on {u.device}")
    for label, t in (("u", u), ("ke", ke), ("esc", esc), ("table", table)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"stencil_matvec: {label} must be contiguous")


def _launch(name: str, u, esc, coef, dims) -> torch.Tensor:
    """One launch of ``name`` with ``coef`` its coefficients: the cell
    table (plane) or Ke (window)."""
    y = torch.empty_like(u)
    lib = _library()
    fn = getattr(lib, f"{name}_{'f32' if u.dtype == torch.float32 else 'f64'}")
    stream = torch.cuda.current_stream(u.device).cuda_stream
    nx, ny, nz = dims
    chunk = (0,) if name == "stencil_plane" else ()
    err = fn(u.data_ptr(), None if esc is None else esc.data_ptr(),
             coef.data_ptr(), y.data_ptr(), nx, ny, nz, *chunk, stream)
    if err != 0:
        msg = lib.stencil_apply_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"({msg})")
    LAUNCHES[name] += 1
    return y


def stencil_matvec(u: torch.Tensor, esc: Optional[torch.Tensor],
                   ke: torch.Tensor, dims: Sequence[int],
                   kernel: Optional[str] = None, *,
                   table: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = K_raw u on the (nx, ny, nz)-cell box (see the module docstring).

    ``u`` [3*NX*NY*NZ], ``esc`` [nz, ny, nx] or None, ``ke`` [24, 24] and
    ``table`` [CELL_TABLE] (:func:`cell_table` of the same tets; the plane
    kernel needs it on the card), all of one dtype (float32 or float64) on
    one device and contiguous."""
    dims = tuple(int(d) for d in dims)
    choice = kernel_choice(kernel)
    _check(u, esc, ke, dims, table)
    if u.device.type == "cpu":
        return stencil_matvec_reference(u, esc, ke, dims)
    if u.device.type != "cuda":
        raise ValueError(f"stencil_matvec: no kernel for device {u.device}")
    if choice == "plane":
        if table is None:
            raise ValueError("stencil_matvec: the plane kernel needs the "
                             "cell table (table=cell_table(...))")
        return _launch("stencil_plane", u, esc, table, dims)
    return _launch("stencil_window", u, esc, ke, dims)


# ---------------------------------------------------------------------------
# Plain PyTorch version: shifted views of the node lattice, the same
# difference form and order as the kernels (inner sum per cell, times esc,
# then the 8 shifted adds)
# ---------------------------------------------------------------------------


def stencil_matvec_reference(u, esc, ke, dims) -> torch.Tensor:
    nx, ny, nz = (int(d) for d in dims)
    u4 = u.reshape(nz + 1, ny + 1, nx + 1, 3)
    # corner values of every cell: [nz, ny, nx, 8, 3]
    uc = torch.stack([u4[oz:oz + nz, oy:oy + ny, ox:ox + nx]
                      for (oz, oy, ox) in CORNER_OFFSETS], dim=3)
    ke4 = ke.reshape(8, 3, 8, 3)
    y4 = torch.zeros_like(u4)
    for j, (oz, oy, ox) in enumerate(CORNER_OFFSETS):
        diff = uc - uc[:, :, :, j:j + 1, :]
        f_j = torch.einsum("akb,zyxkb->zyxa", ke4[j], diff)
        if esc is not None:
            f_j = esc[..., None] * f_j
        y4[oz:oz + nz, oy:oy + ny, ox:ox + nx] += f_j
    return y4.reshape(u.shape)
