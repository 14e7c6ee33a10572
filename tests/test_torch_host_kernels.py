"""The CUDA sources of the kernels this slice redesigned, built for the
host CPU (``tools/host_kernels``: g++ against a stand-in of the CUDA
runtime, each block's threads as ``std::thread``s), held to the plain
versions.

This runs the kernels' own indexing, staging, barriers and order of sums
where there is no card (contraction off: the card may fuse a multiply
and an add where the host rounds twice, so bits are compared only
between kernels built here):

- B10 ``stencil_window`` gives B3 ``stencil_plane``'s bits at one cell,
  odd boxes and tiles cut at every face, uniform and with a per-cell
  scale, in float64 and float32, within 1e-12 / 1e-5 of the plain
  version; B3's z chunks all give its bits;
- B8's ``hex8_ke`` and ``tet10_ke`` (one kernel: node pairs i <= j and
  their transposes, E elements a block) match their plain versions and
  are exactly symmetric on batches of one element, under one block, one
  block and one more, and several.
"""

import ctypes

import numpy as np
import pytest
import torch

import topopteval_tpu_torch as tt
from topopteval_tpu_torch.ops import ke_kernels as kk
from topopteval_tpu_torch.ops.element_kernels import rule_table
from topopteval_tpu_torch.ops.stencil import stencil_matvec_reference
from topopteval_tpu_torch.tools import host_kernels

tt.set_verbosity(False)
torch.set_num_threads(1)

TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
LAM, MU = tt.lame_parameters(1.0, 0.3)


def _sfx(dtype):
    return "f32" if dtype == torch.float32 else "f64"


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("host_kernels"))
    st = host_kernels.build("stencil_apply", out)
    ke = host_kernels.build("element_ke", out)
    for name in ("stencil_plane", "stencil_window"):
        for sfx in ("f32", "f64"):
            fn = getattr(st, f"{name}_{sfx}")
            fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                           + [ctypes.c_int] * (name == "stencil_plane")
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
    for name in ("hex8_ke", "tet10_ke"):
        for sfx in ("f32", "f64"):
            fn = getattr(ke, f"{name}_{sfx}")
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong,
                                                   ctypes.c_void_p]
            fn.restype = ctypes.c_int
    return {"stencil": st, "ke": ke}


def _stencil(lib, name, u, op, zn=None):
    y = torch.full_like(u, float("nan"))
    nx, ny, nz = op.dims
    extra = () if zn is None else (zn,)
    err = getattr(lib, f"{name}_{_sfx(u.dtype)}")(
        u.data_ptr(), None if op.escale is None else op.escale.data_ptr(),
        op.table.data_ptr(), y.data_ptr(), nx, ny, nz, *extra, None)
    assert err == 0
    return y


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("simp", [False, True], ids=["uniform", "simp"])
@pytest.mark.parametrize("dims,box", [
    ((1, 1, 1), (0.7, 0.5, 0.3)),
    ((7, 5, 3), (3.5, 2.0, 0.9)),
    ((15, 8, 7), (7.5, 2.4, 1.4)),
    ((9, 14, 5), (1.2, 3.1, 0.4)),
])
def test_host_b10_gives_b3s_bits(libs, dims, box, simp, dtype):
    nx, ny, nz = dims
    rng = np.random.default_rng(0)
    op = tt.StructuredStiffnessOperator.build(
        nx, ny, nz, (0, 0, 0), box, LAM, MU,
        escale=rng.uniform(0.1, 1.0, (nz, ny, nx)) if simp else None,
        dtype=dtype, device="cpu")
    u = torch.as_tensor(rng.standard_normal(op.n_dofs), dtype=dtype)
    window = _stencil(libs["stencil"], "stencil_window", u, op)
    plane = _stencil(libs["stencil"], "stencil_plane", u, op, zn=0)
    assert torch.equal(window, plane)
    ref = stencil_matvec_reference(u, op.escale, op.ke, dims)
    assert float((window - ref).abs().max()) <= TOL[dtype] \
        * float(ref.abs().max())


def test_host_b3_z_chunks_give_the_same_bits(libs):
    rng = np.random.default_rng(3)
    op = tt.StructuredStiffnessOperator.build(
        9, 4, 7, (0, 0, 0), (4.5, 1.6, 2.1), LAM, MU,
        escale=rng.uniform(0.1, 1.0, (7, 4, 9)), dtype=torch.float32,
        device="cpu")
    u = torch.as_tensor(rng.standard_normal(op.n_dofs), dtype=torch.float32)
    first = _stencil(libs["stencil"], "stencil_plane", u, op, zn=0)
    for zn in (1, 2, 3, 8):
        assert torch.equal(_stencil(libs["stencil"], "stencil_plane", u, op,
                                    zn=zn), first)


def _ke_batch(element_type, n, dtype, seed=0):
    rng = np.random.default_rng(seed)
    if element_type == "hex8":
        mesh = tt.generate_grid_hex(5, 3, 2, (0, 0, 0), (5.0, 3.0, 2.0))
    else:
        mesh = tt.generate_grid_tet(3, 2, 2, (0, 0, 0),
                                    (3.0, 2.0, 2.0)).to_quadratic()
    coords = mesh.coords + 0.1 * rng.standard_normal(mesh.coords.shape)
    return (torch.as_tensor(coords, dtype=dtype),
            torch.as_tensor(mesh.conn[:n].astype(np.int32)),
            torch.as_tensor(rng.uniform(0.5, 2.0, n), dtype=dtype),
            torch.as_tensor(rng.uniform(0.5, 2.0, n), dtype=dtype))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("element_type,n", [
    ("hex8", 1), ("hex8", 7), ("hex8", 9), ("hex8", 30), ("tet10", 1),
    ("tet10", 9), ("tet10", 30)])
def test_host_ke_matches_plain_version(libs, element_type, n, dtype):
    args = _ke_batch(element_type, n, dtype)
    k = args[1].shape[1]
    out = torch.full((n, 3 * k, 3 * k), float("nan"), dtype=dtype)
    err = getattr(libs["ke"], f"{element_type}_ke_{_sfx(dtype)}")(
        *(t.data_ptr() for t in args),
        rule_table(element_type, dtype, torch.device("cpu")).data_ptr(),
        out.data_ptr(), n, None)
    assert err == 0
    ref = getattr(kk, f"{element_type}_ke_reference")(*args)
    assert float((out - ref).abs().max()) <= TOL[dtype] \
        * float(ref.abs().max())
    assert torch.equal(out, out.transpose(1, 2))
