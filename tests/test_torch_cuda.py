"""CUDA kernels of the PyTorch port against their plain versions, on the card.

Every test here needs an NVIDIA GPU and skips without one.  This file
imports neither JAX nor the JAX package, so it also runs on a machine
that has only PyTorch; tests/conftest.py imports JAX, so run it there
with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances are relative to the largest plain-version entry: 1e-12 in
float64 and 1e-5 in float32 (the kernels contract multiply-adds into
FMAs and sum in another order than the batched plain version).  The two
stencil kernels compute one function in two forms (the plane kernel from
the six tets' cell table, the window kernel from Ke): each repeats its
own output bit for bit, and they agree within the tolerance.  The tet10
apply and the Ke-batch kernels run on curved tet10 elements (mid-edge
nodes off their edges) with per-element materials.
"""

import os

import numpy as np
import pytest
import torch

import topopteval_tpu_torch as tt
from topopteval_tpu_torch.ops import element_kernels as ek
from topopteval_tpu_torch.ops import stencil

pytestmark = pytest.mark.cuda

TOL = {torch.float64: 1e-12, torch.float32: 1e-5}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(element_type, dtype, device, nx=7, ny=3, nz=2, seed=0):
    """A perturbed box with per-element materials; C is not a multiple of
    the kernels' block size, so the ragged last block is exercised."""
    rng = np.random.default_rng(seed)
    gen = tt.generate_grid_tet if element_type == "tet4" else \
        tt.generate_grid_hex
    mesh = gen(nx, ny, nz, (0, 0, 0), (2.0 * nx, 1.5 * ny, 1.0 * nz))
    coords = mesh.coords + rng.uniform(-0.1, 0.1, mesh.coords.shape)
    C = mesh.n_cells

    def t(a, dt=dtype):
        return torch.as_tensor(a, dtype=dt, device=device)

    return (t(coords), t(mesh.conn, torch.int32),
            t(rng.standard_normal(mesh.n_dofs)),
            t(rng.uniform(0.1, 2.0, C)), t(rng.uniform(0.1, 2.0, C)))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("element_type,kernel,plain", [
    ("tet4", ek.tet4_apply, ek.tet4_apply_reference),
    ("hex8", ek.hex8_apply, ek.hex8_apply_reference),
])
def test_kernel_matches_plain_version(cuda, element_type, kernel, plain,
                                      dtype):
    args = _inputs(element_type, dtype, cuda)
    before = ek.LAUNCHES[kernel.__name__]
    out = kernel(*args)
    torch.cuda.synchronize()
    assert ek.LAUNCHES[kernel.__name__] == before + 1
    ref = plain(*args)
    scale = float(ref.abs().max())
    assert float((out - ref).abs().max()) <= TOL[dtype] * scale


def test_kernel_handles_empty_batch(cuda):
    coords, _, u, _, _ = _inputs("tet4", torch.float64, cuda)
    empty = torch.zeros((0, 4), dtype=torch.int32, device=cuda)
    none = torch.zeros(0, dtype=torch.float64, device=cuda)
    before = ek.LAUNCHES["tet4_apply"]
    out = ek.tet4_apply(coords, empty, u, none, none)
    assert out.shape == (0, 4, 3)
    assert ek.LAUNCHES["tet4_apply"] == before


def test_wrapper_rejects_bad_inputs(cuda):
    coords, conn, u, lam, mu = _inputs("tet4", torch.float64, cuda)
    with pytest.raises(TypeError):
        ek.tet4_apply(coords, conn.long(), u, lam, mu)
    with pytest.raises(TypeError):
        ek.tet4_apply(coords, conn, u.float(), lam, mu)
    with pytest.raises(ValueError, match="contiguous"):
        ek.tet4_apply(coords, conn, u, lam.repeat(2)[::2], mu)
    with pytest.raises(ValueError):
        ek.tet4_apply(coords, conn[:, :3].contiguous(), u, lam, mu)


@pytest.mark.parametrize("element_type", ["tet4", "hex8"])
def test_operator_on_cuda_matches_cpu(cuda, element_type):
    gen = tt.generate_grid_tet if element_type == "tet4" else \
        tt.generate_grid_hex
    mesh = gen(6, 3, 2, (0, 0, 0), (6.0, 3.0, 2.0))
    u = np.random.default_rng(1).standard_normal(mesh.n_dofs)
    out = {}
    for device in ("cpu", "cuda"):
        p = tt.setup_problem(mesh, dtype=torch.float64, device=device)
        tt.assemble_stiffness_matrix(p, *tt.lame_parameters(1.0, 0.3))
        tt.apply_fixed_boundary(p, tt.nodes_at_plane(mesh, 0, 0.0))
        op = p.build_operator()
        out[device] = op.matvec(torch.as_tensor(u, device=device)).cpu()
    scale = float(out["cpu"].abs().max())
    assert float((out["cuda"] - out["cpu"]).abs().max()) <= 1e-12 * scale


def _stencil_inputs(dims, dtype, device, simp, seed=0):
    """((u, esc, ke, dims), the cell table) on a box of non-cubic
    cells."""
    nx, ny, nz = dims
    rng = np.random.default_rng(seed)
    op = tt.StructuredStiffnessOperator.build(
        nx, ny, nz, (0, 0, 0), (0.5 * nx, 0.4 * ny, 0.3 * nz),
        *tt.lame_parameters(1.0, 0.3),
        escale=rng.uniform(0.1, 1.0, (nz, ny, nx)) if simp else None,
        dtype=dtype, device=device)
    u = torch.as_tensor(rng.standard_normal(op.n_dofs), dtype=dtype,
                        device=device)
    return (u, op.escale, op.ke, dims), op.table


STENCIL_DIMS = [(7, 5, 3), (1, 1, 1), (40, 9, 6), (25, 8, 2), (31, 7, 17)]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("simp", [False, True], ids=["uniform", "simp"])
@pytest.mark.parametrize("dims", STENCIL_DIMS)
@pytest.mark.parametrize("kernel", ["plane", "window"])
def test_stencil_kernel_matches_plain_version(cuda, kernel, dims, simp,
                                              dtype):
    """Odd dims: every boundary case, ragged tiles and z chunks (31 x 7
    cells is one plane-kernel tile of nodes less one row and column; the
    scale-2 box 25 x 8 x 2); each kernel repeats its own bits."""
    args, table = _stencil_inputs(dims, dtype, cuda, simp)
    name = f"stencil_{kernel}"
    before = dict(stencil.LAUNCHES)
    out = stencil.stencil_matvec(*args, kernel=kernel, table=table)
    again = stencil.stencil_matvec(*args, kernel=kernel, table=table)
    torch.cuda.synchronize()
    # a CUDA tensor never reaches the plain version: one launch per call
    assert stencil.LAUNCHES[name] == before[name] + 2
    assert sum(stencil.LAUNCHES.values()) == sum(before.values()) + 2
    ref = stencil.stencil_matvec_reference(*args)
    scale = float(ref.abs().max())
    assert float((out - ref).abs().max()) <= TOL[dtype] * scale
    assert torch.equal(out, again)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_stencil_kernels_agree_within_tolerance(cuda, dtype):
    """The plane kernel (six-tet cell form) and the window kernel (Ke) sum in
    different orders: each within the tolerance of the plain version and
    of the other, each bit for bit its own repeat."""
    args, table = _stencil_inputs((37, 6, 9), dtype, cuda, simp=True)
    a = stencil.stencil_matvec(*args, kernel="plane", table=table)
    b = stencil.stencil_matvec(*args, kernel="window", table=table)
    ref = stencil.stencil_matvec_reference(*args)
    scale = float(ref.abs().max())
    for out in (a, b):
        assert float((out - ref).abs().max()) <= TOL[dtype] * scale
    assert float((a - b).abs().max()) <= TOL[dtype] * scale
    assert torch.equal(a, stencil.stencil_matvec(*args, kernel="plane",
                                                 table=table))
    assert torch.equal(b, stencil.stencil_matvec(*args, kernel="window",
                                                 table=table))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_stencil_plane_z_chunks_give_the_same_bits(cuda, dtype):
    """Every z chunk of the plane kernel (0: its own choice) gives the
    same bits: the order of a node's sum is fixed by the box alone."""
    args, table = _stencil_inputs((33, 9, 11), dtype, cuda, simp=True)
    u, esc, _, (nx, ny, nz) = args
    lib = stencil._library()
    fn = getattr(lib, "stencil_plane_f32" if dtype == torch.float32
                 else "stencil_plane_f64")
    outs = []
    for zn in (0, 1, 2, 5, 12, 100):
        y = torch.full_like(u, float("nan"))
        err = fn(u.data_ptr(), esc.data_ptr(), table.data_ptr(), y.data_ptr(),
                 nx, ny, nz, zn, torch.cuda.current_stream().cuda_stream)
        assert err == 0
        outs.append(y)
    torch.cuda.synchronize()
    assert 1 <= lib.stencil_plane_chunk(nx, ny, nz,
                                        dtype == torch.float64) <= nz + 1
    for y in outs[1:]:
        assert torch.equal(y, outs[0])
    ref = stencil.stencil_matvec_reference(*args)
    assert float((outs[0] - ref).abs().max()) \
        <= TOL[dtype] * float(ref.abs().max())


def test_stencil_kernel_choice_follows_the_environment(cuda, monkeypatch):
    args, table = _stencil_inputs((6, 4, 2), torch.float64, cuda, simp=False)
    monkeypatch.setenv("TOPOPT_STENCIL_KERNEL", "window")
    before = stencil.LAUNCHES["stencil_window"]
    stencil.stencil_matvec(*args, table=table)
    assert stencil.LAUNCHES["stencil_window"] == before + 1


def test_stencil_wrapper_rejects_bad_inputs(cuda):
    (u, esc, ke, dims), table = _stencil_inputs((6, 4, 2), torch.float64,
                                               cuda, True)
    with pytest.raises(TypeError):
        stencil.stencil_matvec(u.float(), esc, ke, dims, table=table)
    with pytest.raises(ValueError, match="on cpu"):
        stencil.stencil_matvec(u, esc, ke.cpu(), dims, table=table)
    with pytest.raises(ValueError, match="contiguous"):
        stencil.stencil_matvec(u, esc, ke.t(), dims, table=table)
    with pytest.raises(ValueError, match="DOFs"):
        stencil.stencil_matvec(u[3:], esc, ke, dims, table=table)
    before = dict(stencil.LAUNCHES)
    with pytest.raises(ValueError, match="cell table"):
        stencil.stencil_matvec(u, esc, ke, dims, kernel="plane")
    with pytest.raises(ValueError, match="on cpu"):
        stencil.stencil_matvec(u, esc, ke, dims, table=table.cpu())
    with pytest.raises(TypeError):
        stencil.stencil_matvec(u, esc, ke, dims, table=table.float())
    with pytest.raises(ValueError, match=r"\[5\]"):
        stencil.stencil_matvec(u, esc, ke, dims, table=table[:4])
    assert stencil.LAUNCHES == before


def test_multigrid_solve_on_cuda_matches_cpu(cuda):
    mesh = tt.generate_grid_tet(16, 8, 4, (0, 0, 0), (16.0, 8.0, 4.0))
    config = tt.SolverConfig(method="cg", preconditioner="multigrid",
                             tolerance=1e-10, verbose=False)
    out = {}
    for device in ("cpu", "cuda"):
        problem = tt.cantilever_beam(mesh, dtype=torch.float64,
                                     device=device)
        stencil.reset_launch_counts()
        out[device] = tt.solve_system(problem, config)
        assert (stencil.LAUNCHES["stencil_plane"] > 0) == (device == "cuda")
    assert out["cuda"].method == "cg" and out["cuda"].converged
    assert out["cuda"].iterations == out["cpu"].iterations
    assert abs(out["cuda"].energy - out["cpu"].energy) \
        <= 1e-10 * out["cpu"].energy


# ---------------------------------------------------------------------------
# block-ELL kernels (csrc/bell_apply.cu)
# ---------------------------------------------------------------------------


def _bell_inputs(device, vals_dtype, vec_dtype, n=1000, n_cols=900,
                 seed=0, block=True):
    """A random row-compressed matrix in which every seventh row is empty
    (lane padding and unsupported voxel corners look like that)."""
    from topopteval_tpu_torch.ops import bell
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n, 12 * n)
    rows = rows[rows % 7 != 3]
    cols = np.clip(rows * n_cols // n + rng.integers(-60, 61, rows.size), 0,
                   n_cols - 1)
    shape = (rows.size, 3, 3) if block else (rows.size,)
    A = bell.pack_csr(rows, cols, rng.standard_normal(shape), n, n_cols,
                      vals_dtype, device)
    u = torch.as_tensor(rng.standard_normal((3, n_cols)), dtype=vec_dtype,
                        device=device)
    return A, u


@pytest.mark.parametrize("case", ["f32", "f32_lo", "f32_bf16", "f64"])
def test_bell_matvec_kernel_matches_plain_version(cuda, case):
    from topopteval_tpu_torch.ops import bell
    vec = torch.float64 if case == "f64" else torch.float32
    vals = {"f32_bf16": torch.bfloat16, "f64": torch.float64}.get(
        case, torch.float32)
    A, u = _bell_inputs(cuda, vals, vec)
    lo = (A.vals * 1e-7).contiguous() if case == "f32_lo" else None
    before = dict(bell.LAUNCHES)
    out = bell.bell_matvec(u, A, lo)
    torch.cuda.synchronize()
    assert bell.LAUNCHES["bell_matvec"] == before["bell_matvec"] + 1
    assert bell.LAUNCHES["sell_matvec"] == before["sell_matvec"]
    ref = bell.bell_matvec_reference(u, A, lo)
    empty = (A.indptr[1:] == A.indptr[:-1])
    assert bool(empty.any()) and bool((out[:, empty] == 0).all())
    scale = float(ref.abs().max())
    assert float((out - ref).abs().max()) <= TOL[vec] * scale


@pytest.mark.parametrize("case", ["f32", "f32_bf16", "f64"])
def test_sell_matvec_kernel_matches_plain_version(cuda, case):
    from topopteval_tpu_torch.ops import bell
    vec = torch.float64 if case == "f64" else torch.float32
    vals = {"f32_bf16": torch.bfloat16, "f64": torch.float64}.get(
        case, torch.float32)
    T, u = _bell_inputs(cuda, vals, vec, block=False)
    before = bell.LAUNCHES["sell_matvec"]
    out = bell.sell_matvec(u, T)
    torch.cuda.synchronize()
    assert bell.LAUNCHES["sell_matvec"] == before + 1
    ref = bell.sell_matvec_reference(u, T)
    scale = float(ref.abs().max())
    assert float((out - ref).abs().max()) <= TOL[vec] * scale


def test_bell_lo_plane_moves_the_output(cuda):
    """On a rigid translation the hi terms cancel to rounding, so the lo
    plane is what moves the output: out(hi, lo) - out(hi) equals out(lo)
    to 1e-3 relative, and differs from zero."""
    from topopteval_tpu_torch.fem.bell import build_bell_multigrid
    from topopteval_tpu_torch.ops import bell
    mesh = tt.generate_grid_tet(6, 3, 3, (0, 0, 0), (6.0, 3.0, 3.0))
    _, _, info = build_bell_multigrid(mesh, *tt.lame_parameters(1.0, 0.3),
                                      dtype=torch.float32, device=cuda)
    host = info["host_arrays"]
    Np = len(host["L0_indptr"]) - 1
    A = bell.BlockCSR.from_numpy(host["L0_indptr"], host["L0_cols"],
                                 host["L0_vals"], Np, torch.float32, cuda)
    lo = torch.as_tensor(host["fine_vals_lo"], device=cuda)
    u = torch.zeros((3, Np), dtype=torch.float32, device=cuda)
    u[0, :mesh.n_nodes], u[1, :mesh.n_nodes] = 1.0, -0.5
    split = bell.bell_matvec(u, A, lo).double()
    hi = bell.bell_matvec(u, A).double()
    lo_only = bell.bell_matvec(u, A.with_vals(lo)).double()
    assert float((split - hi).abs().max()) > 0.0
    assert float((split - hi - lo_only).norm()) \
        <= 1e-3 * float(lo_only.norm())


def test_bell_wrappers_reject_bad_inputs(cuda):
    from topopteval_tpu_torch.ops import bell
    A, u = _bell_inputs(cuda, torch.float64, torch.float64)
    with pytest.raises(TypeError):
        bell.bell_matvec(u.float(), A)
    with pytest.raises(TypeError, match="lo plane"):
        bell.bell_matvec(u, A, A.vals)
    with pytest.raises(ValueError, match="on cpu"):
        bell.bell_matvec(u.cpu(), A)
    with pytest.raises(ValueError, match="contiguous"):
        bell.bell_matvec(u.t().contiguous().t(), A)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_bell_solve_on_cuda_matches_cpu(cuda, dtype, monkeypatch):
    """The block-ELL route on the card against the same call on the CPU:
    the same iteration count in float64, and both at the direct solve's
    energy."""
    from topopteval_tpu_torch.ops import bell
    monkeypatch.setenv("TOPOPT_MG_CACHE_DIR", "off")
    mesh = tt.generate_grid_tet(12, 4, 4, (0, 0, 0), (12.0, 4.0, 4.0))
    mesh.structured_info = None
    config = tt.SolverConfig(method="cg", preconditioner="multigrid",
                             tolerance=1e-10, verbose=False)
    out = {}
    for device in ("cpu", "cuda"):
        problem = tt.cantilever_beam(mesh, dtype=dtype, device=device)
        bell.reset_launch_counts()
        out[device] = tt.solve_system(problem, config)
        launched = bell.LAUNCHES["bell_matvec"] > 0 \
            and bell.LAUNCHES["sell_matvec"] > 0
        assert launched == (device == "cuda")
    assert out["cuda"].method == "cg" and out["cuda"].converged
    if dtype == torch.float64:
        assert out["cuda"].iterations == out["cpu"].iterations
    assert abs(out["cuda"].energy - out["cpu"].energy) \
        <= 1e-9 * out["cpu"].energy


# ---------------------------------------------------------------------------
# tet10 apply (csrc/element_apply.cu) and Ke batches (csrc/element_ke.cu)
# ---------------------------------------------------------------------------


def _curved_inputs(element_type, dtype, device, nx=5, ny=3, nz=2, seed=0):
    """A box of ``element_type`` whose nodes are moved and, for tet10,
    whose mid-edge nodes are moved off their edges (curved elements), with
    per-element materials; C is not a multiple of any kernel's block."""
    rng = np.random.default_rng(seed)
    gen = tt.generate_grid_hex if element_type == "hex8" else \
        tt.generate_grid_tet
    mesh = gen(nx, ny, nz, (0, 0, 0), (2.0 * nx, 1.5 * ny, 1.0 * nz))
    if element_type == "tet10":
        mesh = mesh.to_quadratic()
    coords = mesh.coords + rng.uniform(-0.1, 0.1, mesh.coords.shape)
    C = mesh.n_cells

    def t(a, dt=dtype):
        return torch.as_tensor(a, dtype=dt, device=device)

    return (t(coords), t(mesh.conn, torch.int32),
            t(rng.standard_normal(mesh.n_dofs)),
            t(rng.uniform(0.1, 2.0, C)), t(rng.uniform(0.1, 2.0, C)))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_tet10_apply_matches_plain_version(cuda, dtype):
    args = _curved_inputs("tet10", dtype, cuda)
    before = ek.LAUNCHES["tet10_apply"]
    out = ek.tet10_apply(*args)
    torch.cuda.synchronize()
    assert ek.LAUNCHES["tet10_apply"] == before + 1
    ref = ek.tet10_apply_reference(*args)
    assert out.shape == ref.shape == (args[1].shape[0], 10, 3)
    scale = float(ref.abs().max())
    assert float((out - ref).abs().max()) <= TOL[dtype] * scale


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("element_type", ["tet4", "hex8", "tet10"])
def test_ke_kernel_matches_plain_version(cuda, element_type, dtype):
    from topopteval_tpu_torch.ops import ke_kernels as kk
    coords, conn, _, lam, mu = _curved_inputs(element_type, dtype, cuda)
    name = f"{element_type}_ke"
    before = dict(kk.LAUNCHES)
    out = kk.KE_KERNELS[element_type](coords, conn, lam, mu)
    torch.cuda.synchronize()
    assert kk.LAUNCHES[name] == before[name] + 1
    assert sum(kk.LAUNCHES.values()) == sum(before.values()) + 1
    ref = getattr(kk, f"{name}_reference")(coords, conn, lam, mu)
    k = conn.shape[1]
    assert out.shape == ref.shape == (conn.shape[0], 3 * k, 3 * k)
    scale = float(ref.abs().max())
    assert float((out - ref).abs().max()) <= TOL[dtype] * scale


def test_element_stiffness_dispatch_on_cuda(cuda):
    """tet4 at any order and hex8/tet10 at order 2 go to the kernels; hex8
    at order 3 and hex20 take the batched plain route on the card."""
    from topopteval_tpu_torch.ops import ke_kernels as kk
    from topopteval_tpu_torch.ops.elements import element_stiffness
    for element_type, order, kernel in (("tet4", 1, "tet4_ke"),
                                        ("tet4", 3, "tet4_ke"),
                                        ("hex8", 2, "hex8_ke"),
                                        ("tet10", 2, "tet10_ke"),
                                        ("hex8", 3, None)):
        coords, conn, _, lam, mu = _curved_inputs(
            element_type, torch.float64, cuda, nx=3, ny=2, nz=1)
        ce = coords[conn.long()]
        before = dict(kk.LAUNCHES)
        ke = element_stiffness(ce, lam, mu, element_type, order)
        plain = element_stiffness(ce, lam, mu, element_type, order,
                                  use_kernel=False)
        torch.cuda.synchronize()
        launched = {n for n in kk.LAUNCHES if kk.LAUNCHES[n] > before[n]}
        assert launched == ({kernel} if kernel else set())
        assert float((ke - plain).abs().max()) \
            <= 1e-12 * float(plain.abs().max())


@pytest.mark.parametrize("name", ["tet10_apply", "tet4_ke", "hex8_ke",
                                  "tet10_ke"])
def test_new_kernels_handle_an_empty_batch(cuda, name):
    from topopteval_tpu_torch.ops import ke_kernels as kk
    element_type = name.split("_")[0]
    coords, _, u, _, _ = _curved_inputs(element_type, torch.float64, cuda,
                                        nx=2, ny=1, nz=1)
    k = {"tet4": 4, "hex8": 8, "tet10": 10}[element_type]
    empty = torch.zeros((0, k), dtype=torch.int32, device=cuda)
    none = torch.zeros(0, dtype=torch.float64, device=cuda)
    counts = ek.LAUNCHES if name == "tet10_apply" else kk.LAUNCHES
    before = counts[name]
    if name == "tet10_apply":
        out = ek.tet10_apply(coords, empty, u, none, none)
        assert out.shape == (0, 10, 3)
    else:
        out = kk.KE_KERNELS[element_type](coords, empty, none, none)
        assert out.shape == (0, 3 * k, 3 * k)
    assert counts[name] == before


def test_new_wrappers_reject_bad_inputs(cuda):
    from topopteval_tpu_torch.ops import ke_kernels as kk
    coords, conn, u, lam, mu = _curved_inputs("tet10", torch.float64, cuda)
    with pytest.raises(TypeError):
        ek.tet10_apply(coords, conn.long(), u, lam, mu)
    with pytest.raises(TypeError):
        ek.tet10_apply(coords, conn, u.float(), lam, mu)
    with pytest.raises(TypeError):
        kk.tet10_ke(coords.half(), conn, lam.half(), mu.half())
    with pytest.raises(ValueError, match="contiguous"):
        kk.tet10_ke(coords, conn, lam.repeat(2)[::2], mu)
    with pytest.raises(ValueError, match="on cpu"):
        kk.tet10_ke(coords, conn, lam.cpu(), mu)
    with pytest.raises(ValueError):
        kk.tet10_ke(coords, conn[:, :4].contiguous(), lam, mu)
    with pytest.raises(ValueError):
        ek.tet10_apply(coords, conn, u[3:], lam, mu)


def test_failed_build_or_launch_raises(cuda, monkeypatch, tmp_path):
    """No quiet fallback: a source that does not compile, and a launch
    whose CUDA call reports an error, each raise, and count no launch."""
    from topopteval_tpu_torch import _build
    from topopteval_tpu_torch.ops import ke_kernels as kk
    coords, conn, _, lam, mu = _curved_inputs("tet4", torch.float64, cuda)
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "element_ke.cu").write_text("this is not CUDA C++\n")
    monkeypatch.setattr(_build, "CSRC_DIR", str(src))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_LOADED", {})
    kk._library.cache_clear()
    before = dict(kk.LAUNCHES)
    try:
        with pytest.raises(RuntimeError, match="nvcc failed"):
            kk.tet4_ke(coords, conn, lam, mu)
    finally:
        kk._library.cache_clear()
    monkeypatch.undo()

    class _Failing:
        """A library whose every entry point reports cudaErrorInvalidValue."""

        def __getattr__(self, name):
            if name == "element_ke_error_string":
                return lambda err: b"invalid argument"
            return lambda *args: 1

    monkeypatch.setattr(kk, "_library", lambda: _Failing())
    with pytest.raises(RuntimeError, match="launch failed"):
        kk.tet4_ke(coords, conn, lam, mu)
    assert kk.LAUNCHES == before


@pytest.mark.parametrize("mode", ["otf", "stored"])
@pytest.mark.parametrize("element_type", ["tet4", "hex8", "tet10"])
def test_quadratic_and_stored_operators_on_cuda_match_cpu(cuda, mode,
                                                          element_type):
    gen = tt.generate_grid_hex if element_type == "hex8" else \
        tt.generate_grid_tet
    mesh = gen(6, 3, 2, (0, 0, 0), (6.0, 3.0, 2.0))
    u = None
    out = {}
    for device in ("cpu", "cuda"):
        p = tt.setup_problem(mesh, interpolation_order=2 if element_type
                             == "tet10" else 1, dtype=torch.float64,
                             mode=mode, device=device)
        if u is None:
            u = np.random.default_rng(1).standard_normal(p.n_dofs)
        tt.assemble_stiffness_matrix(p, *tt.lame_parameters(1.0, 0.3))
        tt.apply_fixed_boundary(p, tt.nodes_at_plane(p.mesh, 0, 0.0))
        op = p.build_operator()
        assert (op.ke is None) == (mode == "otf")
        out[device] = op.matvec(torch.as_tensor(u, device=device)).cpu()
    scale = float(out["cpu"].abs().max())
    assert float((out["cuda"] - out["cpu"]).abs().max()) <= 1e-12 * scale


def test_with_material_costs_one_ke_launch(cuda):
    from topopteval_tpu_torch.ops import ke_kernels as kk
    mesh = tt.generate_grid_tet(6, 3, 2, (0, 0, 0), (6.0, 3.0, 2.0))
    p = tt.setup_problem(mesh, interpolation_order=2, dtype=torch.float64,
                         mode="stored", device=cuda)
    tt.assemble_stiffness_matrix(p, *tt.lame_parameters(1.0, 0.3))
    kk.reset_launch_counts()
    op = p.build_operator()
    assert kk.LAUNCHES["tet10_ke"] == 1
    op2 = op.with_material(op.lam * 2.0, op.mu * 2.0)
    assert kk.LAUNCHES["tet10_ke"] == 2
    u = torch.randn(p.n_dofs, dtype=torch.float64, device=cuda)
    assert float((op2.matvec_raw(u) - 2.0 * op.matvec_raw(u)).abs().max()) \
        <= 1e-12 * float(op2.matvec_raw(u).abs().max())


# ---------------------------------------------------------------------------
# scan-window ELL kernels (csrc/ell_apply.cu)
# ---------------------------------------------------------------------------


def _ell_inputs(device, dtype, block=True, n=1000, n_cols=900, seed=0):
    """pack_ell_rows of random banded triplets in which every seventh row is
    empty, and a component-major vector over the padded columns."""
    from topopteval_tpu_torch.ops import ell
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n, 12 * n)
    rows = rows[rows % 7 != 3]
    cols = np.clip(rows * n_cols // n + rng.integers(-60, 61, rows.size), 0,
                   n_cols - 1)
    shape = (rows.size, 3, 3) if block else (rows.size,)
    pk = ell.pack_ell_rows(rows, cols, rng.standard_normal(shape), n, n_cols)
    t = {k: torch.as_tensor(pk[k], device=device)
         for k in ("cols2", "wblk", "gbounds")}
    t["vals2"] = torch.as_tensor(pk["vals2"], dtype=dtype, device=device)
    u = torch.as_tensor(rng.standard_normal((3, pk["n_cols_p"])),
                        dtype=dtype, device=device)
    return pk, t, u


@pytest.mark.parametrize("cut", [False, True], ids=["packed", "cut_window"])
@pytest.mark.parametrize("block", [True, False], ids=["bell", "sell"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_ell_window_kernels_match_plain_version(cuda, dtype, block, cut):
    """Both layouts of the vectors (component-major, and node-major views
    of a wider buffer), every row and a cut of them, the packed window and
    one cut by hand to kc = 1 (columns outside it contribute zero)."""
    from topopteval_tpu_torch.ops import ell
    pk, t, u = _ell_inputs(cuda, dtype, block)
    kern = ell.bell_matvec_window if block else ell.sell_matvec_window
    plain = (ell.bell_matvec_window_reference if block
             else ell.sell_matvec_window_reference)
    name = "bell_window" if block else "sell_window"
    kc = 1 if cut else pk["kc"]
    args = (t["cols2"], t["vals2"], t["wblk"], t["gbounds"])
    wide = torch.zeros((u.shape[1], 5), dtype=dtype, device=cuda)
    wide[:, 1:4] = u.t()
    for vec, kw in ((u, {}),
                    (wide[:, 1:4], {"node_major": True, "n_rows": 997})):
        before = ell.LAUNCHES[name]
        out = kern(*args, vec, pk["S"], kc, **kw)
        torch.cuda.synchronize()
        assert ell.LAUNCHES[name] == before + 1
        ref = plain(*args, vec, pk["S"], kc, **kw)
        assert out.shape == ref.shape
        scale = float(ref.abs().max())
        assert float((out - ref).abs().max()) <= TOL[dtype] * scale
        if not kw:
            assert bool((out[:, 1000:] == 0).all())    # pad rows
    if cut:         # the hand-cut window drops columns: results differ
        full = plain(*args, u, pk["S"], pk["kc"])
        assert float((full - plain(*args, u, pk["S"], kc)).abs().max()) > 0


def test_ell_window_wrapper_raises_on_a_failed_launch(cuda, monkeypatch):
    from topopteval_tpu_torch.ops import ell
    pk, t, u = _ell_inputs(cuda, torch.float64)

    class _Failing:
        def __getattr__(self, name):
            if name == "ell_apply_error_string":
                return lambda err: b"invalid argument"
            return lambda *args: 1

    before = dict(ell.LAUNCHES)
    monkeypatch.setattr(ell, "_library", lambda: _Failing())
    with pytest.raises(RuntimeError, match="launch failed"):
        ell.bell_matvec_window(t["cols2"], t["vals2"], t["wblk"],
                               t["gbounds"], u, pk["S"], pk["kc"])
    assert ell.LAUNCHES == before


def _sell_inputs(device, dtype, per_row, n=997, n_cols=4000, seed=3,
                 block=False):
    """Scalar-weight (or 3x3-block) ELL rows of ``per_row`` distinct
    columns in a band (S = per_row, padded to 8), every eleventh row
    empty, and the columns of the last rows running past ``n_cols - 300``
    (the vector's length in the tests below), so some slots lie at or
    past n_cols."""
    from topopteval_tpu_torch.ops import ell
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), per_row)
    cols = rows * 4 + np.tile(np.arange(per_row), n) * 3 \
        + rng.integers(0, 3, rows.size)
    live = rows % 11 != 5
    rows, cols = rows[live], np.minimum(cols[live], n_cols - 1)
    shape = (rows.size, 3, 3) if block else (rows.size,)
    pk = ell.pack_ell_rows(rows, cols, rng.standard_normal(shape), n,
                           n_cols)
    t = {k: torch.as_tensor(pk[k], device=device)
         for k in ("cols2", "wblk", "gbounds")}
    t["vals2"] = torch.as_tensor(pk["vals2"], dtype=dtype, device=device)
    return pk, t


def _sell_launch(t, u, S, kc, n_rows, node_major, warps,
                 name="sell_window"):
    """One launch of the sell_window (or ``name``) entry point with
    ``warps`` warps for every 32 rows; returns (error code, output)."""
    from topopteval_tpu_torch.ops import ell
    out = torch.full((n_rows, 3) if node_major else (3, n_rows),
                     float("nan"), dtype=u.dtype, device=u.device)
    u_cs, u_ns, n_cols = ell._strides(u, node_major)
    o_cs, o_ns, _ = ell._strides(out, node_major)
    fn = getattr(ell._library(), f"{name}_f32" if u.dtype ==
                 torch.float32 else f"{name}_f64")
    err = fn(t["cols2"].data_ptr(), t["vals2"].data_ptr(),
             t["wblk"].data_ptr(), u.data_ptr(), out.data_ptr(), S, kc,
             t["wblk"].shape[0], n_rows, n_cols, u_cs, u_ns, o_cs, o_ns,
             warps, torch.cuda.current_stream().cuda_stream)
    return err, out


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("per_row", [8, 48], ids=["S8", "S48"])
@pytest.mark.parametrize("warps", [None, 1, 2, 4, 8])
def test_sell_window_warps_match_plain_version(cuda, warps, per_row, dtype):
    """B9b at S 8 (the prolongation's width) and 48 (the restriction's),
    through the wrapper (its own choice of warps) and with each of the
    four at the entry point: both layouts, 997 rows (no multiple of 32 or
    128), a cut window (kc = 1) and columns at or past the vector's end;
    each repeats its bits."""
    from topopteval_tpu_torch.ops import ell
    pk, t = _sell_inputs(cuda, dtype, per_row)
    assert pk["S"] == per_row
    args = (t["cols2"], t["vals2"], t["wblk"], t["gbounds"])
    rng = np.random.default_rng(4)
    n_cols = pk["n_cols_p"] - 300
    u = torch.as_tensor(rng.standard_normal((3, n_cols)), dtype=dtype,
                        device=cuda)
    wide = torch.zeros((n_cols, 5), dtype=dtype, device=cuda)
    wide[:, 1:4] = u.t()
    for kc in (pk["kc"], 1):
        for vec, kw in ((u, {}),
                        (wide[:, 1:4], {"node_major": True, "n_rows": 997})):
            if warps is None:
                before = ell.LAUNCHES["sell_window"]
                out = ell.sell_matvec_window(*args, vec, pk["S"], kc, **kw)
                again = ell.sell_matvec_window(*args, vec, pk["S"], kc,
                                               **kw)
                torch.cuda.synchronize()
                assert ell.LAUNCHES["sell_window"] == before + 2
            else:
                rows = kw.get("n_rows", t["wblk"].shape[0] * 128)
                node_major = kw.get("node_major", False)
                (e1, out), (e2, again) = (
                    _sell_launch(t, vec, pk["S"], kc, rows, node_major,
                                 warps) for _ in range(2))
                torch.cuda.synchronize()
                assert e1 == e2 == 0
            ref = ell.sell_matvec_window_reference(*args, vec, pk["S"], kc,
                                                   **kw)
            assert out.shape == ref.shape
            scale = float(ref.abs().max())
            assert float((out - ref).abs().max()) <= TOL[dtype] * scale
            assert torch.equal(out, again)
    assert ell.sell_warps(pk["S"]) == (1 if per_row == 8 else 8)


def test_sell_window_entry_refuses_bad_warps(cuda):
    """The entry points launch nothing for warps outside 1, 2, 4, 8, 16
    and say so (cudaErrorInvalidValue)."""
    for name, block in (("sell_window", False), ("bell_window", True)):
        pk, t = _sell_inputs(cuda, torch.float64, 8, block=block)
        u = torch.zeros((3, pk["n_cols_p"]), dtype=torch.float64,
                        device=cuda)
        for warps in (0, 3, 32):
            err, out = _sell_launch(t, u, pk["S"], pk["kc"], 997, False,
                                    warps, name)
            torch.cuda.synchronize()
            assert err == 1 and bool(torch.isnan(out).all())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("per_row", [8, 16, 72], ids=["S8", "S16", "S72"])
@pytest.mark.parametrize("warps", [None, 1, 2, 4, 8, 16])
def test_bell_window_warps_match_plain_version(cuda, warps, per_row, dtype):
    """B9a at S 8, 16 and 72 (the Galerkin levels' width: no multiple of
    8 W for W 4 or 8), through the wrapper (its own choice of warps) and
    with each warp count at the entry point: both layouts, 997 rows, a
    cut window (kc = 1) and columns at or past the vector's end; each
    repeats its bits."""
    from topopteval_tpu_torch.ops import ell
    pk, t = _sell_inputs(cuda, dtype, per_row, block=True)
    assert pk["S"] == per_row
    args = (t["cols2"], t["vals2"], t["wblk"], t["gbounds"])
    rng = np.random.default_rng(5)
    n_cols = pk["n_cols_p"] - 300
    u = torch.as_tensor(rng.standard_normal((3, n_cols)), dtype=dtype,
                        device=cuda)
    wide = torch.zeros((n_cols, 5), dtype=dtype, device=cuda)
    wide[:, 1:4] = u.t()
    for kc in (pk["kc"], 1):
        for vec, kw in ((u, {}),
                        (wide[:, 1:4], {"node_major": True, "n_rows": 997})):
            if warps is None:
                before = ell.LAUNCHES["bell_window"]
                out = ell.bell_matvec_window(*args, vec, pk["S"], kc, **kw)
                again = ell.bell_matvec_window(*args, vec, pk["S"], kc,
                                               **kw)
                torch.cuda.synchronize()
                assert ell.LAUNCHES["bell_window"] == before + 2
            else:
                rows = kw.get("n_rows", t["wblk"].shape[0] * 128)
                node_major = kw.get("node_major", False)
                (e1, out), (e2, again) = (
                    _sell_launch(t, vec, pk["S"], kc, rows, node_major,
                                 warps, "bell_window") for _ in range(2))
                torch.cuda.synchronize()
                assert e1 == e2 == 0
            ref = ell.bell_matvec_window_reference(*args, vec, pk["S"], kc,
                                                   **kw)
            assert out.shape == ref.shape
            scale = float(ref.abs().max())
            assert float((out - ref).abs().max()) <= TOL[dtype] * scale
            assert torch.equal(out, again)
    assert ell.window_warps(pk["S"], 997) == {8: 1, 16: 2, 72: 16}[per_row]


def test_galerkin_hierarchy_on_cuda_matches_cpu(cuda):
    """The Galerkin voxel hierarchy built and applied on the card (B1 for
    the probes and the fine level, B9a for the Galerkin levels, B9b for
    the transfers) against the same build on the CPU, float64."""
    from topopteval_tpu_torch.fem import multigrid as mgm
    from topopteval_tpu_torch.ops import ell
    mesh = tt.generate_grid_tet(16, 4, 4, (0, 0, 0), (16.0, 4.0, 4.0))
    mesh.structured_info = None
    mask = tt.free_mask_from_bcs(mesh.n_dofs, [tt.DirichletBC.fixed(
        tt.nodes_at_plane(mesh, 0, 0.0))])
    lam, mu = tt.lame_parameters(1.0, 0.3)
    r = np.random.default_rng(2).standard_normal(mesh.n_dofs) * mask
    out = {}
    for device in ("cpu", "cuda"):
        ell.reset_launch_counts()
        _, mg = mgm.build_unstructured_multigrid(
            mesh, lam, mu, free_mask=mask, dtype=torch.float64,
            max_coarse_dofs=200, device=device)
        out[device] = mg.apply(torch.as_tensor(r, device=device)).cpu()
        if device == "cuda":
            torch.cuda.synchronize()
            assert ell.LAUNCHES["bell_window"] > 0
            assert ell.LAUNCHES["sell_window"] > 0
        else:
            assert not any(ell.LAUNCHES.values())
    scale = float(out["cpu"].abs().max())
    assert float((out["cuda"] - out["cpu"]).abs().max()) <= 1e-10 * scale


# ---------------------------------------------------------------------------
# the probes' kernels: Ke in the lane layout (T1), the ELL ablation (T2)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("block", [128, 256, 512])
@pytest.mark.parametrize("variant", ["cse", "lanes"])
def test_ke_lane_variants_match_plain_version_and_b6(cuda, variant, block,
                                                     dtype):
    """Both probe variants against their plain version and against B6 in
    the lane layout, on a perturbed box with per-element materials; the
    padded lanes come out zero."""
    from topopteval_tpu_torch.ops import ke_kernels as kk
    coords, conn, _, lam, mu = _inputs("tet4", dtype, cuda, nx=9, ny=4,
                                       nz=3)
    C = conn.shape[0]
    ct, Cp = kk.element_coords_lanes(coords, conn, block)
    lam2, mu2 = kk.pad_lanes(lam, Cp), kk.pad_lanes(mu, Cp)
    fn = kk.tet4_ke_cse if variant == "cse" else kk.tet4_ke_lanes
    name = f"tet4_ke_{variant}"
    before = kk.LAUNCHES[name]
    out = fn(ct, lam2, mu2, block)
    torch.cuda.synchronize()
    assert kk.LAUNCHES[name] == before + 1
    ref = kk.tet4_ke_lanes_reference(ct, lam2, mu2)
    scale = float(ref.abs().max())
    assert float((out - ref).abs().max()) <= TOL[dtype] * scale
    assert not bool(out[:, C:].any())
    b6 = kk.tet4_ke(coords, conn, lam, mu).reshape(C, 144).t()
    assert float((out[:, :C] - b6).abs().max()) <= TOL[dtype] * scale


def test_ke_lane_wrapper_rejects_bad_inputs(cuda):
    from topopteval_tpu_torch.ops import ke_kernels as kk
    ct = torch.zeros((12, 256), dtype=torch.float32, device=cuda)
    row = torch.zeros((1, 256), dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError, match="multiple"):
        kk.tet4_ke_cse(ct, row, row, 512)
    with pytest.raises(ValueError, match="mu2"):
        kk.tet4_ke_lanes(ct, row, row.cpu(), 128)


@pytest.mark.parametrize("cut", [False, True], ids=["packed", "cut_window"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_ell_ablate_modes_match_plain_version(cuda, dtype, cut):
    """Every mode against its plain version on random banded triplets with
    empty rows, the packed window and one cut by hand to kc = 1; ``full``
    and ``noskip`` also against B9a, ``empty`` all zeros."""
    from topopteval_tpu_torch.ops import ell
    pk, t, u = _ell_inputs(cuda, dtype)
    kc = 1 if cut else pk["kc"]
    args = (t["cols2"], t["vals2"], t["wblk"], t["gbounds"], u, pk["S"], kc)
    b9a = ell.bell_matvec_window(*args)
    scale = float(b9a.abs().max())
    for mode in ell.ABLATE_MODES:
        before = ell.LAUNCHES["bell_ablate"]
        out = ell.bell_ablate(mode, *args)
        torch.cuda.synchronize()
        assert ell.LAUNCHES["bell_ablate"] == before + 1
        ref = ell.bell_ablate_reference(mode, *args)
        assert out.shape == ref.shape == (3, t["wblk"].shape[0] * 128)
        tol = TOL[dtype] * max(float(ref.abs().max()), 1e-300)
        assert float((out - ref).abs().max()) <= tol, mode
        if mode in ("full", "noskip"):
            assert float((out - b9a).abs().max()) <= TOL[dtype] * scale
        if mode == "empty":
            assert not bool(out.any())


def test_ell_ablate_large_scratch(cuda):
    """S = 72 in float64 needs 221 KB of shared memory a block: the opt-in
    attribute path; S = 80 (240 KB) is refused with the sizes."""
    from topopteval_tpu_torch.ops import ell
    rng = np.random.default_rng(7)
    n = 600
    rows = np.repeat(np.arange(n), 70)
    cols = np.clip(rows + rng.integers(-200, 201, rows.size), 0, n - 1)
    pk = ell.pack_ell_rows(rows, cols, rng.standard_normal((rows.size, 3, 3)),
                           n, n)
    assert pk["S"] == 72
    t = {k: torch.as_tensor(pk[k], device=cuda)
         for k in ("cols2", "wblk", "gbounds")}
    t["vals2"] = torch.as_tensor(pk["vals2"], device=cuda)
    u = torch.as_tensor(rng.standard_normal((3, pk["n_cols_p"])),
                        device=cuda)
    args = (t["cols2"], t["vals2"], t["wblk"], t["gbounds"], u, 72,
            pk["kc"])
    out = ell.bell_ablate("full", *args)
    ref = ell.bell_ablate_reference("full", *args)
    assert float((out - ref).abs().max()) <= 1e-12 * float(ref.abs().max())
    big = ell.pack_ell_rows(np.repeat(np.arange(n), 80),
                            np.tile(np.arange(80), n),
                            np.ones((80 * n, 3, 3)), n, n)
    assert big["S"] == 80
    with pytest.raises(ValueError, match="shared memory"):
        ell.bell_ablate(
            "full", torch.as_tensor(big["cols2"], device=cuda),
            torch.as_tensor(big["vals2"], device=cuda),
            torch.as_tensor(big["wblk"], device=cuda), None, u[:, :128],
            80, big["kc"])


# ---------------------------------------------------------------------------
# the Hopper designs of B7 (tiles of distinct nodes, two cp.async stages)
# and B4 (sub-warps per row over staged value runs)
# ---------------------------------------------------------------------------


def _tet10_case(case, dtype, device):
    """tet10 inputs: curved elements with C = 1, C under one tile, a
    ragged last tile (133 = 4 x 32 + 5) and the scale-2 beam (2,400
    elements); the scale-8 beam (153,600: tiles of 64, several per block)
    with straight edges, since among that many randomly curved elements
    some come out nearly singular, where the float32 plain version itself
    lies 2e-3 of the largest force from the float64 one."""
    if case in ("beam2", "beam8"):
        s = 2 if case == "beam2" else 8
        rng = np.random.default_rng(s)
        mesh = tt.generate_grid_tet(25 * s // 2, 4 * s, s, (0, 0, 0),
                                    (60.0, 20.0, 4.0)).to_quadratic()
        h = 60.0 / (25 * s // 2)
        coords = mesh.coords.copy()
        if case == "beam2":
            mid = np.unique(mesh.conn[:, 4:])      # mid-edge nodes: curved
            coords[mid] += rng.uniform(-0.1 * h, 0.1 * h, (mid.size, 3))
        C = mesh.n_cells

        def t(a, dt=dtype):
            return torch.as_tensor(a, dtype=dt, device=device)

        return (t(coords), t(mesh.conn, torch.int32),
                t(rng.standard_normal(mesh.n_dofs)),
                t(rng.uniform(0.1, 2.0, C)), t(rng.uniform(0.1, 2.0, C)))
    coords, conn, u, lam, mu = _curved_inputs("tet10", dtype, device, nx=6,
                                              ny=3, nz=2)
    return (coords, conn[:case].contiguous(), u, lam[:case].contiguous(),
            mu[:case].contiguous())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", [1, 20, 133, "beam2", "beam8"])
def test_tet10_apply_tiles_match_plain_version(cuda, dtype, case):
    args = _tet10_case(case, dtype, cuda)
    before = ek.LAUNCHES["tet10_apply"]
    out = ek.tet10_apply(*args)
    again = ek.tet10_apply(*args)
    torch.cuda.synchronize()
    assert ek.LAUNCHES["tet10_apply"] == before + 2
    ref = ek.tet10_apply_reference(*args)
    assert out.shape == ref.shape == (args[1].shape[0], 10, 3)
    scale = float(ref.abs().max())
    assert float((out - ref).abs().max()) <= TOL[dtype] * scale
    assert torch.equal(out, again)          # bit-identical launch to launch


def test_tet10_apply_follows_a_conn_written_in_place(cuda):
    """The kernel reads per-tile node lists built from conn once; a conn
    written in place is seen by the next launch."""
    coords, conn, u, lam, mu = _curved_inputs("tet10", torch.float64, cuda)
    ek.tet10_apply(coords, conn, u, lam, mu)
    conn[3] = conn[3].flip(0)
    out = ek.tet10_apply(coords, conn, u, lam, mu)
    ref = ek.tet10_apply_reference(coords, conn, u, lam, mu)
    assert float((out - ref).abs().max()) <= 1e-12 * float(ref.abs().max())


def _bell_shape(shape, device, vals_dtype, seed=0, block=True):
    """Row-compressed 3x3-block (or scalar-weight) matrices: every fifth
    row empty, rows of 700 blocks (more than a chunk of 512) or 2,500
    weights (more than a chunk of 2,048), a coarse level's 72 blocks a
    row, 14 a row over a row count that no tile divides, and the
    transfers' ~34 and ~6 weights a row."""
    from topopteval_tpu_torch.ops import bell
    n, per_row, n_cols = {"empty_rows": (1000, 10, 900),
                          "long_rows": (45, 700, 2000),
                          "long_weights": (45, 2500, 3000),
                          "coarse72": (700, 72, 700),
                          "ragged": (3001, 14, 3001),
                          "restrict34": (2000, 34, 12000),
                          "prolong6": (3001, 6, 500)}[shape]
    rng = np.random.default_rng(seed)
    counts = np.full(n, per_row)
    if shape == "empty_rows":
        counts[::5] = 0
    rows = np.repeat(np.arange(n), counts)
    # a run of distinct columns per row, from a jittered diagonal start
    first = np.arange(n) * n_cols // n + rng.integers(0, 50, n)
    cols = (np.repeat(first, counts) + np.arange(rows.size)
            - np.repeat(np.cumsum(counts) - counts, counts)) % n_cols
    data = rng.standard_normal((rows.size, 3, 3) if block else rows.size)
    A = bell.pack_csr(rows, cols, data, n, n_cols, vals_dtype, device)
    return A, rng


@pytest.mark.parametrize("shape", ["empty_rows", "long_rows", "coarse72",
                                   "ragged"])
@pytest.mark.parametrize("case", ["f32", "f32_lo", "f32_bf16", "f64"])
def test_bell_matvec_subwarps_match_plain_version(cuda, case, shape):
    from topopteval_tpu_torch.ops import bell
    vec = torch.float64 if case == "f64" else torch.float32
    vals = {"f32_bf16": torch.bfloat16, "f64": torch.float64}.get(
        case, torch.float32)
    A, rng = _bell_shape(shape, cuda, vals)
    u = torch.as_tensor(rng.standard_normal((3, A.n_cols)), dtype=vec,
                        device=cuda)
    lo = (A.vals * 1e-7).contiguous() if case == "f32_lo" else None
    out = bell.bell_matvec(u, A, lo)
    again = bell.bell_matvec(u, A, lo)
    torch.cuda.synchronize()
    ref = bell.bell_matvec_reference(u, A, lo)
    empty = A.indptr[1:] == A.indptr[:-1]
    assert bool((out[:, empty] == 0).all())
    scale = float(ref.abs().max())
    assert float((out - ref).abs().max()) <= TOL[vec] * scale
    assert torch.equal(out, again)          # bit-identical launch to launch


@pytest.mark.parametrize("lanes", [None, 1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("shape", ["empty_rows", "long_weights",
                                   "restrict34", "prolong6"])
@pytest.mark.parametrize("case", ["f32", "f32_bf16", "f64"])
def test_sell_matvec_lanes_match_plain_version(cuda, case, shape, lanes):
    """B5 through the wrapper (its own lanes, sell_lanes) and with each
    lane count at the entry point, on rows that are empty, longer than a
    staged chunk, and the transfers' widths; each repeats its bits."""
    from topopteval_tpu_torch.ops import bell
    vec = torch.float64 if case == "f64" else torch.float32
    vals = {"f32_bf16": torch.bfloat16, "f64": torch.float64}.get(
        case, torch.float32)
    T, rng = _bell_shape(shape, cuda, vals, block=False)
    u = torch.as_tensor(rng.standard_normal((3, T.n_cols)), dtype=vec,
                        device=cuda)
    if lanes is None:
        before = bell.LAUNCHES["sell_matvec"]
        out, again = bell.sell_matvec(u, T), bell.sell_matvec(u, T)
        torch.cuda.synchronize()
        assert bell.LAUNCHES["sell_matvec"] == before + 2
    else:
        fn = getattr(bell._library(), f"sell_matvec_{case}")

        def launch():
            o = torch.full((3, T.n_rows), float("nan"), dtype=vec,
                           device=cuda)
            assert fn(T.indptr.data_ptr(), T.cols.data_ptr(),
                      T.vals.data_ptr(), u.data_ptr(), o.data_ptr(),
                      T.n_rows, T.n_cols, lanes,
                      torch.cuda.current_stream().cuda_stream) == 0
            return o
        out, again = launch(), launch()
        torch.cuda.synchronize()
    ref = bell.sell_matvec_reference(u, T)
    empty = T.indptr[1:] == T.indptr[:-1]
    assert bool((out[:, empty] == 0).all())
    scale = float(ref.abs().max())
    assert float((out - ref).abs().max()) <= TOL[vec] * scale
    assert torch.equal(out, again)          # bit-identical launch to launch


def test_redesigned_wrappers_refuse_what_their_kernels_do_not_take(cuda):
    from topopteval_tpu_torch.ops import bell
    A, rng = _bell_shape("ragged", cuda, torch.bfloat16)
    u = torch.as_tensor(rng.standard_normal((3, A.n_cols)),
                        dtype=torch.float32, device=cuda)
    with pytest.raises(TypeError):             # no lo plane with bf16 values
        bell.bell_matvec(u, A, A.vals)
    with pytest.raises(TypeError):             # bf16 vectors
        bell.bell_matvec(u.bfloat16(), A)
    with pytest.raises(ValueError):            # values on the CPU
        bell.bell_matvec(u, A.with_vals(A.vals.cpu()))
    coords, conn, uu, lam, mu = _curved_inputs("tet10", torch.float32, cuda)
    with pytest.raises(ValueError):            # conn on the CPU
        ek.tet10_apply(coords, conn.cpu(), uu, lam, mu)
    with pytest.raises(TypeError):             # mixed float types
        ek.tet10_apply(coords, conn, uu, lam.double(), mu)


# ---------------------------------------------------------------------------
# the Hopper designs of B1 (tet4) and B2 (hex8): the tile kernel, B2 with
# eight threads an element
# ---------------------------------------------------------------------------


def _apply_case(element_type, case, dtype, device):
    """tet4 / hex8 inputs on moved nodes: C = 2 large tiles + 5 (ragged),
    C = 3 below one small tile, element 0 flattened to z = 0 (det 0 at
    every point), SIMP lam, mu (the vfrac-0.4 density on a scale-2 tet beam;
    the SIMP Hex8 fixture itself), and the largest shapes the solver
    gives them (153,600 tets, 25,600 hexes), whose tiles are the large
    ones."""
    rng = np.random.default_rng(len(case))
    k = 4 if element_type == "tet4" else 8
    gen = tt.generate_grid_tet if k == 4 else tt.generate_grid_hex
    simp = tt.create_simp_material_model(1.0, 0.3, 1e-8, 3.0)
    if case == "simp" and k == 8:
        path = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "data", "beam_vfrac_04_Raw.vtu")
        mesh = tt.import_mesh(path)
        lam, mu = simp.lame(tt.extract_cell_density(path))
    elif case in ("simp", "large"):
        s = 2 if case == "simp" else 8
        mesh = gen(25 * s // 2, 4 * s, s, (0, 0, 0), (60.0, 20.0, 4.0))
        lam, mu = (simp.lame(tt.models.vfrac04_density_for(mesh))
                   if case == "simp" else
                   (rng.uniform(0.1, 2.0, mesh.n_cells),
                    rng.uniform(0.1, 2.0, mesh.n_cells)))
    else:
        mesh = gen(9, 5, 4, (0, 0, 0), (18.0, 7.5, 4.0))
        lam = rng.uniform(0.1, 2.0, mesh.n_cells)
        mu = rng.uniform(0.1, 2.0, mesh.n_cells)
    h = 60.0 / 25 if case == "simp" else 1.0
    coords = mesh.coords + rng.uniform(-0.1 * h, 0.1 * h, mesh.coords.shape)
    conn = mesh.conn
    n = {"ragged": 2 * ek.TILES[k][0] + 5,
         "below_one_tile": ek.TILES[k][1] - 3}.get(case, mesh.n_cells)
    if case == "degenerate":
        coords[conn[0], 2] = 0.0

    def t(a, dt=dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                               device=device)

    return (t(coords), t(conn[:n], torch.int32),
            t(rng.standard_normal(mesh.n_dofs)), t(np.asarray(lam)[:n]),
            t(np.asarray(mu)[:n]))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", ["ragged", "below_one_tile", "degenerate",
                                  "simp", "large"])
@pytest.mark.parametrize("element_type", ["tet4", "hex8"])
def test_element_apply_tiles_match_plain_version(cuda, element_type, case,
                                                 dtype):
    kernel = ek.tet4_apply if element_type == "tet4" else ek.hex8_apply
    plain = (ek.tet4_apply_reference if element_type == "tet4"
             else ek.hex8_apply_reference)
    args = _apply_case(element_type, case, dtype, cuda)
    before = ek.LAUNCHES[kernel.__name__]
    out = kernel(*args)
    again = kernel(*args)
    torch.cuda.synchronize()
    assert ek.LAUNCHES[kernel.__name__] == before + 2
    ref = plain(*args)
    assert out.shape == ref.shape == (args[1].shape[0], args[1].shape[1], 3)
    scale = float(ref.abs().max())
    assert float((out - ref).abs().max()) <= TOL[dtype] * scale
    assert torch.equal(out, again)          # bit-identical launch to launch
    if case == "degenerate":                # det 0: the element adds nothing
        assert bool((out[0] == 0).all()) and bool((ref[0] == 0).all())


def test_element_apply_tiles_follow_a_conn_written_in_place(cuda):
    """B1 and B2 read per-tile node lists built from conn once; a conn
    written in place is seen by the next launch."""
    for element_type, kernel, plain in (
            ("tet4", ek.tet4_apply, ek.tet4_apply_reference),
            ("hex8", ek.hex8_apply, ek.hex8_apply_reference)):
        coords, conn, u, lam, mu = _apply_case(element_type, "ragged",
                                               torch.float64, cuda)
        kernel(coords, conn, u, lam, mu)
        conn[3] = conn[3].flip(0)
        out = kernel(coords, conn, u, lam, mu)
        ref = plain(coords, conn, u, lam, mu)
        assert float((out - ref).abs().max()) \
            <= 1e-12 * float(ref.abs().max())
