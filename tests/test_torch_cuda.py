"""CUDA kernels of the PyTorch port against their plain versions, on the card.

Every test here needs an NVIDIA GPU and skips without one.  This file
imports neither JAX nor the JAX package, so it also runs on a machine
that has only PyTorch; tests/conftest.py imports JAX, so run it there
with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances are relative to the largest plain-version entry: 1e-12 in
float64 and 1e-5 in float32 (the kernels contract multiply-adds into
FMAs and sum in another order than the batched plain version).  The two
stencil kernels share their arithmetic and must agree bit for bit.
"""

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
    nx, ny, nz = dims
    rng = np.random.default_rng(seed)
    op = tt.StructuredStiffnessOperator.build(
        nx, ny, nz, (0, 0, 0), (0.5 * nx, 0.4 * ny, 0.3 * nz),
        *tt.lame_parameters(1.0, 0.3),
        escale=rng.uniform(0.1, 1.0, (nz, ny, nx)) if simp else None,
        dtype=dtype, device=device)
    u = torch.as_tensor(rng.standard_normal(op.n_dofs), dtype=dtype,
                        device=device)
    return u, op.escale, op.ke, dims


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("simp", [False, True], ids=["uniform", "simp"])
@pytest.mark.parametrize("dims", [(7, 5, 3), (1, 1, 1), (40, 9, 6)])
@pytest.mark.parametrize("kernel", ["plane", "window"])
def test_stencil_kernel_matches_plain_version(cuda, kernel, dims, simp,
                                              dtype):
    """Odd dims: every boundary case, ragged blocks and ragged tiles."""
    args = _stencil_inputs(dims, dtype, cuda, simp)
    name = f"stencil_{kernel}"
    before = dict(stencil.LAUNCHES)
    out = stencil.stencil_matvec(*args, kernel=kernel)
    torch.cuda.synchronize()
    # a CUDA tensor never reaches the plain version: one launch per call
    assert stencil.LAUNCHES[name] == before[name] + 1
    assert sum(stencil.LAUNCHES.values()) == sum(before.values()) + 1
    ref = stencil.stencil_matvec_reference(*args)
    scale = float(ref.abs().max())
    assert float((out - ref).abs().max()) <= TOL[dtype] * scale


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_stencil_kernels_agree_bit_for_bit(cuda, dtype):
    args = _stencil_inputs((37, 6, 9), dtype, cuda, simp=True)
    a = stencil.stencil_matvec(*args, kernel="plane")
    b = stencil.stencil_matvec(*args, kernel="window")
    assert torch.equal(a, b)


def test_stencil_kernel_choice_follows_the_environment(cuda, monkeypatch):
    args = _stencil_inputs((6, 4, 2), torch.float64, cuda, simp=False)
    monkeypatch.setenv("TOPOPT_STENCIL_KERNEL", "window")
    before = stencil.LAUNCHES["stencil_window"]
    stencil.stencil_matvec(*args)
    assert stencil.LAUNCHES["stencil_window"] == before + 1


def test_stencil_wrapper_rejects_bad_inputs(cuda):
    u, esc, ke, dims = _stencil_inputs((6, 4, 2), torch.float64, cuda, True)
    with pytest.raises(TypeError):
        stencil.stencil_matvec(u.float(), esc, ke, dims)
    with pytest.raises(ValueError, match="on cpu"):
        stencil.stencil_matvec(u, esc, ke.cpu(), dims)
    with pytest.raises(ValueError, match="contiguous"):
        stencil.stencil_matvec(u, esc, ke.t(), dims)
    with pytest.raises(ValueError, match="DOFs"):
        stencil.stencil_matvec(u[3:], esc, ke, dims)


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
