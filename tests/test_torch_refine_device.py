"""The float64 refinement's residual on the device (``fem.bell.
BellResidual64``) against its host twin (``BellSystem.matvec64`` and
``residual_floor64``, scipy), on the CPU through ``ops.bell``'s plain
version of B4's float64 launch: the imported Tet4 cantilever fixture in
float32, and a small Tet10 box (6 x 2 x 2 hexes at order 2) under SIMP.

- The residual agrees with the host twin's to 1e-14 relative, the floor
  to 1e-12: both sum the same float64 products in another order.
- ``api._refined_generic`` takes either oracle, with NumPy vectors on
  the host or float64 tensors on the device, to the same pass count.
  The two iterates are each certified to the tolerance; they agree to
  1e-9 relative, the fixture's float64 reach (test_torch_bell_routes.py
  holds two float64 routes of this fixture to the same bound): any two
  float64 residual orders move them by ~6e-11 there, with the float32
  multigrid inner solve or a float64 direct one.
- A float32 build uploads the fine values once in float64 and splits
  them on the device; the planes are the host split's bits.
- ``solve_system`` on the CPU, sharded or not, keeps the host twin and
  evaluates nothing on the device (``device_residuals == 0``).
"""

import os

import numpy as np
import pytest
import torch

import topopteval_tpu_torch as tt
from topopteval_tpu_torch import api
from topopteval_tpu_torch.fem.bell import BellResidual64, build_bell_multigrid
from topopteval_tpu_torch.fem.solvers import cg
from topopteval_tpu_torch.ops import bell as ops_bell

tt.set_verbosity(False)
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def _tet4_fixture():
    mesh = tt.import_mesh(os.path.join(REPO, "data",
                                       "beam_linear_volume_mesh.vtu"))
    return tt.cantilever_beam(mesh, dtype=torch.float32, device="cpu")


def _tet10_box():
    g = tt.generate_grid_tet(6, 2, 2, (0.0, 0.0, 0.0), (3.0, 1.0, 1.0))
    mesh = tt.Mesh(g.coords, g.conn, "tet4")
    p = tt.setup_problem(mesh, interpolation_order=2, dtype=torch.float32,
                         device="cpu")
    tt.apply_fixed_boundary(p, np.flatnonzero(
        np.abs(p.mesh.coords[:, 0]) < 1e-9))
    rho = np.random.default_rng(5).uniform(0.2, 1.0, len(g.conn))
    tt.assemble_stiffness_matrix_simp(
        p, tt.SIMPMaterial(1.0, 0.3, 1e-9, 3.0), rho)
    tt.apply_variable_density_volume_force(p, [0.3, -0.2, -1.0], rho)
    return p


@pytest.fixture(scope="module", params=["tet4_fixture", "tet10_box"])
def built(request):
    p = _tet4_fixture() if request.param == "tet4_fixture" else _tet10_box()
    mask = tt.free_mask_from_bcs(p.n_dofs, p.bcs)
    system, mg, _ = build_bell_multigrid(
        p.mesh, p.lam, p.mu, free_mask=mask, dtype=torch.float32,
        order=p.quad_order, device="cpu")
    f64 = system.to_cm(p.f) * system.free_mask.double().numpy()
    return system, mg, f64


def test_device_residual_and_floor_match_the_host_twin(built):
    system, _, _ = built
    dev = BellResidual64(system)
    rng = np.random.default_rng(11)
    x = rng.normal(size=system.n_dofs)
    f = rng.normal(size=system.n_dofs) * np.abs(system.matvec64(x)).max()
    want = f - system.matvec64(x)
    r, rn = dev.residual64(torch.as_tensor(f), torch.as_tensor(x))
    assert float(np.linalg.norm(r.numpy() - want)) \
        <= 1e-14 * np.linalg.norm(want)
    assert abs(rn - np.linalg.norm(want)) <= 1e-14 * rn
    floor = system.residual_floor64(x)
    assert abs(dev.residual_floor64(torch.as_tensor(x)) - floor) \
        <= 1e-12 * floor
    assert dev.evaluations == 2 and dev.matvec_seconds > 0.0


def test_refinement_on_the_device_route_matches_the_host_route(built):
    system, mg, f64 = built
    dev = BellResidual64(system)

    def inner(rhs, left, tol):
        r = cg(system, rhs, M=mg, tol=tol, maxiter=left)
        return r.x, r.niter, None

    tol = 1e-10
    host = api._refined_generic(system, inner, f64, tol, 5000, CPU)
    on_dev = api._refined_generic(dev, inner, torch.as_tensor(f64), tol,
                                  5000, CPU)
    assert host[3] and on_dev[3]
    assert on_dev[5] == host[5] >= 2
    assert isinstance(on_dev[0], torch.Tensor)
    assert dev.evaluations == on_dev[5]
    x_host, x_dev = host[0], on_dev[0].numpy()
    target = tol * (1.0 + np.linalg.norm(f64))
    for x in (x_host, x_dev):
        assert np.linalg.norm(f64 - system.matvec64(x)) <= target
    assert np.linalg.norm(x_dev - x_host) <= 1e-9 * np.linalg.norm(x_host)


def test_device_split_is_the_host_split(built):
    """The float32 planes split on the device from the float64 upload,
    laid out as the host BSR: the host split's bits, and ``matrix64``
    shares the system matrix's structure."""
    system, _, _ = built
    hb = system.host_bsr
    A, A64 = system.matrix.A, system.matrix64
    assert A64.vals.dtype == torch.float64
    assert A64.cols is A.cols and A64.indptr is A.indptr
    assert np.array_equal(np.asarray(hb["indices"]), A.cols.numpy())
    v = np.asarray(hb["data"], np.float64)
    hi = v.astype(np.float32)
    lo = (v - hi).astype(np.float32)
    assert np.array_equal(A64.vals.numpy(), v)
    assert np.array_equal(A.vals.numpy(), hi)
    assert np.array_equal(system.matrix.vals_lo.numpy(), lo)


def test_absolute_launch_plain_version():
    """``bell_matvec(absolute=True)``: |A| |u| in float64 only."""
    rng = np.random.default_rng(3)
    rows = np.repeat(np.arange(40), 5)
    cols = rng.integers(0, 30, rows.size)
    keep = np.unique(rows * 30 + cols, return_index=True)[1]
    vals = rng.normal(size=(keep.size, 3, 3))
    A = ops_bell.pack_csr(rows[keep], cols[keep], vals, 40, 30,
                          torch.float64, "cpu")
    u = torch.as_tensor(rng.normal(size=(3, 30)))
    dense = np.zeros((120, 90))
    for r, c, b in zip(rows[keep], cols[keep], np.abs(vals)):
        dense[3 * r:3 * r + 3, 3 * c:3 * c + 3] = b
    want = (dense @ np.abs(u.numpy()).T.reshape(-1)).reshape(40, 3).T
    got = ops_bell.bell_matvec(u, A, absolute=True)
    assert np.allclose(got.numpy(), want, rtol=1e-14, atol=0)
    with pytest.raises(TypeError, match=r"\|A\| \|u\|"):
        ops_bell.bell_matvec(u.float(), A.with_vals(A.vals.float()),
                             absolute=True)


@pytest.mark.parametrize("devices", [None, 2])
def test_cpu_solve_keeps_the_host_route(devices, monkeypatch):
    monkeypatch.setenv("TOPOPT_MG_CACHE_DIR", "off")
    mesh = tt.generate_grid_tet(8, 4, 2, (0, 0, 0), (8.0, 4.0, 2.0))
    mesh.structured_info = None
    p = tt.cantilever_beam(mesh, dtype=torch.float32, device="cpu")
    r = tt.solve_system(p, tt.SolverConfig(
        method="cg", preconditioner="multigrid", tolerance=1e-10,
        max_iterations=500, verbose=False), devices=devices)
    assert r.converged and r.refinement_passes >= 2
    assert r.device_residuals == 0
    assert r.timings["refine_host_matvec_seconds"] > 0.0
