"""Batched design sweeps of the port (parallel/sweep.py) against the JAX
package's, on the CPU in float64: the cases of tests/test_parallel.py:74-203
(except the sharded placement, ROADMAP Queue A item 13).

- ``SweepKernel`` pieces (gradients, weights, unit-E node blocks, the
  unit-E Ke, one lane's matvec in both forms, block-Jacobi inverses and
  diagonal) to rtol 1e-10;
- per-lane energies to rtol 1e-10 and equal per-lane iteration counts and
  converged masks, over [B]x[L] and over explicit pairs, in both forms of
  the operator.  Counts are compared on inputs where they are decided by
  the problem and not by rounding (densities in [0.7, 1] on a 6x3x3 box):
  there the JAX package's two forms, and the JAX package under a 1e-15
  move of the loads, give the same counts.  On the cantilevers of
  tests/test_parallel.py at contrast 1e-4..1e-9 the JAX package's own
  two forms differ by an iteration in some lanes, so there energies only
  are compared;
- a stopped lane's state exact whatever the other lanes do, a surfaced
  non-converged lane, the per-lane memory estimate.

``evaluate_design_batch`` is in tests/test_torch_sweep_routes.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topopteval_tpu.fem.bc import DirichletBC as JaxDirichletBC
from topopteval_tpu.fem.bc import free_mask_from_bcs as jax_free_mask
from topopteval_tpu.fem.bc import nodes_at_plane as jax_nodes_at_plane
from topopteval_tpu.materials import SIMPMaterial as JaxSIMPMaterial
from topopteval_tpu.models import beams as jax_beams
from topopteval_tpu.parallel import sweep as jax_sweep
import topopteval_tpu_torch as tt
from topopteval_tpu_torch.parallel import sweep
from topopteval_tpu_torch.utils import terminal

tt.set_verbosity(False)
torch.set_num_threads(1)

F64 = torch.float64


def _case(nx, ny, nz, length):
    """A cantilever over (length, 1, 1) clamped at x = 0 with a -z tip
    load, in both packages: (jax mesh, port problem, mask, load)."""
    mesh = jax_beams.generate_grid_tet(nx, ny, nz, (0, 0, 0),
                                       (length, 1.0, 1.0))
    fixed = jax_nodes_at_plane(mesh, 0, 0.0)
    tip = jax_nodes_at_plane(mesh, 0, length)
    mask = jax_free_mask(mesh.n_dofs, [JaxDirichletBC.fixed(fixed)])
    f = np.zeros(mesh.n_dofs)
    f[tip * 3 + 2] = -1.0 / tip.size
    pmesh = tt.Mesh(mesh.coords, mesh.conn, mesh.element_type)
    p = tt.setup_problem(pmesh, dtype=F64, device="cpu")
    tt.assemble_stiffness_matrix(p, *tt.lame_parameters(1.0, 0.3))
    tt.apply_fixed_boundary(p, fixed)
    p.f = f.copy()
    return mesh, p, mask, f


def _kernels(mesh, p, mask, full_ke, nu=0.3):
    jk = jax_sweep.SweepKernel.build(mesh, nu, mask, dtype=jnp.float64,
                                     full_ke=full_ke)
    pk = sweep.SweepKernel.build(p.mesh, nu, mask, dtype=F64,
                                 full_ke=full_ke, device="cpu")
    return jk, pk


def _rel(ours, ref):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    return np.abs(ours - ref).max() / np.abs(ref).max()


def _two_loads(f):
    # -z tip load and a +y one on the same nodes
    fy = f.reshape(-1, 3)
    return np.stack([f, np.stack([np.zeros_like(fy[:, 2]), -fy[:, 2],
                                  np.zeros_like(fy[:, 2])], 1).reshape(-1)])


def _direct(p, lam, mu, f):
    p.lam, p.mu, p.f = np.asarray(lam), np.asarray(mu), np.asarray(f)
    return tt.solve_system(p, tt.SolverConfig(method="direct",
                                              verbose=False)).energy


@pytest.mark.parametrize("full_ke", [False, True], ids=["einsum", "ke0"])
@pytest.mark.parametrize("shape", [("tet4", (4, 2, 2)), ("hex8", (3, 2, 2))],
                         ids=["tet4", "hex8"])
def test_sweep_kernel_pieces_equal_jax(full_ke, shape):
    etype, dims = shape
    if etype == "tet4":
        mesh, p, mask, _ = _case(*dims, 6.0)
    else:
        mesh = jax_beams.generate_grid_hex(*dims, (0, 0, 0), (3.0, 1.0, 1.0))
        mask = jax_free_mask(mesh.n_dofs, [JaxDirichletBC.fixed(
            jax_nodes_at_plane(mesh, 0, 0.0))])
        p = tt.setup_problem(tt.Mesh(mesh.coords, mesh.conn, "hex8"),
                             dtype=F64, device="cpu")
    jk, pk = _kernels(mesh, p, mask, full_ke)
    for name in ("g", "wdet", "blocks_ek") + (("ke0",) if full_ke else ()):
        assert _rel(getattr(pk, name).numpy(), getattr(jk, name)) <= 1e-10
    rng = np.random.default_rng(3)
    esc = rng.uniform(1e-3, 1.0, mesh.n_cells)
    u = rng.standard_normal(mesh.n_dofs)
    et, ut = torch.as_tensor(esc), torch.as_tensor(u)
    assert _rel(pk.matvec(et, ut).numpy(),
                jk.matvec(jnp.asarray(esc), jnp.asarray(u))) <= 1e-10
    assert _rel(pk.block_jacobi(et).numpy(),
                jk.block_jacobi(jnp.asarray(esc))) <= 1e-10
    assert _rel(pk.diagonal(et).numpy(),
                jk.diagonal(jnp.asarray(esc))) <= 1e-10
    # lanes: each lane's column equals its own one-lane call
    E = rng.uniform(1e-3, 1.0, (mesh.n_cells, 3))
    U = rng.standard_normal((mesh.n_dofs // 3, 3, 3))
    out = pk.matvec_lanes(torch.as_tensor(E), torch.as_tensor(U)).numpy()
    for j in range(3):
        one = pk.matvec(torch.as_tensor(E[:, j]),
                        torch.as_tensor(U[..., j].reshape(-1))).numpy()
        assert _rel(out[..., j].reshape(-1), one) <= 1e-14


@pytest.mark.parametrize("full_ke", [False, True], ids=["einsum", "ke0"])
def test_sweep_lanes_equal_jax_count_for_count(full_ke):
    mesh, p, mask, f = _case(6, 3, 3, 2.0)
    jk, pk = _kernels(mesh, p, mask, full_ke)
    material = JaxSIMPMaterial(E0=1.0, nu=0.3, Emin=1e-9, p=3.0)
    dens = np.random.default_rng(1).uniform(0.7, 1.0, (4, mesh.n_cells))
    esc = np.asarray(material.youngs_modulus(dens))
    loads = np.stack([f, -0.5 * f])
    kw = dict(tol=1e-10, maxiter=4000)
    e_j, it_j, cv_j = (np.asarray(a) for a in jax_sweep.sweep_compliance(
        jk, jnp.asarray(esc), jnp.asarray(loads), **kw))
    e_p, it_p, cv_p = (a.numpy() for a in sweep.sweep_compliance(
        pk, esc, loads, **kw))
    assert e_p.shape == (4, 2) and cv_p.all() and cv_j.all()
    np.testing.assert_allclose(e_p, e_j, rtol=1e-10)
    np.testing.assert_array_equal(it_p, it_j)
    # explicit pairs: the same lanes one axis
    bi, lj = np.divmod(np.arange(8), 2)
    e_jp, it_jp, cv_jp = (np.asarray(a) for a in
                          jax_sweep.sweep_compliance_pairs(
                              jk, jnp.asarray(esc[bi]),
                              jnp.asarray(loads[lj]), **kw))
    e_pp, it_pp, cv_pp = (a.numpy() for a in sweep.sweep_compliance_pairs(
        pk, esc[bi], loads[lj], **kw))
    np.testing.assert_allclose(e_pp, e_jp, rtol=1e-10)
    np.testing.assert_array_equal(it_pp, it_jp)
    np.testing.assert_array_equal(cv_pp, cv_jp)
    np.testing.assert_allclose(e_pp, e_p.reshape(-1), rtol=1e-10)


def test_sweep_matches_individual_solves():
    mesh, p, mask, f = _case(4, 2, 2, 6.0)
    jk, pk = _kernels(mesh, p, mask, False)
    material = tt.create_simp_material_model(1.0, 0.3, 1e-4, 3.0)
    dens = np.random.default_rng(1).uniform(0.2, 1.0, (4, mesh.n_cells))
    esc = material.youngs_modulus(dens)
    loads = _two_loads(f)
    e, it, cv, u = sweep.sweep_compliance(pk, esc, loads, tol=1e-10,
                                          maxiter=4000, return_u=True)
    assert e.shape == (4, 2) and u.shape == (4, 2, mesh.n_dofs)
    assert bool((it > 0).all()) and bool(cv.all())
    e_j = np.asarray(jax_sweep.sweep_compliance(
        jk, jnp.asarray(esc), jnp.asarray(loads), tol=1e-10,
        maxiter=4000)[0])
    np.testing.assert_allclose(e.numpy(), e_j, rtol=1e-10)
    for b in range(4):
        lam, mu = material.lame(dens[b])
        for j in range(2):
            np.testing.assert_allclose(float(e[b, j]),
                                       _direct(p, lam, mu, loads[j]),
                                       rtol=1e-6)
            np.testing.assert_allclose(0.5 * float(u[b, j] @ torch.as_tensor(
                loads[j] * mask)), float(e[b, j]), rtol=1e-8)


def test_sweep_converges_at_real_simp_contrast():
    """Emin/E0 = 1e-9, p = 3 with voids: block-Jacobi lanes converge and
    match the JAX package's lanes and per-lane direct solves."""
    mesh, p, mask, f = _case(6, 3, 3, 6.0)
    jk, pk = _kernels(mesh, p, mask, True)
    material = tt.create_simp_material_model(1.0, 0.3, 1e-9, 3.0)
    dens = np.random.default_rng(5).uniform(0.0, 1.0, (3, mesh.n_cells))
    dens[:, : mesh.n_cells // 3] = 1.0
    esc = material.youngs_modulus(dens)
    e, it, cv = sweep.sweep_compliance(pk, esc, f[None], tol=1e-10,
                                       maxiter=30000)
    assert bool(cv.all()), it
    e_j = np.asarray(jax_sweep.sweep_compliance(
        jk, jnp.asarray(esc), jnp.asarray(f[None]), tol=1e-10,
        maxiter=30000)[0])
    np.testing.assert_allclose(e.numpy(), e_j, rtol=1e-10)
    for b in range(3):
        lam, mu = material.lame(dens[b])
        np.testing.assert_allclose(float(e[b, 0]), _direct(p, lam, mu, f),
                                   rtol=1e-6)


def test_a_stopped_lane_keeps_its_state():
    """No step is taken on a stopped lane: the lane that converges first
    ends with the same bits whether the others run on or are stopped by
    a budget at its count (the working set shrinks at the same
    iterations in both runs), and each lane stopped by the budget reports
    exactly the budget."""
    mesh, p, mask, f = _case(6, 3, 3, 6.0)
    _, pk = _kernels(mesh, p, mask, True)
    material = tt.create_simp_material_model(1.0, 0.3, 1e-9, 3.0)
    rng = np.random.default_rng(7)
    dens = np.concatenate([rng.uniform(0.9, 1.0, (1, mesh.n_cells)),
                           rng.uniform(0.05, 1.0, (3, mesh.n_cells))])
    esc, F = sweep._as_lanes(pk, material.youngs_modulus(dens),
                             np.repeat(f[None], 4, 0))
    e, it, cv, x = sweep.solve_lanes(pk, esc, F, 1e-10, 30000,
                                     return_u=True)
    first = int(it[0])
    assert bool(cv.all()) and int(it[1:].min()) > first
    e2, it2, cv2, x2 = sweep.solve_lanes(pk, esc, F, 1e-10, first,
                                         return_u=True)
    assert int(it2[0]) == first and bool(cv2[0])
    assert torch.equal(x2[..., 0], x[..., 0]) and float(e2[0]) == float(e[0])
    assert not bool(cv2[1:].any())
    np.testing.assert_array_equal(it2.numpy(), first)


def test_sweep_surfaces_nonconvergence(monkeypatch):
    mesh, p, mask, f = _case(4, 2, 2, 6.0)
    _, pk = _kernels(mesh, p, mask, False)
    material = tt.create_simp_material_model(1.0, 0.3, 1e-9, 3.0)
    dens = np.full((1, mesh.n_cells), 0.4)
    _, it, cv = sweep.sweep_compliance(pk, material.youngs_modulus(dens),
                                       f[None], tol=1e-12, maxiter=3)
    assert not bool(cv[0, 0]) and int(it[0, 0]) == 3
    warnings = []
    monkeypatch.setattr(terminal, "print_warning", warnings.append)
    monkeypatch.setattr(tt.api, "print_warning", warnings.append)
    _, it, cv = tt.evaluate_design_batch(p, dens, material=material,
                                         tol=1e-12, maxiter=3)
    assert not cv.any() and (it == 3).all()
    assert warnings == ["1 of 1 sweep lanes did not converge within 3 "
                        "iterations"]


def test_lanes_that_fit_reads_free_memory():
    mesh, p, mask, _ = _case(4, 2, 2, 6.0)
    _, pk = _kernels(mesh, p, mask, True)
    per = pk.bytes_per_lane()
    C, N = mesh.n_cells, mesh.n_nodes
    assert per >= 8 * (4 * 12 * C + 9 * N)
    assert pk.lanes_that_fit() >= 1
