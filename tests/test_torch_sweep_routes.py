"""``evaluate_design_batch`` of the port against the JAX package's sweep
lanes and the port's direct solves, on the CPU in float64 (the cases of
tests/test_parallel.py:205-270 except the sharded placement, and
tests/test_end_to_end.py:214-222): the nu derivation, lane chunking
against the full batch, the default pairs route against the chunked
einsum route and chunks of pairs sized from free memory, the mixed-nu
rejection, and the SIMP Hex8 fixture within 1e-6 of
``solve_system_simp``.  The sweep's kernel and lanes are in
tests/test_torch_sweep.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topopteval_tpu.fem.bc import DirichletBC as JaxDirichletBC
from topopteval_tpu.fem.bc import free_mask_from_bcs as jax_free_mask
from topopteval_tpu.fem.bc import nodes_at_plane as jax_nodes_at_plane
from topopteval_tpu.models import beams as jax_beams
from topopteval_tpu.parallel import sweep as jax_sweep
import topopteval_tpu_torch as tt
from topopteval_tpu_torch.parallel import sweep

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


def test_evaluate_design_batch_derives_nu():
    mesh, p, mask, f = _case(4, 2, 2, 6.0)
    lam25, mu25 = tt.lame_parameters(1.0, 0.25)
    p.lam = np.full(mesh.n_cells, lam25)
    p.mu = np.full(mesh.n_cells, mu25)
    dens = np.random.default_rng(9).uniform(0.4, 1.0, (4, mesh.n_cells))
    e, it, cv = tt.evaluate_design_batch(p, dens, tol=1e-10, maxiter=20000,
                                         dtype=F64)
    assert cv.all() and e.shape == (4, 1) and it.dtype == np.int64
    # no material: E(rho) = rho at the derived nu = 0.25
    jk = jax_sweep.SweepKernel.build(mesh, 0.25, mask, dtype=jnp.float64,
                                     full_ke=True)
    e_j = np.asarray(jax_sweep.sweep_compliance_pairs(
        jk, jnp.asarray(dens), jnp.asarray(np.repeat(f[None], 4, 0)),
        tol=1e-10, maxiter=20000)[0])
    np.testing.assert_allclose(e[:, 0], e_j, rtol=1e-10)
    for b in (0, 3):
        np.testing.assert_allclose(
            e[b, 0], _direct(p, lam25 * dens[b], mu25 * dens[b], f),
            rtol=1e-6)


def test_evaluate_design_batch_lane_chunking_matches_full():
    mesh, p, mask, f = _case(4, 2, 2, 6.0)
    dens = np.random.default_rng(3).uniform(0.4, 1.0, (7, mesh.n_cells))
    loads = np.stack([f, -0.5 * f])
    kw = dict(tol=1e-12, maxiter=20000, dtype=F64)
    e_full, it_full, cv_full = tt.evaluate_design_batch(
        p, dens, loads, lane_chunk=7, **kw)
    e_chunk, it_chunk, cv_chunk = tt.evaluate_design_batch(
        p, dens, loads, lane_chunk=3, **kw)
    assert e_chunk.shape == (7, 2) and cv_chunk.all() and cv_full.all()
    np.testing.assert_allclose(e_chunk, e_full, rtol=1e-10)


def test_evaluate_design_batch_pairs_route_matches_lane_chunks(monkeypatch):
    """The default pairs route (GEMM form) against the density-chunked
    einsum route, and chunks of pairs sized from free memory."""
    mesh, p, mask, f = _case(5, 2, 2, 6.0)
    dens = np.random.default_rng(11).uniform(0.4, 1.0, (5, mesh.n_cells))
    loads = np.stack([f, -0.5 * f])
    kw = dict(tol=1e-12, maxiter=20000, dtype=F64)
    e_leg, _, cv_leg = tt.evaluate_design_batch(p, dens, loads,
                                                lane_chunk=5, **kw)
    e_pairs, _, cv_pairs = tt.evaluate_design_batch(p, dens, loads, **kw)
    assert cv_leg.all() and cv_pairs.all()
    np.testing.assert_allclose(e_pairs, e_leg, rtol=1e-10)
    calls = []
    real = sweep.sweep_compliance_pairs

    def spy(kernel, esc, loads, **k):
        calls.append(len(esc))
        return real(kernel, esc, loads, **k)

    monkeypatch.setattr(sweep.SweepKernel, "lanes_that_fit",
                        lambda self: 4)
    monkeypatch.setattr(sweep, "sweep_compliance_pairs", spy)
    e_small, _, _ = tt.evaluate_design_batch(p, dens, loads, **kw)
    assert calls == [4, 4, 2]
    np.testing.assert_allclose(e_small, e_pairs, rtol=1e-10)


def test_evaluate_design_batch_rejects_mixed_nu():
    mesh, p, _, _ = _case(4, 2, 2, 6.0)
    p.lam = np.random.default_rng(1).uniform(0.5, 1.5, mesh.n_cells)
    p.mu = np.full(mesh.n_cells, 0.4)
    with pytest.raises(ValueError, match="Poisson"):
        tt.evaluate_design_batch(p, np.ones((2, mesh.n_cells)))
    p.lam = p.mu = None
    with pytest.raises(RuntimeError, match="material"):
        tt.evaluate_design_batch(p, np.ones((2, mesh.n_cells)))


def test_evaluate_design_batch_matches_simp_solve(beam_hex_path):
    simp = tt.simp_beam(beam_hex_path, dtype=F64, device="cpu")
    density = tt.extract_cell_density(beam_hex_path)
    energies, iters, conv = tt.evaluate_design_batch(
        simp, density[None], tol=1e-10, maxiter=20000, dtype=F64)
    assert conv.all()
    ref = tt.solve_system_simp(simp)
    np.testing.assert_allclose(energies[0, 0], ref.energy, rtol=1e-6)
