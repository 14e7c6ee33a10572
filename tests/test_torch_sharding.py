"""Device grids, the element-sharded operator, the data-parallel sweep and
the dry run of the port (parallel/sharding.py, parallel/sweep.py,
dryrun.py), on the CPU: the JAX package's ShardedStiffnessOperator on its
8 virtual devices against the port's 8 CPU shards (rtol 1e-10, the
tolerance of tests/test_parallel.py), ``build_device_mesh`` shapes and
errors, ``shard_sweep_inputs``, the multi-device branch of
``evaluate_design_batch`` under a patched device list (tests/
test_parallel.py:172-210), and ``dryrun_multichip(8)`` on CPU shards.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topopteval_tpu.models.beams import generate_grid_tet as jax_grid_tet
from topopteval_tpu.parallel import (
    ShardedStiffnessOperator as JaxShardedOperator)
from topopteval_tpu.parallel import build_device_mesh as jax_device_mesh
import topopteval_tpu_torch as tt
from topopteval_tpu_torch.parallel import (DATA_AXIS, ELEM_AXIS,
                                           ShardedStiffnessOperator,
                                           build_device_mesh,
                                           shard_sweep_inputs)
from topopteval_tpu_torch.parallel import sweep as sweep_mod

tt.set_verbosity(False)
torch.set_num_threads(1)

CPU = torch.device("cpu")


def _cantilever(nx=6, ny=3, nz=3, nu=0.3):
    mesh = tt.generate_grid_tet(nx, ny, nz, (0, 0, 0), (6, 1, 1))
    p = tt.setup_problem(mesh, dtype=torch.float64, device="cpu")
    tt.assemble_stiffness_matrix(p, *tt.lame_parameters(1.0, nu))
    tt.apply_fixed_boundary(p, tt.nodes_at_plane(mesh, 0, 0.0))
    tt.apply_force(p, tt.nodes_at_plane(mesh, 0, 6.0), [0, 0, -1.0])
    return mesh, p


def test_sharded_operator_matches_the_jax_package():
    assert len(jax.devices()) >= 8
    mesh, p = _cantilever()
    mask = tt.free_mask_from_bcs(p.n_dofs, p.bcs)
    jmesh = jax_grid_tet(6, 3, 3, (0, 0, 0), (6, 1, 1))
    assert np.array_equal(jmesh.conn, mesh.conn)
    jsop = JaxShardedOperator.build(jmesh, p.lam, p.mu, jax_device_mesh(8),
                                    free_mask=mask, dtype=jnp.float64)
    sop = ShardedStiffnessOperator.build(
        mesh, p.lam, p.mu, build_device_mesh(devices=[CPU] * 8),
        free_mask=mask, dtype=torch.float64)
    op = p.build_operator(with_bc=True)
    u = np.random.default_rng(0).standard_normal(p.n_dofs)
    f = sop.matvec(torch.as_tensor(u)).numpy()
    np.testing.assert_allclose(f, np.asarray(jsop.matvec(jnp.asarray(u))),
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(f, op.matvec(torch.as_tensor(u)).numpy(),
                               rtol=1e-10, atol=1e-10)
    d = sop.diagonal().numpy()
    np.testing.assert_allclose(d, np.asarray(jsop.diagonal()), rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_allclose(d, op.diagonal().numpy(), rtol=1e-10,
                               atol=1e-10)


def test_device_mesh_shapes():
    dm = build_device_mesh(devices=[CPU] * 8, data_parallel=2)
    assert dm.shape == {DATA_AXIS: 2, ELEM_AXIS: 4}
    assert dm.elem_devices == [CPU] * 4 and dm.data_devices == [CPU] * 2
    assert build_device_mesh(devices=["cpu"] * 4, n_devices=2).shape == {
        DATA_AXIS: 1, ELEM_AXIS: 2}


def test_device_mesh_errors(monkeypatch):
    with pytest.raises(ValueError, match="not divisible"):
        build_device_mesh(devices=[CPU] * 6, data_parallel=4)
    with pytest.raises(ValueError, match="3 shards asked for, 2 devices"):
        build_device_mesh(3, devices=[CPU] * 2)
    # an int count takes one visible card per shard, and says how to put
    # several shards on one card when there are too few
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match=r"devices=\[torch.device"):
        build_device_mesh(4)


def test_an_int_count_without_cuda_gives_cpu_shards(monkeypatch):
    # no card and no device list is an error, not CPU shards; CPU shards
    # come from a CPU device list, or from an int count on a CPU problem
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=r"devices=\['cpu'\] \* n"):
        build_device_mesh(8, data_parallel=2)
    dm = build_device_mesh(devices=[CPU] * 8, data_parallel=2)
    assert dm.shape == {DATA_AXIS: 2, ELEM_AXIS: 4}
    assert set(dm.elem_devices) == {CPU}
    _, p = _cantilever(4, 2, 2, nu=0.3)
    r = tt.solve_system(p, tt.SolverConfig(method="cg",
                                           preconditioner="block_diagonal",
                                           tolerance=1e-8, verbose=False),
                        devices=4)
    assert r.method == "cg(sharded)" and r.converged


def test_shard_sweep_inputs():
    dm = build_device_mesh(devices=[CPU] * 4, data_parallel=4)
    esc = np.arange(14.0).reshape(7, 2)
    loads = np.ones((3, 5))
    parts, lds = shard_sweep_inputs(dm, esc, loads)
    assert [p.shape[0] for p in parts] == [2, 2, 2, 1]
    np.testing.assert_array_equal(torch.cat(parts).numpy(), esc)
    assert len(lds) == 4
    assert all(np.array_equal(f.numpy(), loads) for f in lds)
    assert all(t.device == CPU for t in (*parts, *lds))


def _split_spy(monkeypatch):
    calls = []
    real = sweep_mod.shard_sweep_inputs

    def spy(dm, e, f):
        calls.append((dm.shape[DATA_AXIS], e.shape[0]))
        return real(dm, e, f)

    monkeypatch.setattr(sweep_mod, "shard_sweep_inputs", spy)
    return calls


def test_evaluate_design_batch_splits_over_devices(monkeypatch):
    """With 8 devices given the batch goes through ``shard_sweep_inputs``
    (the pairs route, one density a device here), nu comes from the
    assembled material (0.25), and the energies equal the one-device
    route's, the counts those of one device running the same parts, and
    the direct solves of sampled lanes."""
    mesh, p = _cantilever(4, 2, 2, nu=0.25)
    lam25, mu25 = tt.lame_parameters(1.0, 0.25)
    calls = _split_spy(monkeypatch)
    rng = np.random.default_rng(9)
    B = 8
    dens = rng.uniform(0.4, 1.0, (B, mesh.n_cells))
    loads = np.stack([p.f, -0.5 * p.f])
    kw = dict(tol=1e-10, maxiter=20000, dtype=torch.float64)
    one = tt.evaluate_design_batch(p, dens, loads, **kw)
    same_parts = np.concatenate([
        tt.evaluate_design_batch(p, dens[b:b + 1], loads, **kw)[1]
        for b in range(B)])
    assert not calls
    e, it, cv = tt.evaluate_design_batch(p, dens, loads, devices=[CPU] * 8,
                                         **kw)
    assert calls == [(8, B)]
    assert cv.all() and e.shape == (B, 2)
    np.testing.assert_array_equal(it, same_parts)
    np.testing.assert_allclose(e, one[0], rtol=1e-12, atol=0)
    for b in (0, B - 1):
        q = tt.setup_problem(mesh, dtype=torch.float64, device="cpu")
        q.lam, q.mu = lam25 * dens[b], mu25 * dens[b]
        q.bcs, q.f = p.bcs, p.f
        r = tt.solve_system(q, tt.SolverConfig(method="direct",
                                               verbose=False))
        np.testing.assert_allclose(e[b, 0], r.energy, rtol=1e-6)


def test_evaluate_design_batch_splits_einsum_chunks(monkeypatch):
    """An explicit ``lane_chunk`` takes the einsum route: each chunk of 8
    densities is split over the 8 devices, one density a device.  The
    energies equal one device's chunks of 8 to 1e-12; the counts equal one
    device's running the same parts (chunks of 1): a lane's rounding
    depends on the lanes beside it, so a count of the chunks of 8 can
    differ by one from the chunks of 1."""
    mesh, p = _cantilever(4, 2, 2, nu=0.25)
    calls = _split_spy(monkeypatch)
    B = 16
    dens = np.random.default_rng(10).uniform(0.4, 1.0, (B, mesh.n_cells))
    loads = np.stack([p.f, -0.5 * p.f])
    kw = dict(tol=1e-10, maxiter=20000, dtype=torch.float64)
    one = tt.evaluate_design_batch(p, dens, loads, lane_chunk=8, **kw)
    same_parts = tt.evaluate_design_batch(p, dens, loads, lane_chunk=1,
                                          **kw)
    assert not calls
    # an int on a problem on the CPU: that many CPU shards
    e, it, cv = tt.evaluate_design_batch(p, dens, loads, lane_chunk=8,
                                         devices=8, **kw)
    assert calls == [(8, 8), (8, 8)]
    assert cv.all()
    np.testing.assert_array_equal(it, same_parts[1])
    np.testing.assert_allclose(e, same_parts[0], rtol=1e-12, atol=0)
    np.testing.assert_allclose(e, one[0], rtol=1e-12, atol=0)


def test_run_on_devices_keeps_job_order_and_raises():
    """One thread per distinct device, results in job order, a job's
    error raised to the caller."""
    meta = torch.device("meta")
    jobs = [(CPU, lambda: 0), (meta, lambda: 1), (CPU, lambda: 2),
            (meta, lambda: 3)]
    assert sweep_mod.run_on_devices(jobs) == [0, 1, 2, 3]
    assert sweep_mod.run_on_devices([]) == []

    def bad():
        raise ValueError("lane failed")

    with pytest.raises(ValueError, match="lane failed"):
        sweep_mod.run_on_devices([(CPU, lambda: 0), (meta, bad)])


def test_dryrun_multichip_on_cpu_shards():
    from topopteval_tpu_torch.dryrun import dryrun_multichip
    out = dryrun_multichip(8, device="cpu")
    assert out["grid"] == [2, 4]
    assert out["halo_cg_rel"] <= 1e-4 and out["mg_pcg_rel"] <= 1e-7
    assert out["sweep_rel_max"] <= 1e-4
