"""The port's halo-exchange sharded operator (parallel/halo.py) against
the JAX package's on its 8 virtual CPU devices, and against the port's
single-device operator, with 8 shards on the CPU.

- The plan (partition, slab layout, boundary) equals the JAX package's
  array for array on the 12x6x4 and 9x5x3 boxes.
- Matvec, diagonal and node blocks agree to rtol 1e-12 (the tolerance of
  tests/test_halo.py) with both.
- Layout round trip; padded slab slots are fixed in the mask.
- Block-Jacobi CG over the shards takes the JAX package's halo CG count.
- Each collective of a matvec delivers S * nbs_max * 3 values, the
  boundary's size, not the DOF vector's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topopteval_tpu.fem.bc import (DirichletBC as JaxDirichletBC,
                                   free_mask_from_bcs as jax_free_mask,
                                   nodes_at_plane as jax_nodes_at_plane)
from topopteval_tpu.fem.solvers import (block_jacobi_preconditioner as
                                       jax_block_jacobi, cg as jax_cg)
from topopteval_tpu.models.beams import generate_grid_tet as jax_grid_tet
from topopteval_tpu.parallel.halo import (
    HaloShardedOperator as JaxHaloOperator)
from topopteval_tpu.parallel.sharding import (
    build_device_mesh as jax_device_mesh)
import topopteval_tpu_torch as tt
from topopteval_tpu_torch.fem.operator import StiffnessOperator
from topopteval_tpu_torch.fem.solvers import cg
from topopteval_tpu_torch.parallel import collectives
from topopteval_tpu_torch.parallel.halo import HaloShardedOperator
from topopteval_tpu_torch.parallel.sharding import build_device_mesh

tt.set_verbosity(False)
torch.set_num_threads(1)

LAM, MU = tt.lame_parameters(1.0, 0.3)
DIMS = (6.0, 3.0, 2.0)


def _case(nx, ny, nz, blocks):
    """(mesh, mask, JAX halo operator, port halo operator on 8 CPU
    shards, port single-device operator, the JAX operator's node blocks
    or None), all float64.  The JAX package compiles each sharded call
    (several seconds on 8 virtual devices), so its node blocks are taken
    once, on one box."""
    assert len(jax.devices()) >= 8
    jmesh = jax_grid_tet(nx, ny, nz, (0, 0, 0), DIMS)
    fixed = jax_nodes_at_plane(jmesh, 0, 0.0)
    mask = jax_free_mask(jmesh.n_dofs, [JaxDirichletBC.fixed(fixed)])
    jhop = JaxHaloOperator.build(jmesh, LAM, MU, jax_device_mesh(8),
                                 free_mask=mask, dtype=jnp.float64)
    mesh = tt.Mesh(jmesh.coords, jmesh.conn, "tet4")
    hop = HaloShardedOperator.build(
        mesh, LAM, MU, build_device_mesh(devices=["cpu"] * 8),
        free_mask=mask, dtype=torch.float64)
    op = StiffnessOperator.build(mesh.device(torch.float64, "cpu"), LAM, MU,
                                 free_mask=torch.as_tensor(mask))
    jblocks = np.asarray(jhop.node_blocks_raw()) if blocks else None
    return mesh, mask, jhop, hop, op, jblocks


@pytest.fixture(scope="module")
def box12():
    return _case(12, 6, 4, blocks=True)


@pytest.fixture(scope="module")
def box9():
    return _case(9, 5, 3, blocks=False)


@pytest.mark.parametrize("name", ["box12", "box9"])
def test_plan_equals_the_jax_package(name, request):
    _, _, jhop, hop, _, _ = request.getfixturevalue(name)
    for field in ("perm", "slab_of"):
        np.testing.assert_array_equal(getattr(hop.plan, field),
                                      getattr(jhop.plan, field))
    for field in ("n_shards", "ns_max", "nbs_max", "n_boundary"):
        assert getattr(hop.plan, field) == getattr(jhop.plan, field)


@pytest.mark.parametrize("name", ["box12", "box9"])
def test_matvec_diagonal_and_blocks_agree(name, request):
    mesh, mask, jhop, hop, op, jblocks = request.getfixturevalue(name)
    u = np.random.default_rng(0).standard_normal(mesh.n_dofs)
    f_port = hop.from_local(hop.matvec(hop.to_local(u)))
    f_jax = jhop.from_local(jhop.matvec(jhop.to_local(u)))
    f_one = op.matvec(torch.as_tensor(u)).numpy()
    for ref in (f_jax, f_one):
        np.testing.assert_allclose(f_port, ref, rtol=1e-12, atol=1e-12)
    d_port = hop.from_local(hop.diagonal())
    np.testing.assert_allclose(d_port, op.diagonal().numpy(), rtol=1e-12,
                               atol=1e-12)
    blocks = torch.cat(hop.node_blocks_raw()).numpy()
    np.testing.assert_allclose(blocks[hop.plan.perm],
                               op.node_blocks_raw().numpy(), rtol=1e-12,
                               atol=1e-12)
    if jblocks is not None:
        np.testing.assert_allclose(blocks, jblocks, rtol=1e-12, atol=1e-12)
        # the JAX package's diagonal() is the masked diagonal of these
        m = np.asarray(jhop.free_mask)
        d_jax = m * m * np.diagonal(jblocks, axis1=1, axis2=2).reshape(-1) \
            + (1.0 - m)
        np.testing.assert_allclose(torch.cat(hop.diagonal().parts).numpy(),
                                   d_jax, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name", ["box12", "box9"])
def test_layout_round_trip_and_padding(name, request):
    mesh, _, _, hop, _, _ = request.getfixturevalue(name)
    u = np.random.default_rng(1).standard_normal(mesh.n_dofs)
    u_l = hop.to_local(u)
    assert len(u_l.parts) == 8
    assert all(p.shape == (hop.ns_max * 3,) for p in u_l.parts)
    np.testing.assert_array_equal(hop.from_local(u_l), u)
    mask_l = torch.cat(hop.free_mask.parts).numpy()
    used = np.zeros(hop.n_dofs, bool)
    used[hop.plan.dofs()] = True
    assert np.all(mask_l[~used] == 0.0)


def test_block_jacobi_cg_takes_the_jax_count(box12):
    mesh, _, jhop, hop, _, jblocks = box12
    f = np.zeros(mesh.n_dofs)
    tip = tt.nodes_at_plane(mesh, 0, DIMS[0])
    f[tip * 3 + 2] = -1.0 / tip.size
    # jhop.block_jacobi() of the fixture's blocks, without a recompile
    M = jax_block_jacobi(jnp.asarray(jblocks), jhop.free_mask)
    ref = jax_cg(jhop, jhop.to_local(f) * jhop.free_mask, M=M, tol=1e-10,
                 maxiter=3000)
    res = cg(hop, hop.to_local(f) * hop.free_mask, M=hop.block_jacobi(),
             tol=1e-10, maxiter=3000)
    assert res.converged and bool(ref.converged)
    assert res.niter == int(ref.niter)
    np.testing.assert_allclose(hop.from_local(res.x),
                               jhop.from_local(ref.x), rtol=1e-9,
                               atol=1e-11)


def test_collectives_are_boundary_sized():
    mesh = tt.generate_grid_tet(40, 14, 12, (0, 0, 0), (20.0, 7.0, 6.0))
    hop = HaloShardedOperator.build(
        mesh, LAM, MU, build_device_mesh(devices=["cpu"] * 8),
        dtype=torch.float64)
    budget = 8 * hop.nbs_max * 3
    assert budget < mesh.n_dofs / 2            # the check is meaningful
    u = hop.to_local(np.zeros(mesh.n_dofs))
    collectives.reset_moved()
    hop.matvec(u)
    assert collectives.MOVED == {"all_gather": budget, "psum": budget}
