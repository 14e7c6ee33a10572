"""The port's sharded multigrid (parallel/halo_mg.py) and
``solve_system(devices=...)`` against the JAX package, on the CPU with 8
shards, on the 60x20x4 beam of 6x3x2 hexes (tests/test_halo_mg.py's
mesh) with its ``structured_info`` dropped, so both packages take the
block-ELL hierarchy.  Both packages run their NumPy/scipy host builds
(host libraries off), so they build the same hierarchy.

- The skeleton route records the fine transfer, equal to the JAX
  package's, and the hierarchy and skeleton caches carry it.
- On a hierarchy the JAX package built, carried over by
  ``bell_from_numpy``: the slab-layout block inverses, parents and
  weights equal ``build_halo_multigrid``'s arrays, and one V-cycle agrees
  with the JAX package's to 1e-12.
- restrict == prolong^T on the slab layout.
- ``solve_system(devices=8)`` in float64 takes the JAX package's
  single-device multigrid count, within 1e-8 of its energy; the other
  cases of tests/test_halo_mg.py (float32 refined, block-Jacobi, float32
  block-Jacobi at 1e-10, the ``x0`` warm start) against it too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import threadpoolctl
import torch

import topopteval_tpu as t
from topopteval_tpu.fem import bell as jax_bell
from topopteval_tpu.models.beams import generate_grid_tet
from topopteval_tpu.fem.bc import free_mask_from_bcs as jax_free_mask
from topopteval_tpu.io import native as jax_native
from topopteval_tpu.parallel.halo_mg import (
    build_halo_multigrid as jax_build_halo_multigrid)
from topopteval_tpu.parallel.sharding import (
    build_device_mesh as jax_device_mesh)
import topopteval_tpu_torch as tt
from topopteval_tpu_torch.fem import bell
from topopteval_tpu_torch.io import native as port_native
from topopteval_tpu_torch.parallel.halo_mg import (build_halo_multigrid,
                                                  slab_transfer_arrays)
from topopteval_tpu_torch.parallel.sharding import build_device_mesh

tt.set_verbosity(False)
torch.set_num_threads(1)

BOX = (60.0, 20.0, 4.0)
MG_KW = dict(method="cg", preconditioner="multigrid", tolerance=1e-10,
             verbose=False)


@pytest.fixture(autouse=True, scope="module")
def _host_builds():
    """One BLAS thread (tier-1 runs files side by side), both host
    libraries off, no hierarchy disk cache."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_native, "_LIB", None)
    mp.setattr(jax_native, "_TRIED", True)
    mp.setenv("TOPOPT_MG_CACHE_DIR", "off")
    with threadpoolctl.threadpool_limits(1), port_native.use_native(False):
        yield
    mp.undo()


def _rel(a, b):
    return abs(a - b) / abs(b)


def _jax_problem(dtype):
    mesh = generate_grid_tet(6, 3, 2, (0, 0, 0), BOX)
    mesh.structured_info = None          # the general (block-ELL) route
    p = t.setup_problem(mesh, dtype=dtype)
    t.assemble_stiffness_matrix(p, *t.create_material_model(1.0, 0.3))
    t.apply_fixed_boundary(p, t.nodes_at_plane(p.mesh, 0, 0.0))
    t.apply_force(p, t.nodes_at_plane(p.mesh, 0, 60.0), [0.0, 0.0, -1.0])
    return p


def _problem(dtype):
    mesh = tt.generate_grid_tet(6, 3, 2, (0, 0, 0), BOX)
    mesh.structured_info = None
    p = tt.setup_problem(mesh, dtype=dtype, device="cpu")
    tt.assemble_stiffness_matrix(p, *tt.lame_parameters(1.0, 0.3))
    tt.apply_fixed_boundary(p, tt.nodes_at_plane(p.mesh, 0, 0.0))
    tt.apply_force(p, tt.nodes_at_plane(p.mesh, 0, 60.0), [0.0, 0.0, -1.0])
    return p


def _shards():
    return build_device_mesh(devices=["cpu"] * 8)


@pytest.fixture(scope="module")
def jax_single():
    """The JAX package's single-device float64 multigrid solve (~14 s of
    tracing)."""
    return t.solve_system(_jax_problem(jnp.float64), t.SolverConfig(
        **MG_KW, chunk_iterations=10 ** 6))


@pytest.fixture(scope="module")
def sharded64():
    return tt.solve_system(_problem(torch.float64), tt.SolverConfig(**MG_KW),
                           devices=8)


@pytest.fixture(scope="module")
def jax_hierarchy(tmp_path_factory):
    """The JAX package's block-ELL hierarchy of the beam (saved to a
    file), its sharded V-cycle on 8 devices, the mask and the Lame
    arrays."""
    p = _jax_problem(jnp.float64)
    mask = jax_free_mask(p.n_dofs, p.bcs)
    hier = jax_bell.build_bell_multigrid(p.mesh, p.lam, p.mu,
                                         free_mask=mask, dtype=jnp.float64,
                                         order=2)
    jhop, jhmg, _ = jax_build_halo_multigrid(
        p.mesh, p.lam, p.mu, jax_device_mesh(8), free_mask=mask,
        dtype=jnp.float64, order=2, hierarchy=hier)
    path = jax_bell.save_hierarchy(
        str(tmp_path_factory.mktemp("jax_hier") / "h.npz"), *hier)
    return p, mask, hier[2], path, jhop, jhmg


def test_skeleton_route_records_the_jax_fine_transfer(jax_hierarchy,
                                                      tmp_path):
    p, mask, jinfo, _, _, _ = jax_hierarchy
    mesh = tt.Mesh(p.mesh.coords, p.mesh.conn, "tet4")
    ref = jinfo["fine_transfer"]
    system, _, info = bell.build_bell_multigrid(
        mesh, p.lam, p.mu, free_mask=mask, dtype=torch.float64, device="cpu")
    assert info["route"] == "skeleton"
    path = bell.save_hierarchy(str(tmp_path / "h.npz"), info)
    _, _, loaded = bell.load_hierarchy(path, torch.float64, "cpu")
    skel = bell.load_skeleton(bell.save_skeleton(
        str(tmp_path / "s.npz"), bell.build_bell_skeleton(mesh, mask)))
    _, _, from_skel = bell.build_bell_values(skel, p.lam, p.mu,
                                             torch.float64, "cpu")
    for ft in (info["fine_transfer"], system.fine_transfer,
               loaded["fine_transfer"], from_skel["fine_transfer"]):
        for key in ("rows", "cols", "w"):
            np.testing.assert_array_equal(ft[key], ref[key])
        assert ft["n_coarse"] == ref["n_coarse"]


def test_cache_versions_are_bumped():
    # the caches gained the fine transfer: files of the versions before
    # it are rebuilt, not read without it
    assert bell._SKEL_VERSION >= 2 and bell._HIER_VERSION >= 2


def test_vcycle_on_the_jax_hierarchy(jax_hierarchy):
    p, mask, _, path, jhop, jhmg = jax_hierarchy
    sys_p, mg_p = bell.bell_from_numpy(np.load(path), torch.float64, "cpu")
    assert sys_p.fine_transfer is not None
    mesh = tt.Mesh(p.mesh.coords, p.mesh.conn, "tet4")
    hop, hmg, _ = build_halo_multigrid(mesh, p.lam, p.mu, _shards(),
                                       free_mask=mask, dtype=torch.float64,
                                       hierarchy=(sys_p, mg_p))
    np.testing.assert_array_equal(torch.cat(hmg.binv.blocks).numpy(),
                                  np.asarray(jhmg.binv))
    parents, pweights = slab_transfer_arrays(hop, sys_p)
    np.testing.assert_array_equal(parents, np.asarray(jhmg.parents))
    np.testing.assert_array_equal(pweights, np.asarray(jhmg.pweights))
    assert hmg.n1p == jhmg.n1p and hmg.lam_max == jhmg.lam_max
    r = np.random.default_rng(0).standard_normal(p.n_dofs)
    z_jax = jhop.from_local(jax.jit(jhmg.apply)(jhop.to_local(r)))
    z = hop.from_local(hmg.apply(hop.to_local(r)))
    np.testing.assert_allclose(z, z_jax, rtol=0,
                               atol=1e-12 * np.abs(z_jax).max())


def test_restrict_is_the_transpose_of_prolong():
    p = _problem(torch.float64)
    mask = tt.free_mask_from_bcs(p.n_dofs, p.bcs)
    hop, hmg, _ = build_halo_multigrid(p.mesh, p.lam, p.mu, _shards(),
                                       free_mask=mask, dtype=torch.float64)
    rng = np.random.default_rng(0)
    r = hop.to_local(rng.standard_normal(p.n_dofs))
    z = torch.as_tensor(rng.standard_normal(3 * hmg.n1p))
    lhs = float(torch.dot(hmg.restrict(r)[0], z))
    rhs = float(r.dot64(hmg.prolong([z] * hop.n_shards)))
    assert abs(lhs - rhs) <= 1e-12 * max(abs(lhs), 1.0)


def test_sharded_mg_takes_the_jax_count_fp64(jax_single, sharded64):
    assert jax_single.converged and sharded64.converged
    assert sharded64.method == "cg(multigrid,sharded)"
    assert sharded64.iterations == jax_single.iterations
    assert _rel(sharded64.energy, jax_single.energy) <= 1e-8
    assert np.abs(sharded64.u - jax_single.u).max() \
        <= 1e-7 * np.abs(jax_single.u).max()


@pytest.mark.parametrize("dtype,kw,gate", [
    # float32 multigrid inside the float64-certified refinement
    (torch.float32, dict(tolerance=1e-8), 1e-6),
    # the plain sharded CG with block-Jacobi and its backward-error gate
    (torch.float64, dict(preconditioner="block_diagonal", tolerance=1e-8,
                         max_iterations=5000), 1e-6),
    # float32 at a float64-grade tolerance off the multigrid route: the
    # refinement again, so the energy is float64-grade
    (torch.float32, dict(preconditioner="block_diagonal", tolerance=1e-10,
                         max_iterations=3000), 1e-8),
], ids=["mg_fp32_refined", "block_jacobi", "block_jacobi_fp32_1e-10"])
def test_sharded_routes(jax_single, dtype, kw, gate):
    r = tt.solve_system(_problem(dtype), tt.SolverConfig(**{**MG_KW, **kw}),
                        devices=8)
    assert r.converged
    assert r.method == ("cg(multigrid,sharded)"
                        if kw.get("preconditioner") is None
                        else "cg(sharded)")
    if "max_iterations" in kw:
        assert r.iterations < kw["max_iterations"]
    assert _rel(r.energy, jax_single.energy) <= gate


def test_sharded_x0_warm_start(sharded64):
    warm = tt.solve_system(_problem(torch.float64), tt.SolverConfig(**MG_KW),
                           x0=sharded64.u, devices=8)
    assert warm.converged
    assert warm.iterations <= max(2, sharded64.iterations // 10)
