"""The port's Galerkin voxel multigrid against the JAX package's, on the
imported Tet4 cantilever fixture in float64 on the CPU: the same mesh,
material and clamp go through both ``build_unstructured_multigrid``s.

- the hierarchy: voxel lattice and level count (through the transfer's
  coarse node count), masks, block inverses, lambda_max(B^-1 A) (1e-10:
  the same NumPy power iteration on the same float32 Ke batch), every
  Galerkin level's operator (1e-12 of its largest entry: float64 probe
  sums in two orders) and the coarse pseudo-inverse (1e-9 of its largest
  entry: the eigencut inverse of a rank-deficient matrix amplifies the
  operator's rounding differences);
- the JAX package's MG-PCG iteration count at tolerance 1e-10
  (``FIXTURE_ITERATIONS``).

The kernels' plain versions (``ops/ell``) carry the coarse levels and the
transfers here.  The port's MG-PCG on its own hierarchy (that count, the
direct energy, V-cycle symmetry), ``galerkin_voxel_operator`` on its own,
the transfers, the host twin and ``solve_system`` are in
tests/test_torch_galerkin_solve.py, which keeps this file under 40 s.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import threadpoolctl
import torch

from topopteval_tpu.api import import_mesh as jax_import_mesh
from topopteval_tpu.fem import multigrid as jax_mg
from topopteval_tpu.fem.solvers import cg as jax_cg
from topopteval_tpu.materials import lame_parameters
import topopteval_tpu_torch as tt
from topopteval_tpu_torch.fem import multigrid as port_mg
from topopteval_tpu_torch.fem.ell import ELLBlockOperator

tt.set_verbosity(False)
torch.set_num_threads(1)

LAM, MU = lame_parameters(1.0, 0.3)

#: MG-PCG iterations of both packages on this fixture at tolerance 1e-10
#: (float64, CPU); chip_smoke.py phase 10b holds the card to it
FIXTURE_ITERATIONS = 111


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """The host build's dense eigensolve runs in OpenBLAS: one thread, so
    that test processes side by side do not fight over the cores."""
    with threadpoolctl.threadpool_limits(1):
        yield


@pytest.fixture(scope="module")
def fixture(beam_tet_path):
    mesh = tt.import_mesh(beam_tet_path)
    mask = tt.free_mask_from_bcs(mesh.n_dofs, [tt.DirichletBC.fixed(
        tt.nodes_at_plane(mesh, 0, 0.0, tol=1e-6))])
    tip = tt.nodes_at_plane(mesh, 0, 60.0, tol=1e-6)
    f = np.zeros(mesh.n_dofs)
    f[tip * 3 + 2] = -1.0 / tip.size
    return mesh, mask, f


def _recording(mp, module, names):
    """Wrap the Galerkin-operator builders of ``module`` (fem.multigrid of
    either package) so that each returned (operator, mask) is kept."""
    made = []
    for name in names:
        fn = getattr(module, name)

        def wrapped(*args, _fn=fn, **kw):
            out = _fn(*args, **kw)
            made.append(out)
            return out

        mp.setattr(module, name, wrapped)
    return made


_BUILDERS = ("galerkin_voxel_operator", "_rap_host")


@pytest.fixture(scope="module")
def jax_hier(beam_tet_path, fixture):
    _, mask, _ = fixture
    with pytest.MonkeyPatch.context() as mp:
        made = _recording(mp, jax_mg, _BUILDERS)
        op, mg = jax_mg.build_unstructured_multigrid(
            jax_import_mesh(beam_tet_path), LAM, MU, free_mask=mask,
            dtype=jnp.float64)
    return op, mg, made


@pytest.fixture(scope="module")
def port_hier(fixture):
    mesh, mask, _ = fixture
    info = {}
    with pytest.MonkeyPatch.context() as mp:
        made = _recording(mp, port_mg, _BUILDERS)
        op, mg = port_mg.build_unstructured_multigrid(
            mesh, LAM, MU, free_mask=mask, dtype=torch.float64,
            device="cpu", info=info)
    return op, mg, info, made


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def test_hierarchy_equals_jax(jax_hier, port_hier):
    jop, jmg, jmade = jax_hier
    op, mg, info, made = port_hier
    vx, vy, vz = info["lattice"]
    # the fixture's lattice: one voxel level (its Galerkin operator is the
    # coarsest), probe reach 3 (elements wider than one voxel)
    assert info["voxel_levels"] == len(mg.levels) == len(jmg.levels) == 1
    assert info["reach"] == (3, 3, 3) and info["n_probes"] == 7 ** 3 * 3
    n_vox = (vx + 1) * (vy + 1) * (vz + 1)
    assert jmg.levels[0].transfer.incidence.shape[0] == n_vox
    assert info["level_nodes"] == [op.plan.n_nodes, n_vox]
    assert mg.omega == jmg.omega and mg.nu == jmg.nu
    assert mg.smoother == jmg.smoother == "chebyshev"
    for L, J in zip(mg.levels, jmg.levels):
        np.testing.assert_array_equal(L.op.free_mask.numpy(),
                                      np.asarray(J.op.free_mask))
        assert abs(L.lam_max - J.lam_max) <= 1e-10 * J.lam_max
        assert _rel(L.binv.numpy(), J.binv) <= 1e-12
    # the voxel transfer against the JAX parent/weight gather
    e = np.random.default_rng(0).standard_normal((n_vox, 3))
    r = np.random.default_rng(1).standard_normal((op.plan.n_nodes, 3))
    T, J0 = mg.levels[0].transfer, jmg.levels[0].transfer
    np.testing.assert_allclose(T.prolong(torch.as_tensor(e)).numpy(),
                               np.asarray(J0.prolong(jnp.asarray(e))),
                               rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(T.restrict(torch.as_tensor(r)).numpy(),
                               np.asarray(J0.restrict(jnp.asarray(r))),
                               rtol=1e-12, atol=1e-12)
    # every Galerkin operator the builds made, with its mask
    assert len(made) == len(jmade) == info["voxel_levels"]
    for (ell, mask), (jell, jmask) in zip(made, jmade):
        assert isinstance(ell, ELLBlockOperator)
        np.testing.assert_array_equal(mask, jmask)
        A, JA = ell.to_scipy_bsr().toarray(), jell.to_scipy_bsr().toarray()
        assert _rel(A, JA) <= 1e-12
    assert _rel(mg.coarse_inv.numpy(), jmg.coarse_inv) <= 1e-9


def test_jax_mg_pcg_iteration_count(fixture, jax_hier):
    """The JAX package's MG-PCG count on this fixture, which the port's
    solve on its own hierarchy must take (tests/test_torch_galerkin_solve
    .py, chip_smoke.py phase 10b): FIXTURE_ITERATIONS."""
    _, _, f = fixture
    jop, jmg, _ = jax_hier
    jres = jax_cg(jop, jnp.asarray(f) * jop.free_mask, M=jmg, tol=1e-10,
                  maxiter=300)
    assert bool(jres.converged)
    assert int(jres.niter) == FIXTURE_ITERATIONS
