"""The port's stencil operator against the JAX package's, on the CPU in
float64: the same seeded inputs go through both.

- ``stencil_matvec_reference`` (the plain version of the CUDA stencil
  kernels) and ``StructuredStiffnessOperator`` against the JAX operator's
  ``slices`` route on the 6x4x2 box of tests/test_structured.py, uniform
  and with a random per-hex scale, masked and not; one case each against
  the JAX Pallas kernels (per-plane and z-blocked window) in interpret
  mode, on the smallest boxes that show a block seam.
- The port's stencil operator against the port's own gather operator
  (the plain version of the Tet4 kernel) on a box with three different
  dims and a non-symmetric scale grid, which a transposed ``esc`` fails.
- Both packages' generators give equal meshes, ``structured_info``
  included.

Tolerance: rtol 1e-11 / atol 1e-12, the JAX stencil tests' own.  Both
sides evaluate the same float64 operator in different summation orders,
so they agree to a few ulps of the largest entry (~10 here).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topopteval_tpu.fem.bc import (DirichletBC, free_mask_from_bcs,
                                   nodes_at_plane)
from topopteval_tpu.fem.structured import \
    StructuredStiffnessOperator as JaxStructured
from topopteval_tpu.materials import lame_parameters
from topopteval_tpu.models import beams as jax_beams
import topopteval_tpu_torch as tt
from topopteval_tpu_torch.fem.operator import StiffnessOperator
from topopteval_tpu_torch.ops import stencil
from topopteval_tpu_torch.ops.stencil import (stencil_matvec,
                                              stencil_matvec_reference)

tt.set_verbosity(False)
# these tests work on small tensors: one intra-op thread each, so that
# test processes running side by side do not fight over the cores (torch's
# thread pool spins at its barriers when the machine is oversubscribed)
torch.set_num_threads(1)

LAM, MU = lame_parameters(1.0, 0.3)
TOL = dict(rtol=1e-11, atol=1e-12)


def _pair(nx=6, ny=4, nz=2, box=(3.0, 2.4, 1.0), mask=True, escale=None):
    """(mesh, JAX stencil operator, port stencil operator)."""
    mesh = jax_beams.generate_grid_tet(nx, ny, nz, (0, 0, 0), box)
    fm = None
    if mask:
        fm = free_mask_from_bcs(
            mesh.n_dofs, [DirichletBC.fixed(nodes_at_plane(mesh, 0, 0.0))])
    ref = JaxStructured.build(nx, ny, nz, (0, 0, 0), box, LAM, MU,
                              free_mask=fm, escale=escale, dtype=jnp.float64)
    ours = tt.StructuredStiffnessOperator.build(
        nx, ny, nz, (0, 0, 0), box, LAM, MU, free_mask=fm, escale=escale,
        dtype=torch.float64, device="cpu")
    return mesh, ref, ours


def _escale(seed, nx, ny, nz):
    return np.random.default_rng(seed).uniform(0.1, 1.0, (nz, ny, nx))


@pytest.mark.parametrize("simp", [False, True], ids=["uniform", "simp"])
@pytest.mark.parametrize("mask", [False, True], ids=["raw", "masked"])
def test_structured_matvec_matches_jax_slices(mask, simp, monkeypatch):
    monkeypatch.setenv("TOPOPT_STENCIL", "slices")
    esc = _escale(1, 6, 4, 2) if simp else None
    mesh, ref, ours = _pair(mask=mask, escale=esc)
    u = np.random.default_rng(0).standard_normal(mesh.n_dofs)
    a = ref.matvec(jnp.asarray(u)) if mask else ref.matvec_raw(jnp.asarray(u))
    b = ours.matvec(torch.tensor(u)) if mask else \
        ours.matvec_raw(torch.tensor(u))
    np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)
    # the plain version itself, called as the kernels are
    direct = stencil_matvec_reference(
        torch.tensor(u), None if esc is None else torch.tensor(esc),
        torch.tensor(ref._hex_ke()), (6, 4, 2))
    np.testing.assert_allclose(direct.numpy(),
                               np.asarray(ref.matvec_raw(jnp.asarray(u))),
                               **TOL)


@pytest.mark.parametrize("kernel,dims", [("plane", (3, 2, 2)),
                                         ("window", (3, 2, 4))])
def test_structured_matvec_matches_jax_pallas_interpret(kernel, dims,
                                                        monkeypatch):
    """The TPU kernels these CUDA kernels replace, run in interpret mode.
    The window cap gives the z-blocked kernel two blocks on 5 planes, so
    a block seam lies inside the box."""
    nx, ny, nz = dims
    monkeypatch.setenv("TOPOPT_STENCIL", "pallas")
    monkeypatch.setenv("TOPOPT_STENCIL_KERNEL", kernel)
    monkeypatch.setenv("TOPOPT_STENCIL_WINDOW_MAX", str(64 * 1024))
    mesh, ref, ours = _pair(nx, ny, nz, escale=_escale(3, nx, ny, nz))
    u = np.random.default_rng(4).standard_normal(mesh.n_dofs)
    np.testing.assert_allclose(ours.matvec(torch.tensor(u)).numpy(),
                               np.asarray(ref.matvec(jnp.asarray(u))), **TOL)


@pytest.mark.parametrize("simp", [False, True], ids=["uniform", "simp"])
def test_structured_blocks_diagonal_and_hex_ke_match_jax(simp):
    esc = _escale(5, 6, 4, 2) if simp else None
    _, ref, ours = _pair(escale=esc)
    np.testing.assert_allclose(ours._hex_ke(), ref._hex_ke(), rtol=1e-14,
                               atol=0)
    np.testing.assert_allclose(ours.node_blocks_raw().numpy(),
                               np.asarray(ref.node_blocks_raw()), **TOL)
    np.testing.assert_allclose(ours.diagonal().numpy(),
                               np.asarray(ref.diagonal()), **TOL)
    np.testing.assert_allclose(ours.diagonal_raw().numpy(),
                               np.asarray(ref.diagonal_raw()), **TOL)
    assert ours.n_dofs == ref.n_dofs and ours.dims == ref.dims
    u = np.random.default_rng(6).standard_normal(ours.n_dofs)
    np.testing.assert_allclose(float(ours.energy(torch.tensor(u))),
                               float(ref.energy(jnp.asarray(u))), rtol=1e-12)


@pytest.mark.parametrize("simp", [False, True], ids=["uniform", "simp"])
def test_structured_operator_matches_port_gather_operator(simp):
    """Three different dims and a scale grid without any symmetry: an
    ``esc`` in the wrong axis order passes every uniform test and fails
    here.  The gather operator numbers hexes x-major (models/beams.py),
    the stencil takes a z-major [nz, ny, nx] grid."""
    nx, ny, nz = 5, 3, 2
    box = (2.5, 1.8, 0.8)
    mesh = tt.generate_grid_tet(nx, ny, nz, (0, 0, 0), box)
    fm = tt.free_mask_from_bcs(
        mesh.n_dofs, [tt.DirichletBC.fixed(tt.nodes_at_plane(mesh, 0, 0.0))])
    esc = _escale(7, nx, ny, nz) if simp else None
    per_tet = (np.ones(mesh.n_cells) if esc is None
               else np.repeat(esc.transpose(2, 1, 0).reshape(-1), 6))
    gather = StiffnessOperator.build(
        mesh.device(dtype=torch.float64, device="cpu"), LAM * per_tet,
        MU * per_tet, free_mask=torch.tensor(fm), order=1)
    ours = tt.StructuredStiffnessOperator.build(
        nx, ny, nz, (0, 0, 0), box, LAM, MU, free_mask=fm, escale=esc,
        dtype=torch.float64, device="cpu")
    u = torch.tensor(np.random.default_rng(8).standard_normal(mesh.n_dofs))
    np.testing.assert_allclose(ours.matvec(u).numpy(),
                               gather.matvec(u).numpy(), **TOL)
    np.testing.assert_allclose(ours.matvec_raw(u).numpy(),
                               gather.matvec_raw(u).numpy(), **TOL)
    np.testing.assert_allclose(ours.node_blocks_raw().numpy(),
                               gather.node_blocks_raw().numpy(), **TOL)


def test_stencil_reference_float32_survives_a_large_translation():
    """The difference form: on a rigid translation of 1000 plus a strain
    of 1e-3 (rounded to float32 first, so both dtypes see one input) the
    float32 plain version gives K u to 1e-5 of its largest entry, because
    differences of neighbouring float32 values are exact; summing raw
    Ke*u would carry the rounding of translation terms 1e6 times larger
    than the result (several per cent here)."""
    nx, ny, nz = 8, 4, 2
    mesh = tt.generate_grid_tet(nx, ny, nz, (0, 0, 0), (4.0, 2.0, 1.0))
    u32 = torch.tensor((1000.0 + 1e-3 * mesh.coords).reshape(-1),
                       dtype=torch.float32)
    out = {}
    for dtype in (torch.float64, torch.float32):
        op = tt.StructuredStiffnessOperator.build(
            nx, ny, nz, (0, 0, 0), (4.0, 2.0, 1.0), LAM, MU, dtype=dtype,
            device="cpu")
        out[dtype] = op.matvec_raw(u32.to(dtype)).double()
    scale = float(out[torch.float64].abs().max())
    assert scale > 1e-4
    assert float((out[torch.float32] - out[torch.float64]).abs().max()) \
        <= 1e-5 * scale


def test_stencil_wrapper_on_cpu_runs_plain_version_and_checks_inputs(
        monkeypatch):
    nx, ny, nz = 3, 2, 2
    rng = np.random.default_rng(9)
    u = torch.tensor(rng.standard_normal(3 * 4 * 3 * 3))
    esc = torch.tensor(rng.uniform(0.1, 1.0, (nz, ny, nx)))
    ke = torch.tensor(rng.standard_normal((24, 24)))
    stencil.reset_launch_counts()
    for kernel in (None, "plane", "window"):
        torch.testing.assert_close(
            stencil_matvec(u, esc, ke, (nx, ny, nz), kernel=kernel),
            stencil_matvec_reference(u, esc, ke, (nx, ny, nz)), rtol=0,
            atol=0)
    assert stencil.LAUNCHES == {"stencil_plane": 0, "stencil_window": 0}
    assert stencil.kernel_choice() == "plane"
    monkeypatch.setenv("TOPOPT_STENCIL_KERNEL", "window")
    assert stencil.kernel_choice() == "window"
    assert stencil.kernel_choice("plane") == "plane"
    with pytest.raises(ValueError, match="one of"):
        stencil.kernel_choice("conv")
    with pytest.raises(ValueError, match="DOFs"):
        stencil_matvec(u[:-3], esc, ke, (nx, ny, nz))
    with pytest.raises(ValueError, match=r"\[nz, ny, nx\]"):
        stencil_matvec(u, esc.permute(2, 1, 0).contiguous(), ke, (nx, ny, nz))
    with pytest.raises(TypeError):
        stencil_matvec(u, esc.float(), ke, (nx, ny, nz))
    with pytest.raises(TypeError):
        stencil_matvec(u.to(torch.float16), None, ke.to(torch.float16),
                       (nx, ny, nz))
    with pytest.raises(ValueError, match="contiguous"):
        stencil_matvec(u, esc, ke.t(), (nx, ny, nz))


@pytest.mark.parametrize("element", ["tet4", "hex8"])
def test_generators_match_jax_with_structured_info(element):
    """Both packages' generators give the same mesh and the same
    ``structured_info``, the field that selects the multigrid route."""
    args = (5, 3, 2, (0.0, -1.0, 0.5), (2.5, 0.8, 1.3))
    name = "generate_grid_tet" if element == "tet4" else "generate_grid_hex"
    ref = getattr(jax_beams, name)(*args)
    ours = getattr(tt, name)(*args)
    np.testing.assert_array_equal(ours.coords, ref.coords)
    np.testing.assert_array_equal(ours.conn, ref.conn)
    assert ours.element_type == ref.element_type
    assert ours.structured_info == ref.structured_info
    # a mesh read from a file carries none, as in the JAX package
    assert tt.Mesh(ours.coords, ours.conn, element).structured_info is None


def test_refined_beam_and_presets_match_jax():
    from topopteval_tpu import config as jax_config
    ref = jax_beams.refined_beam(3000)
    ours = tt.refined_beam(3000)
    assert ours.structured_info == ref.structured_info
    np.testing.assert_array_equal(ours.conn, ref.conn)
    for name in ("large_symmetric_config", "large_general_config",
                 "memory_efficient_config"):
        a, b = getattr(tt, name)(), getattr(jax_config, name)()
        assert (a.method, a.preconditioner, a.tolerance, a.max_iterations,
                a.restart) == (b.method, b.preconditioner, b.tolerance,
                               b.max_iterations, b.restart)
    a, b = tt.adaptive_config(123_456), jax_config.adaptive_config(123_456)
    assert (a.method, a.max_iterations, a.history) == \
        (b.method, b.max_iterations, b.history)
