"""Quadratic elements (tet10, hex20) and the Ke batches of the PyTorch
port against the JAX package, on the CPU in float64.

- shape functions, quadrature tables and ``Mesh.to_quadratic`` on the
  imported Tet4 cantilever fixture and on generated boxes: identical
  arrays;
- the plain ``element_stiffness`` and ``apply_element_stiffness`` of all
  four solid types against the JAX einsum route;
- the port's Ke-batch and tet10-apply wrappers (their plain versions on a
  CPU tensor) against the JAX Pallas kernels, on the curved tet10 batch
  and the non-uniform lam, mu of tests/test_pallas.py:111-175:
  ``tet4_element_stiffness_pallas`` and ``tet10_apply_pallas`` in
  interpret mode, and both B8 variants (``_make_iso_ke_kernel`` and
  ``_make_iso_ke_kernel_stream``, the kernels of ``hex8_`` and
  ``tet10_element_stiffness_pallas`` with ``stream=False`` and
  ``stream=True``) as kernel bodies run once over the whole batch, on
  NumPy arrays standing in for their VMEM blocks.  In interpret mode the
  B8 kernels cost 2-5 minutes each on this CPU (XLA compiles one
  read-modify-write per Ke entry and point), past this file's budget;
  tests/test_pallas.py holds them in interpret mode to the einsum route,
  which this file holds the port to.

Tolerance: rtol=1e-10, as tests/test_pallas.py uses, with an absolute
floor of 1e-10 of the largest entry.  Both sides evaluate the same
formulas in float64 in different association orders, which leaves a few
ulps times the element's conditioning.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topopteval_tpu.io.vtu import read_vtu_mesh as jax_read_vtu
from topopteval_tpu.models.beams import generate_grid_hex, generate_grid_tet
from topopteval_tpu.ops import elements as jax_elements
from topopteval_tpu.ops import pallas_kernels as pk
import topopteval_tpu_torch as tt
from topopteval_tpu_torch.ops import element_kernels as ek
from topopteval_tpu_torch.ops import elements as port_elements
from topopteval_tpu_torch.ops import ke_kernels as kk

tt.set_verbosity(False)
# these tests work on small tensors: one intra-op thread each, so that
# test processes running side by side do not fight over the cores
torch.set_num_threads(1)

RTOL = 1e-10
SOLID_TYPES = ("tet4", "hex8", "tet10", "hex20")


def _assert_close(actual, desired):
    desired = np.asarray(desired)
    np.testing.assert_allclose(np.asarray(actual), desired, rtol=RTOL,
                               atol=RTOL * np.abs(desired).max())


@pytest.mark.parametrize("element_type", SOLID_TYPES)
def test_tables_equal_jax(element_type):
    for order in (1, 2, 3):
        for ours, ref in zip(port_elements.element_tables(element_type,
                                                          order),
                             jax_elements.element_tables(element_type,
                                                         order)):
            np.testing.assert_array_equal(ours, ref)
    rng = np.random.default_rng(0)
    shape_fn, grad_fn = port_elements._SHAPE_FNS[element_type]
    ref_shape, ref_grad = jax_elements._SHAPE_FNS[element_type]
    for xi in rng.uniform(-0.3, 0.6, (5, 3)):
        np.testing.assert_array_equal(shape_fn(xi), ref_shape(xi))
        np.testing.assert_array_equal(grad_fn(xi), ref_grad(xi))


@pytest.mark.parametrize("element_type", ["tet10", "hex20"])
def test_quadratic_basis_is_a_partition_of_unity(element_type):
    """sum N = 1 and sum dN = 0 at every point; N_i(x_j) = delta_ij at the
    nodes."""
    N, dN, _ = port_elements.element_tables(element_type, 2)
    np.testing.assert_allclose(N.sum(axis=1), 1.0, atol=1e-14)
    np.testing.assert_allclose(dN.sum(axis=1), 0.0, atol=1e-14)
    shape_fn = port_elements._SHAPE_FNS[element_type][0]
    if element_type == "hex20":
        nodes = port_elements.HEX20_NAT
    else:
        corners = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1.0]])
        edges = tt.mesh.EDGE_TABLES["tet4"]
        nodes = np.vstack([corners] + [0.5 * (corners[a] + corners[b])
                                       for a, b in edges])
    vals = np.stack([shape_fn(x) for x in nodes])
    np.testing.assert_allclose(vals, np.eye(len(nodes)), atol=1e-14)


def _both_quadratic(jax_mesh):
    ours = tt.Mesh(jax_mesh.coords, jax_mesh.conn,
                   jax_mesh.element_type).to_quadratic()
    return ours, jax_mesh.to_quadratic()


@pytest.mark.parametrize("case", ["fixture_tet4", "box_tet4", "box_hex8"])
def test_to_quadratic_equals_jax(case, beam_tet_path):
    jax_mesh = {"fixture_tet4": lambda: jax_read_vtu(beam_tet_path),
                "box_tet4": lambda: generate_grid_tet(
                    5, 3, 2, (0, 0, 0), (5.0, 3.0, 2.0)),
                "box_hex8": lambda: generate_grid_hex(
                    4, 3, 2, (0, 0, 0), (4.0, 3.0, 2.0))}[case]()
    ours, ref = _both_quadratic(jax_mesh)
    assert ours.element_type == ref.element_type
    np.testing.assert_array_equal(ours.coords, ref.coords)
    np.testing.assert_array_equal(ours.conn, ref.conn)
    assert ours.structured_info is None
    # every edge got exactly one mid-edge node, shared by its elements
    k = {"tet10": 4, "hex20": 8}[ours.element_type]
    assert ours.conn[:, k:].min() == jax_mesh.n_nodes
    assert ours.n_nodes == jax_mesh.n_nodes + len(np.unique(
        ours.conn[:, k:]))


def test_setup_problem_refines_to_tet10(beam_tet_path):
    from topopteval_tpu.api import setup_problem as jax_setup
    mesh = tt.import_mesh(beam_tet_path)
    p = tt.setup_problem(mesh, interpolation_order=2, dtype=torch.float64,
                         device="cpu")
    ref = jax_setup(jax_read_vtu(beam_tet_path), interpolation_order=2,
                    dtype=jnp.float64)
    assert p.mesh.element_type == "tet10" and p.n_dofs == ref.n_dofs
    assert p.n_dofs == 50_274
    assert p.quad_order == ref.quad_order == 2
    q = tt.setup_problem(p.mesh, interpolation_order=2, device="cpu")
    assert q.mesh is p.mesh                     # already quadratic
    hex20 = tt.setup_problem(tt.generate_grid_hex(2, 1, 1),
                             interpolation_order=2, device="cpu")
    assert hex20.mesh.element_type == "hex20" and hex20.quad_order == 3


def _curved_batch(element_type, seed):
    """(coords [N,3], conn [C,k], u [3N], lam [C], mu [C]): a small box,
    its nodes moved and its mid-edge nodes moved off the edges (curved
    isoparametric elements), with non-uniform materials."""
    rng = np.random.default_rng(seed)
    if element_type in ("tet4", "tet10"):
        mesh = generate_grid_tet(2, 1, 1, (0, 0, 0), (1.5, 1.0, 1.0))
    else:
        mesh = generate_grid_hex(2, 2, 1, (0, 0, 0), (2.0, 1.5, 1.0))
    if element_type in ("tet10", "hex20"):
        mesh = mesh.to_quadratic()
    coords = mesh.coords + rng.uniform(-0.01, 0.01, mesh.coords.shape)
    C = mesh.n_cells
    return (coords, mesh.conn, rng.standard_normal(3 * mesh.n_nodes),
            rng.uniform(0.1, 2.0, C), rng.uniform(0.1, 2.0, C))


@pytest.mark.parametrize("element_type,order", [
    ("tet4", 1), ("tet4", 2), ("hex8", 2), ("hex8", 3), ("tet10", 2),
    ("tet10", 3), ("hex20", 2), ("hex20", 3)])
def test_plain_ke_and_apply_match_jax_einsum(element_type, order):
    coords, conn, u, lam, mu = _curved_batch(element_type, seed=1)
    ce, ue = coords[conn], u.reshape(-1, 3)[conn]
    ke_ref = jax_elements.element_stiffness(
        jnp.asarray(ce), jnp.asarray(lam), jnp.asarray(mu), element_type,
        order, use_pallas=False)
    ke = port_elements.element_stiffness(
        torch.from_numpy(ce), torch.from_numpy(lam), torch.from_numpy(mu),
        element_type, order)
    _assert_close(ke.numpy(), ke_ref)
    f_ref = jax_elements.apply_element_stiffness(
        jnp.asarray(ce), jnp.asarray(ue), jnp.asarray(lam), jnp.asarray(mu),
        element_type, order)
    f = port_elements.apply_element_stiffness(
        torch.from_numpy(ce), torch.from_numpy(ue), torch.from_numpy(lam),
        torch.from_numpy(mu), element_type, order)
    _assert_close(f.numpy(), f_ref)
    # Ke is symmetric and Ke u_e is the apply
    np.testing.assert_allclose(ke.numpy(), ke.numpy().transpose(0, 2, 1),
                               rtol=0, atol=1e-13 * np.abs(ke_ref).max())
    _assert_close(np.einsum("cij,cj->ci", ke.numpy(),
                            ue.reshape(len(ue), -1)), np.asarray(
                                f_ref).reshape(len(ue), -1))


def _ke_body(make_kernel, element_type, coords_e, lam, mu):
    """A B8 TPU kernel body (``pallas_kernels._make_iso_ke_kernel`` or its
    ``_stream`` twin) run once over the whole batch as one block: NumPy
    arrays stand in for its VMEM refs, in the kernels' lane layout
    ([3k, C] coordinates, [1, C] materials, [9k^2, C] out)."""
    dn, w = pk._iso_tables(element_type)
    k = len(dn[0])
    C = coords_e.shape[0]
    out = np.zeros((9 * k * k, C))
    make_kernel(dn, w, k)(np.ascontiguousarray(coords_e.reshape(C, -1).T),
                          lam[None, :], mu[None, :], out)
    return out.T.reshape(C, 3 * k, 3 * k)


@pytest.mark.parametrize("element_type,variant", [
    ("tet4", "interpret"), ("hex8", "stream"), ("hex8", "registers"),
    ("tet10", "stream"), ("tet10", "registers")])
def test_ke_wrappers_match_pallas(element_type, variant):
    """The port's Ke-batch wrapper (its plain version on the CPU) against
    the TPU kernels: tet4's in interpret mode, both B8 variants as kernel
    bodies (see the module docstring)."""
    coords, conn, _, lam, mu = _curved_batch(element_type, seed=2)
    if variant == "interpret":
        ref = pk.tet4_element_stiffness_pallas(
            jnp.asarray(coords[conn]), jnp.asarray(lam), jnp.asarray(mu),
            block=8, interpret=True)
    else:
        make = {"stream": pk._make_iso_ke_kernel_stream,
                "registers": pk._make_iso_ke_kernel}[variant]
        ref = _ke_body(make, element_type, coords[conn], lam, mu)
    launches = dict(kk.LAUNCHES)
    ours = kk.KE_KERNELS[element_type](*(torch.from_numpy(a) for a in (
        coords, conn, lam, mu)))
    assert kk.LAUNCHES == launches          # the CPU runs no kernel
    k = conn.shape[1]
    assert ours.shape == (conn.shape[0], 3 * k, 3 * k)
    _assert_close(ours.numpy(), ref)


def test_tet10_apply_matches_pallas_interpret():
    coords, conn, u, lam, mu = _curved_batch("tet10", seed=3)
    ref = pk.tet10_apply_pallas(jnp.asarray(coords[conn]),
                                jnp.asarray(u.reshape(-1, 3)[conn]),
                                jnp.asarray(lam), jnp.asarray(mu), block=8,
                                interpret=True)
    launches = dict(ek.LAUNCHES)
    ours = ek.tet10_apply(*(torch.from_numpy(a) for a in (coords, conn, u,
                                                          lam, mu)))
    assert ek.LAUNCHES == launches
    assert ours.shape == (conn.shape[0], 10, 3)
    _assert_close(ours.numpy(), ref)


def test_rule_table_carries_element_tables():
    """The isoparametric kernels read dN then w from one flat table."""
    for element_type in ("hex8", "tet10"):
        _, dN, w = port_elements.element_tables(element_type, 2)
        t = ek.rule_table(element_type, torch.float64, torch.device("cpu"))
        np.testing.assert_array_equal(t.numpy(), np.concatenate(
            [dN.reshape(-1), w]))
    assert port_elements.has_ke_kernel("tet4", 1)
    assert port_elements.has_ke_kernel("tet10", 2)
    assert not port_elements.has_ke_kernel("hex8", 3)
    assert not port_elements.has_ke_kernel("hex20", 3)
