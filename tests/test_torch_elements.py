"""Element-level parity of the PyTorch port against the JAX package.

The same NumPy inputs (made from a seed) go through the JAX function and
its port counterpart on the CPU.  The port's fused applies run their plain
PyTorch versions here (CPU tensors); the JAX applies run their Pallas
kernels in interpret mode, as tests/test_pallas.py does, on the small
batch and ``block=8`` it uses because interpret mode is slow.

Tolerance: rtol=1e-10 in float64.  Both sides compute the same formulas
in float64 but in different association orders (einsum contraction order,
adjugate vs. 4-point quadrature for tet4), which leaves differences of a
few ulps times the condition of the element geometry — far below 1e-10.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topopteval_tpu.models.beams import generate_grid_hex, generate_grid_tet
from topopteval_tpu.ops import elements as jax_elements
from topopteval_tpu.ops.pallas_kernels import (hex8_apply_pallas,
                                               tet4_apply_pallas)
from topopteval_tpu_torch.ops import element_kernels as ek
from topopteval_tpu_torch.ops import elements as port_elements
from topopteval_tpu_torch.utils import set_verbosity

set_verbosity(False)
# these tests work on small tensors: one intra-op thread each, so that
# test processes running side by side do not fight over the cores (torch's
# thread pool spins at its barriers when the machine is oversubscribed)
torch.set_num_threads(1)

RTOL = 1e-10


def _batch(element_type, seed):
    """(coords [N,3], conn [C,k], u [3N], lam [C], mu [C]) as NumPy, on a
    small perturbed (non-affine) box."""
    rng = np.random.default_rng(seed)
    if element_type == "tet4":
        mesh = generate_grid_tet(2, 2, 1, (0, 0, 0), (2.5, 1.5, 1.0))
    else:
        mesh = generate_grid_hex(2, 2, 1, (0, 0, 0), (2.0, 1.5, 1.0))
    coords = mesh.coords + rng.uniform(-0.05, 0.05, mesh.coords.shape)
    C = mesh.n_cells
    return (coords, mesh.conn, rng.standard_normal(3 * mesh.n_nodes),
            rng.uniform(0.3, 2.0, C), rng.uniform(0.3, 2.0, C))


def _torch(arrays):
    coords, conn, u, lam, mu = arrays
    return (torch.from_numpy(coords), torch.from_numpy(conn),
            torch.from_numpy(u), torch.from_numpy(lam), torch.from_numpy(mu))


def _assert_close(actual, desired):
    desired = np.asarray(desired)
    np.testing.assert_allclose(np.asarray(actual), desired, rtol=RTOL,
                               atol=RTOL * np.abs(desired).max())


@pytest.mark.parametrize("element_type,pallas_apply,port_apply", [
    ("tet4", tet4_apply_pallas, ek.tet4_apply),
    ("hex8", hex8_apply_pallas, ek.hex8_apply),
])
def test_apply_matches_pallas_interpret(element_type, pallas_apply,
                                        port_apply):
    coords, conn, u, lam, mu = _batch(element_type, seed=0)
    f_jax = pallas_apply(jnp.asarray(coords[conn]),
                         jnp.asarray(u.reshape(-1, 3)[conn]),
                         jnp.asarray(lam), jnp.asarray(mu), block=8,
                         interpret=True)
    launches = dict(ek.LAUNCHES)
    f_port = port_apply(*_torch((coords, conn, u, lam, mu)))
    assert f_port.shape == (conn.shape[0], conn.shape[1], 3)
    _assert_close(f_port.numpy(), f_jax)
    # a CPU tensor runs the plain version: no kernel launch is counted
    assert ek.LAUNCHES == launches


@pytest.mark.parametrize("element_type", ["tet4", "hex8"])
def test_apply_matches_einsum_path(element_type):
    """The fused apply against the JAX package's einsum strain route
    (ops/elements.apply_element_stiffness) and the port's copy of it."""
    coords, conn, u, lam, mu = _batch(element_type, seed=1)
    f_jax = jax_elements.apply_element_stiffness(
        jnp.asarray(coords[conn]), jnp.asarray(u.reshape(-1, 3)[conn]),
        jnp.asarray(lam), jnp.asarray(mu), element_type, 2)
    f_einsum = port_elements.apply_element_stiffness(
        torch.from_numpy(coords[conn]),
        torch.from_numpy(u.reshape(-1, 3)[conn]), torch.from_numpy(lam),
        torch.from_numpy(mu), element_type, 2)
    apply = ek.tet4_apply if element_type == "tet4" else ek.hex8_apply
    f_port = apply(*_torch((coords, conn, u, lam, mu)))
    _assert_close(f_einsum.numpy(), f_jax)
    _assert_close(f_port.numpy(), f_jax)


@pytest.mark.parametrize("element_type", ["tet4", "hex8"])
@pytest.mark.parametrize("order", [1, 2, 3])
def test_element_stiffness_and_volumes_match_jax(element_type, order):
    coords, conn, _, lam, mu = _batch(element_type, seed=2)
    ce = coords[conn]
    ke_jax = jax_elements.element_stiffness(
        jnp.asarray(ce), jnp.asarray(lam), jnp.asarray(mu), element_type,
        order, use_pallas=False)
    ke_port = port_elements.element_stiffness(
        torch.from_numpy(ce), torch.from_numpy(lam), torch.from_numpy(mu),
        element_type, order)
    _assert_close(ke_port.numpy(), ke_jax)
    g_jax, w_jax = jax_elements.physical_gradients(jnp.asarray(ce),
                                                   element_type, order)
    g_port, w_port = port_elements.physical_gradients(
        torch.from_numpy(ce), element_type, order)
    _assert_close(g_port.numpy(), g_jax)
    _assert_close(w_port.numpy(), w_jax)
    _assert_close(port_elements.element_volumes(
        torch.from_numpy(ce), element_type, order).numpy(),
        jax_elements.element_volumes(jnp.asarray(ce), element_type, order))


@pytest.mark.parametrize("element_type", ["tet4", "hex8"])
def test_element_tables_match_jax(element_type):
    for order in (1, 2, 3):
        for a, b in zip(port_elements.element_tables(element_type, order),
                        jax_elements.element_tables(element_type, order)):
            np.testing.assert_array_equal(a, b)


def test_cuda_hex8_gradient_table_matches_element_tables():
    """The dN table the hex8 kernel of csrc/element_apply.cu forms holds
    exactly the float64 values element_tables('hex8', 2) computes: its
    three magnitude literals, picked by how many of the two other
    directions put node k on Gauss point q's side, signed by node k's
    sign along the derivative's direction (Hex8Body)."""
    path = os.path.join(os.path.dirname(port_elements.__file__), "..",
                        "csrc", "element_apply.cu")
    with open(path) as fh:
        src = fh.read()
    mags = [float(re.search(rf"#define HEX_DN_NEAR{n} ([0-9.e-]+)",
                            src).group(1)) for n in range(3)]
    # VTK node k's signs along x, y, z and point q's (bit d of q), 1 for +
    signs = [((k & 3) in (1, 2), (k & 3) >= 2, k >= 4) for k in range(8)]
    vals = np.empty((8, 8, 3))
    for q in range(8):
        side = ((q & 1), (q >> 1) & 1, q >> 2)
        for k in range(8):
            for b in range(3):
                near = sum(int(signs[k][d]) == side[d] for d in range(3)
                           if d != b)
                vals[q, k, b] = mags[near] if signs[k][b] else -mags[near]
    _, dN, w = port_elements.element_tables("hex8", 2)
    np.testing.assert_array_equal(vals, dN)
    np.testing.assert_array_equal(w, np.ones(8))


def test_reference_applies_are_deterministic_and_linear():
    """f(a u + b v) = a f(u) + b f(v) to rounding, and rigid translations
    give zero force (patch-test property of the element apply)."""
    for element_type, apply in (("tet4", ek.tet4_apply_reference),
                                ("hex8", ek.hex8_apply_reference)):
        coords, conn, u, lam, mu = _torch(_batch(element_type, seed=3))
        v = torch.from_numpy(np.random.default_rng(4).standard_normal(
            u.shape[0]))
        lhs = apply(coords, conn, 2.0 * u - 3.0 * v, lam, mu)
        rhs = (2.0 * apply(coords, conn, u, lam, mu)
               - 3.0 * apply(coords, conn, v, lam, mu))
        _assert_close(lhs.numpy(), rhs.numpy())
        shift = torch.tensor([0.3, -1.2, 0.7],
                             dtype=torch.float64).repeat(coords.shape[0])
        f = apply(coords, conn, shift, lam, mu)
        assert float(f.abs().max()) < 1e-12


def test_wrapper_rejects_device_without_kernel():
    coords, conn, u, lam, mu = _torch(_batch("tet4", seed=5))
    with pytest.raises(ValueError, match="no kernel"):
        ek.tet4_apply(coords.to("meta"), conn.to("meta"), u.to("meta"),
                      lam.to("meta"), mu.to("meta"))
