"""Host-side pieces of the Hopper design of the structured stencil apply
(B3 ``stencil_plane``), on the CPU.

The kernel runs only on the card (tests/test_torch_cuda.py).  Here its
arithmetic and its z march are emulated in NumPy, in the kernel's order
(csrc/stencil_apply.cu ``cell_forces`` and ``stencil_plane_kernel``), and
held to the plain version and to the JAX package:

- per cell the twelve edges over their lengths, then per tet of the split
  (the path 0 -> P1 -> P2 -> 6 along axes A, B, C) H with columns the
  path's edges, sigma from e*vol*lam and e*vol*mu, s_k = sigma e_k / h_k
  and the vertex forces -s_0, s_0 - s_1, s_1 - s_2, s_2; a node of plane
  z sums corners 0-3 of cell layer z in order, then the sum of corners
  4-7 of layer z - 1 kept from the step before;
- float64 against ``stencil_matvec_reference`` and the JAX
  ``stencil_matvec`` in interpret mode within 1e-12 of the largest entry,
  uniform and with a per-cell scale, on one cell, odd boxes and a
  non-cubic cell; float32 within the card's 1e-5 on the scale-2 beam;
- the z march in chunks of any length gives the same bits (each chunk
  recomputes the cell layer below its first plane);
- the per-level cell table: the operator's six tets are the path tets of
  its 1/dx, 1/dy, 1/dz, and vol*lam, vol*mu are its own.
"""

import numpy as np
import pytest
import torch

from topopteval_tpu.ops.pallas_stencil import \
    stencil_matvec as jax_stencil_matvec
import topopteval_tpu_torch as tt
from topopteval_tpu_torch.grid import _TET_SPLIT
from topopteval_tpu_torch.ops import stencil
from topopteval_tpu_torch.ops.stencil import (CELL_TABLE, CORNER_OFFSETS,
                                              TET_PATHS, cell_table,
                                              path_gradients,
                                              stencil_matvec_reference)

tt.set_verbosity(False)
torch.set_num_threads(1)

LAM, MU = tt.lame_parameters(1.0, 0.3)
# csrc/stencil_apply.cu cell_forces: its twelve edges (from, to, axis)
EDGES = {"X01": (0, 1, 0), "Y03": (0, 3, 1), "Z04": (0, 4, 2),
         "Y12": (1, 2, 1), "X32": (3, 2, 0), "Z37": (3, 7, 2),
         "Y47": (4, 7, 1), "X45": (4, 5, 0), "Z15": (1, 5, 2),
         "Z26": (2, 6, 2), "X76": (7, 6, 0), "Y56": (5, 6, 1)}
# and each tet's three path edges, in the order of grid._TET_SPLIT
TET_EDGES = (("X01", "Y12", "Z26"), ("Y03", "X32", "Z26"),
             ("Y03", "Z37", "X76"), ("Z04", "Y47", "X76"),
             ("Z04", "X45", "Y56"), ("X01", "Z15", "Y56"))


def cell_layer(U, esc, table, dims, cz):
    """``cell_forces`` over every cell of layer ``cz``: [8, ny, nx, 3]
    forces on the corners (zero for a layer outside the box)."""
    nx, ny, nz = dims
    dt = U.dtype
    F = np.zeros((8, ny, nx, 3), dt)
    if not 0 <= cz < nz:
        return F
    c = []
    for oz, oy, ox in CORNER_OFFSETS:
        c.append(U[cz + oz, oy:oy + ny, ox:ox + nx])
    ih = table[:3]
    e = np.ones((ny, nx), dt) if esc is None else esc[cz]
    lt, mt = e * table[3], e * table[4]
    E = {k: (c[b] - c[a]) * ih[ax] for k, (a, b, ax) in EDGES.items()}
    first = {}                          # corner -> its first tet's force
    for t, ((p1, p2), axes) in enumerate(TET_PATHS):
        H = np.zeros((3, 3) + e.shape, dt)
        for col, edge in zip(axes, TET_EDGES[t]):
            for a in range(3):
                H[a, col] = E[edge][..., a]
        ltr = lt * (H[0, 0] + H[1, 1] + H[2, 2])
        m2 = mt + mt
        sg = np.zeros_like(H)
        for a in range(3):
            sg[a, a] = ltr + m2 * H[a, a]
        for a, b in ((0, 1), (0, 2), (1, 2)):
            sg[a, b] = sg[b, a] = mt * (H[a, b] + H[b, a])
        s = [np.stack([sg[b, ax] * ih[ax] for b in range(3)], axis=-1)
             for ax in axes]
        F[0] = -s[0] if t == 0 else F[0] - s[0]
        F[6] = s[2] if t == 0 else F[6] + s[2]
        for corner, f in ((p1, s[0] - s[1]), (p2, s[1] - s[2])):
            if corner in first:
                F[corner] = first.pop(corner) + f
            else:
                first[corner] = f
    assert not first
    return F


def node_sum(F, j, NY, NX):
    """Corner j's force on every node of a plane: the cell of which the
    node is corner j, zero where that cell lies outside the box."""
    _, oy, ox = CORNER_OFFSETS[j]
    ny, nx = F.shape[1:3]
    pad = np.zeros((ny + 2, nx + 2, 3), F.dtype)
    pad[1:-1, 1:-1] = F[j]
    return pad[1 - oy:1 - oy + NY, 1 - ox:1 - ox + NX]


def emulate_plane(u, esc, table, dims, zn=None):
    """``stencil_plane_kernel``: node planes in chunks of ``zn`` (all of
    them when None), each chunk marching the cell layers z0 - 1 .. z1 - 1
    with the sum of corners 4-7 carried from layer to layer."""
    nx, ny, nz = dims
    NX, NY, NZ = nx + 1, ny + 1, nz + 1
    U = u.reshape(NZ, NY, NX, 3)
    y = np.full_like(U, np.nan)
    zn = zn or NZ
    for z0 in range(0, NZ, zn):
        z1 = min(z0 + zn, NZ)
        ptop = np.zeros((NY, NX, 3), U.dtype)
        for cz in range(z0 - 1, z1):
            F = cell_layer(U, esc, table, dims, cz)
            if cz >= z0:
                acc = node_sum(F, 0, NY, NX)
                for j in (1, 2, 3):
                    acc = acc + node_sum(F, j, NY, NX)
                y[cz] = acc + ptop
            ptop = node_sum(F, 4, NY, NX)
            for j in (5, 6, 7):
                ptop = ptop + node_sum(F, j, NY, NX)
    return y.reshape(-1)


def _case(dims, box, simp, dtype=torch.float64, seed=0):
    nx, ny, nz = dims
    rng = np.random.default_rng(seed)
    op = tt.StructuredStiffnessOperator.build(
        nx, ny, nz, (0, 0, 0), box, LAM, MU,
        escale=rng.uniform(0.1, 1.0, (nz, ny, nx)) if simp else None,
        dtype=dtype, device="cpu")
    u = torch.as_tensor(rng.standard_normal(op.n_dofs), dtype=dtype)
    return op, u


@pytest.mark.parametrize("simp", [False, True], ids=["uniform", "simp"])
@pytest.mark.parametrize("dims,box", [
    ((1, 1, 1), (0.7, 0.5, 0.3)),
    ((7, 5, 3), (3.5, 2.0, 0.9)),
    ((40, 9, 6), (20.0, 3.6, 1.8)),
    ((6, 4, 5), (1.2, 3.1, 0.4)),       # dx, dy, dz far apart
])
def test_b3_cell_form_matches_plain_version_and_jax(dims, box, simp):
    op, u = _case(dims, box, simp)
    esc = None if op.escale is None else op.escale.numpy()
    got = emulate_plane(u.numpy(), esc, op.table.numpy(), dims)
    ref = stencil_matvec_reference(u, op.escale, op.ke, dims).numpy()
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= 1e-12 * scale
    # the TPU kernel B3 replaces, in interpret mode
    jax_out = np.asarray(jax_stencil_matvec(
        u.numpy(), esc, op._hex_ke(), dims, interpret=True))
    assert np.abs(got - jax_out).max() <= 1e-12 * scale


def test_b3_cell_form_float32_within_card_tolerance():
    """The scale-2 beam box (25 x 8 x 2 cells of 2.4 x 2.5 x 2) in
    float32, against the float32 plain version at the card's 1e-5."""
    for simp in (False, True):
        op, u = _case((25, 8, 2), (60.0, 20.0, 4.0), simp, torch.float32)
        esc = None if op.escale is None else op.escale.numpy()
        got = emulate_plane(u.numpy(), esc, op.table.numpy(), op.dims)
        assert got.dtype == np.float32
        ref = stencil_matvec_reference(u, op.escale, op.ke, op.dims).numpy()
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def test_b3_z_chunks_give_the_same_bits():
    """In float32 the march in chunks of 1, 2, 3 or all planes gives the
    same bits: a chunk recomputes the layer below its first plane, and a
    node's sum runs in the same order whichever chunk it falls in."""
    op, u = _case((9, 4, 7), (4.5, 1.6, 2.1), True, torch.float32)
    args = (u.numpy(), op.escale.numpy(), op.table.numpy(), op.dims)
    whole = emulate_plane(*args)
    assert not np.isnan(whole).any()
    for zn in (1, 2, 3, 5):
        assert np.array_equal(emulate_plane(*args, zn=zn), whole)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_b3_table_is_the_operators_tets(dtype):
    """The operator's six tets (grid._TET_SPLIT over its cell) are the
    path tets of the table's 1/dx, 1/dy, 1/dz, vertex for vertex, and the
    table holds their common vol times lam and mu."""
    op, _ = _case((5, 3, 2), (1.0, 0.9, 0.3), False, dtype)
    table = op.table
    assert table.shape == (CELL_TABLE,) and table.dtype == dtype
    inv_h = np.array([5 / 1.0, 3 / 0.9, 2 / 0.3])
    want = np.array([*inv_h, op.vol[0] * op.lam, op.vol[0] * op.mu])
    np.testing.assert_allclose(table.double().numpy(), want,
                               rtol=1e-15 if dtype == torch.float64
                               else 1e-7, atol=0)
    np.testing.assert_allclose(op.vol, (1.0 / 5) * (0.9 / 3) * (0.3 / 2) / 6,
                               rtol=1e-14)
    g_path = path_gradients(inv_h)
    for t, ((p1, p2), axes) in enumerate(TET_PATHS):
        path = [0, p1, p2, 6]
        assert sorted(path) == sorted(_TET_SPLIT[t])
        for i, v in enumerate(_TET_SPLIT[t]):
            np.testing.assert_allclose(op.g[t, i], g_path[t, path.index(v)],
                                       rtol=0, atol=1e-12 * inv_h.max())
        # the path steps along one axis each, in the order given
        for (a, b), ax in zip(zip(path, path[1:]), axes):
            step = np.subtract(CORNER_OFFSETS[b], CORNER_OFFSETS[a])[::-1]
            assert list(step) == list(np.eye(3, dtype=int)[ax])
    np.testing.assert_array_equal(
        cell_table(op.g, op.vol, op.lam, op.mu, dtype).numpy(),
        table.numpy())
    with pytest.raises(ValueError, match="path tets"):
        g = op.g.copy()
        g[2, 1] += 0.1
        cell_table(g, op.vol, op.lam, op.mu)
    with pytest.raises(ValueError, match="volume"):
        cell_table(op.g, op.vol * np.arange(1, 7), op.lam, op.mu)


def test_b3_wrapper_checks_the_table_on_the_cpu():
    op, u = _case((3, 2, 2), (1.0, 1.0, 1.0), True)
    args = (u, op.escale, op.ke, op.dims)
    stencil.reset_launch_counts()
    torch.testing.assert_close(
        stencil.stencil_matvec(*args, table=op.table),
        stencil_matvec_reference(*args), rtol=0, atol=0)
    assert stencil.LAUNCHES == {"stencil_plane": 0, "stencil_window": 0}
    with pytest.raises(ValueError, match=r"\[5\]"):
        stencil.stencil_matvec(*args, table=op.table[:4])
    with pytest.raises(TypeError):
        stencil.stencil_matvec(*args, table=op.table.float())
    with pytest.raises(ValueError, match="contiguous"):
        stencil.stencil_matvec(*args, table=torch.zeros(10,
                               dtype=torch.float64)[::2])
