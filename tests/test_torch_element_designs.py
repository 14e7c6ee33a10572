"""Host-side pieces of the Hopper designs of the Tet4 apply (B1) and the
Hex8 apply (B2), on the CPU.

The kernels themselves run only on the card (tests/test_torch_cuda.py).
Here their arithmetic and partitions are emulated in NumPy, in the
kernels' order, and held to the plain versions and to the JAX package:

- B2 gives each Gauss point of an element one thread, forms du/dxi and
  the forces by sum-factorised butterflies across the element's eight
  lanes and J from the dN table (csrc/element_apply.cu Hex8Body; its
  literals: tests/test_torch_elements.py): the emulated formulation
  against the port's plain version and the JAX package's Pallas kernel
  body on NumPy refs (float64, 1e-12 of the largest force) on distorted hexes
  and on the SIMP Hex8 fixture's lam, mu; in float32 against the plain
  version in float32 (the card's 1e-5) at the shapes the card times; a
  degenerate hex adds what the plain version adds;
- B1 keeps the earlier kernel's arithmetic expression for expression, and
  that arithmetic in float32 stays within the card's tolerance on the
  gmsh-ordered fixture;
- the per-tile node lists that B1, B2 and B7 gather from name the conn
  for 4, 8 and 10 nodes an element (ragged C, C below one tile, C = 0,
  the gmsh-ordered fixture), the tile follows the batch size and the
  source instantiates the wrapper's tiles (their cache:
  tests/test_torch_kernel_designs.py);
- the A/B tool's sweep variants add the tile they name.
"""

import os
import re

import numpy as np
import pytest
import torch

from topopteval_tpu.ops import pallas_kernels as pk
import topopteval_tpu_torch as tt
from topopteval_tpu_torch import _build
from topopteval_tpu_torch.ops import element_kernels as ek
from topopteval_tpu_torch.ops.elements import element_tables
from topopteval_tpu_torch.tools import kernel_ab

tt.set_verbosity(False)
torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data")
SOURCE = os.path.join(_build.CSRC_DIR, "element_apply.cu")
SIMP = tt.create_simp_material_model(1.0, 0.3, 1e-8, 3.0)
G = 1.0 / np.sqrt(3.0)
#: the element's lane q (Gauss point, bit d its sign along direction d)
#: ends with the forces of VTK node NODE_OF_LANE[q], the corner of the
#: same signs
NODE_OF_LANE = [q ^ ((q >> 1) & 1) for q in range(8)]


def _source():
    with open(SOURCE) as fh:
        return fh.read()


# ---------------------------------------------------------------------------
# B2
# ---------------------------------------------------------------------------


def hex8_table_of_the_kernel():
    """dN [q, k, b] as Hex8Body forms it: the magnitude literal of the
    source by how many of the two other directions put node k on point
    q's side, the sign node k's along b."""
    text = _source()
    mags = [float(re.search(rf"#define HEX_DN_NEAR{n} ([0-9.e-]+)",
                            text).group(1)) for n in range(3)]
    signs = [((k & 3) in (1, 2), (k & 3) >= 2, k >= 4) for k in range(8)]
    dN = np.empty((8, 8, 3))
    for q in range(8):
        t = (q & 1, (q >> 1) & 1, q >> 2)
        for k in range(8):
            for b in range(3):
                near = sum(int(signs[k][d]) == t[d] for d in range(3)
                           if d != b)
                dN[q, k, b] = mags[near] if signs[k][b] else -mags[near]
    return dN


def emulate_hex8(coords, conn, u, lam, mu, dtype=np.float64):
    """csrc/element_apply.cu Hex8Body in NumPy, the eight lanes of an
    element as an axis, in the kernel's order of operations (FMAs aside),
    in ``dtype``."""
    near, far, half = dtype((1 + G) / 2), dtype((1 - G) / 2), dtype(0.5)
    lanes = np.arange(8)
    hs = [np.where((lanes >> d) & 1, half, -half).astype(dtype)
          for d in range(3)]

    def xor(v, d):
        return v[:, lanes ^ (1 << d)]

    def gradient(v):
        """d/dxi_b of a node field at the lanes' points, b = 0, 1, 2."""
        ix, dx = near * v + far * xor(v, 0), hs[0] * (v - xor(v, 0))
        ixy, ixdy = near * ix + far * xor(ix, 1), hs[1] * (ix - xor(ix, 1))
        dxiy = near * dx + far * xor(dx, 1)
        return (near * dxiy + far * xor(dxiy, 2),
                near * ixdy + far * xor(ixdy, 2),
                hs[2] * (ixy - xor(ixy, 2)))

    x = coords.astype(dtype)[conn]                          # [C, k, a]
    uu = u.astype(dtype).reshape(-1, 3)[conn][:, NODE_OF_LANE]  # [C, lane, a]
    lam, mu = lam.astype(dtype)[:, None], mu.astype(dtype)[:, None]
    H = np.stack([np.stack(gradient(uu[..., a]), -1) for a in range(3)], -2)
    # J from the dN table, summed over the nodes in order
    dN = hex8_table_of_the_kernel().astype(dtype)           # [q, k, b]
    J = np.zeros(H.shape, dtype)
    for k in range(8):
        J += x[:, None, k, :, None] * dN[None, :, k, None, :]
    j = lambda r, c: J[..., r, c]                          # noqa: E731
    A = j(1, 1) * j(2, 2) - j(1, 2) * j(2, 1)
    B = j(0, 2) * j(2, 1) - j(0, 1) * j(2, 2)
    Cc = j(0, 1) * j(1, 2) - j(0, 2) * j(1, 1)
    det = j(0, 0) * A + j(1, 0) * B + j(2, 0) * Cc
    adj = np.stack([
        np.stack([A, B, Cc], -1),
        np.stack([j(1, 2) * j(2, 0) - j(1, 0) * j(2, 2),
                  j(0, 0) * j(2, 2) - j(0, 2) * j(2, 0),
                  j(0, 2) * j(1, 0) - j(0, 0) * j(1, 2)], -1),
        np.stack([j(1, 0) * j(2, 1) - j(1, 1) * j(2, 0),
                  j(0, 1) * j(2, 0) - j(0, 0) * j(2, 1),
                  j(0, 0) * j(1, 1) - j(0, 1) * j(1, 0)], -1)], -2)
    s = np.where(det == 0, dtype(0),
                 dtype(1) / np.where(det == 0, dtype(1), det))
    M = H @ adj
    ls = lam * s * np.trace(M, axis1=-2, axis2=-1)
    S = ls[..., None, None] * np.eye(3, dtype=dtype) \
        + (mu * s)[..., None, None] * (M + np.swapaxes(M, -1, -2))
    P = S @ np.swapaxes(adj, -1, -2)                # [C, lane, a, b]
    f = np.empty(x.shape, dtype)
    for a in range(3):
        p0, p1, p2 = P[..., a, 0], P[..., a, 1], P[..., a, 2]
        x0 = hs[0] * (p0 + xor(p0, 0))
        x1 = near * p1 + far * xor(p1, 0)
        x2 = near * p2 + far * xor(p2, 0)
        y01 = (near * x0 + far * xor(x0, 1)) + hs[1] * (x1 + xor(x1, 1))
        y2 = near * x2 + far * xor(x2, 1)
        f[:, NODE_OF_LANE, a] = ((near * y01 + far * xor(y01, 2))
                                 + hs[2] * (y2 + xor(y2, 2)))
    return f


def _distorted(nx, ny, nz, seed):
    """A hex box with every node moved (non-affine elements) and
    per-element materials."""
    rng = np.random.default_rng(seed)
    mesh = tt.generate_grid_hex(nx, ny, nz, (0, 0, 0),
                                (1.3 * nx, 0.9 * ny, 1.1 * nz))
    coords = mesh.coords + rng.uniform(-0.15, 0.15, mesh.coords.shape)
    C = mesh.n_cells
    return (coords, mesh.conn.astype(np.int32),
            rng.standard_normal(mesh.n_dofs), rng.uniform(0.1, 2.0, C),
            rng.uniform(0.1, 2.0, C))


def _simp_fixture():
    path = os.path.join(DATA, "beam_vfrac_04_Raw.vtu")
    mesh = tt.import_mesh(path)
    lam, mu = SIMP.lame(tt.extract_cell_density(path))
    return mesh, np.asarray(lam, np.float64), np.asarray(mu, np.float64)


def _plain(*arrays, fn=ek.hex8_apply_reference):
    return fn(*(torch.from_numpy(np.ascontiguousarray(a))
                for a in arrays)).numpy()


def _hex8_pallas_body(coords, conn, u, lam, mu):
    """The JAX package's B2 TPU kernel body (``_hex8_apply_kernel``) run
    once over the whole batch as one block: NumPy arrays stand in for its
    VMEM refs, in the kernel's lane layout ([24, C] coordinates and
    displacements, [1, C] materials, [24, C] out).  (Interpret mode gives
    the same numbers but compiles for ~20 s per batch size here.)"""
    C = conn.shape[0]
    out = np.zeros((24, C))
    pk._hex8_apply_kernel(
        np.ascontiguousarray(coords[conn].reshape(C, -1).T),
        np.ascontiguousarray(u.reshape(-1, 3)[conn].reshape(C, -1).T),
        lam[None, :], mu[None, :], out)
    return out.T.reshape(C, 8, 3)


def test_hex8_lanes_pair_points_with_corners():
    """Lane q's point lies nearest the node whose forces it ends with:
    the corner of the same signs in VTK order."""
    N, _, _ = element_tables("hex8", 2)
    assert list(np.argmax(N, axis=1)) == NODE_OF_LANE
    assert sorted(NODE_OF_LANE) == list(range(8))


def test_hex8_near_far_literals_are_the_rule():
    """The source's two 1-D weights are (1 +- 1/sqrt3) / 2 as NumPy
    rounds them."""
    text = _source()
    near = float(re.search(r"#define HEX_NEAR ([0-9.e-]+)", text).group(1))
    far = float(re.search(r"#define HEX_FAR ([0-9.e-]+)", text).group(1))
    assert near == (1 + G) / 2 and far == (1 - G) / 2


@pytest.mark.parametrize("case", ["one", "ragged", "box", "simp_cut"])
def test_hex8_formulation_matches_plain_and_jax(case):
    """C = 1, C = 13 (a ragged count), a 5 x 3 x 2 box, and 40
    elements of the SIMP fixture moved off their grid, with its lam, mu."""
    if case == "simp_cut":
        mesh, lam, mu = _simp_fixture()
        rng = np.random.default_rng(3)
        conn = mesh.conn[:40].astype(np.int32)
        coords = mesh.coords + rng.uniform(-0.1, 0.1, mesh.coords.shape)
        u = rng.standard_normal(mesh.n_dofs)
        lam, mu = lam[:40], mu[:40]
    else:
        coords, conn, u, lam, mu = _distorted(5, 3, 2, seed=len(case))
        n = {"one": 1, "ragged": 13, "box": 30}[case]
        conn, lam, mu = conn[:n], lam[:n], mu[:n]
    got = emulate_hex8(coords, conn, u, lam, mu)
    plain = _plain(coords, conn, u, lam, mu)
    f_jax = _hex8_pallas_body(coords, conn, u, lam, mu)
    scale = np.abs(plain).max()
    assert np.abs(got - plain).max() <= 1e-12 * scale
    assert np.abs(got - f_jax).max() <= 1e-12 * scale


@pytest.mark.parametrize("shape", ["simp_fixture", "box"])
def test_hex8_formulation_float32_within_card_tolerance(shape):
    """The shapes the card times, in float32 with SIMP lam, mu: the
    formulation stays within the card's 1e-5 of the plain version run in
    float32 on the same inputs (J summed from the table on absolute
    coordinates, as the plain version sums it)."""
    if shape == "simp_fixture":
        mesh, lam, mu = _simp_fixture()
    else:
        mesh = tt.generate_grid_hex(100, 32, 8, (0, 0, 0), (60, 20, 4))
        lam, mu = SIMP.lame(tt.models.vfrac04_density_for(mesh))
    rng = np.random.default_rng(0)
    args = (mesh.coords.astype(np.float32), mesh.conn.astype(np.int32),
            rng.standard_normal(mesh.n_dofs).astype(np.float32),
            np.asarray(lam, np.float32), np.asarray(mu, np.float32))
    plain32 = _plain(*args)
    got32 = emulate_hex8(*args, dtype=np.float32)
    assert np.abs(got32 - plain32).max() <= 1e-5 * np.abs(plain32).max()


def test_hex8_formulation_degenerate_element_adds_what_plain_adds():
    """Element 0 flattened to z = 0: det == 0 at every point, so it adds
    nothing (the _inv3_scalars guard divides by 1 and weighs by det = 0);
    its neighbours, distorted by it, still match."""
    coords, conn, u, lam, mu = _distorted(3, 2, 2, seed=5)
    flat = coords.copy()
    flat[conn[0], 2] = 0.0
    got = emulate_hex8(flat, conn, u, lam, mu)
    plain = _plain(flat, conn, u, lam, mu)
    assert np.all(np.isfinite(got))
    assert np.all(got[0] == 0) and np.all(plain[0] == 0)
    np.testing.assert_allclose(got, plain, rtol=0,
                               atol=1e-12 * np.abs(plain).max())


# ---------------------------------------------------------------------------
# B1
# ---------------------------------------------------------------------------

#: the earlier one-thread kernel's arithmetic statements, which Tet4Body
#: keeps verbatim (so its forces keep their bits)
TET4_EXPRESSIONS = [
    "e[i][a] = x[i + 1][a] - x[0][a];",
    "const T c0 = e[1][1] * e[2][2] - e[1][2] * e[2][1];",
    "const T c1 = e[1][2] * e[2][0] - e[1][0] * e[2][2];",
    "const T c2 = e[1][0] * e[2][1] - e[1][1] * e[2][0];",
    "const T det = e[0][0] * c0 + e[0][1] * c1 + e[0][2] * c2;",
    "const T inv_det = T(1) / (det == T(0) ? T(1) : det);",
    "g[i + 1][a] = adj[a][i] * inv_det;",
    "g[0][a] = -(g[1][a] + g[2][a] + g[3][a]);",
    "const T vol = det / T(6);",
    "gu[a][b] = uu[0][a] * g[0][b] + uu[1][a] * g[1][b] +",
    "uu[2][a] * g[2][b] + uu[3][a] * g[3][b];",
    "sig[a][b] = two_mu * (T(0.5) * (gu[a][b] + gu[b][a])) +",
    "(a == b ? lam_tr : T(0));",
    "= vol * (sig[a][0] * g[k][0] +",
]


def test_tet4_body_keeps_the_earlier_arithmetic():
    text = _source()
    body = text[text.index("struct Tet4Body {"):text.index("struct Hex8Body")]
    flat = " ".join(body.split())
    for expr in TET4_EXPRESSIONS:
        assert " ".join(expr.split()) in flat, expr


def test_tet4_arithmetic_float32_within_card_tolerance():
    """B1's arithmetic (edge matrix, adjugate, constant strain) in float32
    on the gmsh-ordered Tet4 fixture against the plain version in
    float32."""
    mesh = tt.import_mesh(os.path.join(DATA, "beam_linear_volume_mesh.vtu"))
    C = mesh.n_cells
    lam0, mu0 = tt.lame_parameters(1.0, 0.3)
    rng = np.random.default_rng(0)
    dt = np.float32
    x = mesh.coords.astype(dt)[mesh.conn]
    uu = rng.standard_normal(mesh.n_dofs).astype(dt).reshape(-1, 3)
    e = x[:, 1:] - x[:, :1]
    cof = np.cross(e[:, [1, 2, 0]], e[:, [2, 0, 1]])    # rows: adj columns
    det = np.einsum("ca,ca->c", e[:, 0], cof[:, 0])
    g = np.empty((C, 4, 3), dt)
    g[:, 1:] = cof * (dt(1) / np.where(det == 0, dt(1), det))[:, None, None]
    g[:, 0] = -(g[:, 1] + g[:, 2] + g[:, 3])
    gu = np.einsum("cka,ckb->cab", uu[mesh.conn], g)
    sig = (dt(2) * dt(mu0)) * (dt(0.5) * (gu + np.swapaxes(gu, 1, 2))) \
        + (dt(lam0) * np.trace(gu, axis1=1, axis2=2))[:, None, None] \
        * np.eye(3, dtype=dt)
    got = (det / dt(6))[:, None, None] * np.einsum("cab,ckb->cka", sig, g)
    plain = _plain(mesh.coords.astype(dt), mesh.conn.astype(np.int32),
                   uu.reshape(-1), np.full(C, lam0, dt), np.full(C, mu0, dt),
                   fn=ek.tet4_apply_reference)
    assert np.abs(got - plain).max() <= 1e-5 * np.abs(plain).max()


# ---------------------------------------------------------------------------
# the tile lists of every element kernel
# ---------------------------------------------------------------------------


def _conn(k, case):
    if case == "fixture":              # gmsh order: little reuse per tile
        return tt.import_mesh(os.path.join(
            DATA, "beam_linear_volume_mesh.vtu")).conn
    if case == "simp_fixture":
        return _simp_fixture()[0].conn
    mesh = {4: tt.generate_grid_tet(9, 4, 3, (0, 0, 0), (9.0, 4.0, 3.0)),
            8: tt.generate_grid_hex(20, 6, 5, (0, 0, 0), (20.0, 6.0, 5.0)),
            10: tt.generate_grid_tet(5, 3, 2, (0, 0, 0),
                                     (5.0, 3.0, 2.0)).to_quadratic()}[k]
    n = {"ragged": 2 * ek.TILES[k][0] + 5,
         "below_one_tile": ek.TILES[k][1] - 3, "empty": 0}[case]
    assert mesh.n_cells >= n
    return mesh.conn[:n]


@pytest.mark.parametrize("k,case", [
    (4, "fixture"), (4, "ragged"), (4, "below_one_tile"), (4, "empty"),
    (8, "simp_fixture"), (8, "ragged"), (8, "below_one_tile"), (8, "empty"),
    (10, "ragged"), (10, "below_one_tile"), (10, "empty")])
def test_element_tiles_name_the_conn(k, case):
    """At both tiles of the element type: each tile lists its distinct
    nodes once, sorted, padded with -1; the int16 local ids give conn
    back; the reuse is conn entries over listed rows."""
    conn = torch.as_tensor(np.asarray(_conn(k, case), np.int32))
    C = conn.shape[0]
    assert conn.shape[1] == k
    for tile in ek.TILES[k]:
        t = ek.element_tiles_of(conn, tile)
        assert t.tile == tile and t.lconn.dtype == torch.int16
        assert t.nodes.shape == (-(-C // tile), t.max_nodes)
        assert t.lconn.shape == (C, k)
        rows = torch.arange(C) // tile
        assert torch.equal(t.nodes[rows[:, None], t.lconn.long()], conn)
        listed = 0
        for r, tile_nodes in enumerate(t.nodes):
            live = tile_nodes[tile_nodes >= 0]
            assert torch.equal(live, torch.unique(
                conn[r * tile:(r + 1) * tile]).to(torch.int32))
            assert bool((tile_nodes[live.numel():] == -1).all())
            listed += live.numel()
        assert t.max_nodes == max((int((n >= 0).sum()) for n in t.nodes),
                                  default=0)
        assert t.reuse == (C * k / listed if listed else 0.0)
    if case == "fixture":
        # the gmsh-ordered fixture reuses less than a generated beam
        beam = tt.generate_grid_tet(25, 8, 2, (0, 0, 0), (60.0, 20.0, 4.0))
        generated = ek.element_tiles_of(torch.as_tensor(beam.conn), 64)
        assert ek.element_tiles_of(conn, 64).reuse < generated.reuse


@pytest.mark.parametrize("k", [4, 8, 10])
def test_element_tiles_follow_the_batch_size(k):
    """The large tile from two tiles per SM of the card (132 SMs where no
    card is given) upwards, the small one below."""
    big, small = ek.TILES[k]
    n = 2 * 132 * big
    rng = np.random.default_rng(k)
    conn = torch.as_tensor(rng.integers(0, 5000, (n, k)).astype(np.int32))
    assert ek.element_tiles(conn).tile == big
    assert ek.element_tiles(conn[:n - 1]).tile == small


def test_tile_sizes_in_source_are_the_wrappers():
    found = {int(k): (int(tile), int(small), int(tpe))
             for k, tpe, tile, small in re.findall(
                 r"static constexpr int K = (\d+), TPE = (\d+), "
                 r"TILE = (\d+), SMALL_TILE = (\d+);", _source())}
    assert {k: v[:2] for k, v in found.items()} == ek.TILES
    assert {k: v[2] for k, v in found.items()} == {4: 1, 8: 8, 10: 1}


@pytest.mark.parametrize("name", sorted(kernel_ab.SWEEP))
def test_kernel_ab_sweep_variant_adds_its_tile(name):
    variant, tile = kernel_ab.SWEEP[name]
    k = {"tet4_apply": 4, "hex8_apply": 8}[name]
    text = kernel_ab.ablated_source(_source(),
                                    kernel_ab.ABLATIONS[("current", variant)])
    got = re.search(rf"static constexpr int K = {k}, TPE = \d+, "
                    rf"TILE = (\d+), SMALL_TILE = (\d+);", text)
    assert int(got.group(1)) == tile
    assert tile not in ek.TILES[k]
