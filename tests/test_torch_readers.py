"""The port's GMSH and Abaqus readers against the JAX package's, on the
CPU (the cases of tests/test_gmsh.py, tests/test_inp.py and the surface
cache of tests/test_bc.py:88).

Every inline mesh is read by both packages: coordinates, connectivity,
element type, cellsets and nodesets must be equal, the tet10 and hex20
node reorders and the skipped element types included.  Meshes written by
chip_smoke.py's own .msh and .inp writers (the ones its phase 14 uses at
full size) are read by both packages too, a .msh beam clamped and loaded
by its named node sets solves to the JAX package's energy (1e-10), and
``inp_to_vtu`` round-trips.
"""

import importlib.util
import os
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topopteval_tpu import api as japi
from topopteval_tpu.config import SolverConfig as JaxSolverConfig
from topopteval_tpu.fem import bc as jbc
from topopteval_tpu.io import gmsh as jgmsh
from topopteval_tpu.io import inp as jinp
from topopteval_tpu.io.vtu import VTUFile as JaxVTUFile
from topopteval_tpu.materials import lame_parameters
import topopteval_tpu_torch as tt
from topopteval_tpu_torch.fem import bc
from topopteval_tpu_torch.io import gmsh, inp
from topopteval_tpu_torch.io.vtu import VTUFile

tt.set_verbosity(False)
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAM, MU = lame_parameters(1.0, 0.3)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _chip_smoke()


def _same_mesh(ours, ref):
    assert ours.element_type == ref.element_type
    np.testing.assert_array_equal(ours.coords, ref.coords)
    np.testing.assert_array_equal(ours.conn, ref.conn)
    assert ours.conn.dtype == ref.conn.dtype
    for name in ("cellsets", "nodesets"):
        a, b = getattr(ours, name), getattr(ref, name)
        assert sorted(a) == sorted(b), name
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])


def _read_both(path):
    ours, ref = gmsh.read_msh_mesh(path), jgmsh.read_msh_mesh(path)
    _same_mesh(ours, ref)
    return ours


# ---------------------------------------------------------------------------
# Inline meshes of tests/test_gmsh.py
# ---------------------------------------------------------------------------

MSH_V2 = """$MeshFormat
2.2 0 8
$EndMeshFormat
$Nodes
5
1 0 0 0
2 1 0 0
3 0 1 0
4 0 0 1
5 1 1 1
$EndNodes
$Elements
4
1 4 2 7 1 1 2 3 4
2 4 2 7 1 2 3 4 5
3 2 2 9 1 1 2 3
4 15 2 0 1 1
$EndElements
"""

MSH_V4 = """$MeshFormat
4.1 0 8
$EndMeshFormat
$Nodes
1 4 1 4
3 1 0 4
1
2
3
4
0 0 0
1 0 0
0 1 0
0 0 1
$EndNodes
$Elements
1 1 1 1
3 1 4 1
1 1 2 3 4
$EndElements
"""

MSH_V4_ENTITIES = """$MeshFormat
4.1 0 8
$EndMeshFormat
$Entities
0 0 0 1
5 0 0 0 1 1 1 1 42 0
$EndEntities
$Nodes
1 4 1 4
3 5 0 4
1
2
3
4
0 0 0
1 0 0
0 1 0
0 0 1
$EndNodes
$Elements
1 1 1 1
3 5 4 1
1 1 2 3 4
$EndElements
"""

MSH_NAMED = """$MeshFormat
2.2 0 8
$EndMeshFormat
$PhysicalNames
2
2 5 "load_face"
3 7 "body"
$EndPhysicalNames
$Nodes
5
1 0 0 0
2 1 0 0
3 0 1 0
4 0 0 1
5 1 1 1
$EndNodes
$Elements
4
1 4 2 7 1 1 2 3 4
2 4 2 7 1 2 3 4 5
3 2 2 5 1 2 3 4
4 2 2 5 1 2 4 5
$EndElements
"""


def _mixed_v2():
    n20 = " ".join(str(1 + (i % 5)) for i in range(20))
    n8q = " ".join(str(1 + (i % 5)) for i in range(8))
    return f"""$MeshFormat
2.2 0 8
$EndMeshFormat
$Nodes
5
1 0 0 0
2 1 0 0
3 0 1 0
4 0 0 1
5 1 1 1
$EndNodes
$Elements
5
1 4 2 7 1 1 2 3 4
2 17 2 7 1 {n20}
3 16 2 7 1 {n8q}
4 4 2 7 1 2 3 4 5
5 99 2 7 1 1 2
$EndElements
"""


@pytest.mark.parametrize("text", [MSH_V2, MSH_V4, MSH_V4_ENTITIES,
                                  MSH_NAMED, _mixed_v2()],
                         ids=["v2", "v4", "v4_entities", "named", "mixed"])
def test_inline_ascii_meshes_equal_jax(tmp_path, text):
    p = tmp_path / "model.msh"
    p.write_text(text)
    mesh = _read_both(str(p))
    assert mesh.element_type == "tet4"
    _same_mesh(tt.import_mesh(str(p)), jgmsh.read_msh_mesh(str(p)))


def test_named_groups_and_node_set_selection(tmp_path):
    p = tmp_path / "named.msh"
    p.write_text(MSH_NAMED)
    mesh = _read_both(str(p))
    np.testing.assert_array_equal(mesh.cellsets["body"], [0, 1])
    np.testing.assert_array_equal(mesh.nodesets["load_face"], [1, 2, 3, 4])
    sel = tt.select_nodes_by_set(mesh, "load_face")
    assert sel.dtype == np.int64
    np.testing.assert_array_equal(
        sel, jbc.select_nodes_by_set(jgmsh.read_msh_mesh(str(p)),
                                     "load_face"))
    with pytest.raises(KeyError, match="available"):
        tt.select_nodes_by_set(mesh, "nope")
    # the sets ride through the quadratic refinement
    assert sorted(mesh.to_quadratic().nodesets) == ["load_face"]


def _write_msh_v2_binary(path):
    """One tet + one tri, physical tag 7, little-endian (as in
    tests/test_gmsh.py)."""
    with open(path, "wb") as f:
        f.write(b"$MeshFormat\n2.2 1 8\n")
        f.write(struct.pack("<i", 1))
        f.write(b"\n$EndMeshFormat\n$Nodes\n4\n")
        for nid, x, y, z in [(1, 0, 0, 0), (2, 1, 0, 0), (3, 0, 1, 0),
                             (4, 0, 0, 1)]:
            f.write(struct.pack("<i3d", nid, x, y, z))
        f.write(b"\n$EndNodes\n$Elements\n2\n")
        f.write(struct.pack("<3i", 4, 1, 2))
        f.write(struct.pack("<7i", 1, 7, 1, 1, 2, 3, 4))
        f.write(struct.pack("<3i", 2, 1, 2))
        f.write(struct.pack("<6i", 2, 9, 1, 1, 2, 3))
        f.write(b"\n$EndElements\n")


def _write_msh_v4_binary(path):
    """v4.1 binary: volume entity 5 with physical tag 42, one tet."""
    with open(path, "wb") as f:
        f.write(b"$MeshFormat\n4.1 1 8\n")
        f.write(struct.pack("<i", 1))
        f.write(b"\n$EndMeshFormat\n$Entities\n")
        f.write(struct.pack("<4Q", 0, 0, 0, 1))
        f.write(struct.pack("<i", 5))
        f.write(struct.pack("<6d", 0, 0, 0, 1, 1, 1))
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<i", 42))
        f.write(struct.pack("<Q", 0))
        f.write(b"\n$EndEntities\n$Nodes\n")
        f.write(struct.pack("<4Q", 1, 4, 1, 4))
        f.write(struct.pack("<3i", 3, 5, 0))
        f.write(struct.pack("<Q", 4))
        f.write(struct.pack("<4Q", 1, 2, 3, 4))
        for x, y, z in [(0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1)]:
            f.write(struct.pack("<3d", x, y, z))
        f.write(b"\n$EndNodes\n$Elements\n")
        f.write(struct.pack("<4Q", 1, 1, 1, 1))
        f.write(struct.pack("<3i", 3, 5, 4))
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<5Q", 1, 1, 2, 3, 4))
        f.write(b"\n$EndElements\n")


@pytest.mark.parametrize("writer,tag", [(_write_msh_v2_binary, 7),
                                        (_write_msh_v4_binary, 42)],
                         ids=["v2", "v4"])
def test_binary_meshes_equal_jax(tmp_path, writer, tag):
    p = str(tmp_path / "bin.msh")
    writer(p)
    mesh = _read_both(p)
    assert mesh.n_cells == 1 and f"cellset_{tag}" in mesh.cellsets


def test_large_ascii_import_equals_jax(tmp_path):
    """A 9,600-tet v2.2 file through the vectorised parse of both."""
    gen = tt.generate_grid_tet(20, 10, 8, (0, 0, 0), (2, 1, 0.8))
    p = str(tmp_path / "big.msh")
    cs.write_msh22_ascii(p, gen.coords, [(3, 1, "body", "tet4", gen.conn)])
    mesh = _read_both(p)
    np.testing.assert_array_equal(mesh.conn, gen.conn)
    np.testing.assert_array_equal(mesh.coords, gen.coords)


# ---------------------------------------------------------------------------
# Quadratic node orders, and chip_smoke.py's writers
# ---------------------------------------------------------------------------


def _gmsh_order(conn, etype):
    """VTK-ordered connectivity in gmsh's node order (the inverse of the
    reader's map)."""
    return conn[:, np.argsort(gmsh._GMSH_TO_VTK[etype])]


@pytest.mark.parametrize("base,etype,gtype", [("tet4", "tet10", 11),
                                              ("hex8", "hex20", 17)])
def test_quadratic_elements_are_reordered_as_jax(tmp_path, base, etype,
                                                 gtype):
    lin = (tt.generate_grid_tet(2, 1, 1) if base == "tet4"
           else tt.generate_grid_hex(2, 1, 1))
    quad = lin.to_quadratic()
    conn = _gmsh_order(quad.conn, etype)
    lines = ["$MeshFormat", "2.2 0 8", "$EndMeshFormat", "$Nodes",
             str(quad.n_nodes)]
    lines += [f"{i + 1} {float(x)!r} {float(y)!r} {float(z)!r}"
              for i, (x, y, z) in enumerate(quad.coords)]
    lines += ["$EndNodes", "$Elements", str(len(conn))]
    lines += [f"{i + 1} {gtype} 2 1 1 " + " ".join(str(n + 1) for n in row)
              for i, row in enumerate(conn)]
    lines.append("$EndElements")
    p = tmp_path / "quad.msh"
    p.write_text("\n".join(lines) + "\n")
    mesh = _read_both(str(p))
    assert mesh.element_type == etype
    np.testing.assert_array_equal(mesh.conn, quad.conn)


def test_chip_smoke_writers_round_trip_through_both_readers(tmp_path):
    beam = tt.generate_grid_tet(6, 2, 2, (0, 0, 0), (6.0, 2.0, 2.0))
    groups = [(2, 1, "clamped", "tri3",
               cs.plane_triangles(beam.coords, 0, 0.0)),
              (2, 2, "loaded", "tri3",
               cs.plane_triangles(beam.coords, 0, 6.0)),
              (3, 3, "body", "tet4", beam.conn)]
    for name, writer in (("b41.msh", cs.write_msh41_binary),
                         ("a22.msh", cs.write_msh22_ascii)):
        p = str(tmp_path / name)
        writer(p, beam.coords, groups)
        mesh = _read_both(p)
        np.testing.assert_array_equal(mesh.coords, beam.coords)
        np.testing.assert_array_equal(mesh.conn, beam.conn)
        np.testing.assert_array_equal(mesh.cellsets["body"],
                                      np.arange(beam.n_cells))
        for side, x in (("clamped", 0.0), ("loaded", 6.0)):
            np.testing.assert_array_equal(mesh.nodesets[side],
                                          tt.nodes_at_plane(beam, 0, x))
    quad = beam.to_quadratic()
    p = str(tmp_path / "tet10.msh")
    cs.write_msh41_binary(p, quad.coords,
                          [(3, 1, "body", "tet10", quad.conn)])
    mesh = _read_both(p)
    np.testing.assert_array_equal(mesh.conn, quad.conn)


def test_msh_beam_by_node_sets_solves_to_jax_energy(tmp_path):
    beam = tt.generate_grid_tet(8, 2, 2, (0, 0, 0), (8.0, 2.0, 2.0))
    p = str(tmp_path / "beam.msh")
    cs.write_msh41_binary(p, beam.coords, [
        (2, 1, "clamped", "tri3", cs.plane_triangles(beam.coords, 0, 0.0)),
        (2, 2, "loaded", "tri3", cs.plane_triangles(beam.coords, 0, 8.0)),
        (3, 3, "body", "tet4", beam.conn)])
    mesh = tt.import_mesh(p)
    assert mesh.structured_info is None
    problem = tt.setup_problem(mesh, dtype=torch.float64, device="cpu")
    tt.assemble_stiffness_matrix(problem, LAM, MU)
    tt.apply_fixed_boundary(problem, tt.select_nodes_by_set(mesh, "clamped"))
    tt.apply_force(problem, tt.select_nodes_by_set(mesh, "loaded"),
                   [0.0, 0.0, -1.0])
    jmesh = japi.import_mesh(p)
    jp = japi.setup_problem(jmesh, dtype=jnp.float64)
    japi.assemble_stiffness_matrix(jp, LAM, MU)
    japi.apply_fixed_boundary(jp, jbc.select_nodes_by_set(jmesh, "clamped"))
    japi.apply_force(jp, jbc.select_nodes_by_set(jmesh, "loaded"),
                     [0.0, 0.0, -1.0])
    ref = japi.solve_system(jp, JaxSolverConfig(method="direct",
                                                verbose=False))
    ours = tt.solve_system(problem, tt.SolverConfig(method="direct",
                                                    verbose=False))
    assert abs(ours.energy - ref.energy) <= 1e-10 * ref.energy
    cg = tt.solve_system(problem, tt.SolverConfig(
        method="cg", preconditioner="block_diagonal", tolerance=1e-10,
        max_iterations=5000, verbose=False))
    assert cg.method == "cg" and cg.converged
    assert abs(cg.energy - ref.energy) <= 1e-8 * ref.energy


# ---------------------------------------------------------------------------
# Abaqus .inp (tests/test_inp.py)
# ---------------------------------------------------------------------------

INP_SAMPLE = """** sample heading
*NODE
1, 0.0, 0.0, 0.0
2, 1.0, 0.0, 0.0
3, 0.0, 1.0, 0.0
4, 0.0, 0.0, 1.0
5, 1.0, 1.0, 1.0
*ELEMENT, TYPE=C3D4, ELSET=solid
1, 1, 2, 3, 4
2, 2, 3, 4, 5
*ELEMENT, TYPE=S3, ELSET=skin
3, 1, 2, 3
*ELEMENT, TYPE=FOO99
9, 1, 2
"""

INP_HEX = "*NODE\n" + "\n".join(
    f"{i + 1}, {x}, {y}, {z}" for i, (x, y, z) in enumerate(
        [(0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
         (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)])) + """
*ELEMENT, TYPE=C3D8R
1, 1, 2, 3, 4,
 5, 6, 7, 8
"""


@pytest.mark.parametrize("text,etype", [(INP_SAMPLE, "tet4"),
                                        (INP_HEX, "hex8")],
                         ids=["sample", "hex_continued"])
def test_inp_reader_equals_jax(tmp_path, text, etype):
    p = str(tmp_path / "model.inp")
    with open(p, "w") as fh:
        fh.write(text)
    ours, ref = inp.parse_inp(p), jinp.parse_inp(p)
    assert ours.nodes == ref.nodes
    assert ours.sections == ref.sections
    assert ours.unsupported == ref.unsupported
    assert inp.validate_inp_file(p) == jinp.validate_inp_file(p)
    assert inp.inspect_inp_elements(p) == jinp.inspect_inp_elements(p)
    mesh = tt.read_inp_mesh(p)
    _same_mesh(mesh, jinp.read_inp_mesh(p))
    assert mesh.element_type == etype


def test_inp_to_vtu_round_trip_equals_jax(tmp_path):
    p = str(tmp_path / "model.inp")
    with open(p, "w") as fh:
        fh.write(INP_SAMPLE)
    assert tt.inp_to_vtu(p, str(tmp_path / "ours"), verbose=False)
    assert jinp.inp_to_vtu(p, str(tmp_path / "ref"), verbose=False)
    ours = VTUFile(str(tmp_path / "ours.vtu"))
    ref = JaxVTUFile(str(tmp_path / "ref.vtu"))
    for a, b in zip(ours.cells(), ref.cells()):
        np.testing.assert_array_equal(a, b)
    assert list(ours.cells()[2]) == [10, 10, 5]      # 2 tets + 1 tri
    np.testing.assert_array_equal(ours.points(), ref.points())
    mesh = tt.read_vtu_mesh(str(tmp_path / "ours.vtu"))
    assert mesh.element_type == "tet4" and mesh.n_cells == 2
    with pytest.raises(FileNotFoundError):
        tt.inp_to_vtu("/nope/missing.inp", str(tmp_path / "x"),
                      verbose=False)
    assert not inp.validate_inp_file("/nope/missing.inp")["exists"]


def test_chip_smoke_inp_writer_round_trips(tmp_path):
    beam = tt.generate_grid_tet(6, 2, 2, (0, 0, 0), (6.0, 2.0, 2.0))
    p = str(tmp_path / "beam.inp")
    cs.write_inp(p, beam.coords, beam.conn)
    mesh = tt.read_inp_mesh(p)
    _same_mesh(mesh, jinp.read_inp_mesh(p))
    np.testing.assert_array_equal(mesh.coords, beam.coords)
    np.testing.assert_array_equal(mesh.conn, beam.conn)
    assert tt.inp_to_vtu(p, str(tmp_path / "beam"), verbose=False)
    back = tt.read_vtu_mesh(str(tmp_path / "beam.vtu"))
    np.testing.assert_array_equal(back.coords, beam.coords)
    np.testing.assert_array_equal(back.conn, beam.conn)


# ---------------------------------------------------------------------------
# Surface cache (tests/test_bc.py:88)
# ---------------------------------------------------------------------------


def test_surface_cache_reuse_and_clear(beam_tet_path):
    from topopteval_tpu.io.vtu import read_vtu_mesh as jax_read_vtu
    mesh = tt.read_vtu_mesh(beam_tet_path)
    s1 = bc.precompute_surface_nodes(mesh)
    assert mesh.surface() is s1                     # cached
    bc.clear_surface_cache(mesh)
    s2 = mesh.surface()
    assert s2 is not s1
    np.testing.assert_array_equal(s1.surface_nodes, s2.surface_nodes)
    mesh.clear_surface_cache()
    assert mesh.surface() is not s2
    ref = jbc.precompute_surface_nodes(jax_read_vtu(beam_tet_path))
    np.testing.assert_array_equal(s2.surface_nodes, ref.surface_nodes)
