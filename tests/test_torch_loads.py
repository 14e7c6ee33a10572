"""The load path of the PyTorch port (fem/loads.py, ops/facets.py, the
sliding and circle selections, the gravity problems, the BC export)
against the JAX package, on the CPU.

The cases are those of tests/test_loads.py, tests/test_analytical.py and
tests/test_tet10_facets.py, each run through both packages: load vectors
must agree to rtol 1e-10 (the port sums the cell quadrature with
``np.bincount`` on the problem's device, the JAX package with
``np.add.at``: the same sums in another order), and the analytical checks
hold at the JAX tests' own tolerances.
"""

import numpy as np
import pytest
import torch

from topopteval_tpu import api as jax_api
from topopteval_tpu.config import SolverConfig as JaxSolverConfig
from topopteval_tpu.fem import bc as jax_bc
from topopteval_tpu.fem import loads as jax_loads
from topopteval_tpu.io import read_vtu_mesh as jax_read_vtu
from topopteval_tpu.io.results import \
    export_boundary_conditions as jax_export_bc
from topopteval_tpu.materials import constitutive_stress as jax_stress
from topopteval_tpu.materials import elasticity_matrix as jax_D
from topopteval_tpu.models import beams as jax_beams
from topopteval_tpu.models import problems as jax_problems
from topopteval_tpu.ops import facets as jax_facets
import topopteval_tpu_torch as tt
from topopteval_tpu_torch.io.vtu import VTUFile
from topopteval_tpu_torch.materials import constitutive_stress
from topopteval_tpu_torch.ops import facets

tt.set_verbosity(False)
torch.set_num_threads(1)

DIRECT = dict(method="direct", verbose=False)
GEN = {"hex": (jax_beams.generate_grid_hex, tt.generate_grid_hex),
       "tet": (jax_beams.generate_grid_tet, tt.generate_grid_tet)}


def _pair(kind, *args, order=1):
    """The same generated box as a JAX and a port problem (float64, CPU)."""
    jgen, tgen = GEN[kind]
    jp = jax_api.setup_problem(jgen(*args), interpolation_order=order)
    tp = tt.setup_problem(tgen(*args), interpolation_order=order,
                          dtype=torch.float64, device="cpu")
    return jp, tp


def _same_f(jp, tp):
    np.testing.assert_allclose(tp.f, jp.f, rtol=1e-10,
                               atol=1e-10 * np.abs(jp.f).max())


@pytest.mark.parametrize("kind", ["hex", "tet"])
def test_volume_force_total(kind):
    jp, tp = _pair(kind, 3, 2, 2, (0, 0, 0), (3.0, 2.0, 1.0))
    b = np.array([0.5, -1.0, 2.0])
    jax_loads.apply_volume_force(jp, b)
    tt.apply_volume_force(tp, b)
    _same_f(jp, tp)
    np.testing.assert_allclose(tp.f.reshape(-1, 3).sum(axis=0), b * 6.0,
                               rtol=1e-12)


def test_gravity_and_acceleration_totals():
    jp, tp = _pair("hex", 4, 4, 4)              # unit cube
    rho, g = 7850.0, 9.81
    jax_loads.apply_gravity(jp, rho, g, [0.0, 0.0, -1.0])
    tt.apply_gravity(tp, rho, g, [0.0, 0.0, -1.0])
    _same_f(jp, tp)
    np.testing.assert_allclose(tp.f.reshape(-1, 3).sum(axis=0),
                               [0.0, 0.0, -rho * g], rtol=1e-12, atol=1e-9)
    jax_loads.apply_acceleration(jp, [1.0, 2.0, 0.0], 3.0)
    tt.apply_acceleration(tp, [1.0, 2.0, 0.0], 3.0)
    _same_f(jp, tp)


def test_variable_density_volume_force_skips_void():
    jp, tp = _pair("hex", 4, 1, 1, (0, 0, 0), (4.0, 1, 1))
    rho = np.array([1.0, 0.5, 1e-8, 0.0])   # last two below 1e-6: skipped
    jax_loads.apply_variable_density_volume_force(jp, [0, 0, -10.0], rho)
    tt.apply_variable_density_volume_force(tp, [0, 0, -10.0], rho)
    _same_f(jp, tp)
    total = tp.f.reshape(-1, 3).sum(axis=0)
    np.testing.assert_allclose(total, [0, 0, -10.0 * 1.5], rtol=1e-12)
    void_only = np.flatnonzero(tp.mesh.coords[:, 0] >= 3.0 - 1e-12)
    assert np.all(tp.f.reshape(-1, 3)[void_only] == 0.0)
    with pytest.raises(ValueError, match="density length"):
        tt.apply_variable_density_volume_force(tp, [0, 0, 1.0], rho[:2])


def test_boundary_facets_and_area_beam_end(beam_tet_path):
    """The fixture's x=60 cross-section is a partial region of the 20x4
    face: facets and area against the JAX package and against a brute
    force over the surface triangles."""
    jmesh, mesh = jax_read_vtu(beam_tet_path), tt.import_mesh(beam_tet_path)
    end_nodes = tt.nodes_at_plane(mesh, 0, 60.0)
    fac = tt.get_boundary_facets(mesh, end_nodes)
    np.testing.assert_array_equal(
        fac, jax_loads.get_boundary_facets(jmesh, end_nodes))
    area = tt.compute_boundary_area(mesh, fac)
    np.testing.assert_allclose(
        area, jax_loads.compute_boundary_area(jmesh, fac), rtol=1e-12)
    surf = mesh.surface()
    fc = mesh.coords[surf.face_conn]
    on_end = np.all(np.abs(fc[:, :, 0] - 60.0) < 1e-6, axis=1)
    assert on_end.sum() == len(fac)
    np.testing.assert_allclose(area, facets.facet_areas(fc[on_end]).sum(),
                               rtol=1e-12)
    assert 0 < area < 20.0 * 4.0


def test_boundary_facets_hex_box():
    mesh = tt.generate_grid_hex(3, 2, 2, (0, 0, 0), (3, 2, 2))
    fac = tt.get_boundary_facets(mesh, tt.nodes_at_plane(mesh, 2, 2.0))
    assert len(fac) == 3 * 2
    np.testing.assert_allclose(tt.compute_boundary_area(mesh, fac), 6.0,
                               rtol=1e-12)
    assert tt.compute_boundary_area(mesh, np.zeros((0, 2), int)) == 0.0


@pytest.mark.parametrize("fk", [3, 4, 6, 8])
def test_facet_tables_and_geometry(fk):
    """The tri3 / quad4 / tri6 / quad8 rules, array for array, and the
    geometry of a random batch of warped facets."""
    for mine, ref in zip(facets.facet_tables(fk),
                         jax_facets.facet_tables(fk)):
        np.testing.assert_array_equal(mine, ref)
    coords = np.random.default_rng(fk).standard_normal((7, fk, 3))
    for mine, ref in zip(facets.facet_geometry(coords),
                         jax_facets.facet_geometry(coords)):
        np.testing.assert_allclose(mine, ref, rtol=1e-14, atol=1e-14)
    with pytest.raises(NotImplementedError):
        facets.facet_tables(5)


def test_uniform_surface_traction_totals(beam_tet_path):
    jmesh, mesh = jax_read_vtu(beam_tet_path), tt.import_mesh(beam_tet_path)
    jp = jax_api.setup_problem(jmesh)
    tp = tt.setup_problem(mesh, dtype=torch.float64, device="cpu")
    end = tt.nodes_at_plane(mesh, 0, 60.0)
    fac = tt.get_boundary_facets(mesh, end)
    F = [0.0, 0.0, -1.0]
    jax_loads.apply_uniform_surface_traction(jp, fac, F)
    tt.apply_uniform_surface_traction(tp, fac, F)
    _same_f(jp, tp)
    np.testing.assert_allclose(tp.f.reshape(-1, 3).sum(axis=0), F,
                               rtol=1e-9, atol=1e-12)
    loaded = np.flatnonzero(np.abs(tp.f.reshape(-1, 3)).sum(axis=1) > 0)
    np.testing.assert_array_equal(np.sort(loaded), np.sort(end))


def test_position_dependent_traction():
    jp, tp = _pair("hex", 2, 2, 1, (0, 0, 0), (2, 2, 1))
    fac = tt.get_boundary_facets(tp.mesh, tt.nodes_at_plane(tp.mesh, 2, 1.0))
    # t = [0, 0, -x]: total Fz = -integral of x over [0,2]x[0,2] = -4;
    # the second function does not broadcast, so it runs point by point
    for fn in (lambda x, y, z: [0.0 * x, 0.0 * x, -x],
               lambda x, y, z: [0.0, 0.0, -float(x)]):
        jax_loads.apply_surface_traction(jp, fac, fn)
        tt.apply_surface_traction(tp, fac, fn)
        _same_f(jp, tp)
    np.testing.assert_allclose(tp.f.reshape(-1, 3).sum(axis=0),
                               [0, 0, -8.0], rtol=1e-12, atol=1e-12)


def test_zero_area_guard():
    p = tt.setup_problem(tt.generate_grid_hex(2, 2, 2), device="cpu")
    with pytest.raises(ValueError, match="zero"):
        tt.apply_uniform_surface_traction(p, np.zeros((0, 2), dtype=int),
                                          [1.0, 0, 0])


def _solve_pair(jp, tp, jcfg=None, tcfg=None):
    return (jax_api.solve_system(jp, jcfg or JaxSolverConfig(**DIRECT)),
            tt.solve_system(tp, tcfg or tt.SolverConfig(**DIRECT)))


def test_cantilever_gravity_euler_bernoulli():
    """reference: testVolumeForces.jl:6-60; the JAX test's 5 % bar.  The
    problem comes from ``cantilever_under_gravity`` in both packages."""
    jp = jax_problems.cantilever_under_gravity()
    tp = tt.cantilever_under_gravity(dtype=torch.float64, device="cpu")
    _same_f(jp, tp)
    jr, tr = _solve_pair(jp, tp)
    L, w, h, E, rho, g = 10.0, 1.0, 1.0, 200e9, 7850.0, 9.81
    analytical = rho * g * L ** 4 / (8 * E * w * h ** 3 / 12)
    numerical = np.max(np.abs(tr.u.reshape(-1, 3)[:, 2]))
    assert numerical > 0.0
    assert abs(numerical - analytical) / analytical * 100 < 5.0
    assert abs(tr.energy - jr.energy) <= 1e-10 * jr.energy


def test_cube_gravity_stress_scale():
    """reference: testVolumeForces.jl:65-102, bounds at :172-178."""
    jp = jax_problems.cube_under_gravity()
    tp = tt.cube_under_gravity(dtype=torch.float64, device="cpu")
    _same_f(jp, tp)
    jr, tr = _solve_pair(jp, tp)
    assert 0.0 < np.max(np.abs(tr.u)) < 1e-3
    analytical = 7850.0 * 9.81 * 1.0
    mesh = tp.mesh
    bottom = np.flatnonzero(
        mesh.coords[mesh.conn].mean(axis=1)[:, 2] < 1.0 / 8)
    szz = tr.stress_avg[bottom, 2, 2]
    assert abs(np.median(szz) + analytical) / analytical < 0.15
    assert abs(tr.energy - jr.energy) <= 1e-10 * jr.energy


@pytest.mark.parametrize("direction,fix_axis", [
    ([0.0, 0.0, -1.0], 2),
    ([1.0, 0.0, 0.0], 0),
    ([0.0, 1.0, 0.0], 1),
    ([1.0 / np.sqrt(2), 1.0 / np.sqrt(2), 0.0], 0),
])
def test_gravity_directions(direction, fix_axis):
    """reference: testVolumeForces.jl:107-157, 181-191."""
    jp, tp = _pair("hex", 6, 6, 6)
    normal = [0.0, 0.0, 0.0]
    normal[fix_axis] = 1.0
    lam, mu = tt.create_material_model(200e9, 0.3)
    for api, p in ((jax_api, jp), (tt, tp)):
        api.assemble_stiffness_matrix(p, lam, mu)
        api.apply_fixed_boundary(p, tt.select_nodes_by_plane(
            tp.mesh, [0.0, 0, 0], normal, 1e-9))
    jax_loads.apply_gravity(jp, 7850.0, 9.81, direction)
    tt.apply_gravity(tp, 7850.0, 9.81, direction)
    _same_f(jp, tp)
    jr, tr = _solve_pair(jp, tp)
    assert tr.energy > 0.0 and np.max(np.abs(tr.u)) > 0.0
    assert abs(tr.energy - jr.energy) <= 1e-10 * jr.energy


def _tet10_pair():
    return _pair("tet", 4, 2, 2, (0, 0, 0), (4.0, 2.0, 2.0), order=2)


def test_surface_selection_includes_midedge_nodes():
    jp, tp = _tet10_pair()
    sel = tt.select_nodes_by_plane(tp.mesh, (4.0, 0, 0), (1, 0, 0),
                                   tolerance=1e-6)
    np.testing.assert_array_equal(sel, jax_bc.select_nodes_by_plane(
        jp.mesh, (4.0, 0, 0), (1, 0, 0), tolerance=1e-6))
    mesh4 = tt.generate_grid_tet(4, 2, 2, (0, 0, 0), (4.0, 2.0, 2.0))
    assert sel.size > int((np.abs(mesh4.coords[:, 0] - 4.0) < 1e-9).sum())
    assert np.all(np.abs(tp.mesh.coords[sel, 0] - 4.0) < 1e-9)


def test_tet10_traction_consistent_load_vector():
    """Constant traction on straight tri6 faces: zero on the corners and
    A t / 3 per mid-edge node, in both packages."""
    jp, tp = _tet10_pair()
    sel = tt.select_nodes_by_plane(tp.mesh, (4.0, 0, 0), (1, 0, 0),
                                   tolerance=1e-6)
    fac = tt.get_boundary_facets(tp.mesh, sel)
    assert abs(tt.compute_boundary_area(tp.mesh, fac) - 4.0) < 1e-10
    jax_loads.apply_uniform_surface_traction(jp, fac, [0.0, 0.0, -1.0])
    tt.apply_uniform_surface_traction(tp, fac, [0.0, 0.0, -1.0])
    _same_f(jp, tp)
    np.testing.assert_allclose(tp.f.reshape(-1, 3).sum(axis=0), [0, 0, -1.0],
                               atol=1e-12)
    fz = tp.f.reshape(-1, 3)[:, 2]
    n4 = tt.generate_grid_tet(4, 2, 2).n_nodes
    corners, mids = sel[sel < n4], sel[sel >= n4]
    assert abs(fz[corners].sum()) < 1e-10 * abs(fz[mids].sum())


def test_tet10_traction_solve_matches_direct():
    jp, tp = _tet10_pair()
    sel = tt.select_nodes_by_plane(tp.mesh, (4.0, 0, 0), (1, 0, 0),
                                   tolerance=1e-6)
    fac = tt.get_boundary_facets(tp.mesh, sel)
    lam, mu = tt.lame_parameters(1.0, 0.3)
    for api, p, lo in ((jax_api, jp, jax_loads), (tt, tp, tt)):
        lo.apply_uniform_surface_traction(p, fac, [0.0, 0.0, -1.0])
        api.assemble_stiffness_matrix(p, lam, mu)
        api.apply_fixed_boundary(p, tt.nodes_at_plane(tp.mesh, 0, 0.0))
    cg = dict(method="cg", preconditioner="block_diagonal", tolerance=1e-12,
              max_iterations=10000, verbose=False)
    r_it = tt.solve_system(tp, tt.SolverConfig(**cg))
    jr, r_d = _solve_pair(jp, tp)
    assert abs(r_it.energy - r_d.energy) / r_d.energy < 1e-9
    assert abs(r_d.energy - jr.energy) <= 1e-10 * jr.energy


def test_circle_and_sliding_selection():
    jmesh = jax_beams.generate_grid_hex(6, 6, 2, (0, 0, 0), (6.0, 6.0, 2.0))
    mesh = tt.generate_grid_hex(6, 6, 2, (0, 0, 0), (6.0, 6.0, 2.0))
    args = ([3.0, 3.0, 2.0], [0.0, 0.0, 1.0], 1.5, 0.1)
    sel = tt.select_nodes_by_circle(mesh, *args)
    np.testing.assert_array_equal(sel, jax_bc.select_nodes_by_circle(
        jmesh, *args))
    assert 0 < sel.size < tt.nodes_at_plane(mesh, 2, 2.0).size
    jp, tp = _pair("hex", 2, 2, 2)
    jbc = jax_api.apply_sliding_boundary(jp, sel[:3] % 27, [0, 2])
    tbc = tt.apply_sliding_boundary(tp, sel[:3] % 27, [0, 2])
    np.testing.assert_array_equal(tbc.fixed_dofs, jbc.fixed_dofs)
    assert tp.bcs == [tbc]
    with pytest.raises(ValueError, match="components"):
        tt.DirichletBC.sliding([0], [3])


def test_elasticity_matrix_and_constitutive_stress():
    lam, mu = tt.lame_parameters(210.0, 0.3)
    np.testing.assert_array_equal(tt.elasticity_matrix(lam, mu),
                                  jax_D(lam, mu))
    eps = np.random.default_rng(1).standard_normal((5, 3, 3))
    eps = eps + eps.transpose(0, 2, 1)
    ref = np.asarray(jax_stress(eps, lam, mu))
    np.testing.assert_allclose(constitutive_stress(eps, lam, mu), ref,
                               rtol=1e-14)
    np.testing.assert_allclose(
        constitutive_stress(torch.as_tensor(eps), lam, mu).numpy(), ref,
        rtol=1e-14)


@pytest.mark.parametrize("kind", ["hex", "tet10"])
def test_export_boundary_conditions(tmp_path, kind):
    """The BC surface mesh of both packages, cell for cell; a tet10 face
    exports as its corner triangle (FACE_TABLES, not the full tables)."""
    jp, tp = (_pair("hex", 4, 2, 2, (0, 0, 0), (4.0, 2.0, 2.0))
              if kind == "hex" else _tet10_pair())
    fixed = tt.nodes_at_plane(tp.mesh, 0, 0.0)
    loaded = tt.nodes_at_plane(tp.mesh, 0, 4.0)
    paths = [jax_export_bc(jp.mesh, fixed, loaded, str(tmp_path / "jax")),
             tt.export_boundary_conditions(tp.mesh, fixed, loaded,
                                           str(tmp_path / "port"))]
    cells = []
    for path in paths:
        vf = VTUFile(path)
        cells.append((*vf.cells(), vf.cell_data()["boundary_type"]))
    for mine, ref in zip(cells[1], cells[0]):
        np.testing.assert_array_equal(mine, ref)
    types = cells[1][3]
    assert set(np.unique(types)) == {1, 2}
    # the x = 0 end: 2 x 2 quads, or the 8 triangles of the tet split
    assert np.count_nonzero(types == 1) == (4 if kind == "hex" else 8)
