"""Operator, I/O and post-processing parity of the PyTorch port against the
JAX package, on both bundled fixtures (mirrors
tests/test_end_to_end.py:119-143).

Each fixture problem is built once with the JAX package's API; its state
goes to the port as plain NumPy arrays through ``problem_from_numpy``, so
both packages apply the same operator to the same seeded inputs, in
float64 on the CPU.

Tolerance: rtol=1e-10 (atol scaled by the largest entry), the JAX
package's own operator tolerance.  Both sides evaluate the same float64
formulas in different summation orders, so they agree to a few ulps
times the element conditioning.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topopteval_tpu.api import (apply_fixed_boundary, apply_force,
                                assemble_stiffness_matrix,
                                assemble_stiffness_matrix_simp,
                                calculate_volume, extract_cell_density,
                                import_mesh, setup_problem)
from topopteval_tpu.fem.bc import (free_mask_from_bcs, nodes_at_plane,
                                   select_nodes_by_plane)
from topopteval_tpu.fem.operator import assemble_scipy
from topopteval_tpu.io.vtu import read_cell_density, read_vtu_mesh
from topopteval_tpu.materials import (create_material_model,
                                      create_simp_material_model)
from topopteval_tpu.ops import stress as jax_stress
import topopteval_tpu_torch as tt
from topopteval_tpu_torch.fem.operator import \
    assemble_scipy as port_assemble_scipy
from topopteval_tpu_torch.ops import stress as port_stress

tt.set_verbosity(False)
# these tests work on small tensors: one intra-op thread each, so that
# test processes running side by side do not fight over the cores (torch's
# thread pool spins at its barriers when the machine is oversubscribed)
torch.set_num_threads(1)

RTOL = 1e-10


def problem_state(problem) -> dict:
    """A JAX-package Problem as the plain NumPy state the port takes."""
    return {"coords": problem.mesh.coords, "conn": problem.mesh.conn,
            "element_type": problem.mesh.element_type,
            "lam": problem.lam, "mu": problem.mu,
            "density": problem.density, "f": problem.f,
            "fixed_dofs": [bc.fixed_dofs for bc in problem.bcs],
            "quad_order": problem.quad_order}


def _jax_fixture(path, simp):
    mesh = import_mesh(path)
    problem = setup_problem(mesh)
    if simp:
        assemble_stiffness_matrix_simp(
            problem, create_simp_material_model(1.0, 0.3, 1e-8, 3.0),
            extract_cell_density(path))
    else:
        assemble_stiffness_matrix(problem, *create_material_model(1.0, 0.3))
    apply_fixed_boundary(problem, nodes_at_plane(mesh, 0, 0.0))
    apply_force(problem, nodes_at_plane(mesh, 0, 60.0), [0.0, 0.0, -1.0])
    return problem


@pytest.fixture(scope="module", params=["cantilever", "simp"])
def pair(request, beam_tet_path, beam_hex_path):
    """(JAX problem, port problem) for one fixture, float64 on the CPU."""
    simp = request.param == "simp"
    jp = _jax_fixture(beam_hex_path if simp else beam_tet_path, simp)
    pp = tt.problem_from_numpy(problem_state(jp), device="cpu",
                               dtype=torch.float64)
    return jp, pp


def _close(actual, desired):
    desired = np.asarray(desired)
    np.testing.assert_allclose(np.asarray(actual), desired, rtol=RTOL,
                               atol=RTOL * np.abs(desired).max())


def _u(n, seed):
    return np.random.default_rng(seed).standard_normal(n)


def test_matvec_raw_matches_jax_and_assembled(pair):
    jp, pp = pair
    u = _u(jp.n_dofs, 0)
    ref_jax = np.asarray(jp.build_operator(with_bc=False).matvec_raw(
        jnp.asarray(u)))
    ours = pp.build_operator(with_bc=False).matvec_raw(torch.from_numpy(u))
    _close(ours.numpy(), ref_jax)
    K_raw = assemble_scipy(jp.mesh, jp.lam, jp.mu)
    _close(ours.numpy(), K_raw @ u)


def test_matvec_masked_matches_jax_and_assembled(pair):
    jp, pp = pair
    u = _u(jp.n_dofs, 1)
    ref_jax = np.asarray(jp.build_operator().matvec(jnp.asarray(u)))
    ours = pp.build_operator().matvec(torch.from_numpy(u)).numpy()
    _close(ours, ref_jax)
    mask = free_mask_from_bcs(jp.n_dofs, jp.bcs)
    K_bc = assemble_scipy(jp.mesh, jp.lam, jp.mu, free_mask=mask)
    _close(ours, K_bc @ u)


def test_diagonal_matches_jax_and_assembled(pair):
    jp, pp = pair
    ours = pp.build_operator().diagonal().numpy()
    _close(ours, np.asarray(jp.build_operator().diagonal()))
    mask = free_mask_from_bcs(jp.n_dofs, jp.bcs)
    _close(ours, assemble_scipy(jp.mesh, jp.lam, jp.mu,
                                free_mask=mask).diagonal())


def test_node_blocks_match_jax_and_assembled(pair):
    jp, pp = pair
    ours = pp.build_operator().node_blocks_raw().numpy()
    _close(ours, np.asarray(jp.build_operator().node_blocks_raw()))
    K = assemble_scipy(jp.mesh, jp.lam, jp.mu).tocsr()
    n = jp.mesh.n_nodes
    idx = np.arange(3 * n).reshape(n, 3)
    blocks = np.stack([np.asarray(K[idx[:, a], idx[:, b]]).reshape(-1)
                       for a in range(3) for b in range(3)],
                      axis=1).reshape(n, 3, 3)
    _close(ours, blocks)


def test_assemble_scipy_energy_and_volume_match_jax(pair):
    jp, pp = pair
    mask = free_mask_from_bcs(jp.n_dofs, jp.bcs)
    K_jax = assemble_scipy(jp.mesh, jp.lam, jp.mu, free_mask=mask)
    K_port = port_assemble_scipy(pp.mesh, pp.lam, pp.mu, free_mask=mask)
    diff = abs(K_jax - K_port).max()
    assert diff <= RTOL * abs(K_jax).max()
    u = _u(jp.n_dofs, 2)
    e_jax = float(jp.build_operator().energy(jnp.asarray(u)))
    e_port = float(pp.build_operator().energy(torch.from_numpy(u)))
    assert abs(e_port - e_jax) <= RTOL * abs(e_jax)
    v_jax = calculate_volume(jp.mesh, jp.density)
    v_port = tt.calculate_volume(pp.mesh, pp.density, device="cpu")
    assert abs(v_port - v_jax) <= RTOL * v_jax


def test_stress_recovery_matches_jax(pair):
    jp, pp = pair
    u = _u(jp.n_dofs, 3)
    dm_jax = jp.mesh.device(dtype=jnp.float64)
    out_jax = jax_stress.stress_summary(dm_jax, jnp.asarray(u),
                                        jnp.asarray(jp.lam),
                                        jnp.asarray(jp.mu))
    dm_port = pp.mesh.device(dtype=torch.float64, device="cpu")
    out_port = port_stress.stress_summary(dm_port, torch.from_numpy(u),
                                          torch.from_numpy(pp.lam),
                                          torch.from_numpy(pp.mu))
    for a, b in zip(out_port[:4], out_jax[:4]):
        _close(a.numpy(), b)
    assert int(out_port[4]) == int(out_jax[4])
    _close(port_stress.principal_stresses(out_port[1]).numpy(),
           jax_stress.principal_stresses(out_jax[1]))


@pytest.mark.parametrize("name", ["beam_linear_volume_mesh.vtu",
                                  "beam_vfrac_04_Raw.vtu"])
def test_vtu_readers_return_identical_arrays(data_dir, name):
    path = os.path.join(data_dir, name)
    a, b = read_vtu_mesh(path), tt.read_vtu_mesh(path)
    assert a.element_type == b.element_type
    np.testing.assert_array_equal(a.coords, b.coords)
    np.testing.assert_array_equal(a.conn, b.conn)
    assert a.cellsets.keys() == b.cellsets.keys()
    for key in a.cellsets:
        np.testing.assert_array_equal(a.cellsets[key], b.cellsets[key])
    if name == "beam_vfrac_04_Raw.vtu":
        np.testing.assert_array_equal(read_cell_density(path),
                                      tt.read_cell_density(path))


def _b64_zlib_dataarray(arr, vtk_type, name=None, ncomp=None) -> str:
    """Inline format="binary" + vtkZLibDataCompressor element text, as in
    tests/test_vtu_io.py: header and data are two separate base64 streams."""
    import base64
    import zlib

    raw = np.ascontiguousarray(arr).tobytes()
    comp = zlib.compress(raw)
    header = np.array([1, len(raw), len(raw), len(comp)],
                      dtype="<u8").tobytes()
    text = (base64.b64encode(header).decode()
            + base64.b64encode(comp).decode())
    attrs = f'type="{vtk_type}" format="binary"'
    if name:
        attrs += f' Name="{name}"'
    if ncomp:
        attrs += f' NumberOfComponents="{ncomp}"'
    return f"<DataArray {attrs}>{text}</DataArray>"


def test_inline_binary_vtu_reads_identically(tmp_path):
    """The compressed inline-binary variant (two base64 streams) of
    tests/test_vtu_io.py decodes to the same arrays in both readers."""
    pts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]],
                   dtype=np.float64)
    xml = f"""<?xml version="1.0"?>
<VTKFile type="UnstructuredGrid" version="1.0" byte_order="LittleEndian"
         header_type="UInt64" compressor="vtkZLibDataCompressor">
<UnstructuredGrid><Piece NumberOfPoints="4" NumberOfCells="1">
<Points>{_b64_zlib_dataarray(pts, "Float64", ncomp=3)}</Points>
<Cells>{_b64_zlib_dataarray(np.arange(4), "Int64", name="connectivity")}
{_b64_zlib_dataarray(np.array([4]), "Int64", name="offsets")}
{_b64_zlib_dataarray(np.array([10], np.uint8), "UInt8", name="types")}</Cells>
<CellData>{_b64_zlib_dataarray(np.array([0.5]), "Float64", name="density")}</CellData>
</Piece></UnstructuredGrid></VTKFile>"""
    p = tmp_path / "inline.vtu"
    p.write_text(xml)
    a, b = read_vtu_mesh(str(p)), tt.read_vtu_mesh(str(p))
    np.testing.assert_array_equal(a.coords, b.coords)
    np.testing.assert_array_equal(a.conn, b.conn)
    assert b.element_type == "tet4"
    np.testing.assert_array_equal(read_cell_density(str(p)),
                                  tt.read_cell_density(str(p)))


def test_surface_selection_matches_jax(beam_tet_path):
    a, b = read_vtu_mesh(beam_tet_path), tt.read_vtu_mesh(beam_tet_path)
    sa, sb = a.surface(), b.surface()
    np.testing.assert_array_equal(sa.surface_nodes, sb.surface_nodes)
    np.testing.assert_array_equal(sa.face_cells, sb.face_cells)
    np.testing.assert_array_equal(sa.face_local, sb.face_local)
    np.testing.assert_array_equal(
        select_nodes_by_plane(a, [0, 0, 0], [1, 0, 0], 1.0),
        tt.select_nodes_by_plane(b, [0, 0, 0], [1, 0, 0], 1.0))
    np.testing.assert_array_equal(nodes_at_plane(a, 0, 60.0),
                                  tt.nodes_at_plane(b, 0, 60.0))
