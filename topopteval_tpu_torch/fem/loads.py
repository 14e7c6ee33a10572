"""Volume forces (gravity/acceleration) and surface tractions
(counterpart of ``topopteval_tpu.fem.loads``; reference:
src/FiniteElementAnalysis/VolumeForce.jl:1-243,
src/FiniteElementAnalysis/SurfaceTraction.jl:1-288).

Loads accumulate into the host-side problem load vector, as in the JAX
package.  The cell quadrature of a volume force runs on the problem's
device (``physical_gradients`` over every element at once); only the
nodal weights [C, k] come back to the host, where ``np.bincount`` sums
them onto the nodes.  Facet quadrature is host NumPy (ops/facets.py): a
facet batch is a few thousand faces.

``apply_volume_force`` and ``apply_variable_density_volume_force`` (and
``apply_gravity``/``apply_acceleration`` through the first) run as public
calls (``PhaseTimer.call``): a phase ``volume_force`` with the spans
``volume_force/quadrature`` (the device cell quadrature and its copy
back) and ``volume_force/nodal_sum`` (the host sum onto ``problem.f``),
whose host seconds the call leaves in ``problem.load_timings``, replaced
by each call.
"""

from __future__ import annotations

import functools
from typing import Callable, Sequence, Tuple

import numpy as np
import torch

from ..mesh import DIM, FULL_FACE_TABLES, Mesh
from ..ops.elements import element_tables, physical_gradients
from ..ops.facets import facet_geometry
from ..utils.profiling import PhaseTimer, span
from ..utils.terminal import log


def _cell_quadrature(mesh: Mesh, device, order: int = 2
                     ) -> Tuple[np.ndarray, float]:
    """(nodal weights [C, k] = sum_q N[q, k] w_q |J|, total volume), in
    float64, computed on ``device``."""
    with span("quadrature"):
        N, _, _ = element_tables(mesh.element_type, order)
        dmesh = mesh.device(dtype=torch.float64, device=device)
        _, wdet = physical_gradients(dmesh.coords[dmesh.conn.long()],
                                     mesh.element_type, order)
        nodal = wdet @ torch.as_tensor(N, dtype=torch.float64,
                                       device=wdet.device)
        return nodal.cpu().numpy(), float(wdet.sum())


def _add_nodal(problem, nodes: np.ndarray, weights: np.ndarray,
               vector: np.ndarray) -> np.ndarray:
    """problem.f[node, :] += (sum of the weights at node) * vector; returns
    the per-node weight sums."""
    with span("nodal_sum"):
        w = np.bincount(np.asarray(nodes, np.int64).reshape(-1),
                        weights=weights.reshape(-1),
                        minlength=problem.n_dofs // DIM)
        problem.f.reshape(-1, DIM)[:] += w[:, None] * vector[None, :]
    return w


def _volume_force_call(fn):
    """``fn(problem, ...)`` as a public call with its own timer, inside a
    phase ``volume_force``; the timer's seconds by path go to
    ``problem.load_timings``."""

    @functools.wraps(fn)
    def call(problem, *args, **kwargs):
        timer = PhaseTimer()
        with timer.call(fn.__name__), timer.phase("volume_force"):
            fn(problem, *args, **kwargs)
        problem.load_timings = timer.as_dict()

    return call


@_volume_force_call
def apply_volume_force(problem, body_force_vector: Sequence[float],
                       density: float = 1.0, order: int = 2) -> None:
    """Body force integration f_i += b * N_i * dOmega.

    The reference divides by ``density`` then multiplies it back, so the
    net applied load is exactly ``body_force_vector`` per unit volume
    whatever the density argument (reference: VolumeForce.jl:26-94), as in
    the JAX package.
    """
    mesh = problem.mesh
    b = np.asarray(body_force_vector, dtype=np.float64)
    nodal_w, total_volume = _cell_quadrature(mesh, problem.device, order)
    w = _add_nodal(problem, mesh.conn, nodal_w, b)
    total_force = w.sum() * b
    log(f"Applied volume force: {list(b)} N/m³")
    log(f"Total force applied: {list(total_force)} N")
    log(f"Total volume: {total_volume} m³")
    log(f"Average force density: {list(total_force / total_volume)} N/m³")


def apply_gravity(problem, density: float = 1.0, g: float = 9.81,
                  direction: Sequence[float] = (0.0, 0.0, -1.0)) -> None:
    """Gravity as a volume force (reference: VolumeForce.jl:112-132)."""
    d = np.asarray(direction, dtype=np.float64)
    unit = d / np.linalg.norm(d)
    log(f"Applying gravity: g = {g} m/s², direction = {list(unit)}, "
        f"density = {density} kg/m³")
    apply_volume_force(problem, density * g * unit, 1.0)


def apply_acceleration(problem, acceleration_vector: Sequence[float],
                       density: float = 1.0) -> None:
    """Uniform acceleration field (reference: VolumeForce.jl:149-159)."""
    a = np.asarray(acceleration_vector, dtype=np.float64)
    log(f"Applying acceleration: a = {list(a)} m/s², density = {density}")
    apply_volume_force(problem, density * a, 1.0)


@_volume_force_call
def apply_variable_density_volume_force(problem,
                                        body_force_vector: Sequence[float],
                                        density_data: np.ndarray,
                                        order: int = 2,
                                        void_threshold: float = 1e-6
                                        ) -> None:
    """Per-cell density-weighted body force; cells with rho < 1e-6 are
    skipped (reference: VolumeForce.jl:176-243, skip at :199-201)."""
    mesh = problem.mesh
    rho = np.asarray(density_data, dtype=np.float64).reshape(-1)
    if len(rho) != mesh.n_cells:
        raise ValueError("density length does not match number of cells")
    b = np.asarray(body_force_vector, dtype=np.float64)
    nodal_w, _ = _cell_quadrature(mesh, problem.device, order)
    rho_eff = np.where(rho < void_threshold, 0.0, rho)
    w = _add_nodal(problem, mesh.conn, nodal_w * rho_eff[:, None], b)
    log("Applied variable density volume force")
    log(f"Total force applied: {list(w.sum() * b)} N")


# ---------------------------------------------------------------------------
# Surface traction (reference: SurfaceTraction.jl)
# ---------------------------------------------------------------------------


def get_boundary_facets(mesh: Mesh, nodes) -> np.ndarray:
    """(cell, local_face) pairs whose face nodes are ALL in ``nodes``
    (reference: SurfaceTraction.jl:45-67, which scans every cell face, not
    just surface faces).  A tet10 / hex20 facet needs its mid-edge nodes
    in the set too (the full face tables).

    Returns an int array [M, 2].
    """
    node_arr = np.asarray(list(nodes) if not isinstance(nodes, np.ndarray)
                          else nodes, dtype=np.int64)
    member = np.zeros(mesh.n_nodes, dtype=bool)
    member[node_arr] = True
    faces = np.asarray(FULL_FACE_TABLES[mesh.element_type], dtype=np.int64)
    all_in = member[mesh.conn[:, faces]].all(axis=2)     # [C, nf]
    cell_ids, local_ids = np.nonzero(all_in)
    out = np.stack([cell_ids, local_ids], axis=1)
    log(f"Found {len(out)} boundary facets")
    return out


def _facet_coords(mesh: Mesh, boundary_facets: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """(face global node ids [M, fk], their coordinates [M, fk, 3]), on the
    full face tables: quadratic facets (tri6, quad8) get the consistent
    quadratic load vector."""
    faces = np.asarray(FULL_FACE_TABLES[mesh.element_type], dtype=np.int64)
    bf = np.asarray(boundary_facets, dtype=np.int64).reshape(-1, 2)
    gnodes = mesh.conn[bf[:, 0][:, None], faces[bf[:, 1]]]
    return gnodes, mesh.coords[gnodes]


def compute_boundary_area(mesh: Mesh, boundary_facets: np.ndarray) -> float:
    """Total facet area via Gauss quadrature (reference:
    SurfaceTraction.jl:94-125)."""
    if len(boundary_facets) == 0:
        return 0.0
    _, coords = _facet_coords(mesh, boundary_facets)
    _, dGamma, _ = facet_geometry(coords)
    return float(dGamma.sum())


def apply_surface_traction(problem, boundary_facets: np.ndarray,
                           traction_function: Callable) -> None:
    """Position-dependent traction: f_i += (N_i · t(x)) dGamma
    (reference: SurfaceTraction.jl:165-235).

    ``traction_function(x, y, z) -> [tx, ty, tz]``; it is applied to whole
    arrays of quadrature points if it broadcasts over them, else point by
    point.
    """
    mesh = problem.mesh
    gnodes, coords = _facet_coords(mesh, boundary_facets)
    N, dGamma, xq = facet_geometry(coords)            # [q,fk],[F,q],[F,q,3]
    try:  # vectorized path
        t = np.asarray(traction_function(xq[..., 0], xq[..., 1], xq[..., 2]),
                       dtype=np.float64)
        if t.shape == (3,):
            t = np.broadcast_to(t, (*xq.shape[:2], 3)).copy()
        elif t.shape != (*xq.shape[:2], 3):
            t = np.moveaxis(t, 0, -1)
    except Exception:  # pointwise fallback
        t = np.array([[traction_function(*p) for p in fq] for fq in xq],
                     dtype=np.float64)
    # fe[f,k,comp] = sum_q N[q,k] t[f,q,comp] dGamma[f,q]
    fe = np.einsum("qk,fqc,fq->fkc", N, t, dGamma)
    dofs = gnodes[:, :, None] * DIM + np.arange(DIM, dtype=np.int64)
    problem.f += np.bincount(dofs.reshape(-1), weights=fe.reshape(-1),
                             minlength=problem.n_dofs)
    total_force = np.einsum("fqc,fq->c", t, dGamma)
    log(f"Applied surface traction over {len(boundary_facets)} facets")
    log(f"  Total boundary area: {round(float(dGamma.sum()), 6)}")
    log(f"  Total applied force: {[round(float(v), 6) for v in total_force]}")


def apply_uniform_surface_traction(problem, boundary_facets: np.ndarray,
                                   total_force_vector: Sequence[float]
                                   ) -> None:
    """Uniform traction t = F_total / A (reference:
    SurfaceTraction.jl:261-287, zero-area guard at :272-274)."""
    area = compute_boundary_area(problem.mesh, boundary_facets)
    if area < 1e-12:
        raise ValueError(
            "Boundary area is effectively zero. Check facet selection.")
    traction = np.asarray(total_force_vector, dtype=np.float64) / area
    log("Uniform surface traction:")
    log(f"  Boundary area: {round(area, 6)}")
    log(f"  Traction magnitude: {round(float(np.linalg.norm(traction)), 6)}")
    apply_surface_traction(problem, boundary_facets,
                           lambda x, y, z: traction)
