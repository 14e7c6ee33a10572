"""High-level workflow API (counterpart of ``topopteval_tpu.api``).

The reference drives a linear pipeline from the caller:
import → setup → assemble → BC/loads → solve → post-process → export
(reference: test/runtests.jl:24-48; facade src/TopOptEval.jl:17-42).
A :class:`Problem` carries the mesh, the accumulated loads and
constraints, the material, the compute dtype and the device; the solve
runs the matrix-free operator on that device.

Routes of ``solve_system`` in this package: ``direct`` (host sparse LU),
block-Jacobi PCG (``cg``) with float64 dots, multigrid PCG
(``preconditioner="multigrid"``) on generated tet4 boxes through the
stencil hierarchy of fem/multigrid.py and on every other mesh through the
block-ELL hierarchy of fem/bell.py (or, with ``TOPOPT_MG=galerkin``, the
Galerkin voxel hierarchy of fem/multigrid.py), the robust ladder of
fem/robust.py (``minres``, ``gmres``, ``bicgstab``, and ``cg`` with
``verbose=True`` outside multigrid: the chosen method, then plain CG at
10x the tolerance, then the host direct solve), float32 inner solves
inside float64 host-residual refinement, and the backward-error gate
with its direct fallback.  ``solve_system_adaptive`` and
``solve_system_robust`` are the reference's size-switched and
diagnosed entry points.  ``devices=`` shards the CG solve over several
devices (parallel/halo.py, parallel/halo_mg.py), driven by one process.
``evaluate_design_batch`` evaluates a density batch times load cases by
batched block-Jacobi PCG lanes (parallel/sweep.py).
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import os
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from .config import (ADAPTIVE_DOF_THRESHOLD, DIRECT_LAST_RESORT_DOFS,
                     SolverConfig, adaptive_config)
from .fem.bc import DirichletBC, free_mask_from_bcs
from .fem.host_operator import HostFineOperator
from .fem.operator import StiffnessOperator, assemble_scipy
from .fem.solvers import (block_jacobi_preconditioner, cg, direct_solve,
                          jacobi_preconditioner)
from .materials import SIMPMaterial
from .mesh import DIM, Mesh, dofs_of_nodes, resolve_device
from .ops.elements import element_volumes
from .ops.stress import stress_summary
from .utils.profiling import PhaseRecord, PhaseTimer, span
from .utils.terminal import log, print_warning

#: lower clip of the per-pass inner tolerance in mixed-precision refinement
_REFINE_INNER_FLOOR = 1e-7
#: past ``max_passes`` a refinement pass has to cut the true residual this
#: many times, else the refinement has stalled
_REFINE_MIN_GAIN = 10.0


# ---------------------------------------------------------------------------
# Mesh import / inspection
# ---------------------------------------------------------------------------


def import_mesh(path: str) -> Mesh:
    """Read a .vtu or .msh mesh (reference: MeshImport.jl:20-164)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".vtu":
        log(f"Importing VTU mesh from {path}...")
        from .io.vtu import read_vtu_mesh
        return read_vtu_mesh(path)
    if ext == ".msh":
        log(f"Importing GMSH mesh from {path}...")
        from .io.gmsh import read_msh_mesh
        return read_msh_mesh(path)
    raise ValueError(f"Unsupported mesh format: {ext}. "
                     "Only .msh and .vtu formats are supported.")


def extract_cell_density(path: str) -> np.ndarray:
    """reference: MeshImport.jl:177-215."""
    ext = os.path.splitext(path)[1].lower()
    if ext != ".vtu":
        raise ValueError("Density extraction is only supported for VTU files")
    from .io.vtu import read_cell_density
    return read_cell_density(path)


def calculate_volume(mesh: Mesh, density: Optional[np.ndarray] = None,
                     device="cuda") -> float:
    """Density-weighted volume in float64 on ``device`` (reference:
    Utils.jl:24-92)."""
    if density is None:
        log("No density data provided, assuming uniform density of 1.0")
        density = np.ones(mesh.n_cells)
    density = np.asarray(density, dtype=np.float64).reshape(-1)
    if len(density) != mesh.n_cells:
        raise ValueError(
            f"Density data length ({len(density)}) does not match number "
            f"of cells ({mesh.n_cells})")
    dmesh = mesh.device(dtype=torch.float64, device=device)
    vols = element_volumes(dmesh.coords[dmesh.conn.long()], mesh.element_type)
    total = float(torch.sum(vols * torch.tensor(density,
                                                device=dmesh.device)))
    log(f"Total weighted mesh volume: {total} cubic units")
    return total


# ---------------------------------------------------------------------------
# Problem container
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Problem:
    """Mutable workflow state (the reference's (dh, cellvalues, K, f)
    tuple, FiniteElementAnalysis.jl:151-185, collapsed into one object)."""

    mesh: Mesh
    interpolation_order: int = 1
    dtype: torch.dtype = torch.float32
    quad_order: Optional[int] = None          # None → per-type default
    f: np.ndarray = None                      # host-accumulated load vector
    bcs: List[DirichletBC] = dataclasses.field(default_factory=list)
    lam: Optional[np.ndarray] = None          # per-element
    mu: Optional[np.ndarray] = None
    density: Optional[np.ndarray] = None
    material: Optional[SIMPMaterial] = None
    mode: str = "otf"
    device: torch.device = dataclasses.field(
        default_factory=lambda: torch.device("cuda"))
    #: (fingerprint, operator, preconditioner) of the last multigrid build
    _mg_cache: Optional[tuple] = dataclasses.field(default=None, repr=False)
    #: build record of the last block-ELL hierarchy (fem/bell.py)
    _mg_build_info: Optional[dict] = dataclasses.field(default=None,
                                                       repr=False)
    #: host seconds by span path of ``setup_problem`` (``to_quadratic``)
    #: and of the last volume-force call (fem/loads.py: ``volume_force``,
    #: ``volume_force/quadrature``, ``volume_force/nodal_sum``)
    setup_timings: Optional[dict] = dataclasses.field(default=None,
                                                      repr=False)
    load_timings: Optional[dict] = dataclasses.field(default=None,
                                                     repr=False)

    def __post_init__(self):
        if self.quad_order is None:
            self.quad_order = 3 if self.mesh.element_type == "hex20" else 2
        if self.f is None:
            self.f = np.zeros(self.mesh.n_dofs, dtype=np.float64)
        if self.dtype not in (torch.float32, torch.float64):
            raise ValueError(f"dtype must be torch.float32 or torch.float64, "
                             f"got {self.dtype}")
        self.device = resolve_device(self.device)

    @property
    def n_dofs(self) -> int:
        return self.mesh.n_dofs

    def build_operator(self, with_bc: bool = True) -> StiffnessOperator:
        if self.lam is None:
            raise RuntimeError("assemble_stiffness_matrix(...) first")
        dmesh = self.mesh.device(dtype=self.dtype, device=self.device)
        mask = None
        if with_bc and self.bcs:
            mask = torch.as_tensor(free_mask_from_bcs(self.n_dofs, self.bcs),
                                   dtype=self.dtype, device=self.device)
        return StiffnessOperator.build(dmesh, self.lam, self.mu,
                                       free_mask=mask, mode=self.mode,
                                       order=self.quad_order)


def setup_problem(mesh: Mesh, interpolation_order: int = 1,
                  dtype: torch.dtype = torch.float32, mode: str = "otf",
                  device="cuda") -> Problem:
    """reference: FiniteElementAnalysis.jl:151-185.

    ``interpolation_order=2`` on a tet4 or hex8 mesh refines it to tet10 /
    hex20 (``Mesh.to_quadratic``; the reference applies the order to both
    families, FiniteElementAnalysis.jl:160-163).  ``dtype`` defaults to
    float32, the JAX package's accelerator default; ``torch.float64``
    gives fp64 throughout.  ``mode`` is the operator's, ``"otf"`` or
    ``"stored"``.  ``device`` defaults to ``"cuda"`` and must exist.
    A refinement runs as a public call (``PhaseTimer.call``) with the span
    ``to_quadratic``, whose seconds are in ``Problem.setup_timings``."""
    from .mesh import SOLID_TYPES
    if mesh.element_type not in SOLID_TYPES:
        raise ValueError(
            f"unsupported element type for analysis: {mesh.element_type!r} "
            f"(supported solid types: {', '.join(SOLID_TYPES)}); import a "
            "mesh whose dominant cell type is one of these")
    if interpolation_order not in (1, 2):
        raise ValueError("interpolation_order must be 1 or 2")
    setup_timings = {}
    if interpolation_order == 2:
        if mesh.element_type in ("tet4", "hex8"):
            timer = PhaseTimer()
            with timer.call("setup_problem"), span("to_quadratic"):
                mesh = mesh.to_quadratic()
            setup_timings = timer.as_dict()
        else:
            log(f"mesh is already quadratic ({mesh.element_type})")
    log(f"Setting up problem with {mesh.element_type} elements")
    log(f"Number of DOFs: {mesh.n_dofs}")
    return Problem(mesh=mesh, interpolation_order=interpolation_order,
                   dtype=dtype, mode=mode, device=device,
                   setup_timings=setup_timings)


def problem_from_numpy(state: dict, device="cuda",
                       dtype: torch.dtype = torch.float32) -> Problem:
    """A :class:`Problem` from plain NumPy state, e.g. one taken from
    another implementation so both solve the same problem.

    Keys: ``coords`` [N,3], ``conn`` [C,k], ``element_type`` (any solid
    type, quadratic ones included), ``lam`` and ``mu`` [C], ``f`` [3N],
    ``fixed_dofs`` (a list of DOF-id arrays, one per constraint), and
    optionally ``density`` [C], ``quad_order``, ``mode`` (the operator's,
    ``"otf"`` by default) and ``structured_info`` (a generated box's
    provenance, which selects the stencil multigrid route).
    """
    mesh = Mesh(state["coords"], state["conn"], state["element_type"])
    info = state.get("structured_info")
    if info is not None:
        mesh.structured_info = {
            "dims": tuple(int(d) for d in info["dims"]),
            "lo": tuple(float(v) for v in info["lo"]),
            "hi": tuple(float(v) for v in info["hi"])}
    problem = setup_problem(mesh, dtype=dtype, device=device,
                            mode=state.get("mode", "otf"))
    if state.get("quad_order") is not None:
        problem.quad_order = int(state["quad_order"])
    C = mesh.n_cells
    problem.lam = np.array(np.broadcast_to(
        np.asarray(state["lam"], np.float64), (C,)))
    problem.mu = np.array(np.broadcast_to(
        np.asarray(state["mu"], np.float64), (C,)))
    if state.get("density") is not None:
        problem.density = np.asarray(state["density"], np.float64)
    problem.f = np.array(state["f"], dtype=np.float64).reshape(-1)
    if problem.f.size != mesh.n_dofs:
        raise ValueError(f"f has {problem.f.size} entries, the mesh "
                         f"{mesh.n_dofs} DOFs")
    problem.bcs = [DirichletBC(np.unique(np.asarray(d, np.int64)))
                   for d in state.get("fixed_dofs", [])]
    return problem


# ---------------------------------------------------------------------------
# Assembly (materials onto the problem)
# ---------------------------------------------------------------------------


def assemble_stiffness_matrix(problem: Problem, lam: float, mu: float
                              ) -> Problem:
    """Uniform material (reference: FiniteElementAnalysis.jl:204-250).
    Nothing is factorized — the operator stays matrix-free."""
    problem.lam = np.full(problem.mesh.n_cells, lam, dtype=np.float64)
    problem.mu = np.full(problem.mesh.n_cells, mu, dtype=np.float64)
    log("Stiffness matrix assembled successfully")
    return problem


def assemble_stiffness_matrix_simp(problem: Problem,
                                   material_model: SIMPMaterial,
                                   density_data: np.ndarray) -> Problem:
    """SIMP-penalized material (reference:
    FiniteElementAnalysis.jl:654-707)."""
    density = np.asarray(density_data, dtype=np.float64).reshape(-1)
    if len(density) != problem.mesh.n_cells:
        raise ValueError("density length does not match number of cells")
    lam, mu = material_model.lame(density)
    problem.lam = np.asarray(lam)
    problem.mu = np.asarray(mu)
    problem.density = density
    problem.material = material_model
    log("Stiffness matrix assembled successfully with variable material "
        "properties")
    return problem


# ---------------------------------------------------------------------------
# BCs and loads
# ---------------------------------------------------------------------------


def apply_fixed_boundary(problem: Problem, nodes) -> DirichletBC:
    """reference: FiniteElementAnalysis.jl:314-333 (deferred application)."""
    bc = DirichletBC.fixed(nodes)
    problem.bcs.append(bc)
    return bc


def apply_sliding_boundary(problem: Problem, nodes,
                           fixed_components: Sequence[int]) -> DirichletBC:
    """reference: FiniteElementAnalysis.jl:356-374 (0-based components)."""
    bc = DirichletBC.sliding(nodes, fixed_components)
    problem.bcs.append(bc)
    return bc


def apply_force(problem: Problem, nodes, force_vector: Sequence[float]
                ) -> None:
    """Equal split of the total force over the nodes (reference:
    FiniteElementAnalysis.jl:392-418)."""
    nodes = np.asarray(list(nodes) if not isinstance(nodes, np.ndarray)
                       else nodes, dtype=np.int64)
    if nodes.size == 0:
        raise ValueError("No nodes provided for force application.")
    force = np.asarray(force_vector, dtype=np.float64)
    per_node = force / nodes.size
    dofs = dofs_of_nodes(nodes)                 # [n, 3]
    np.add.at(problem.f, dofs.reshape(-1),
              np.broadcast_to(per_node, (nodes.size, DIM)).reshape(-1))
    log(f"Applied force {list(force)} distributed over {nodes.size} nodes")


# ---------------------------------------------------------------------------
# Solve + post-process
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SolveResult:
    """Reference tuple (u, energy, stress_field, max_von_mises,
    max_stress_cell) plus solver telemetry."""

    u: np.ndarray                  # [ndof]
    energy: float
    stress_qp: np.ndarray          # [C, nqp, 3, 3]
    stress_avg: np.ndarray         # [C, 3, 3]
    von_mises: np.ndarray          # [C]
    max_von_mises: float
    max_stress_cell: int
    method: str
    iterations: int
    residual_norm: float
    converged: bool
    solve_time: float
    history: Optional[np.ndarray] = None
    timings: Optional[dict] = None        # per-phase seconds
    refinement_passes: int = 0            # inner solves of the fp32 route
    graph_iterations: int = 0             # of iterations, CUDA graph replays
    device_residuals: int = 0             # refinement residuals and floors
                                          # evaluated on the card

    # tuple-unpacking parity with the reference's 5-tuple return
    def __iter__(self):
        return iter((self.u, self.energy, self.stress_field,
                     self.max_von_mises, self.max_stress_cell))

    @property
    def stress_field(self):
        return self.stress_qp

    @property
    def displacements(self) -> np.ndarray:
        return self.u.reshape(-1, 3)


def _default_config() -> SolverConfig:
    # the reference's posture: a direct solve, switching to Krylov at 50k
    # dofs (FiniteElementAnalysis.jl:547, 574); method="auto" resolves by
    # ADAPTIVE_DOF_THRESHOLD
    return SolverConfig(method="auto", preconditioner="block_diagonal",
                        tolerance=1e-10, max_iterations=20000, verbose=False)


def _material_fingerprint(problem: Problem) -> tuple:
    return (problem.lam.tobytes(), problem.mu.tobytes(),
            tuple(bc.fixed_dofs.tobytes() for bc in problem.bcs),
            str(problem.dtype), str(problem.device))


def _mg_cache_root() -> Optional[str]:
    root = os.environ.get("TOPOPT_MG_CACHE_DIR",
                          os.path.join(os.getcwd(), ".topopt_mg_cache"))
    return None if root.lower() in ("0", "off", "none", "") else root


def _bell_cache_path(problem: Problem, mask) -> Optional[str]:
    """On-disk hierarchy cache location (None: caching disabled by
    ``TOPOPT_MG_CACHE_DIR=off``).  The files are this package's own format
    and carry a ``bell_torch_`` prefix, so neither package tries to load
    the other's hierarchy from a shared directory."""
    root = _mg_cache_root()
    if root is None:
        return None
    from .fem.bell import hierarchy_cache_key
    key = hierarchy_cache_key(problem.mesh, problem.lam, problem.mu, mask,
                              problem.dtype, problem.quad_order)
    return os.path.join(root, f"bell_torch_{key}.npz")


#: process-wide skeleton RAM cache (one entry, see fem/bell.py): a density
#: swap on the same mesh and BCs skips straight to the value pass
_SKEL_RAM_CACHE: dict = {}


def _skel_cache_path(problem: Problem, mask) -> Optional[str]:
    """On-disk location of the density-independent skeleton.  Opt-in
    (``TOPOPT_BELL_SKEL_DISK=1``): the skeleton is large and the RAM cache
    above serves density swaps within a process."""
    if os.environ.get("TOPOPT_BELL_SKEL_DISK", "0") != "1":
        return None
    root = _mg_cache_root()
    if root is None:
        return None
    from .fem.bell import skeleton_cache_key
    key = skeleton_cache_key(problem.mesh, mask, problem.quad_order)
    return os.path.join(root, f"bellskel_torch_{key}.npz")


def _get_bell_multigrid(problem: Problem, mask):
    """Block-ELL hierarchy for a general mesh, with .npz persistence keyed
    by mesh, material and BCs, and the skeleton cache keyed by mesh and
    BCs only (density swaps re-pay values, not the mesh work)."""
    from .fem.bell import (build_bell_multigrid, load_hierarchy,
                           save_hierarchy)
    t0 = time.perf_counter()
    path = _bell_cache_path(problem, mask)
    if path is not None and os.path.exists(path):
        try:
            system, mg, info = load_hierarchy(path, problem.dtype,
                                              device=problem.device)
            info["load_seconds"] = round(time.perf_counter() - t0, 3)
            log(f"multigrid hierarchy loaded from cache "
                f"({info['load_seconds']}s): {path}")
            return system, mg, info
        except (OSError, ValueError, KeyError) as e:   # stale/corrupt cache
            print_warning(f"hierarchy cache load failed ({e}); rebuilding")
    system, mg, info = build_bell_multigrid(
        problem.mesh, problem.lam, problem.mu, free_mask=mask,
        dtype=problem.dtype, order=problem.quad_order,
        skeleton_path=_skel_cache_path(problem, mask),
        skeleton_cache=_SKEL_RAM_CACHE, device=problem.device)
    info["cached"] = False
    if path is not None:
        try:
            t_s = time.perf_counter()
            save_hierarchy(path, info)
            info["save_seconds"] = round(time.perf_counter() - t_s, 3)
            log(f"multigrid hierarchy cached to {path} "
                f"({info['save_seconds']}s)")
        except OSError as e:
            print_warning(f"hierarchy cache save failed: {e}")
    # the host arrays exist for save_hierarchy only
    info.pop("host_arrays", None)
    return system, mg, info


def _get_multigrid(problem: Problem):
    """(op, mg) for preconditioner='multigrid', cached per material+BCs.

    Generated structured tet4 boxes (mesh.structured_info) with a per-hex
    constant material ride the stencil hierarchy (fem/structured.py,
    fem/multigrid.py).  Anything else (imported meshes, hex8, a material
    that varies inside a hex, dims that do not coarsen 2:1) gets the
    block-ELL hierarchy (fem/bell.py), whose operator is a
    :class:`.fem.bell.BellSystem` on component-major vectors.
    ``TOPOPT_MG=galerkin`` forces the voxel-probing Galerkin hierarchy
    (fem/multigrid.build_unstructured_multigrid) for those meshes instead;
    its operator is the matrix-free fine :class:`StiffnessOperator`."""
    key = _material_fingerprint(problem)
    cached = problem._mg_cache
    if cached is not None and cached[0] == key:
        return cached[1], cached[2]

    from .fem.multigrid import (build_structured_multigrid,
                                build_unstructured_multigrid)
    mesh = problem.mesh
    mask = free_mask_from_bcs(problem.n_dofs, problem.bcs)
    info = mesh.structured_info
    op = mg = None
    if info is not None and mesh.element_type == "tet4":
        nx, ny, nz = info["dims"]
        lam_e = np.broadcast_to(problem.lam, (mesh.n_cells,))
        mu_e = np.broadcast_to(problem.mu, (mesh.n_cells,))
        # per-hex-constant material (uniform or SIMP on the hex grid)?
        mu_h = mu_e.reshape(-1, 6)
        per_hex = (np.ptp(mu_h, axis=1).max() == 0
                   and np.ptp((lam_e / np.maximum(mu_e, 1e-300))) < 1e-12)
        if per_hex:
            iref = int(np.argmax(mu_e))
            lam0, mu0 = float(lam_e[iref]), float(mu_e[iref])
            # hex order from grid._hex_conn is x-major (ix slowest);
            # the stencil operator wants a z-major [nz, ny, nx] grid
            esc = (mu_h[:, 0] / mu0).reshape(nx, ny, nz).transpose(2, 1, 0)
            if np.all(esc == 1.0):
                esc = None
            try:
                _, op, mg = build_structured_multigrid(
                    nx, ny, nz, info["lo"], info["hi"], lam0, mu0,
                    free_mask=mask, escale=esc, dtype=problem.dtype,
                    device=problem.device)
            except ValueError:      # e.g. odd dims: no 2:1 coarsening
                op = mg = None
    if op is None:
        if os.environ.get("TOPOPT_MG", "bell").lower() == "galerkin":
            info = {"route": "galerkin"}
            op, mg = build_unstructured_multigrid(
                mesh, problem.lam, problem.mu, free_mask=mask,
                dtype=problem.dtype, device=problem.device, info=info)
            problem._mg_build_info = info
        else:
            op, mg, problem._mg_build_info = _get_bell_multigrid(problem,
                                                                 mask)
    problem._mg_cache = (key, op, mg)
    return op, mg


def _norm(v) -> float:
    """Euclidean norm of a tensor or a sharded slab vector."""
    return (float(torch.linalg.vector_norm(v))
            if isinstance(v, torch.Tensor) else v.norm())


def _backward_error(op, f_dev: torch.Tensor, u: torch.Tensor):
    """Normwise backward error eta = ||f-Au|| / (||A||·||u|| + ||f||) with
    a fresh matvec and an 8-step power estimate of ||A||_2.

    Returns (eta, fnorm_fraction) where fnorm_fraction =
    ||f|| / (||A||·||u|| + ||f||), which folds the requested Krylov
    tolerance into the acceptance threshold."""
    true_r = _norm(f_dev - op.matvec(u))
    unorm = _norm(u)
    fnorm = _norm(f_dev)
    if unorm == 0:
        return (0.0 if true_r == 0 else 1.0), 1.0
    v = u / unorm
    lam_max = 1.0
    for _ in range(8):
        w = op.matvec(v)
        lam_max = _norm(w)
        v = w / max(lam_max, 1e-300)
    denom = lam_max * unorm + fnorm
    return true_r / denom, fnorm / denom


class _HostRefineSystem:
    """Exact fp64 host twin of the masked operator — the residual oracle
    for mixed-precision refinement on the fp32 routes."""

    def __init__(self, problem: Problem):
        t0 = time.perf_counter()
        mask_np = free_mask_from_bcs(problem.n_dofs, problem.bcs)
        C = problem.mesh.n_cells
        self._host = HostFineOperator(
            problem.mesh,
            np.broadcast_to(np.asarray(problem.lam, np.float64), (C,)),
            np.broadcast_to(np.asarray(problem.mu, np.float64), (C,)),
            mask_np, problem.quad_order)
        self.mask = mask_np
        self.n = problem.n_dofs
        #: host seconds: the geometry tables, and the residual matvecs
        #: (the first of which also builds the Ke batch)
        self.build_seconds = time.perf_counter() - t0
        self.matvec_seconds = 0.0

    def matvec64(self, x64: np.ndarray) -> np.ndarray:
        t0 = time.perf_counter()
        y = self._host.matvec64(np.asarray(x64)[:self.n])
        self.matvec_seconds += time.perf_counter() - t0
        return y


def _residual64(system, f64, x64):
    """The refinement's true residual f - A x and its norm: the system's
    own ``residual64`` where it has one (float64 tensors on the card),
    else from its exact float64 host ``matvec64``."""
    own = getattr(system, "residual64", None)
    if own is not None:
        return own(f64, x64)
    r64 = f64 - system.matvec64(x64)
    return r64, float(np.linalg.norm(r64))


def _refined_generic(system, inner, f64, tol, maxiter, device, x0_64=None,
                     record_history=False, max_passes=6,
                     dtype=torch.float32):
    """Mixed-precision iterative refinement around an fp32 inner solve.

    Each pass evaluates the TRUE residual in float64 (:func:`_residual64`),
    rescales it to unit norm and calls
    ``inner(rhs_dev, iters_left, tol_inner) -> (x_dev, niter, history)``
    for the correction.  The inner tolerance aims just below what would
    finish this pass (0.3*eps/rn), clipped to [1e-7, 1e-4].

    The refinement stops at the tolerance, at the iteration budget, or,
    after ``max_passes`` passes, at the first pass that does not cut the
    true residual ``_REFINE_MIN_GAIN`` times.  A refinement stalled so is
    converged where its residual is down to the float64 rounding floor of
    the operator applied to its iterate (``system.residual_floor64``),
    about the least a float64 iterate reaches: on a slender SIMP part
    under its own weight that floor lies above the tolerance.
    The vectors (``f64``, ``x0_64``, the returned ``x64``) are float64
    NumPy arrays, or float64 tensors on the system's device where its
    residual runs there: the iterate and its corrections then stay on the
    device.
    Returns (x64, total_iters, true_rnorm, converged, history, passes),
    ``passes`` being the number of inner solves.
    """
    on_device = isinstance(f64, torch.Tensor)
    rn0 = _norm(f64) if on_device else float(np.linalg.norm(f64))
    eps = tol + tol * rn0
    if x0_64 is not None:
        x64 = x0_64 if on_device else np.asarray(x0_64, np.float64)
    else:
        x64 = torch.zeros_like(f64) if on_device else np.zeros_like(f64)
    total = 0
    passes = 0
    hists = []
    rn_prev = np.inf
    converged = False
    for p in itertools.count():
        with span("refine/residual"):
            r64, rn = ((f64, rn0) if (p == 0 and x0_64 is None)
                       else _residual64(system, f64, x64))
        if rn <= eps:
            converged = True
            break
        if total >= maxiter:
            break
        if p >= max_passes and rn * _REFINE_MIN_GAIN > rn_prev:
            floor = getattr(system, "residual_floor64", None)
            if floor is not None:
                with span("refine/floor"):
                    converged = rn <= floor(x64)
                log(f"  Refinement stalled at {rn:.6e}: "
                    f"{'at' if converged else 'above'} the float64 floor")
            break
        log(f"  Refinement pass {p}: true residual = {rn:.6e}")
        rn_prev = s = rn
        with span("refine/transfer"):
            rhs = torch.as_tensor(r64 / s, dtype=dtype, device=device)
        tol_inner = float(np.clip(0.3 * eps / rn, _REFINE_INNER_FLOOR, 1e-4))
        x_dev, n_it, hist = inner(rhs, maxiter - total, tol_inner)
        passes += 1
        if n_it == 0:
            break
        with span("refine/transfer"):
            dx = x_dev.double()
            x64 = x64 + s * (dx if on_device else dx.cpu().numpy())
        total += n_it
        if record_history and hist is not None:
            h = np.asarray(hist)[: n_it + 1] * s
            hists.append(h if not hists else h[1:])
    history = (np.concatenate(hists)
               if record_history and hists else None)
    return x64, total, rn, converged, history, passes


def _build_preconditioner(op, config: SolverConfig):
    name = config.preconditioner
    if name == "none":
        return None
    if name == "diagonal":
        return jacobi_preconditioner(op.diagonal())
    # block_diagonal is the strongest mesh-free option; the reference's
    # ilu/ichol fall back to diagonal anyway (RobustSolver.jl:239-264)
    if name in ("block_diagonal", "ilu", "ichol"):
        return block_jacobi_preconditioner(op.node_blocks_raw(),
                                           op.free_mask)
    if name == "multigrid":
        # the V-cycle needs the problem mesh; solve_system takes the cg
        # route to it before reaching here, so the other Krylov methods
        # degrade to the strongest mesh-free option
        print_warning("multigrid preconditioning is only wired to the CG "
                      "path; using block-diagonal instead")
        return block_jacobi_preconditioner(op.node_blocks_raw(),
                                           op.free_mask)
    raise ValueError(f"unknown preconditioner {name!r}")


def _bell_hierarchy(problem: Problem, mask):
    """The block-ELL hierarchy of the problem: the in-process one of its
    last single-device multigrid solve where that is a block-ELL build of
    this material, else through :func:`_get_bell_multigrid` (its caches)."""
    from .fem.bell import BellSystem
    cached = problem._mg_cache
    if (cached is not None and cached[0] == _material_fingerprint(problem)
            and isinstance(cached[1], BellSystem)
            and cached[1].fine_transfer is not None):
        return cached[1], cached[2], problem._mg_build_info
    return _get_bell_multigrid(problem, mask)


class _Relayout:
    """A block-ELL system's exact float64 host matvec in the public
    interleaved layout (the refinement's residual oracle)."""

    def __init__(self, system):
        self.system = system

    def matvec64(self, x64: np.ndarray) -> np.ndarray:
        s = self.system
        return s.to_il(s.matvec64(s.to_cm(x64)))

    def residual_floor64(self, x64: np.ndarray) -> float:
        s = self.system
        return s.residual_floor64(s.to_cm(x64))


def _device_mesh(problem: Problem, devices, data_parallel: int = 1):
    """``devices`` (an int, a list of devices or a ``DeviceMesh``) as a
    ``parallel.DeviceMesh``: an int is that many visible cards for a
    problem on the card, that many shards on the CPU for one on the CPU."""
    from .parallel.sharding import DeviceMesh, build_device_mesh

    if isinstance(devices, DeviceMesh):
        return devices
    if isinstance(devices, int):
        if problem.device.type == "cuda":
            return build_device_mesh(devices, data_parallel=data_parallel)
        devices = [problem.device] * devices
    return build_device_mesh(devices=list(devices),
                             data_parallel=data_parallel)


def _solve_system_sharded(problem: Problem, config: SolverConfig, devices,
                          timer: PhaseTimer,
                          x0: Optional[np.ndarray] = None) -> SolveResult:
    """Multi-device PCG: DOF vectors are node-partitioned slabs over the
    ``elem`` axis, the operator is the halo-exchange sharded matvec
    (parallel/halo.py) and the multigrid preconditioner runs its fine
    level sharded with replicated coarse levels (parallel/halo_mg.py).
    One process drives every shard.  float32 solves that need it run
    inside the float64-certified refinement of the single-device routes."""
    from .parallel.halo import HaloShardedOperator
    from .parallel.halo_mg import build_halo_multigrid

    if config.method not in ("cg", "auto"):
        raise ValueError(
            f"sharded solve supports method='cg' (got {config.method!r})")
    dev_mesh = _device_mesh(problem, devices)

    n = problem.n_dofs
    dtype = problem.dtype
    mask = free_mask_from_bcs(n, problem.bcs)
    use_mg = config.preconditioner == "multigrid"
    system = None
    with timer.phase("build_operator"):
        if use_mg:
            with timer.phase("hierarchy"):
                hierarchy = _bell_hierarchy(problem, mask)
            with timer.phase("halo"):
                hop, M, system = build_halo_multigrid(
                    problem.mesh, problem.lam, problem.mu, dev_mesh,
                    free_mask=mask, dtype=dtype, order=problem.quad_order,
                    hierarchy=hierarchy)
        else:
            hop = HaloShardedOperator.build(
                problem.mesh, problem.lam, problem.mu, dev_mesh,
                free_mask=mask, dtype=dtype, order=problem.quad_order)
            M = hop.block_jacobi()

    f64 = np.asarray(problem.f, np.float64)[:n] * mask
    x0_64 = None if x0 is None else np.asarray(x0, np.float64)[:n] * mask
    log(f"Solving linear system (sharded over "
        f"{dev_mesh.shape['elem']} devices)...")
    history = None
    passes = 0
    with timer.phase("solve") as solve_phase:
        if dtype == torch.float32 and (use_mg or config.tolerance < 1e-6):
            # float32 sharded PCG inner solves inside the float64-certified
            # refinement: the multigrid route's residuals from the
            # block-ELL system's host twin (as on one device), the others
            # from the exact host twin of the operator
            refine = (_Relayout(system) if use_mg
                      else _HostRefineSystem(problem))

            def _inner(rhs, left, tol_inner):
                with span("krylov"):
                    r = cg(hop, hop.to_local(rhs.numpy()) * hop.free_mask,
                           M=M, tol=tol_inner, maxiter=left,
                           record_history=config.history)
                return (torch.from_numpy(hop.from_local(r.x)), r.niter,
                        r.history)

            u64, niter, rnorm, conv, history, passes = _refined_generic(
                refine, _inner, f64, config.tolerance,
                config.max_iterations, torch.device("cpu"), x0_64=x0_64,
                record_history=config.history, dtype=dtype)
            _record_refine(timer, system if use_mg else refine)
        else:
            f_slab = hop.to_local(f64) * hop.free_mask
            x0_slab = (None if x0_64 is None
                       else hop.to_local(x0_64) * hop.free_mask)
            with span("krylov"):
                res = cg(hop, f_slab, x0=x0_slab, M=M, tol=config.tolerance,
                         maxiter=config.max_iterations,
                         record_history=config.history)
            niter, rnorm, conv = res.niter, res.residual_norm, res.converged
            history = res.history
            if conv:
                # the backward-error gate of the single-device routes
                with span("verify"):
                    eta, ffrac = _backward_error(hop, f_slab, res.x)
                eps_dt = float(torch.finfo(dtype).eps)
                if eta > 100.0 * eps_dt + 100.0 * config.tolerance * ffrac:
                    print_warning(f"sharded solution FAILED backward-error "
                                  f"verification (eta={eta:.2e})")
                    conv = False
            u64 = hop.from_local(res.x)
    solve_time = solve_phase.seconds
    energy = 0.5 * float(u64 @ f64)
    method = "cg(multigrid,sharded)" if use_mg else "cg(sharded)"
    if config.verbose:
        from .fem.robust import print_convergence_report
        print_convergence_report(config, method, niter, rnorm, conv,
                                 history)
    elif not conv:
        print_warning(
            f"Sharded solver did not converge after {niter} iterations "
            f"(residual {rnorm:.3e}, target {config.tolerance:.1e})")
    u = torch.as_tensor(u64, dtype=dtype, device=problem.device)
    return _finish_result(problem, u, energy, method, niter, rnorm, conv,
                          solve_time, history, timer, u64=u64,
                          refinement_passes=passes)


def _record_refine(timer: PhaseTimer, system) -> None:
    """The refinement's residual seconds, cumulative over the system's
    solves: ``refine_host_build_seconds`` its oracle's set-up,
    ``refine_host_matvec_seconds`` its residual and floor evaluations.
    On the host twins these are host seconds; on the card
    (:class:`.fem.bell.BellResidual64`) the wall seconds of the
    evaluations, the norm's read-back included."""
    for name in ("build_seconds", "matvec_seconds"):
        timer.records[f"refine_host_{name}"] = PhaseRecord(
            f"refine_host_{name}", getattr(system, name))


def solve_system(problem: Problem,
                 config: Optional[SolverConfig] = None,
                 x0: Optional[np.ndarray] = None,
                 devices=None) -> SolveResult:
    """Solve K u = f with the accumulated constraints, then recover energy
    and stresses (reference: FiniteElementAnalysis.jl:538-561, 831-862).
    ``x0`` warm-starts the Krylov iteration.

    ``devices`` shards the solve: an int shard count (the visible cards,
    or that many shards on the CPU for a problem there), a list of devices
    (a repeated device holds several shards) or a
    :class:`.parallel.sharding.DeviceMesh`.  DOF vectors are
    node-partitioned slabs, the operator the halo-exchange sharded matvec
    and the multigrid V-cycle runs its fine level sharded with replicated
    coarse levels; one process drives every shard.

    ``SolveResult.timings`` holds the host seconds of each phase and span
    of the call by its path (``build_operator``, ``solve``,
    ``solve/krylov``, ``solve/krylov/iter/vcycle/L0``, ``postprocess``,
    ...; README.md lists them); under ``torch.profiler`` each span is also
    a range of that name, inside a range ``solve_system`` that carries the
    call's number."""
    timer = PhaseTimer()
    with timer.call("solve_system"):
        return _solve_system(problem, config or _default_config(), x0,
                             devices, timer)


def _solve_system(problem: Problem, config: SolverConfig, x0, devices,
                  timer: PhaseTimer) -> SolveResult:
    if devices is not None:
        return _solve_system_sharded(problem, config, devices, timer, x0=x0)
    method = config.method
    if method == "auto":
        method = ("direct" if problem.n_dofs < ADAPTIVE_DOF_THRESHOLD
                  else "cg")

    M_mg = None
    with timer.phase("build_operator"):
        if config.preconditioner == "multigrid" and method == "cg":
            op, M_mg = _get_multigrid(problem)
        else:
            op = problem.build_operator(with_bc=True)
    n = problem.n_dofs
    dtype, device = problem.dtype, problem.device
    # the block-ELL operator (fem/bell.py) works on RCM-permuted
    # component-major vectors; to_cm / to_il convert at the boundary
    is_cm = getattr(op, "layout", None) == "cm"
    f_host = op.to_cm(problem.f) if is_cm else problem.f
    f_dev = torch.as_tensor(f_host, dtype=dtype, device=device) * op.free_mask

    # fp32 cannot reach fp64-grade residuals on its own: a tolerance below
    # 1e-6 routes the solve through mixed-precision refinement whose OUTER
    # criterion is an exact fp64 host matvec.  The block-ELL route refines
    # every float32 solve, as the JAX package does: its fp64 scipy twin is
    # already built and cheap to apply
    want_refine = (method != "direct" and dtype == torch.float32
                   and (is_cm or config.tolerance < 1e-6))

    log("Solving linear system...")
    history = None
    energy64 = None         # fp64 energy from the refined route
    u64 = None              # fp64 displacements from the refined route
    passes = 0              # inner solves of the refined route
    graph_its = 0           # iterations run as CUDA graph replays (cg)
    device_res = 0          # the refined route's evaluations on the card

    def _host_direct():
        """fp64 host sparse LU with the problem's own f and BCs."""
        mask_np = free_mask_from_bcs(n, problem.bcs)
        K = assemble_scipy(problem.mesh, problem.lam, problem.mu,
                           order=problem.quad_order, free_mask=mask_np)
        u_np = direct_solve(K, np.asarray(problem.f)[:n] * mask_np)
        return torch.as_tensor(u_np, dtype=dtype, device=device)

    with timer.phase("solve") as solve_phase:
        if method == "direct":
            u = _host_direct()
            niter, rnorm, conv = 1, 0.0, True
        elif method == "cg" and (M_mg is not None or not config.verbose):
            # plain PCG without the robust ladder's bookkeeping; multigrid
            # takes this path whatever ``verbose`` says
            M = M_mg if M_mg is not None else _build_preconditioner(op, config)
            if want_refine:
                # on the card the block-ELL route's residuals run by B4 in
                # float64 over the fine values' copy and the refinement's
                # vectors stay there; elsewhere the exact float64 host twins
                on_card = is_cm and device.type == "cuda"
                if is_cm:
                    system = op.device_residual() if on_card else op
                    mask64 = op.free_mask.double().cpu().numpy()
                    f64 = op.to_cm(problem.f) * mask64
                    x0_64 = (None if x0 is None
                             else op.to_cm(np.asarray(x0)[:n]) * mask64)
                else:
                    system = _HostRefineSystem(problem)
                    f64 = np.asarray(problem.f, np.float64)[:n] * system.mask
                    x0_64 = None
                    if x0 is not None:
                        x0_64 = np.asarray(x0, np.float64)[:n] * system.mask

                def _inner(rhs, left, tol_inner):
                    nonlocal graph_its
                    with span("krylov"):
                        r = cg(op, rhs, M=M, tol=tol_inner, maxiter=left,
                               record_history=config.history)
                    graph_its += r.graph_iters
                    return r.x, r.niter, r.history

                f_ref, x0_ref = f64, x0_64
                if on_card:
                    evaluated = system.evaluations
                    f_ref = torch.as_tensor(f64, device=device)
                    if x0_64 is not None:
                        x0_ref = torch.as_tensor(x0_64, device=device)
                x_ref, niter, rnorm, conv, history, passes = \
                    _refined_generic(
                        system, _inner, f_ref, config.tolerance,
                        config.max_iterations, device, x0_64=x0_ref,
                        record_history=config.history, dtype=dtype)
                if on_card:
                    device_res = system.evaluations - evaluated
                    u64 = x_ref.cpu().numpy()
                    u = x_ref.to(dtype)
                else:
                    u64 = x_ref
                    u = torch.as_tensor(u64, dtype=dtype, device=device)
                energy64 = 0.5 * float(u64 @ f64)
                _record_refine(timer, system)
            else:
                x0_dev = None
                if x0 is not None:
                    x0_h = np.asarray(x0)[:n]
                    x0_dev = torch.as_tensor(
                        op.to_cm(x0_h) if is_cm else x0_h, dtype=dtype,
                        device=device) * op.free_mask
                with span("krylov"):
                    res = cg(op, f_dev, x0=x0_dev, M=M, tol=config.tolerance,
                             maxiter=config.max_iterations,
                             record_history=config.history)
                u, niter, rnorm, conv = (res.x, res.niter, res.residual_norm,
                                         res.converged)
                history = res.history
                graph_its = res.graph_iters
            if config.verbose:
                from .fem.robust import print_convergence_report
                print_convergence_report(config, "cg(multigrid)", niter, rnorm,
                                         conv, history)
            elif not conv:
                print_warning(
                    f"Krylov solver did not converge after {niter} iterations "
                    f"(residual {rnorm:.3e}, target {config.tolerance:.1e})")
        else:
            # the robust ladder (fem/robust.py): the chosen method, plain CG
            # at 10x the tolerance, then the host direct solve
            from .fem.robust import _DirectFallback, solve_with_krylov
            try:
                if want_refine:
                    # the ladder's inner solves inside the same float64-
                    # certified refinement as the plain route
                    system = _HostRefineSystem(problem)
                    f64 = np.asarray(problem.f, np.float64)[:n] * system.mask
                    meths = []

                    def _inner(rhs, left, tol_inner):
                        cfg = dataclasses.replace(
                            config, tolerance=tol_inner, max_iterations=left)
                        with span("krylov"):
                            ui, ni, _rn, _cv, hist, m_ = solve_with_krylov(
                                op, rhs, method, cfg)
                        meths.append(m_)
                        return ui, ni, hist

                    u64, niter, rnorm, conv, history, passes = \
                        _refined_generic(
                            system, _inner, f64, config.tolerance,
                            config.max_iterations, device,
                            record_history=config.history, dtype=dtype)
                    u = torch.as_tensor(u64, dtype=dtype, device=device)
                    energy64 = 0.5 * float(u64 @ f64)
                    method = (meths[-1] if meths else method) + "+refine"
                    _record_refine(timer, system)
                else:
                    with span("krylov"):
                        u, niter, rnorm, conv, history, method = \
                            solve_with_krylov(op, f_dev, method, config)
            except _DirectFallback:
                u = _host_direct()
                niter, rnorm, conv, method = 1, 0.0, True, "direct(fallback)"
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    solve_time = solve_phase.seconds

    if conv and not method.startswith("direct"):
        # backward-error verification with FRESH matvecs: the recurrence
        # residual can look converged while the iterate is wrong; the
        # normwise backward error catches that while tolerating the dtype's
        # attainable-accuracy floor and the requested Krylov tolerance
        with timer.phase("verify"):
            eta, ffrac = _backward_error(op, f_dev, u)
        eps_dt = float(torch.finfo(dtype).eps)
        eta_max = 100.0 * eps_dt + 100.0 * config.tolerance * ffrac
        if eta > eta_max:
            print_warning(
                f"solution FAILED backward-error verification "
                f"(eta={eta:.2e} > {eta_max:.1e})")
            if n < DIRECT_LAST_RESORT_DOFS:
                print_warning("falling back to host direct solve")
                u = _host_direct()
                niter, rnorm, conv, graph_its = 1, 0.0, True, 0
                method = "direct(verification-fallback)"
                # the direct solve is interleaved, and ``op`` may be the
                # component-major block-ELL system: the energy and the
                # stresses come from the direct route's own operator
                op = problem.build_operator(with_bc=True)
                is_cm = False
                energy64 = None
                u64 = None
                history = None
            else:
                conv = False

    # the refined route's fp64 energy (0.5 u.f with exact residual
    # control) supersedes the working-dtype device evaluation
    energy = energy64 if energy64 is not None else float(op.energy(u))
    if is_cm:
        # back to the public interleaved DOF layout for stresses and export
        # (the working-dtype u is the float64 one rounded: one relayout)
        with timer.phase("relayout"):
            if u64 is not None:
                u64 = op.to_il(u64)
                u = torch.as_tensor(u64, dtype=dtype, device=device)
            else:
                u = torch.as_tensor(op.to_il(u.cpu().numpy()), dtype=dtype,
                                    device=device)
    return _finish_result(problem, u, energy, method, niter, rnorm, conv,
                          solve_time, history, timer,
                          dmesh=getattr(op, "dmesh", None), u64=u64,
                          refinement_passes=passes, graph_iterations=graph_its,
                          device_residuals=device_res)


def _finish_result(problem: Problem, u, energy: float, method: str,
                   niter: int, rnorm: float, conv: bool,
                   solve_time: float, history, timer: PhaseTimer,
                   dmesh=None, u64=None, refinement_passes=0,
                   graph_iterations=0, device_residuals=0) -> SolveResult:
    """Post-solve tail: stress recovery + SolveResult assembly.  ``u64``
    holds the refined route's fp64-certified displacements, which the
    result keeps instead of their working-dtype copy.  ``dmesh`` is the
    operator's device mesh; the stencil operator has none, and the
    stresses then gather through a fresh one."""
    with timer.phase("postprocess"):
        if dmesh is None:
            dmesh = problem.mesh.device(dtype=problem.dtype,
                                        device=problem.device)
        lam_e = torch.as_tensor(problem.lam, dtype=problem.dtype,
                                device=problem.device)
        mu_e = torch.as_tensor(problem.mu, dtype=problem.dtype,
                               device=problem.device)
        sigma_qp, avg, vm, max_vm, max_cell = stress_summary(
            dmesh, u, lam_e, mu_e, problem.quad_order)

    with timer.phase("download"):
        u_pub = u64 if u64 is not None else u.cpu().numpy()
        sigma_qp, avg, vm = (t.cpu().numpy() for t in (sigma_qp, avg, vm))
        max_vm, max_cell = float(max_vm), int(max_cell)
    log("Analysis complete")
    log(f"Deformation energy: {energy} J")
    log(f"Maximum von Mises stress: {max_vm} at cell {max_cell}")

    return SolveResult(
        u=np.asarray(u_pub)[: problem.n_dofs], energy=energy,
        stress_qp=sigma_qp, stress_avg=avg, von_mises=vm,
        max_von_mises=max_vm, max_stress_cell=max_cell,
        method=method, iterations=niter, residual_norm=rnorm,
        converged=conv, solve_time=solve_time, history=history,
        timings=timer.as_dict(), refinement_passes=refinement_passes,
        graph_iterations=graph_iterations, device_residuals=device_residuals)


# SIMP variant shares the implementation; the material was captured at
# assembly time (reference keeps separate solve_system_simp,
# FiniteElementAnalysis.jl:831-862)
solve_system_simp = solve_system


def solve_system_adaptive(problem: Problem) -> SolveResult:
    """Size-based direct/iterative switch (reference:
    FiniteElementAnalysis.jl:570-598).

    Below 50,000 DOFs the default solve (a direct solve); above, multigrid
    PCG with the reference's large-problem settings (``adaptive_config``).
    The JAX package sends non-solid meshes to the robust ladder instead;
    a :class:`Problem` here always holds a solid mesh (``setup_problem``
    refuses others)."""
    n = problem.n_dofs
    if n < ADAPTIVE_DOF_THRESHOLD:
        return solve_system(problem)
    return solve_system(problem, dataclasses.replace(
        adaptive_config(n), method="cg", preconditioner="multigrid"))


def solve_system_robust(problem: Problem,
                        config: Optional[SolverConfig] = None
                        ) -> SolveResult:
    """Robust solve: property probe, automatic method selection,
    pre-solve diagnostics, then the Krylov fallback ladder (reference:
    RobustSolver.jl:530-621).  Uniform and SIMP materials alike (the
    reference's solve_system_robust_simp, RobustSolver.jl:645-734, is the
    same flow with the assembled SIMP material)."""
    from .fem.robust import (check_operator_properties,
                             print_presolve_diagnostics,
                             select_solver_method)
    config = config or SolverConfig()
    op = problem.build_operator(with_bc=True)
    props = check_operator_properties(op)
    method = select_solver_method(op, config, props)
    print_presolve_diagnostics(op, config, method,
                               simp=problem.material is not None,
                               problem=problem)
    del op
    result = solve_system(problem, dataclasses.replace(config,
                                                       method=method))
    if config.verbose:
        log(f"\nSolve time: {result.solve_time:.2f} seconds")
        log(f"Solution vector norm: {np.linalg.norm(result.u)}")
        log("\n" + "=" * 60)
        tag = " (SIMP)" if problem.material is not None else ""
        log(f"FINAL ANALYSIS RESULTS{tag}")
        log("=" * 60)
        log(f"Deformation energy: {result.energy:.6f} J")
        log(f"Maximum von Mises stress: {result.max_von_mises:.2f} Pa")
        log(f"Max stress location: cell {result.max_stress_cell}")
        log("=" * 60)
    return result


solve_system_robust_simp = solve_system_robust


# ---------------------------------------------------------------------------
# Result persistence
# ---------------------------------------------------------------------------


def save_result(result: SolveResult, path: str) -> str:
    """Save a SolveResult to a compressed .npz archive."""
    if not path.endswith(".npz"):
        path += ".npz"
    np.savez_compressed(
        path, u=result.u, energy=result.energy,
        stress_qp=result.stress_qp, von_mises=result.von_mises,
        max_von_mises=result.max_von_mises,
        max_stress_cell=result.max_stress_cell,
        method=result.method, iterations=result.iterations,
        residual_norm=result.residual_norm, converged=result.converged,
        solve_time=result.solve_time,
        history=(result.history if result.history is not None
                 else np.zeros(0)))
    return path


def load_result(path: str) -> SolveResult:
    z = np.load(path, allow_pickle=False)
    hist = z["history"]
    return SolveResult(
        u=z["u"], energy=float(z["energy"]), stress_qp=z["stress_qp"],
        stress_avg=z["stress_qp"].mean(axis=1),
        von_mises=z["von_mises"],
        max_von_mises=float(z["max_von_mises"]),
        max_stress_cell=int(z["max_stress_cell"]),
        method=str(z["method"]), iterations=int(z["iterations"]),
        residual_norm=float(z["residual_norm"]),
        converged=bool(z["converged"]), solve_time=float(z["solve_time"]),
        history=hist if hist.size else None)


# ---------------------------------------------------------------------------
# Batched design evaluation (BASELINE.md config 5)
# ---------------------------------------------------------------------------


def evaluate_design_batch(problem: Problem, densities: np.ndarray,
                          load_cases: Optional[np.ndarray] = None,
                          material: Optional[SIMPMaterial] = None,
                          tol: float = 1e-6, maxiter: int = 5000,
                          dtype=None, lane_chunk: Optional[int] = None,
                          devices=None):
    """Compliance energies for a density batch × load cases on the
    problem's device, every (density, load) pair one block-Jacobi PCG lane
    sharing the mesh's element geometry (parallel/sweep.py).

    Parameters
    ----------
    densities : [B, C] density fields
    load_cases : [L, ndof] load vectors (defaults to the problem's f)
    material : SIMP material (defaults to the problem's, else E(rho)=rho)
    lane_chunk : densities a call at a time through the einsum form of
        the operator; None (the default) runs the (density, load) pairs
        through the GEMM form, as many at once as half the device's free
        memory holds.  Both give the same energies.
    devices : None (the default) runs on the problem's device; an int
        (that many visible cards, or that many CPU shards for a problem
        on the CPU) or a list of devices splits the densities (each
        chunk's, on the einsum form) over them
        (``parallel/sweep.shard_sweep_inputs``), each device running its
        part at the same time, one host thread a device
        (``parallel/sweep.run_on_devices``).  On a host of four H100s,
        BASELINE config 5 ran slower split over the four cards than on
        one (PERF.md), so one device is the default.

    Returns
    -------
    energies [B, L], iterations [B, L], converged [B, L] (a lane that did
    not converge is flagged, and a warning names how many)

    Under ``torch.profiler`` the call is a range ``evaluate_design_batch``
    carrying the call's number, with spans ``sweep/prepare``,
    ``sweep/kernel_build``, ``sweep/upload`` (the lanes' inputs to the
    device), ``sweep/pcg`` (its ``iter`` and ``sync``) and
    ``sweep/energy`` inside; jobs on worker threads (several cards) time
    nothing.
    """
    timer = PhaseTimer()
    with timer.call("evaluate_design_batch"), timer.phase("sweep"):
        return _evaluate_design_batch(problem, densities, load_cases,
                                      material, tol, maxiter, dtype,
                                      lane_chunk, devices)


def _evaluate_design_batch(problem, densities, load_cases, material, tol,
                           maxiter, dtype, lane_chunk, devices):
    from .parallel import sweep as sweep_mod
    from .parallel.sweep import (SweepKernel, sweep_all_pairs,
                                 sweep_compliance)

    material = material or problem.material
    mask = free_mask_from_bcs(problem.n_dofs, problem.bcs)
    dtype = dtype or problem.dtype
    if material is not None:
        nu = material.nu
    elif problem.lam is not None:
        # nu from the assembled Lame parameters; the kernel shares one nu
        # across elements, so a mixed-nu assembly is rejected
        lam_e = np.broadcast_to(problem.lam, (problem.mesh.n_cells,))
        mu_e = np.broadcast_to(problem.mu, (problem.mesh.n_cells,))
        nus = lam_e / (2.0 * (lam_e + mu_e))
        if np.ptp(nus) > 1e-12:
            raise ValueError(
                "evaluate_design_batch needs a single Poisson ratio; the "
                "assembled material has per-element nu variation — pass "
                "material= explicitly")
        nu = float(nus[0])
    else:
        raise RuntimeError("assemble a material or pass material= before "
                           "evaluate_design_batch")
    with span("prepare"):
        dens = np.asarray(densities, np.float64)
        esc = np.asarray(material.youngs_modulus(dens)
                         if material is not None else dens)
        loads = np.asarray(problem.f[None] if load_cases is None
                           else load_cases, np.float64)
    B, L = esc.shape[0], loads.shape[0]
    pairs = lane_chunk is None
    dev_mesh = None
    if devices is None:
        devices = [problem.device]
    else:
        n_dev = devices if isinstance(devices, int) else len(devices)
        dev_mesh = _device_mesh(problem, devices, data_parallel=n_dev)
        devices = dev_mesh.data_devices
    with span("kernel_build"):
        kernels = {d: SweepKernel.build(problem.mesh, nu, mask, dtype=dtype,
                                        full_ke=pairs, device=d)
                   for d in dict.fromkeys(devices)}

    def split(block):
        """[(device, densities' scales, loads)], one per data shard."""
        if dev_mesh is None:
            return [(devices[0], block, loads)]
        escs, lds = sweep_mod.shard_sweep_inputs(dev_mesh, block, loads)
        return [(d, e, f) for d, e, f in zip(devices, escs, lds)
                if e.shape[0]]

    def einsum_part(kernel, e, f):
        return [t.cpu().numpy() for t in sweep_compliance(
            kernel, e, f, tol=tol, maxiter=maxiter)]

    if pairs:
        jobs = [(d, functools.partial(sweep_all_pairs, kernels[d], e, f,
                                      tol=tol, maxiter=maxiter))
                for d, e, f in split(esc)]
    else:
        chunk = max(1, min(int(lane_chunk), B))
        jobs = [(d, functools.partial(einsum_part, kernels[d], e, f))
                for c0 in range(0, B, chunk)
                for d, e, f in split(esc[c0:c0 + chunk])]
    parts = sweep_mod.run_on_devices(jobs)
    energies, iters, conv = (np.concatenate([p[i] for p in parts])
                             for i in range(3))
    if not conv.all():
        print_warning(
            f"{int((~conv).sum())} of {conv.size} sweep lanes did not "
            f"converge within {maxiter} iterations")
    return energies, iters, conv
