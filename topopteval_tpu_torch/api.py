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
block-ELL hierarchy of fem/bell.py, float32 PCG inside float64
host-residual refinement, and the backward-error gate with its direct
fallback.  Multi-device solves, the other Krylov methods, the
``verbose=True`` robust ladder, ``TOPOPT_MG=galerkin`` and the monolithic
block-ELL build are not ported yet and raise ``NotImplementedError``
naming their ROADMAP item.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from .config import ADAPTIVE_DOF_THRESHOLD, DIRECT_LAST_RESORT_DOFS, SolverConfig
from .fem.bc import DirichletBC, free_mask_from_bcs
from .fem.host_operator import HostFineOperator
from .fem.operator import StiffnessOperator, assemble_scipy
from .fem.solvers import (block_jacobi_preconditioner, cg, direct_solve,
                          jacobi_preconditioner)
from .materials import SIMPMaterial
from .mesh import DIM, Mesh, dofs_of_nodes, resolve_device
from .ops.elements import element_volumes
from .ops.stress import stress_summary
from .utils.profiling import PhaseRecord, PhaseTimer
from .utils.terminal import log, print_warning

#: lower clip of the per-pass inner tolerance in mixed-precision refinement
_REFINE_INNER_FLOOR = 1e-7


# ---------------------------------------------------------------------------
# Mesh import / inspection
# ---------------------------------------------------------------------------


def import_mesh(path: str) -> Mesh:
    """Read a .vtu mesh (reference: MeshImport.jl:20-164)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".vtu":
        log(f"Importing VTU mesh from {path}...")
        from .io.vtu import read_vtu_mesh
        return read_vtu_mesh(path)
    if ext == ".msh":
        raise NotImplementedError(
            "GMSH import is not ported yet (ROADMAP Queue A item 10)")
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

    ``dtype`` defaults to float32, the JAX package's accelerator default;
    ``torch.float64`` gives fp64 throughout.  ``device`` defaults to
    ``"cuda"`` and must exist."""
    from .mesh import SOLID_TYPES
    if mesh.element_type not in SOLID_TYPES:
        raise ValueError(
            f"unsupported element type for analysis: {mesh.element_type!r} "
            f"(supported solid types: {', '.join(SOLID_TYPES)}); import a "
            "mesh whose dominant cell type is one of these")
    if interpolation_order not in (1, 2):
        raise ValueError("interpolation_order must be 1 or 2")
    if interpolation_order == 2 or mesh.element_type in ("tet10", "hex20"):
        raise NotImplementedError(
            "quadratic elements are not ported yet (ROADMAP Queue A item 7)")
    log(f"Setting up problem with {mesh.element_type} elements")
    log(f"Number of DOFs: {mesh.n_dofs}")
    return Problem(mesh=mesh, interpolation_order=interpolation_order,
                   dtype=dtype, mode=mode, device=device)


def problem_from_numpy(state: dict, device="cuda",
                       dtype: torch.dtype = torch.float32) -> Problem:
    """A :class:`Problem` from plain NumPy state, e.g. one taken from
    another implementation so both solve the same problem.

    Keys: ``coords`` [N,3], ``conn`` [C,k], ``element_type``, ``lam`` and
    ``mu`` [C], ``f`` [3N], ``fixed_dofs`` (a list of DOF-id arrays, one
    per constraint), and optionally ``density`` [C], ``quad_order`` and
    ``structured_info`` (a generated box's provenance, which selects the
    stencil multigrid route).
    """
    mesh = Mesh(state["coords"], state["conn"], state["element_type"])
    info = state.get("structured_info")
    if info is not None:
        mesh.structured_info = {
            "dims": tuple(int(d) for d in info["dims"]),
            "lo": tuple(float(v) for v in info["lo"]),
            "hi": tuple(float(v) for v in info["hi"])}
    problem = setup_problem(mesh, dtype=dtype, device=device)
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
    ``TOPOPT_MG=galerkin`` (the voxel-probing hierarchy) is not ported and
    raises."""
    key = _material_fingerprint(problem)
    cached = problem._mg_cache
    if cached is not None and cached[0] == key:
        return cached[1], cached[2]

    from .fem.multigrid import build_structured_multigrid
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
            # hex order from models.beams._hex_conn is x-major (ix slowest);
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
            raise NotImplementedError(
                "TOPOPT_MG=galerkin (the voxel-probing Galerkin hierarchy) "
                "is not ported yet (ROADMAP Queue A item 12)")
        op, mg, problem._mg_build_info = _get_bell_multigrid(problem, mask)
    problem._mg_cache = (key, op, mg)
    return op, mg


def _backward_error(op, f_dev: torch.Tensor, u: torch.Tensor):
    """Normwise backward error eta = ||f-Au|| / (||A||·||u|| + ||f||) with
    a fresh matvec and an 8-step power estimate of ||A||_2.

    Returns (eta, fnorm_fraction) where fnorm_fraction =
    ||f|| / (||A||·||u|| + ||f||), which folds the requested Krylov
    tolerance into the acceptance threshold."""
    true_r = float(torch.linalg.vector_norm(f_dev - op.matvec(u)))
    unorm = float(torch.linalg.vector_norm(u))
    fnorm = float(torch.linalg.vector_norm(f_dev))
    if unorm == 0:
        return (0.0 if true_r == 0 else 1.0), 1.0
    v = u / unorm
    lam_max = 1.0
    for _ in range(8):
        w = op.matvec(v)
        lam_max = float(torch.linalg.vector_norm(w))
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


def _refined_generic(system, inner, f64, tol, maxiter, device, x0_64=None,
                     record_history=False, max_passes=6,
                     dtype=torch.float32):
    """Mixed-precision iterative refinement around an fp32 inner solve.

    Each pass evaluates the TRUE residual with the exact fp64 host matvec,
    rescales it to unit norm and calls
    ``inner(rhs_dev, iters_left, tol_inner) -> (x_dev, niter, history)``
    for the correction.  The inner tolerance aims just below what would
    finish this pass (0.3*eps/rn), clipped to [1e-7, 1e-4].
    Returns (x64, total_iters, true_rnorm, converged, history, passes),
    ``passes`` being the number of inner solves.
    """
    rn0 = float(np.linalg.norm(f64))
    eps = tol + tol * rn0
    x64 = np.zeros_like(f64) if x0_64 is None else np.asarray(
        x0_64, np.float64)
    total = 0
    passes = 0
    hists = []
    rn = rn0
    for p in range(max_passes):
        r64 = f64 if (p == 0 and x0_64 is None) \
            else f64 - system.matvec64(x64)
        rn = float(np.linalg.norm(r64))
        if rn <= eps or total >= maxiter:
            break
        log(f"  Refinement pass {p}: true residual = {rn:.6e}")
        s = rn
        rhs = torch.as_tensor(r64 / s, dtype=dtype, device=device)
        tol_inner = float(np.clip(0.3 * eps / rn, _REFINE_INNER_FLOOR, 1e-4))
        x_dev, n_it, hist = inner(rhs, maxiter - total, tol_inner)
        passes += 1
        if n_it == 0:
            break
        x64 = x64 + s * x_dev.double().cpu().numpy()
        total += n_it
        if record_history and hist is not None:
            h = np.asarray(hist)[: n_it + 1] * s
            hists.append(h if not hists else h[1:])
    else:
        r64 = f64 - system.matvec64(x64)
        rn = float(np.linalg.norm(r64))
    history = (np.concatenate(hists)
               if record_history and hists else None)
    return x64, total, rn, rn <= eps, history, passes


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
    raise ValueError(f"unknown preconditioner {name!r}")


def _check_ported(config: SolverConfig, method: str, devices) -> None:
    if devices is not None:
        raise NotImplementedError(
            "multi-device solves are not ported yet (ROADMAP Queue A "
            "item 13)")
    if method in ("minres", "gmres", "bicgstab"):
        raise NotImplementedError(
            f"method={method!r} is not ported yet (ROADMAP Queue A item 9)")
    if (method == "cg" and config.verbose
            and config.preconditioner != "multigrid"):
        raise NotImplementedError(
            "the verbose=True robust solver ladder is not ported yet "
            "(ROADMAP Queue A item 9); pass verbose=False for plain PCG")


def solve_system(problem: Problem,
                 config: Optional[SolverConfig] = None,
                 x0: Optional[np.ndarray] = None,
                 devices=None) -> SolveResult:
    """Solve K u = f with the accumulated constraints, then recover energy
    and stresses (reference: FiniteElementAnalysis.jl:538-561, 831-862).
    ``x0`` warm-starts the Krylov iteration."""
    timer = PhaseTimer()
    config = config or _default_config()
    method = config.method
    if method == "auto":
        method = ("direct" if problem.n_dofs < ADAPTIVE_DOF_THRESHOLD
                  else "cg")
    _check_ported(config, method, devices)

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
    t0 = time.perf_counter()
    history = None
    energy64 = None         # fp64 energy from the refined route
    u64 = None              # fp64 displacements from the refined route
    passes = 0              # inner solves of the refined route

    def _host_direct():
        """fp64 host sparse LU with the problem's own f and BCs."""
        mask_np = free_mask_from_bcs(n, problem.bcs)
        K = assemble_scipy(problem.mesh, problem.lam, problem.mu,
                           order=problem.quad_order, free_mask=mask_np)
        u_np = direct_solve(K, np.asarray(problem.f)[:n] * mask_np)
        return torch.as_tensor(u_np, dtype=dtype, device=device)

    if method == "direct":
        u = _host_direct()
        niter, rnorm, conv = 1, 0.0, True
    else:
        # multigrid takes this plain-PCG path whatever ``verbose`` says
        M = M_mg if M_mg is not None else _build_preconditioner(op, config)
        if want_refine:
            if is_cm:                   # BellSystem.matvec64, fp64 scipy
                system = op
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
                r = cg(op, rhs, M=M, tol=tol_inner, maxiter=left,
                       record_history=config.history)
                return r.x, r.niter, r.history

            u64, niter, rnorm, conv, history, passes = _refined_generic(
                system, _inner, f64, config.tolerance,
                config.max_iterations, device, x0_64=x0_64,
                record_history=config.history, dtype=dtype)
            u = torch.as_tensor(u64, dtype=dtype, device=device)
            energy64 = 0.5 * float(u64 @ f64)
            for name in ("build_seconds", "matvec_seconds"):
                timer.records[f"refine_host_{name}"] = PhaseRecord(
                    f"refine_host_{name}", getattr(system, name))
        else:
            x0_dev = None
            if x0 is not None:
                x0_h = np.asarray(x0)[:n]
                x0_dev = torch.as_tensor(
                    op.to_cm(x0_h) if is_cm else x0_h, dtype=dtype,
                    device=device) * op.free_mask
            res = cg(op, f_dev, x0=x0_dev, M=M, tol=config.tolerance,
                     maxiter=config.max_iterations,
                     record_history=config.history)
            u, niter, rnorm, conv = (res.x, res.niter, res.residual_norm,
                                     res.converged)
            history = res.history
        if not conv:
            print_warning(
                f"Krylov solver did not converge after {niter} iterations "
                f"(residual {rnorm:.3e}, target {config.tolerance:.1e})")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    solve_time = time.perf_counter() - t0
    timer.records["solve"] = PhaseRecord("solve", solve_time)

    if conv and not method.startswith("direct"):
        # backward-error verification with FRESH matvecs: the recurrence
        # residual can look converged while the iterate is wrong; the
        # normwise backward error catches that while tolerating the dtype's
        # attainable-accuracy floor and the requested Krylov tolerance
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
                niter, rnorm, conv = 1, 0.0, True
                method = "direct(verification-fallback)"
                is_cm = False          # the direct solve is interleaved
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
        u = torch.as_tensor(op.to_il(u.cpu().numpy()), dtype=dtype,
                            device=device)
        if u64 is not None:
            u64 = op.to_il(u64)
    return _finish_result(problem, u, energy, method, niter, rnorm, conv,
                          solve_time, history, timer,
                          dmesh=getattr(op, "dmesh", None), u64=u64,
                          refinement_passes=passes)


def _finish_result(problem: Problem, u, energy: float, method: str,
                   niter: int, rnorm: float, conv: bool,
                   solve_time: float, history, timer: PhaseTimer,
                   dmesh=None, u64=None, refinement_passes=0) -> SolveResult:
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

    log("Analysis complete")
    log(f"Deformation energy: {energy} J")
    log(f"Maximum von Mises stress: {float(max_vm)} at cell "
        f"{int(max_cell)}")

    u_pub = u64 if u64 is not None else u.cpu().numpy()
    return SolveResult(
        u=np.asarray(u_pub)[: problem.n_dofs], energy=energy,
        stress_qp=sigma_qp.cpu().numpy(),
        stress_avg=avg.cpu().numpy(),
        von_mises=vm.cpu().numpy(),
        max_von_mises=float(max_vm), max_stress_cell=int(max_cell),
        method=method, iterations=niter, residual_norm=rnorm,
        converged=conv, solve_time=solve_time, history=history,
        timings=timer.as_dict(), refinement_passes=refinement_passes)


# SIMP variant shares the implementation; the material was captured at
# assembly time (reference keeps separate solve_system_simp,
# FiniteElementAnalysis.jl:831-862)
solve_system_simp = solve_system


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
