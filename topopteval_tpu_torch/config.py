"""Solver configuration (copy of ``topopteval_tpu.config``; reference:
src/FiniteElementAnalysis/RobustSolver.jl:24-64).

The fields are the JAX package's, one for one, so a config written for
either package means the same thing.  ``chunk_iterations`` is kept for
that reason only: the port runs its Krylov loop unchunked.
"""

from __future__ import annotations

import dataclasses


def _total_memory_gb() -> float:
    try:
        import os
        pages = os.sysconf("SC_PHYS_PAGES")
        page_size = os.sysconf("SC_PAGE_SIZE")
        return pages * page_size / 1e9
    except (ValueError, OSError, AttributeError):  # pragma: no cover
        return 16.0


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Mirrors RobustSolver.jl:24-34 field-for-field.

    method: 'direct' | 'cg' | 'minres' | 'gmres' | 'bicgstab' | 'auto'
    preconditioner: 'none' | 'diagonal' | 'block_diagonal' | 'ilu' | 'ichol'
        | 'multigrid'  ('ilu'/'ichol' map to block-diagonal, as in the JAX
        package; 'multigrid' runs on every mesh: the stencil hierarchy on
        generated tet4 boxes, the block-ELL hierarchy, or with
        ``TOPOPT_MG=galerkin`` the Galerkin voxel hierarchy, on any
        other; fem/multigrid.py, fem/bell.py)
    """

    method: str = "auto"
    preconditioner: str = "diagonal"
    tolerance: float = 1e-8
    max_iterations: int = 10000          # reference default (RobustSolver.jl:50)
    memory_limit: float = dataclasses.field(
        default_factory=lambda: _total_memory_gb() * 0.8)
    verbose: bool = True
    restart: int = 30                    # GMRES restart
    drop_tolerance: float = 1e-4         # kept for parity (ILU/IChol knob)
    history: bool = False
    chunk_iterations: int = 0            # parity field; unused by the port

    def __post_init__(self):
        if self.method not in ("auto", "direct", "cg", "minres", "gmres",
                               "bicgstab"):
            raise ValueError(f"unknown method {self.method!r}")
        if self.preconditioner not in ("none", "diagonal", "block_diagonal",
                                       "ilu", "ichol", "multigrid"):
            raise ValueError(
                f"unknown preconditioner {self.preconditioner!r}")
        if self.max_iterations == 0:
            object.__setattr__(self, "max_iterations", 10000)


def large_symmetric_config() -> SolverConfig:
    """Preset for large SPD problems (reference: RobustSolver.jl:747-755)."""
    return SolverConfig(method="cg", preconditioner="ichol", tolerance=1e-8,
                        max_iterations=5000, verbose=True)


def large_general_config() -> SolverConfig:
    """Preset for large general problems (reference: RobustSolver.jl:763-772)."""
    return SolverConfig(method="gmres", preconditioner="ilu", tolerance=1e-8,
                        restart=50, max_iterations=2000, verbose=True)


def memory_efficient_config() -> SolverConfig:
    """Preset for strict memory budgets (reference: RobustSolver.jl:780-788)."""
    return SolverConfig(method="bicgstab", preconditioner="diagonal",
                        tolerance=1e-7, max_iterations=10000, verbose=True)


# reference switches to the robust/iterative path at 50k DOFs
ADAPTIVE_DOF_THRESHOLD = 50_000       # FiniteElementAnalysis.jl:574
DIRECT_LAST_RESORT_DOFS = 100_000     # RobustSolver.jl:407


def adaptive_config(n_dofs: int) -> SolverConfig:
    """The reference's large-problem settings
    (FiniteElementAnalysis.jl:578-586)."""
    return SolverConfig(
        method="auto", preconditioner="diagonal", tolerance=1e-7,
        max_iterations=min(max(n_dofs // 10, 5000), 50000),
        verbose=True, restart=30, history=True)
