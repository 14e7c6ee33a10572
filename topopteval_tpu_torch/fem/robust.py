"""Robust-solver layer: diagnostics, automatic method selection and the
fallback ladder (counterpart of ``topopteval_tpu.fem.robust``; reference:
src/FiniteElementAnalysis/RobustSolver.jl).

- memory estimates with the reference's fill-in factors (:72-101)
- operator property probe: randomized symmetry check + positive-diagonal
  SPD heuristic (matrix-free analog of :133-188)
- automatic method selection by size, memory and properties (:196-216)
- the 3-level fallback ladder: the chosen method, then unpreconditioned CG
  at 10x the tolerance, then the host direct solve below 100,000 DOFs
  (:382-417); every fallback shows in the returned method string
- verbose telemetry: pre-solve diagnostics, residual history every 50
  iterations, convergence verdict with advice (:419-504)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import DIRECT_LAST_RESORT_DOFS, SolverConfig
from ..utils.terminal import log, print_warning
from .solvers import bicgstab, cg, gmres, minres


# ---------------------------------------------------------------------------
# Diagnostics
# ---------------------------------------------------------------------------


def estimate_memory_usage(n: int, nnz: int) -> Dict[str, float]:
    """GB estimates per method with the reference's conservative fill-in
    factors (reference: RobustSolver.jl:72-101)."""
    matrix_memory = (nnz * 8 + n * 8) / 1e9
    vector_memory = n * 8 / 1e9
    if n > 500_000:
        fill = min(50.0, n / 20_000)
    elif n > 100_000:
        fill = min(20.0, n / 10_000)
    else:
        fill = 5.0
    return {
        "direct": matrix_memory * (1 + fill),
        "cg": matrix_memory + 6 * vector_memory,
        "gmres": matrix_memory + 35 * vector_memory,
        "matrix_only": matrix_memory,
    }


def operator_nnz_estimate(op) -> int:
    """Upper bound on assembled nnz: sum of element-matrix entries."""
    C, k = op.dmesh.conn.shape
    return C * (3 * k) ** 2


@dataclasses.dataclass(frozen=True)
class OperatorProperties:
    symmetric: bool
    positive_definite: bool


def check_operator_properties(op, n_probes: int = 3,
                              seed: int = 0) -> OperatorProperties:
    """Matrix-free analog of the reference's sampled symmetry check and
    positive-diagonal scan (reference: RobustSolver.jl:133-188): random
    probes from a generator seeded with ``seed`` test |x'Ay - y'Ax|, and
    the operator's diagonal tests positivity.

    The symmetry tolerance scales with the probe dtype (100·sqrt(n)·eps,
    at least 1e-10): float32 dots carry about sqrt(n)·eps of rounding, so a
    fixed 1e-8 bar would call a symmetric float32 operator non-symmetric.
    """
    n = op.n_dofs
    dtype = op.free_mask.dtype
    device = op.free_mask.device
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    eps = float(torch.finfo(dtype).eps)
    tol = max(100.0 * np.sqrt(n) * eps, 1e-10)
    sym = True
    for _ in range(n_probes):
        x = torch.randn(n, generator=gen, dtype=dtype, device=device)
        y = torch.randn(n, generator=gen, dtype=dtype, device=device)
        xa = float(torch.dot(x, op.matvec(y)))
        ya = float(torch.dot(y, op.matvec(x)))
        scale = max(abs(xa), abs(ya), 1e-30)
        if abs(xa - ya) / scale > tol:
            sym = False
            break
    pd = bool(torch.all(op.diagonal() > 0))
    return OperatorProperties(symmetric=sym, positive_definite=pd)


def select_solver_method(op, config: SolverConfig,
                         props: Optional[OperatorProperties] = None) -> str:
    """Automatic method selection (reference: RobustSolver.jl:196-216)."""
    if config.method != "auto":
        return config.method
    n = op.n_dofs
    mem = estimate_memory_usage(n, operator_nnz_estimate(op))
    props = props or check_operator_properties(op)
    if n < 50_000 and mem["direct"] < config.memory_limit * 0.5:
        return "direct"
    if props.symmetric and props.positive_definite:
        return "cg"
    if props.symmetric:
        return "minres"
    return "gmres" if mem["gmres"] < config.memory_limit else "bicgstab"


def condition_number(K_csr) -> float:
    """2-norm condition number of a sparse SPD matrix: the extreme
    eigenvalues by Lanczos (largest) and shift-invert (smallest), the
    sparse equivalent of the reference's dense ``cond(Matrix(K))``
    (RobustSolver.jl:568); dense below 600 rows."""
    import scipy.sparse.linalg as spla

    n = K_csr.shape[0]
    if n <= 600:
        return float(np.linalg.cond(K_csr.toarray()))
    lam_max = float(spla.eigsh(K_csr, k=1, which="LM",
                               return_eigenvectors=False,
                               maxiter=2000)[0])
    lam_min = float(spla.eigsh(K_csr, k=1, sigma=0, which="LM",
                               return_eigenvectors=False)[0])
    return abs(lam_max / lam_min)


def print_presolve_diagnostics(op, config: SolverConfig, method: str,
                               simp: bool = False, problem=None) -> None:
    """reference: RobustSolver.jl:552-580.

    The memory block prints the reference's assembled-matrix estimates
    beside what the matrix-free operator really holds on its device
    (``utils.profiling.device_tree_bytes``) and, on a CUDA device, what
    PyTorch's allocator has handed out.  With ``problem`` given and
    n < 10,000 it also prints the condition number with the reference's
    ill-conditioning warning (RobustSolver.jl:566-577)."""
    if not config.verbose:
        return
    n = op.n_dofs
    mem = estimate_memory_usage(n, operator_nnz_estimate(op))
    tag = " (SIMP)" if simp else ""
    log("\n" + "=" * 60)
    log(f"PRE-SOLVE DIAGNOSTICS{tag}")
    log("=" * 60)
    log("Memory estimates (assembled-matrix model, reference-shaped):")
    log(f"  Matrix storage: {mem['matrix_only']:.2f} GB")
    log(f"  Direct solver: {mem['direct']:.2f} GB")
    log(f"  CG solver: {mem['cg']:.2f} GB")
    log(f"  GMRES solver: {mem['gmres']:.2f} GB")
    from ..utils.profiling import device_tree_bytes
    actual = device_tree_bytes(op)
    device = op.free_mask.device
    line = (f"Operator device residency (actual {device.type} bytes): "
            f"{actual / 1e9:.3f} GB ({actual} bytes)")
    if device.type == "cuda":
        alloc = torch.cuda.memory_allocated(device)
        line += f"; allocated on the device: {alloc} bytes"
    log(line)
    if problem is not None and n < 10_000:
        try:
            from .bc import free_mask_from_bcs
            from .operator import assemble_scipy
            mask = free_mask_from_bcs(n, problem.bcs)
            K = assemble_scipy(problem.mesh, problem.lam, problem.mu,
                               order=problem.quad_order, free_mask=mask)
            kappa = condition_number(K)
            log(f"Condition number: {kappa:.2f}")
            if kappa > 1e12:
                log("⚠ Matrix is ill-conditioned - convergence may be "
                    "slow")
        except Exception:
            log("Condition number: Could not compute")
    log(f"Selected method: {method.upper()}")


def print_convergence_report(config: SolverConfig, method: str, niter: int,
                             rnorm: float, converged: bool,
                             history: Optional[np.ndarray]) -> None:
    """Residual history every 50 iterations, verdict and advice
    (reference: RobustSolver.jl:419-504)."""
    if not config.verbose:
        return
    log("-" * 60)
    log("SOLVER RESULTS")
    log("-" * 60)
    log(f"Iterations completed: {niter}")
    if history is not None and len(history) > 1:
        log("\nConvergence history (every 50th iteration):")
        for i in range(0, len(history), 50):
            log(f"  Iteration {i:5d}: residual = {history[i]:.6e}")
        if (len(history) - 1) % 50 != 0:
            log(f"  Iteration {len(history) - 1:5d}: residual = "
                f"{history[-1]:.6e}")
    log(f"\nStatus: {'✓ CONVERGED' if converged else '✗ NOT CONVERGED'}")
    log(f"Final residual: {rnorm}")
    log(f"Target tolerance: {config.tolerance}")
    if not converged:
        print_warning(
            f"Krylov solver did not converge after {niter} iterations.\n"
            f"Final residual: {rnorm}\n"
            f"Target tolerance: {config.tolerance}\n"
            "Suggestions:\n"
            f"1. Increase max_iterations (current: {config.max_iterations})\n"
            f"2. Relax tolerance (try {config.tolerance * 100})\n"
            f"3. Try different preconditioner (current: "
            f"{config.preconditioner})\n"
            f"4. Try different method (current: {method}, try cg or "
            "bicgstab)\n"
            "5. Check matrix conditioning\n"
            "6. Verify boundary conditions are properly applied")


# ---------------------------------------------------------------------------
# Krylov dispatch + fallback ladder
# ---------------------------------------------------------------------------


def solve_with_method(op, f: torch.Tensor, method: str, config: SolverConfig
                      ) -> Tuple[torch.Tensor, int, float, bool,
                                 Optional[np.ndarray]]:
    """Dispatch one Krylov method; returns (u, niter, rnorm, conv, hist)."""
    from ..api import _build_preconditioner
    M = _build_preconditioner(op, config)
    common = dict(M=M, tol=config.tolerance, maxiter=config.max_iterations,
                  record_history=config.history)
    if method == "cg":
        res = cg(op, f, **common)
    elif method == "minres":
        res = minres(op, f, **common)
    elif method == "bicgstab":
        res = bicgstab(op, f, **common)
    elif method == "gmres":
        res = gmres(op, f, restart=config.restart, **common)
    else:
        raise ValueError(f"Unknown Krylov method: {method}")
    hist = (res.history[: res.niter + 1] if res.history is not None
            else None)
    return res.x, res.niter, res.residual_norm, res.converged, hist


def solve_with_krylov(op, f: torch.Tensor, method: str, config: SolverConfig
                      ) -> Tuple[torch.Tensor, int, float, bool,
                                 Optional[np.ndarray], str]:
    """Krylov solve with the reference's 3-level fallback ladder
    (reference: RobustSolver.jl:382-417).  Returns
    (u, niter, rnorm, converged, history, method_used); the method is
    ``"cg(fallback)"`` when the relaxed plain CG saved the solve, and
    :class:`_DirectFallback` is raised when the host direct solve must."""
    if config.verbose:
        log("\n" + "=" * 60)
        log("KRYLOV SOLVER DETAILS")
        log("=" * 60)
        log(f"Method: {method.upper()}")
        log(f"Matrix size: {op.n_dofs} × {op.n_dofs}")
        log(f"Preconditioner: {config.preconditioner}")
        log(f"Target tolerance: {config.tolerance}")
        log(f"Max iterations: {config.max_iterations}")
        if method == "gmres":
            log(f"GMRES restart: {config.restart}")

    try:
        u, niter, rnorm, conv, hist = solve_with_method(op, f, method,
                                                        config)
        if conv or method == "cg":
            print_convergence_report(config, method, niter, rnorm, conv,
                                     hist)
            if conv:
                return u, niter, rnorm, conv, hist, method
        raise RuntimeError(
            f"{method} did not converge (residual {rnorm:.3e})")
    except Exception as e:  # fallback 1: plain CG at relaxed tolerance
        if config.verbose:
            print_warning(f"Primary Krylov method {method} failed: {e}")
            log("Attempting fallback to simple CG...")
        fb = dataclasses.replace(config, method="cg", preconditioner="none",
                                 tolerance=config.tolerance * 10)
        u, niter, rnorm, conv, hist = solve_with_method(op, f, "cg", fb)
        if conv:
            if config.verbose:
                log("Fallback CG solver succeeded!")
            print_convergence_report(fb, "cg", niter, rnorm, conv, hist)
            return u, niter, rnorm, conv, hist, "cg(fallback)"
        # fallback 2: host direct solve for modest sizes
        if op.n_dofs < DIRECT_LAST_RESORT_DOFS:
            print_warning("Attempting direct solve as last resort...")
            raise _DirectFallback()
        print_convergence_report(config, method, niter, rnorm, conv, hist)
        return u, niter, rnorm, conv, hist, method


class _DirectFallback(Exception):
    """Signal to the API layer that the ladder bottomed out into the host
    direct solve (it owns the mesh needed to assemble)."""


def estimate_bandwidth(edofs: np.ndarray) -> int:
    """Matrix bandwidth from element DOF connectivity: max |i - j| over
    all element-local DOF pairs (the reference defines it over assembled
    CSC columns, RobustSolver.jl:109-125); it judges node-numbering
    locality before a solve."""
    edofs = np.asarray(edofs)
    return int((edofs.max(axis=1) - edofs.min(axis=1)).max())
