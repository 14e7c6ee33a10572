"""Preconditioned conjugate gradients and the host direct solve
(counterpart of ``topopteval_tpu.fem.solvers``; reference: Krylov.jl
dispatch in RobustSolver.jl:279-507 and the CHOLMOD backslash,
FiniteElementAnalysis.jl:547).

``cg`` keeps the JAX package's recurrence and Krylov.jl's stopping rule
``‖r‖ ≤ atol + rtol·‖r0‖`` with ``atol = rtol = tol`` (RobustSolver.jl:
294-300).  Dots accumulate in float64 whatever the working dtype.  The
loop runs eagerly on the operator's device; each iteration reads ‖r‖ back
to the host for the stopping test.  Vectors are updated in place.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..ops.elements import _inv3x3


@dataclasses.dataclass(frozen=True)
class KrylovResult:
    """Solution + convergence telemetry (mirrors the Krylov.jl stats fields
    the reference reports, RobustSolver.jl:419-481)."""

    x: torch.Tensor
    niter: int                      # iterations performed
    residual_norm: float            # final recurrence ‖r‖
    converged: bool
    history: Optional[np.ndarray] = None   # [niter+1] ‖r‖ per iteration


def apply_preconditioner(M, r: torch.Tensor) -> torch.Tensor:
    """M is None | inv-diagonal [n] | inverted node blocks [n/3, 3, 3] |
    any object with an ``.apply(r)`` method (e.g. the multigrid V-cycle,
    fem/multigrid.py)."""
    if M is None:
        return r
    if hasattr(M, "apply"):
        return M.apply(r)
    if M.dim() == 3:
        return torch.bmm(M, r.reshape(-1, 3, 1)).reshape(r.shape)
    return M * r


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Inner product accumulated in float64 (solvers.py:95-99)."""
    return torch.dot(a.double(), b.double())


def cg(A, b: torch.Tensor, x0: Optional[torch.Tensor] = None, M=None,
       tol: float = 1e-8, maxiter: int = 10000,
       record_history: bool = False) -> KrylovResult:
    """Preconditioned conjugate gradients for SPD operators (the
    reference's ``Krylov.cg`` path, RobustSolver.jl:332-338).  ``A``
    exposes ``.matvec``."""
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    r = b - A.matvec(x)
    z = apply_preconditioner(M, r)
    p = z.clone()
    rz = _dot(r, z)
    rnorm = float(torch.sqrt(_dot(r, r)))
    eps = tol + tol * rnorm        # Krylov.jl: atol + rtol*‖r0‖
    hist = [rnorm] if record_history else None
    it = 0
    while it < maxiter and rnorm > eps:
        Ap = A.matvec(p)
        pAp = _dot(p, Ap)
        alpha = (rz / torch.where(pAp == 0, 1.0, pAp)).to(b.dtype)
        x.addcmul_(alpha, p)
        r.addcmul_(alpha, Ap, value=-1.0)
        z = apply_preconditioner(M, r)
        rz_new = _dot(r, z)
        beta = (rz_new / torch.where(rz == 0, 1.0, rz)).to(b.dtype)
        p.mul_(beta).add_(z)
        rz = rz_new
        it += 1
        rnorm = float(torch.sqrt(_dot(r, r)))
        if record_history:
            hist.append(rnorm)
    return KrylovResult(x, it, rnorm, rnorm <= eps,
                        np.asarray(hist) if record_history else None)


def direct_solve(K_csr, f: np.ndarray) -> np.ndarray:
    """Sparse LU on host — the reference's ``u = K \\ f``
    (FiniteElementAnalysis.jl:547) in role and precision (fp64)."""
    from scipy.sparse.linalg import spsolve
    return spsolve(K_csr.tocsc(), np.asarray(f, dtype=np.float64))


def jacobi_preconditioner(diag: torch.Tensor,
                          guard: float = 1e-12) -> torch.Tensor:
    """Inverse-diagonal with the reference's zero-diagonal guard
    (RobustSolver.jl:231-237: |d|<1e-12 → 1.0)."""
    safe = torch.where(torch.abs(diag) < guard, torch.ones_like(diag), diag)
    return 1.0 / safe


def block_jacobi_preconditioner(blocks: torch.Tensor,
                                free_mask: torch.Tensor) -> torch.Tensor:
    """Inverted 3x3 node blocks of the *constrained* operator: fixed DOFs
    get identity rows/cols inside their node block, singular blocks fall
    back to the identity."""
    m = free_mask.reshape(-1, 3)
    eye = torch.eye(3, dtype=blocks.dtype, device=blocks.device)
    bm = blocks * (m[:, :, None] * m[:, None, :]) + (1.0 - m)[:, :, None] * eye
    inv, det = _inv3x3(bm)
    return torch.where((det == 0)[:, None, None], eye, inv)
