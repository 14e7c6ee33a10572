"""Krylov solvers and the host direct solve (counterpart of
``topopteval_tpu.fem.solvers``; reference: Krylov.jl dispatch in
RobustSolver.jl:279-507 and the CHOLMOD backslash,
FiniteElementAnalysis.jl:547).

``cg``, ``minres``, ``bicgstab`` and ``gmres`` keep the JAX package's
recurrences and stopping tests: Krylov.jl's ``‖r‖ ≤ atol + rtol·‖r0‖``
with ``atol = rtol = tol`` (RobustSolver.jl:294-300), on the recurrence
residual (CG, BiCGSTAB), on MINRES's ``phibar`` and on GMRES's
preconditioned residual estimate.  Dots accumulate in float64 whatever
the working dtype.  Each loop runs eagerly on the operator's device and
reads its stopping scalar back to the host once an iteration.  ``cg``
times its steps as spans of the current timer (``utils.profiling``):
``iter`` an iteration, inside it ``matvec``, ``update`` (dots and
axpys) and ``sync`` (the ‖r‖ readback); a multigrid preconditioner
adds its own ``vcycle``.
``A`` is anything with ``.matvec`` or a dense 2-D matrix.

On a CUDA vector, with an ``A`` and an ``M`` (where there is one) whose
class is marked ``capturable`` (its apply makes no host read and
allocates only through PyTorch's allocator: the block-ELL
``BellSystem``, ``BellMatrix`` and ``BellMG``), ``cg`` captures one whole
iteration as a CUDA graph, once per preconditioner, and runs every
iteration as one replay of it.  The set-up before the loop, the one host
read of ‖r‖ an iteration and the stopping test stay as they are, and so
do the iterates' bits.  The body's spans (``matvec``, ``update``,
``vcycle``) then time the capture, under ``capture``; ``iter`` and
``iter/sync`` still time each replay.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import weakref
from typing import Optional

import numpy as np
import torch

from ..ops.elements import _inv3x3
from ..utils.profiling import span


@dataclasses.dataclass(frozen=True)
class DenseOperator:
    """A dense [n, n] matrix as an operator (tests, small cases)."""

    K: torch.Tensor

    def matvec(self, u: torch.Tensor) -> torch.Tensor:
        return self.K @ u


def _wrap_operator(A):
    if hasattr(A, "matvec"):
        return A
    A = torch.as_tensor(A)
    if A.dim() == 2:
        return DenseOperator(A)
    raise TypeError("A must expose .matvec or be a dense 2D array")


@dataclasses.dataclass(frozen=True)
class KrylovResult:
    """Solution + convergence telemetry (mirrors the Krylov.jl stats fields
    the reference reports, RobustSolver.jl:419-481)."""

    x: torch.Tensor
    niter: int                      # iterations performed
    residual_norm: float            # final recurrence ‖r‖
    converged: bool
    history: Optional[np.ndarray] = None   # [niter+1] ‖r‖ per iteration
    graph_iters: int = 0            # of niter, run as CUDA graph replays


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
    """Inner product accumulated in float64 (solvers.py:95-99).  A sharded
    slab vector (parallel/collectives.SlabVector) sums its shards'
    float64 partial dots in shard order."""
    if isinstance(a, torch.Tensor):
        return torch.dot(a.double(), b.double())
    return a.dot64(b)


def _zeros_like(b):
    """``torch.zeros_like``, also for a sharded slab vector."""
    return torch.zeros_like(b) if isinstance(b, torch.Tensor) \
        else b.zeros_like()


def _cg_iteration(A, M, x, r, p, rz, dtype):
    """One PCG iteration after the set-up: updates ``x``, ``r`` and ``p``
    in place and returns the new r·z and ‖r‖ (float64 device scalars).
    The eager loop and the captured graph both run it."""
    with span("matvec"):
        Ap = A.matvec(p)
    with span("update"):
        pAp = _dot(p, Ap)
        alpha = (rz / torch.where(pAp == 0, 1.0, pAp)).to(dtype)
        x.addcmul_(alpha, p)
        r.addcmul_(alpha, Ap, value=-1.0)
    z = apply_preconditioner(M, r)
    with span("update"):
        rz_new = _dot(r, z)
        beta = (rz_new / torch.where(rz == 0, 1.0, rz)).to(dtype)
        p.mul_(beta).add_(z)
        return rz_new, torch.sqrt(_dot(r, r))


def _captures(A, b, M) -> bool:
    """Whether ``cg`` runs its iterations as replays of a CUDA graph: ``b``
    is a CUDA tensor, and ``A`` and ``M`` (unless None) are marked
    ``capturable``."""
    return (isinstance(b, torch.Tensor) and b.is_cuda
            and getattr(A, "capturable", False)
            and (M is None or getattr(M, "capturable", False)))


@functools.lru_cache(maxsize=None)
def _capture_stream(device: torch.device):
    """The stream of the captures on ``device``: one a device, so that
    the libraries' per-stream workspaces (cuBLAS's) are made once."""
    return torch.cuda.Stream(device)


def _capture(step, device: torch.device):
    """``step`` captured as a CUDA graph on ``device``; returns the
    graph's replay, which launches it on the device's current stream."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.device(device):
        with torch.cuda.graph(graph, stream=_capture_stream(device)):
            step()

    def replay():
        with torch.cuda.device(device):
            graph.replay()

    return replay


def _launch_counters():
    """The kernel wrappers' launch counts (each module's ``LAUNCHES``)."""
    from ..ops import bell, element_kernels, ell, ke_kernels, stencil
    return [m.LAUNCHES for m in (bell, element_kernels, ell, ke_kernels,
                                 stencil)]


class _IterationGraph:
    """:func:`_cg_iteration` captured as a CUDA graph over buffers of its
    own (``x``, ``r``, ``p``, ``rz``); the graph's last node copies ‖r‖
    into a pinned host scalar.  The capture's kernel launches are taken
    off the wrappers' counts and added again at every replay, so the
    counts are those of the eager loop."""

    def __init__(self, A, M, b: torch.Tensor):
        self.A = weakref.ref(A)
        self.device = b.device
        self.x, self.r, self.p = (torch.empty_like(b) for _ in range(3))
        self.rz = torch.empty((), dtype=torch.float64, device=b.device)
        self.rnorm = torch.empty((), dtype=torch.float64,
                                 pin_memory=b.is_cuda)

        def step():
            rz, rnorm = _cg_iteration(A, M, self.x, self.r, self.p, self.rz,
                                      b.dtype)
            self.rz.copy_(rz)
            self.rnorm.copy_(rnorm, non_blocking=True)

        counters = _launch_counters()
        before = [dict(c) for c in counters]
        self._replay = _capture(step, b.device)
        self.launches = []
        for counter, old in zip(counters, before):
            added = {k: n - old[k] for k, n in counter.items() if n != old[k]}
            counter.update(old)
            if added:
                self.launches.append((counter, added))

    def load(self, x, r, p, rz) -> None:
        for buf, v in ((self.x, x), (self.r, r), (self.p, p), (self.rz, rz)):
            buf.copy_(v)

    def replay(self) -> None:
        self._replay()
        for counter, added in self.launches:
            for name, n in added.items():
                counter[name] += n

    def norm(self) -> float:
        """‖r‖ of the last replay, once the stream has run it."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return float(self.rnorm)


def _iteration_graph(A, M, b: torch.Tensor) -> _IterationGraph:
    """The captured iteration of ``A`` and ``M`` for vectors like ``b``,
    captured at its first use (span ``capture``).  It is kept on ``M``
    (on ``A`` without one), keyed by dtype, shape and device, so it dies
    with the hierarchy whose tensors it reads."""
    owner = A if M is None else M
    graphs = owner.__dict__.setdefault("_cg_graphs", {})
    key = (b.dtype, tuple(b.shape), b.device)
    graph = graphs.get(key)
    if graph is None or graph.A() is not A:
        with span("capture"):
            graph = graphs[key] = _IterationGraph(A, M, b)
    return graph


def cg(A, b: torch.Tensor, x0: Optional[torch.Tensor] = None, M=None,
       tol: float = 1e-8, maxiter: int = 10000,
       record_history: bool = False) -> KrylovResult:
    """Preconditioned conjugate gradients for SPD operators (the
    reference's ``Krylov.cg`` path, RobustSolver.jl:332-338).  ``A``
    exposes ``.matvec``; ``b`` may be a tensor or a sharded slab vector
    (parallel/collectives.SlabVector, with ``A`` and ``M`` sharded).
    Where :func:`_captures` holds, the iterations are replays of one
    CUDA graph (module docstring) and ``graph_iters`` counts them."""
    A = _wrap_operator(A)
    x = _zeros_like(b) if x0 is None else x0.clone()
    with span("matvec"):
        r = b - A.matvec(x)
    z = apply_preconditioner(M, r)
    p = z.clone()
    rz = _dot(r, z)
    with span("sync"):
        rnorm = float(torch.sqrt(_dot(r, r)))
    eps = tol + tol * rnorm        # Krylov.jl: atol + rtol*‖r0‖
    hist = [rnorm] if record_history else None
    it = 0
    graph = None
    if maxiter > 0 and rnorm > eps and _captures(A, b, M):
        graph = _iteration_graph(A, M, b)
        graph.load(x, r, p, rz)
    while it < maxiter and rnorm > eps:
        with span("iter"):
            if graph is None:
                rz, rnorm_dev = _cg_iteration(A, M, x, r, p, rz, b.dtype)
            else:
                graph.replay()
            it += 1
            with span("sync"):
                rnorm = float(rnorm_dev) if graph is None else graph.norm()
            if record_history:
                hist.append(rnorm)
    if graph is not None:
        x = graph.x.clone()
    return KrylovResult(x, it, rnorm, rnorm <= eps,
                        np.asarray(hist) if record_history else None,
                        it if graph is not None else 0)


def _pnorm(r: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp_min(_dot(r, r), 0.0))


def minres(A, b: torch.Tensor, x0: Optional[torch.Tensor] = None, M=None,
           tol: float = 1e-8, maxiter: int = 10000,
           record_history: bool = False) -> KrylovResult:
    """Paige-Saunders MINRES for symmetric (possibly indefinite) operators
    with an SPD preconditioner (the reference dispatches ``:minres`` for
    symmetric-indefinite matrices, RobustSolver.jl:210-211, 340-345).

    Stops when ``phibar ≤ tol + tol·β₁`` and reports the true residual
    ‖b − A x‖ of a fresh matvec (RobustSolver.jl:469)."""
    A = _wrap_operator(A)
    dtype = b.dtype
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    r1 = b - A.matvec(x)
    y = apply_preconditioner(M, r1)
    beta1 = torch.sqrt(torch.clamp_min(_dot(r1, y), 0.0))
    eps0 = float(tol + tol * beta1)
    f64 = dict(dtype=torch.float64, device=b.device)
    r2 = r1
    w = w2 = torch.zeros_like(b)
    oldb = torch.zeros((), **f64)
    beta, phibar = beta1, beta1
    dbar = torch.zeros((), **f64)
    epsln = torch.zeros((), **f64)
    cs = torch.full((), -1.0, **f64)
    sn = torch.zeros((), **f64)
    rnorm = float(beta1)
    hist = [rnorm] if record_history else None
    it = 0
    while it < maxiter and rnorm > eps0:
        v = ((1.0 / beta) * y.double()).to(dtype)
        yv = A.matvec(v)
        if it >= 1:
            yv = yv - (beta / oldb).to(dtype) * r1
        alfa = _dot(v, yv)
        yv = yv - (alfa / beta).to(dtype) * r2
        r1, r2 = r2, yv
        y = apply_preconditioner(M, r2)
        oldb = beta
        beta = torch.sqrt(torch.clamp_min(_dot(r2, y), 0.0))
        oldeps = epsln
        delta = cs * dbar + sn * alfa
        gbar = sn * dbar - cs * alfa
        epsln = sn * beta
        dbar = -cs * beta
        gamma = torch.clamp_min(torch.sqrt(gbar * gbar + beta * beta),
                                1e-300)
        cs = gbar / gamma
        sn = beta / gamma
        phi = cs * phibar
        phibar = sn * phibar
        w1, w2 = w2, w
        w = ((v.double() - oldeps * w1.double() - delta * w2.double())
             / gamma).to(dtype)
        x = x + phi.to(dtype) * w
        it += 1
        rnorm = float(phibar)
        if record_history:
            hist.append(rnorm)
    r_true = b - A.matvec(x)
    return KrylovResult(x, it, float(torch.sqrt(_dot(r_true, r_true))),
                        rnorm <= eps0,
                        np.asarray(hist) if record_history else None)


def _nonzero(t: torch.Tensor) -> torch.Tensor:
    return torch.where(t == 0, torch.ones_like(t), t)


def bicgstab(A, b: torch.Tensor, x0: Optional[torch.Tensor] = None, M=None,
             tol: float = 1e-8, maxiter: int = 10000,
             record_history: bool = False) -> KrylovResult:
    """van der Vorst BiCGSTAB with right preconditioning, for general
    operators (reference: RobustSolver.jl:370-376)."""
    A = _wrap_operator(A)
    dtype = b.dtype
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    r = b - A.matvec(x)
    rhat = r
    rnorm = float(torch.sqrt(_dot(r, r)))
    eps0 = tol + tol * rnorm
    p = v = torch.zeros_like(b)
    rho = alpha = omega = torch.ones((), dtype=torch.float64,
                                     device=b.device)
    hist = [rnorm] if record_history else None
    it = 0
    while it < maxiter and rnorm > eps0:
        rho_n = _dot(rhat, r)
        beta = (rho_n / _nonzero(rho)) * (alpha / _nonzero(omega))
        p = r + beta.to(dtype) * (p - omega.to(dtype) * v)
        phat = apply_preconditioner(M, p)
        v = A.matvec(phat)
        alpha = rho_n / _nonzero(_dot(rhat, v))
        s = r - alpha.to(dtype) * v
        shat = apply_preconditioner(M, s)
        t = A.matvec(shat)
        omega = _dot(t, s) / _nonzero(_dot(t, t))
        x = x + alpha.to(dtype) * phat + omega.to(dtype) * shat
        r = s - omega.to(dtype) * t
        rho = rho_n
        it += 1
        rnorm = float(torch.sqrt(_dot(r, r)))
        if record_history:
            hist.append(rnorm)
    return KrylovResult(x, it, rnorm, rnorm <= eps0,
                        np.asarray(hist) if record_history else None)


def _gmres_run(A, b, x0, tol, M, maxiter, m, record_history):
    """One restarted GMRES(m) run: left preconditioning, modified
    Gram-Schmidt Arnoldi on the device, the Hessenberg column and its
    Givens rotations in float64 on the host (one read of the column an
    iteration).  Returns (x, iterations, estimate, converged, history)."""
    dtype = b.dtype
    n = b.shape[0]

    def prec(r):
        return apply_preconditioner(M, r)

    beta0 = float(_pnorm(prec(b - A.matvec(x0))))
    eps0 = tol + tol * beta0
    hist = [beta0] if record_history else None
    x, it, res = x0, 0, beta0
    while it < maxiter and res > eps0:
        r = prec(b - A.matvec(x))
        beta = _pnorm(r)
        V = torch.zeros((m + 1, n), dtype=dtype, device=b.device)
        V[0] = (r / _nonzero(beta)).to(dtype)
        Hr = np.zeros((m + 1, m))            # rotated: upper triangular
        cs = np.ones(m)
        sn = np.zeros(m)
        g = np.zeros(m + 1)
        g[0] = res = float(beta)
        j = 0
        while j < m and res > eps0 and it < maxiter:
            w = prec(A.matvec(V[j]))
            hs = []
            for i in range(j + 1):          # rows past j are still zero
                hij = _dot(V[i], w)
                w = torch.addcmul(w, V[i], hij.to(dtype), value=-1.0)
                hs.append(hij)
            hnorm = _pnorm(w)
            hcol = np.zeros(m + 1)
            hcol[: j + 2] = torch.stack(hs + [hnorm]).cpu().numpy()
            if hcol[j + 1] > 0:
                V[j + 1] = (w.double() / hnorm).to(dtype)
            for i in range(j):              # rotations of earlier steps
                hi, hi1 = hcol[i], hcol[i + 1]
                hcol[i] = cs[i] * hi + sn[i] * hi1
                hcol[i + 1] = -sn[i] * hi + cs[i] * hi1
            denom = math.sqrt(hcol[j] * hcol[j] + hcol[j + 1] * hcol[j + 1])
            c, s = ((1.0, 0.0) if denom == 0
                    else (hcol[j] / denom, hcol[j + 1] / denom))
            cs[j], sn[j] = c, s
            hcol[j] = c * hcol[j] + s * hcol[j + 1]
            hcol[j + 1] = 0.0
            g_j1 = -s * g[j]
            g[j + 1], g[j] = g_j1, c * g[j]
            Hr[:, j] = hcol
            res = abs(g_j1)
            j += 1
            it += 1
            if record_history:
                hist.append(res)
        y = np.zeros(m)                     # back substitution, j columns
        for i in range(j - 1, -1, -1):
            dii = Hr[i, i]
            y[i] = (g[i] - np.dot(Hr[i], y)) / (1.0 if dii == 0 else dii)
        x = x + torch.as_tensor(y, device=b.device).to(dtype) @ V[:m]
    return x, it, float(res), bool(res <= eps0), hist


def gmres(A, b: torch.Tensor, x0: Optional[torch.Tensor] = None, M=None,
          tol: float = 1e-8, maxiter: int = 10000, restart: int = 30,
          record_history: bool = False) -> KrylovResult:
    """Restarted GMRES with left preconditioning (reference:
    RobustSolver.jl:348-368, restart default 30).  It stops on the
    preconditioned residual estimate and reports the true residual.

    As the reference retries a failed restarted run without the restart
    argument, a run that does not converge is repeated once from ``x0``
    with the Krylov space widened to ``min(maxiter, n, 200)``; the
    iterations of both runs are counted and the history is the retry's.
    """
    A = _wrap_operator(A)
    x0 = torch.zeros_like(b) if x0 is None else x0
    n = b.shape[0]
    restart = max(1, min(int(restart), n, int(maxiter)))
    x, it, _, conv, hist = _gmres_run(A, b, x0, tol, M, maxiter, restart,
                                      record_history)
    if not conv:
        wide = min(int(maxiter), n, 200)
        if wide > restart:
            from ..utils.terminal import log
            log(f"GMRES(restart={restart}) did not converge; retrying "
                f"unrestarted (m={wide})")
            x, it2, _, conv, hist = _gmres_run(A, b, x0, tol, M, maxiter,
                                               wide, record_history)
            it += it2
    r_true = b - A.matvec(x)
    return KrylovResult(x, it, float(torch.sqrt(_dot(r_true, r_true))),
                        conv, np.asarray(hist) if record_history else None)


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
