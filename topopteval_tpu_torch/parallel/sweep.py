"""Batched design sweeps: many density fields × load cases at once
(counterpart of ``topopteval_tpu/parallel/sweep.py``).

Every lane shares one mesh, so the element geometry (gradients,
integration weights, the unit-E element stiffness) is computed once and
reused across the batch; a density only rescales each element's Young's
modulus (SIMP: E(rho) = Emin + (E0 - Emin) rho^p, reference
FiniteElementAnalysis.jl:623).  Each (density, load) lane runs its own
block-Jacobi PCG (BASELINE.md config 5: 64 densities × 4 load cases).

Lanes are the last axis of every state tensor: vectors are [N, 3, P], so
the element gather ``u[conn]`` gives [C, k, 3, P] with no transpose, and
the GEMM form of the operator is one ``torch.bmm`` over elements,
[C, 3k, 3k] @ [C, 3k, P].  The lanes keep the semantics of the JAX
package's ``vmap`` over ``while_loop``: each lane tests its own condition
before every step, a stopped lane keeps its state and its count, and the
loop ends when no lane is active.  Stopped lanes are dropped from the
working tensors, so the later iterations cost only the lanes still
running.  A lane's arithmetic does not depend on the other lanes' values,
but its rounding can depend on how many lanes run beside it (GEMM and
reduction blocking change with the width), as in the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..materials import SIMPMaterial, lame_parameters
from ..mesh import DIM, Mesh, resolve_device
from ..ops.elements import _inv3x3, physical_gradients
from ..ops.scatter import RowScatterPlan
from ..utils.profiling import span

#: share of the free device (or host) memory one call's lanes may take
_MEMORY_SHARE = 0.5


def _ldot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-lane inner products of [N, 3, P] tensors, accumulated in
    float64: [P]."""
    return (a.double() * b.double()).sum(dim=(0, 1))


@dataclasses.dataclass(frozen=True)
class SweepKernel:
    """Per-mesh state for density sweeps.

    ``blocks_ek`` holds the E = 1 per-element 3x3 node-block
    contributions, so each lane's block-Jacobi preconditioner is one
    escale-weighted sum and a batched 3x3 inversion (plain Jacobi stalls
    at SIMP contrast Emin/E0 = 1e-8..1e-9).  ``ke0``, when built, is the
    unit-E element stiffness [C, 3k, 3k] of the GEMM form of the
    operator.  The geometry is computed in float64 and stored in the
    lanes' dtype."""

    g: torch.Tensor          # [C, q, k, 3] physical gradients
    wdet: torch.Tensor       # [C, q]
    blocks_ek: torch.Tensor  # [C, k, 3, 3] unit-E node-block contributions
    plan: RowScatterPlan
    conn: torch.Tensor       # [C, k] int64
    free_mask: torch.Tensor  # [ndof]
    nu: float
    ke0: Optional[torch.Tensor] = None   # [C, 3k, 3k]

    @staticmethod
    def build(mesh: Mesh, nu: float, free_mask: np.ndarray,
              dtype=torch.float32, order: int = 2, full_ke: bool = False,
              device="cuda") -> "SweepKernel":
        dev = resolve_device(device)
        coords = torch.as_tensor(mesh.coords, dtype=torch.float64, device=dev)
        conn = torch.as_tensor(np.asarray(mesh.conn, np.int64), device=dev)
        g, wdet = physical_gradients(coords[conn], mesh.element_type, order)
        lam0, mu0 = lame_parameters(1.0, float(nu))
        eye = torch.eye(DIM, dtype=torch.float64, device=dev)
        outer = (torch.einsum("cq,cqka,cqkb->ckab", wdet * lam0, g, g)
                 + torch.einsum("cq,cqkb,cqka->ckab", wdet * mu0, g, g))
        norm2 = torch.einsum("cq,cqka,cqka->ck", wdet * mu0, g, g)
        blocks_ek = outer + norm2[..., None, None] * eye
        ke0 = None
        if full_ke:
            # unit-E isotropic Ke, row (k, a) x column (l, b): the integrand
            # of blocks_ek extended off the node diagonal
            k = g.shape[2]
            ke0 = (torch.einsum("cq,cqka,cqlb->ckalb", wdet * lam0, g, g)
                   + torch.einsum("cq,cqkb,cqla->ckalb", wdet * mu0, g, g)
                   + torch.einsum("cq,cqkd,cqld->ckl", wdet * mu0, g, g
                                  )[:, :, None, :, None]
                   * eye[None, None, :, None, :])
            ke0 = ke0.reshape(-1, k * DIM, k * DIM).to(dtype)
        return SweepKernel(
            g=g.to(dtype), wdet=wdet.to(dtype), blocks_ek=blocks_ek.to(dtype),
            plan=RowScatterPlan.build(mesh.conn, mesh.n_nodes, dev),
            conn=conn,
            free_mask=torch.as_tensor(np.asarray(free_mask), dtype=dtype,
                                      device=dev),
            nu=float(nu), ke0=ke0)

    @property
    def n_nodes(self) -> int:
        return self.plan.n_nodes

    @property
    def dtype(self) -> torch.dtype:
        return self.g.dtype

    @property
    def device(self) -> torch.device:
        return self.g.device

    def _mask(self) -> torch.Tensor:
        return self.free_mask.reshape(-1, DIM, 1)

    # -- lanes last: escale [C, P], vectors [N, 3, P] -----------------------

    def block_jacobi_lanes(self, esc: torch.Tensor) -> torch.Tensor:
        """Inverted 3x3 node blocks of each lane's constrained operator,
        [N, 3, 3, P] (fixed components get identity rows and columns,
        singular blocks the identity)."""
        C, k = self.conn.shape
        P = esc.shape[1]
        inc = self.plan.incidence                       # [N, D]
        N = inc.shape[0]
        b9 = torch.cat([self.blocks_ek.reshape(C * k, 9),
                        self.blocks_ek.new_zeros((1, 9))])[inc]  # [N, D, 9]
        e = torch.cat([esc.repeat_interleave(k, dim=0),
                       esc.new_zeros((1, P))])[inc]     # [N, D, P]
        bm = torch.bmm(b9.transpose(1, 2), e).permute(0, 2, 1).reshape(
            N, P, DIM, DIM)
        m = self.free_mask.reshape(N, 1, DIM)
        eye = torch.eye(DIM, dtype=bm.dtype, device=bm.device)
        bm = bm * (m[..., :, None] * m[..., None, :]) \
            + (1.0 - m)[..., :, None] * eye
        inv, det = _inv3x3(bm)
        inv = torch.where((det == 0)[..., None, None], eye, inv)
        return inv.permute(0, 2, 3, 1).contiguous()     # [N, 3, 3, P]

    def matvec_lanes(self, esc: torch.Tensor, u: torch.Tensor
                     ) -> torch.Tensor:
        """A(u) per lane, with per-element Young's-modulus scales ``esc``
        [C, P], on ``u`` [N, 3, P]."""
        C, k = self.conn.shape
        N, P = u.shape[0], u.shape[-1]
        m = self._mask()
        u_e = (m * u).reshape(N, DIM * P)[self.conn].reshape(C, k, DIM, P)
        if self.ke0 is not None:
            # float32 cancellation control: rigid translations lie in Ke's
            # null space, so taking the element-mean displacement off each
            # component changes nothing exactly but shrinks the GEMM's
            # operands from |u| to |u - mean| ~ h |grad u|
            uc = (u_e - u_e.mean(dim=1, keepdim=True)).reshape(C, DIM * k, P)
            # the product lands in the scatter's source rows, whose last
            # row is the zero row the incidence table's padding points at
            rows = u.new_empty((C * k + 1, DIM * P))
            rows[-1].zero_()
            f_e = rows[:-1].view(C, DIM * k, P)
            torch.bmm(self.ke0, uc, out=f_e)
            f_e.mul_(esc[:, None, :])
            inc = self.plan.incidence
            f = rows.index_select(0, inc.reshape(-1)).reshape(
                N, inc.shape[1], DIM * P).sum(dim=1)
            return m * f.reshape(N, DIM, P) + (1.0 - m) * u
        lam0, mu0 = lame_parameters(1.0, self.nu)
        grad_u = torch.einsum("cqkb,ckap->cqabp", self.g, u_e)
        eps = 0.5 * (grad_u + grad_u.transpose(2, 3))
        tr = eps[:, :, 0, 0] + eps[:, :, 1, 1] + eps[:, :, 2, 2]
        eye = torch.eye(DIM, dtype=u.dtype, device=u.device)
        sigma = (lam0 * tr[:, :, None, None, :] * eye[..., None]
                 + 2.0 * mu0 * eps)
        w = self.wdet[:, :, None] * esc[:, None, :]      # [C, q, P]
        f_e = torch.einsum("cqp,cqabp,cqkb->ckap", w, sigma, self.g)
        f = self.plan.scatter_add(f_e.reshape(C, k, DIM * P))
        return m * f.reshape(N, DIM, P) + (1.0 - m) * u

    def diagonal_lanes(self, esc: torch.Tensor) -> torch.Tensor:
        """The constrained operator's diagonal per lane, [N, 3, P]."""
        lam0, mu0 = lame_parameters(1.0, self.nu)
        C, k = self.conn.shape
        g2 = self.g * self.g
        norm2 = g2.sum(dim=-1, keepdim=True)
        w = self.wdet[:, :, None] * esc[:, None, :]      # [C, q, P]
        d = (torch.einsum("cqp,cqka->ckap", w * (lam0 + mu0), g2)
             + torch.einsum("cqp,cqka->ckap", w * mu0,
                            norm2.expand_as(g2)))
        P = esc.shape[1]
        diag = self.plan.scatter_add(d.reshape(C, k, DIM * P)).reshape(
            -1, DIM, P)
        m = self._mask()
        return m * m * diag + (1.0 - m)

    # -- one lane, the JAX package's shapes: escale [C], u [ndof] -----------

    def block_jacobi(self, escale: torch.Tensor) -> torch.Tensor:
        """Inverted node blocks [N, 3, 3] of one lane."""
        return self.block_jacobi_lanes(escale[:, None])[..., 0]

    def matvec(self, escale: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """A(u) [ndof] of one lane with per-element scales ``escale``."""
        return self.matvec_lanes(escale[:, None],
                                 u.reshape(-1, DIM, 1)).reshape(-1)

    def diagonal(self, escale: torch.Tensor) -> torch.Tensor:
        return self.diagonal_lanes(escale[:, None]).reshape(-1)

    # -- sizing --------------------------------------------------------------

    def bytes_per_lane(self) -> int:
        """Device bytes one lane needs while the lanes iterate: the element
        temporaries of one operator apply, the scatter's gathered rows, the
        block inverses and the PCG vectors (float64 dot copies included)."""
        C, q, k, _ = self.g.shape
        N, D = self.plan.incidence.shape
        item = self.g.element_size()
        elem = (4 * DIM * k if self.ke0 is not None
                else 4 * q * DIM * DIM + 2 * k * DIM)
        words = C * (elem + 2) + N * D * (DIM + 1) + N * 27 + N * DIM * 8
        return int(words * item + N * DIM * 8 * 2)

    def lanes_that_fit(self) -> int:
        """Lanes one call may run at once: half the device's free memory
        (the host's available memory on the CPU) over
        :meth:`bytes_per_lane`."""
        if self.device.type == "cuda":
            free = torch.cuda.mem_get_info(self.device)[0]
        else:
            free = os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
        return max(1, int(_MEMORY_SHARE * free) // self.bytes_per_lane())


def solve_lanes(kernel: SweepKernel, esc: torch.Tensor, loads: torch.Tensor,
                tol: float, maxiter: int, return_u: bool = False):
    """Block-Jacobi PCG for P lanes at once.

    ``esc`` [C, P] per-element Young's-modulus scales, ``loads`` [N, 3, P].
    Returns (energies [P] float64, iterations [P], converged [P]) and the
    solutions [N, 3, P] if ``return_u``.  Each lane stops when
    ``it >= maxiter`` or ``|r| <= tol |r0| + tol`` (tested before every
    step, one host read per iteration); a non-converged lane is reported
    through its mask.  The energy is ``0.5 x . A(x)``.  Spans of the
    current timer: ``pcg`` (inside it each ``iter`` and its ``sync``, the
    active-lane count read back) and ``energy``."""
    dtype = loads.dtype
    P = loads.shape[-1]
    dev = loads.device
    m = kernel._mask()
    b = m * loads
    binv = kernel.block_jacobi_lanes(esc)

    def prec(r):
        return (binv * r[:, None]).sum(dim=2)

    r = b
    z = prec(r)
    p = z
    rz = _ldot(r, z)
    rn = torch.sqrt(_ldot(r, r))
    eps = tol * rn + tol
    x = torch.zeros_like(b)
    it = torch.zeros(P, dtype=torch.int64, device=dev)
    lanes = torch.arange(P, device=dev)
    x_out = torch.empty_like(b)
    it_out = torch.empty_like(it)
    rn_out = torch.empty_like(rn)
    eps_all = eps
    esc_run = esc
    with span("pcg"):
        while True:
            with span("iter"):
                active = (it < maxiter) & (rn > eps)
                with span("sync"):
                    n_active = int(active.sum())
                if n_active < lanes.numel():
                    stop = ~active
                    done = lanes[stop]
                    x_out[..., done] = x[..., stop]
                    it_out[done] = it[stop]
                    rn_out[done] = rn[stop]
                    if n_active == 0:
                        break
                    # keep the lanes still running only
                    x, r, p = x[..., active], r[..., active], p[..., active]
                    rz, rn = rz[active], rn[active]
                    eps, it = eps[active], it[active]
                    esc_run, binv = esc_run[:, active], binv[..., active]
                    lanes = lanes[active]
                Ap = kernel.matvec_lanes(esc_run, p)
                pAp = _ldot(p, Ap)
                alpha = (rz / torch.where(pAp == 0, 1.0, pAp)).to(dtype)
                x = x + alpha * p
                r = r - alpha * Ap
                z = prec(r)
                rz_n = _ldot(r, z)
                beta = (rz_n / torch.where(rz == 0, 1.0, rz)).to(dtype)
                p = z + beta * p
                rn = torch.sqrt(_ldot(r, r))
                rz = rz_n
                it = it + 1
    with span("energy"):
        energy = 0.5 * _ldot(x_out, kernel.matvec_lanes(esc, x_out))
    out = (energy, it_out, rn_out <= eps_all)
    return (*out, x_out) if return_u else out


def _as_lanes(kernel: SweepKernel, escales, loads):
    """[P, C] scales and [P, ndof] loads → [C, P] and [N, 3, P] tensors of
    the kernel's dtype on its device (a span ``upload``, as the pairs'
    gather in :func:`sweep_all_pairs`)."""
    with span("upload"):
        esc = torch.as_tensor(
            np.asarray(escales) if not torch.is_tensor(escales) else escales,
            dtype=kernel.dtype, device=kernel.device)
        f = torch.as_tensor(np.asarray(loads) if not torch.is_tensor(loads)
                            else loads, dtype=kernel.dtype,
                            device=kernel.device)
        P = f.shape[0]
        return (esc.t().contiguous(),
                f.reshape(P, -1, DIM).permute(1, 2, 0).contiguous())


def sweep_compliance(kernel: SweepKernel, escales, loads,
                     tol: float = 1e-6, maxiter: int = 5000,
                     return_u: bool = False):
    """Compliance for every (density i, load j) pair.

    ``escales`` [B, C] per-lane Young's-modulus scale fields (e.g.
    :func:`simp_scales`), ``loads`` [L, ndof].  Returns energies [B, L],
    iterations [B, L], converged [B, L] (and u [B, L, ndof] if
    ``return_u``), as tensors on the kernel's device."""
    B, L = escales.shape[0], loads.shape[0]
    idx_b = np.repeat(np.arange(B), L)
    idx_l = np.tile(np.arange(L), B)
    esc = escales[idx_b] if not torch.is_tensor(escales) \
        else escales[torch.as_tensor(idx_b, device=escales.device)]
    f = loads[idx_l] if not torch.is_tensor(loads) \
        else loads[torch.as_tensor(idx_l, device=loads.device)]
    out = solve_lanes(kernel, *_as_lanes(kernel, esc, f), tol, maxiter,
                      return_u)
    e, it, cv = (t.reshape(B, L) for t in out[:3])
    if return_u:
        u = out[3].permute(2, 0, 1).reshape(B, L, -1)
        return e, it, cv, u
    return e, it, cv


def sweep_compliance_pairs(kernel: SweepKernel, escales, loads,
                           tol: float = 1e-6, maxiter: int = 5000):
    """Compliance for explicit (density, load) pairs, one lane each:
    escales [P, C], loads [P, ndof] → energies, iterations, converged [P]."""
    return solve_lanes(kernel, *_as_lanes(kernel, escales, loads), tol,
                       maxiter)


def shard_sweep_inputs(device_mesh, escales, loads):
    """Split the density batch [B, C] over the ``data`` axis of
    ``device_mesh`` (a :class:`.sharding.DeviceMesh`) and place the loads
    [L, ndof] on each data shard's device: (escales parts, loads copies),
    one per data shard, in batch order.  Each part's lanes then run on
    their own device with no communication until the results are
    gathered."""
    devices = device_mesh.data_devices
    esc = torch.as_tensor(np.asarray(escales) if not torch.is_tensor(escales)
                          else escales)
    f = torch.as_tensor(np.asarray(loads) if not torch.is_tensor(loads)
                        else loads)
    return ([part.to(d) for part, d in zip(
                torch.tensor_split(esc, len(devices)), devices)],
            [f.to(d) for d in devices])


def sweep_all_pairs(kernel: SweepKernel, escales, loads,
                    tol: float = 1e-6, maxiter: int = 5000):
    """Every (density, load) pair of ``escales`` [B, C] × ``loads``
    [L, ndof] as one lane of the GEMM form, as many lanes a call as the
    kernel's device holds (:meth:`SweepKernel.lanes_that_fit`): energies,
    iterations, converged [B, L] as NumPy arrays."""
    B, L = escales.shape[0], loads.shape[0]
    P = B * L
    chunk = min(P, kernel.lanes_that_fit())
    bi, lj = np.divmod(np.arange(P), L)
    e_out, it_out, cv_out = (np.empty(P), np.empty(P, np.int64),
                             np.empty(P, bool))
    for c0 in range(0, P, chunk):
        sl = slice(c0, min(c0 + chunk, P))
        with span("upload"):
            esc_c, f_c = escales[bi[sl]], loads[lj[sl]]
        e, it, cv = sweep_compliance_pairs(kernel, esc_c, f_c, tol=tol,
                                           maxiter=maxiter)
        e_out[sl], it_out[sl], cv_out[sl] = (
            e.cpu().numpy(), it.cpu().numpy(), cv.cpu().numpy())
    return e_out.reshape(B, L), it_out.reshape(B, L), cv_out.reshape(B, L)


def run_on_devices(jobs: Sequence[Tuple[torch.device, Callable]]) -> List:
    """Run ``jobs`` [(device, fn)] and return their results in job order.
    The jobs of one device run in turn; each distinct device gets a host
    thread of its own, so the cards work at the same time (the lanes'
    loops wait on the card each iteration, and a waiting thread lets the
    others launch).  With one device the jobs run in this thread."""
    groups = {}
    for i, (d, _) in enumerate(jobs):
        groups.setdefault(d, []).append(i)
    out = [None] * len(jobs)

    def run(idx):
        d = jobs[idx[0]][0]
        with (torch.cuda.device(d) if d.type == "cuda"
              else contextlib.nullcontext()):
            for i in idx:
                out[i] = jobs[i][1]()

    if len(groups) <= 1:
        for idx in groups.values():
            run(idx)
        return out
    with ThreadPoolExecutor(len(groups)) as pool:
        for fut in [pool.submit(run, idx) for idx in groups.values()]:
            fut.result()
    return out


def simp_scales(material: SIMPMaterial, densities):
    """Density batch [B, C] → per-element Young's moduli E(rho) (the
    scales of the unit-E kernel)."""
    return material.youngs_modulus(densities)
