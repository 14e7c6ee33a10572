"""Block-ELL (BELL) multigrid for general meshes (counterpart of
``topopteval_tpu/fem/bell.py``; the names are the JAX package's).

The route of ``solve_system(preconditioner="multigrid")`` on any mesh
that is not a generated tet4 box: imported ``.vtu`` meshes, hex8 meshes,
materials that vary inside a hex.

- The fine operator is assembled once on the host into an explicit
  3x3-block sparse matrix with RCM-ordered nodes and applied by the
  block SpMV kernel of ops/bell.py on component-major [3, Np] vectors
  (Np = nodes padded to 128; padded rows are empty and fixed).
- The hierarchy is a voxel chain: fine nodes embed trilinearly into a
  voxel lattice over the bounding box, then 2:1 lattice coarsening;
  coarse operators are Galerkin products A_c = P^T A P on the host
  (scipy), transfers are scalar-weight matrices stored row-wise both ways
  (P over fine rows, R = P^T over coarse rows), applied by the transfer
  kernel of ops/bell.py.
- The build splits into a density-independent skeleton (structure, RCM,
  element gradients, the voxel chain and its coarse patterns) and a value
  pass per material, so a SIMP density swap on the same mesh and BCs
  reuses the skeleton (in-process RAM cache; disk cache opt-in).
- In float32 the system operator stores the float64 values as an fp32
  hi/lo pair (``BellMatrix.vals_lo``), the V-cycle copies hold bf16
  values, and ``BellSystem.matvec64`` (the exact fp64 scipy twin kept at
  build time) certifies residuals for mixed-precision refinement.

The build runs on the host in NumPy/scipy and uploads finished tensors.
Not ported: the monolithic build the JAX package falls back to (a
material with lam or mu <= 0, a skeleton over the byte budget, a coarse
pattern that deviates from the skeleton); those raise
``NotImplementedError`` naming ROADMAP Queue A item 6.  The JAX package's
native host library (element gradients, block values, scalar RAP) is not
used either: its NumPy/scipy fallbacks are this package's host build.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..mesh import Mesh, resolve_device
from ..ops.bell import (BlockCSR, bell_matvec, csr_arrays, pad_rows,
                        sell_matvec)
from .multigrid import MultigridPreconditioner

_SKEL_VERSION = 1     # bump to invalidate on-disk skeleton caches
_HIER_VERSION = 1     # bump to invalidate on-disk hierarchy caches
#: tag of the port's hierarchy files (the JAX package's have another format)
_HIER_FORMAT = "topopteval_tpu_torch.bell"

#: voxel spacing of the chain's first level over the mean node spacing
_COARSEN = 2.0
#: Chebyshev smoothing steps before and after the coarse correction
_NU = 2

#: largest skeleton (bytes of its block work arrays) the skeleton build
#: takes; the JAX package sends bigger meshes to its monolithic build
_SKEL_MAX_BYTES = 4.8e10
_NOT_PORTED = ("the monolithic block-ELL build is not ported yet (ROADMAP "
               "Queue A item 6)")


# ---------------------------------------------------------------------------
# Operators
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BellMatrix:
    """Constrained block-sparse operator on flat component-major vectors.

    Vectors are flat ``[3 * Np]`` views of ``[3, Np]``.  ``matvec``
    applies the Dirichlet-masked form ``m * A(m u) + (1 - m) u``, the
    algebra of :class:`..fem.operator.StiffnessOperator`.
    """

    A: BlockCSR                  # [Np, Np] 3x3 blocks
    free_mask: torch.Tensor      # [3*Np] flat component-major
    n_rows_p: int
    # Optional fp32 remainder of the fp64 values (vals64 - f32(vals64)):
    # with it matvec applies both planes, an operator whose entries are
    # fp64-accurate.  A rounded stored stiffness matrix is a biased
    # perturbation that breaks the element rigid-body invariants; on the
    # slender benchmark beam the JAX package measured fp32-only storage
    # shifting the energy by ~1 % at 35k DOFs (fem/bell.py:94-104 there).
    vals_lo: Optional[torch.Tensor] = None

    @property
    def n_dofs(self) -> int:
        return 3 * self.n_rows_p

    def matvec_raw(self, u: torch.Tensor) -> torch.Tensor:
        return bell_matvec(u.reshape(3, self.n_rows_p), self.A,
                           self.vals_lo).reshape(-1)

    def matvec(self, u: torch.Tensor) -> torch.Tensor:
        m = self.free_mask
        return m * self.matvec_raw(m * u) + (1.0 - m) * u

    def __call__(self, u):
        return self.matvec(u)

    def energy(self, u: torch.Tensor) -> torch.Tensor:
        return 0.5 * torch.dot(u.double(), self.matvec(u).double())


@dataclasses.dataclass(frozen=True)
class BellTransfer:
    """Prolongation/restriction pair, both stored row-wise over their own
    output space (gather-only): ``P`` maps coarse → fine, ``R`` (the
    transposed entries regrouped by coarse row) maps fine → coarse."""

    P: BlockCSR                  # [nf_p, nc_p] scalar weights
    R: BlockCSR                  # [nc_p, nf_p]

    def prolong(self, u_c: torch.Tensor) -> torch.Tensor:
        """[3, nc_p] → [3, nf_p]."""
        return sell_matvec(u_c, self.P)

    def restrict(self, r_f: torch.Tensor) -> torch.Tensor:
        """[3, nf_p] → [3, nc_p]."""
        return sell_matvec(r_f, self.R)


@dataclasses.dataclass(frozen=True)
class BellLevel:
    op: BellMatrix
    binv9: torch.Tensor           # [9, Np] inverted 3x3 node blocks, cm
    transfer: Optional[BellTransfer]
    lam_max: Optional[float] = None


def _binv_apply(binv9: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[9, Np] cm blocks × [3, Np] → [3, Np] (elementwise multiply-adds)."""
    return torch.stack([
        binv9[0] * v[0] + binv9[1] * v[1] + binv9[2] * v[2],
        binv9[3] * v[0] + binv9[4] * v[1] + binv9[5] * v[2],
        binv9[6] * v[0] + binv9[7] * v[1] + binv9[8] * v[2]])


@dataclasses.dataclass(frozen=True)
class BellMG(MultigridPreconditioner):
    """Component-major V-cycle over BELL levels: the recurrence, smoothers
    and coarse solve of :class:`..fem.multigrid.MultigridPreconditioner`
    (Chebyshev block-Jacobi smoothing + coarsest pseudo-inverse) on
    ``[3, Np]`` vectors.  Drop-in ``M`` for :func:`..fem.solvers.cg` on
    flat component-major vectors."""

    smoother: str = "chebyshev"

    def _shape(self, r):
        return r.reshape(3, -1)

    def _mask(self, L):
        return L.op.free_mask.reshape(3, -1)

    def _binv(self, L, v):
        return _binv_apply(L.binv9, v)


class BellSystem:
    """The fine BELL operator plus interleaved↔component-major converters.

    The public API speaks the interleaved DOF layout (``3*node + comp``);
    the BELL route runs RCM-permuted component-major.  This wrapper owns
    the permutation and the exact fp64 host twin of the fine operator.
    """

    layout = "cm"
    dmesh = None

    def __init__(self, matrix: BellMatrix, perm: np.ndarray, n_nodes: int,
                 dtype, host_bsr: dict):
        self.matrix = matrix
        self.perm = np.asarray(perm, np.int64)        # new pos -> old node
        self.n_nodes = int(n_nodes)
        self.dtype = dtype
        #: fp64 scipy BSR arrays (indptr, indices, data) of the fine
        #: operator, unmasked, over the n_nodes real rows
        self.host_bsr = host_bsr
        self._csr64 = None
        #: host seconds spent in matvec64 (the refinement's residuals)
        self.matvec_seconds = 0.0
        self.build_seconds = 0.0

    @property
    def free_mask(self):
        return self.matrix.free_mask

    @property
    def n_dofs(self):
        return self.matrix.n_dofs

    @property
    def device(self):
        return self.free_mask.device

    def matvec(self, u):
        return self.matrix.matvec(u)

    def energy(self, u):
        return self.matrix.energy(u)

    # ---- exact fp64 host matvec (the refinement's residual oracle) ------
    # The stored hi/lo planes sum to the fp64 assembly, but the fp32
    # device matvec's rounding noise (~eps32·‖K‖·‖u‖) drowns the
    # low-eigenmode residual of a slender beam; refinement with this fp64
    # residual recovers it pass by pass.

    def _host_csr64(self):
        if self._csr64 is None:
            import scipy.sparse as sp
            Np = self.matrix.n_rows_p
            hb = self.host_bsr
            indptr = np.asarray(hb["indptr"], np.int64)
            indptr_p = np.concatenate(
                [indptr, np.full(Np + 1 - len(indptr), indptr[-1])])
            K = sp.bsr_matrix(
                (np.asarray(hb["data"], np.float64).reshape(-1, 3, 3),
                 np.asarray(hb["indices"], np.int64), indptr_p),
                shape=(3 * Np, 3 * Np))
            mask = self.free_mask.double().cpu().numpy()
            self._csr64 = (K, mask)
        return self._csr64

    def matvec64(self, x64: np.ndarray) -> np.ndarray:
        """Constrained fp64 matvec on the host (flat cm vector)."""
        t0 = time.perf_counter()
        K, m = self._host_csr64()
        Np = self.matrix.n_rows_p
        u_nm = (m * x64).reshape(3, Np).T.reshape(-1)
        out = (K @ u_nm).reshape(Np, 3).T.reshape(-1)
        y = m * out + (1.0 - m) * x64
        self.matvec_seconds += time.perf_counter() - t0
        return y

    # layout converters (host)
    def to_cm(self, vec_il: np.ndarray) -> np.ndarray:
        v = np.zeros((3, self.matrix.n_rows_p))
        v[:, : self.n_nodes] = np.asarray(vec_il, np.float64) \
            .reshape(-1, 3)[self.perm].T
        return v.reshape(-1)

    def to_il(self, u_cm) -> np.ndarray:
        u2 = np.asarray(u_cm, np.float64).reshape(
            3, self.matrix.n_rows_p)[:, : self.n_nodes].T   # [N,3] permuted
        out = np.empty_like(u2)
        out[self.perm] = u2
        return out.reshape(-1)


# ---------------------------------------------------------------------------
# Host helpers (fp64 NumPy)
# ---------------------------------------------------------------------------


def rcm_order(rows, cols, n_nodes: int) -> np.ndarray:
    """Bandwidth-minimizing node ordering (perm: new pos -> old node)."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee
    G = sp.csr_matrix((np.ones(len(rows), np.int8), (rows, cols)),
                      shape=(n_nodes, n_nodes))
    return np.asarray(reverse_cuthill_mckee(G, symmetric_mode=True),
                      np.int64)


def _block_jacobi_inv(diag: np.ndarray, mask3: np.ndarray) -> np.ndarray:
    """Inverted masked diagonal blocks (fixed comps get identity)."""
    eye = np.eye(3)
    bm = (diag * (mask3[:, :, None] * mask3[:, None, :])
          + (1.0 - mask3)[:, :, None] * eye)
    det = np.linalg.det(bm)
    bm[det == 0] = eye
    return np.linalg.inv(bm)


def _binv9_cm(binv: np.ndarray, n_rows_p: int, dtype) -> np.ndarray:
    """[N, 3, 3] → [9, Np] component-major host array."""
    N = binv.shape[0]
    out = np.zeros((9, n_rows_p))
    out[:, :N] = binv.reshape(N, 9).T
    return out.astype(_np_dtype(dtype))


def _power_lambda_max(A_bsr, binv: np.ndarray, mask: np.ndarray,
                      iters: int = 30, seed: int = 0,
                      inflate: float = 1.1) -> float:
    """Upper estimate of lambda_max(B^-1 A') by host power iteration
    (same seed, iterations and inflation as the JAX package, so the
    Chebyshev bands are identical)."""
    N = binv.shape[0]
    m = np.asarray(mask, np.float64).reshape(-1)
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(3 * N) * m
    v /= np.linalg.norm(v)
    lam = 1.0
    for _ in range(iters):
        Av = m * (A_bsr @ (m * v)) + (1.0 - m) * v
        w = np.einsum("nab,nb->na", binv, Av.reshape(N, 3),
                      optimize=True).reshape(-1)
        lam = float(np.linalg.norm(w))
        v = w / max(lam, 1e-300)
    return inflate * lam


def _mask_cm_flat(mask_il: np.ndarray, n_rows_p: int, dtype) -> np.ndarray:
    """Interleaved [3N] mask → flat cm [3*Np] host array.  Padded rows are
    FIXED: their identity rows keep the operator SPD on the padded space
    and never couple to real components."""
    N = len(mask_il) // 3
    out = np.zeros((3, n_rows_p))
    out[:, :N] = np.asarray(mask_il, np.float64).reshape(N, 3).T
    return out.reshape(-1).astype(_np_dtype(dtype))


def _np_dtype(dtype):
    return {torch.float32: np.float32, torch.float64: np.float64}[dtype]


def _narrow_smoother_levels(levels, smoother_dtype):
    """Downcast V-cycle level operator values and transfer weights to
    ``smoother_dtype`` (bf16 for fp32 problems, :func:`_smoother_dtype`).

    They shape only the preconditioner: the CG fixed point is owned by
    the fp32 hi/lo system operator and the fp64 refinement residuals, so
    halving their bytes costs a few iterations at most while the V-cycle
    moves half the data.  The kernels widen them at multiply time; block
    inverses and the dense coarse inverse stay at solve precision."""
    if smoother_dtype is None:
        return levels
    out = []
    for lvl in levels:
        A = lvl.op.A
        op = dataclasses.replace(
            lvl.op, A=A.with_vals(A.vals.to(smoother_dtype)))
        t = lvl.transfer
        if t is not None:
            t = BellTransfer(t.P.with_vals(t.P.vals.to(smoother_dtype)),
                             t.R.with_vals(t.R.vals.to(smoother_dtype)))
        out.append(dataclasses.replace(lvl, op=op, transfer=t))
    return out


def _smoother_dtype(dtype):
    """The V-cycle copies' value dtype: bf16 under float32 problems, the
    solve dtype otherwise (``None``: no narrowing)."""
    return torch.bfloat16 if dtype == torch.float32 else None


def _coarse_pinv_cm(K_c_dense: np.ndarray, mask_cur: np.ndarray,
                    n_cur: int, Npc: int, dtype) -> np.ndarray:
    """Masked eigencutoff pseudo-inverse of the coarsest operator,
    scattered into the padded cm index space (host array).  The gap-based
    cut of ``coarse_pinv_weights`` keeps the slender beam's bending modes,
    which a fixed cutoff would zero."""
    from .multigrid import coarse_pinv_weights
    m_c = mask_cur
    K_c = (m_c[:, None] * K_c_dense * m_c[None, :] + np.diag(1.0 - m_c))
    K_c = 0.5 * (K_c + K_c.T)
    evals, evecs = np.linalg.eigh(K_c)
    inv_e = coarse_pinv_weights(evals, dtype)
    inv_il = (evecs * inv_e) @ evecs.T
    inv_il = m_c[:, None] * inv_il * m_c[None, :]
    # cm index = a*Npc + n
    cm_idx = (np.arange(3 * n_cur).reshape(n_cur, 3) // 3
              + (np.arange(3)[None, :]) * Npc).reshape(-1)
    inv_cm = np.zeros((3 * Npc, 3 * Npc))
    inv_cm[np.ix_(cm_idx, cm_idx)] = inv_il
    return inv_cm.astype(_np_dtype(dtype))


# ---------------------------------------------------------------------------
# Hierarchy from host arrays (build, disk cache and carried-over state all
# end here)
# ---------------------------------------------------------------------------


def _pad_indptr(indptr: np.ndarray, n_rows_p: int) -> np.ndarray:
    indptr = np.asarray(indptr, np.int64)
    return np.concatenate([indptr, np.full(n_rows_p + 1 - len(indptr),
                                           indptr[-1])])


def _from_host(host: dict, dtype, device) -> Tuple[BellSystem, BellMG]:
    """(system, mg) on ``device`` from the host arrays of a hierarchy (the
    keys :func:`save_hierarchy` writes)."""
    device = resolve_device(device)

    def t(a, dt=dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                               device=device)

    n_levels = int(host["n_levels"])
    Np = [len(host[f"L{i}_indptr"]) - 1 for i in range(n_levels)]
    Np.append(host["coarse_inv"].shape[0] // 3)
    levels = []
    for i in range(n_levels):
        A = BlockCSR.from_numpy(host[f"L{i}_indptr"], host[f"L{i}_cols"],
                                host[f"L{i}_vals"], Np[i], dtype, device)
        op = BellMatrix(A, t(host[f"L{i}_mask"]), Np[i])
        transfer = BellTransfer(
            BlockCSR.from_numpy(host[f"L{i}_p_indptr"], host[f"L{i}_p_cols"],
                                host[f"L{i}_p_w"], Np[i + 1], dtype, device),
            BlockCSR.from_numpy(host[f"L{i}_r_indptr"], host[f"L{i}_r_cols"],
                                host[f"L{i}_r_w"], Np[i], dtype, device))
        lam = float(host[f"L{i}_lam_max"])
        levels.append(BellLevel(op, t(host[f"L{i}_binv9"]), transfer,
                                None if np.isnan(lam) else lam))
    # the system operator keeps full solve precision (and the lo plane);
    # only the V-cycle copies narrow
    fine = levels[0].op
    if "fine_vals_lo" in host:
        fine = dataclasses.replace(fine, vals_lo=t(host["fine_vals_lo"]))
    levels = _narrow_smoother_levels(levels, _smoother_dtype(dtype))
    mg = BellMG(tuple(levels), t(host["coarse_inv"]), nu=int(host["nu"]),
                smoother=str(host["smoother"]))
    system = BellSystem(fine, host["perm"], int(host["n_nodes"]), dtype,
                        {"indptr": host["hb_indptr"],
                         "indices": host["hb_indices"],
                         "data": host["hb_data"]})
    return system, mg


def bell_from_numpy(arrays, dtype, device="cuda"
                    ) -> Tuple[BellSystem, BellMG]:
    """The port's (system, mg) from a hierarchy in the JAX package's
    ``save_hierarchy`` format (an opened ``.npz`` or a dict with its keys:
    ``perm``, ``n_nodes``, ``nu``, ``n_levels``, ``smoother``,
    ``coarse_inv``, ``L{i}_cols2/vals2/cmeta/mask/binv9/lam_max/meta``,
    ``L{i}_t_*``, ``fine_vals2_lo``, ``hb_*``), so both packages can run
    one and the same hierarchy.

    The chunk-aligned slots are re-packed into block-CSR; pad slots (all
    values zero, in both planes for the fine operator) are dropped, as the
    JAX package's ``_host_csr64`` does."""

    def ell_rows(cols2, planes, S, Np, width):
        """Aligned ELL planes → (indptr, cols, vals) of the real slots."""
        Nt = Np // 128
        cols = np.asarray(cols2).reshape(Nt, S, 128).transpose(0, 2, 1) \
            .reshape(Np, S)
        vals = [np.asarray(p, np.float64).reshape(Nt, width, S, 128)
                .transpose(0, 3, 2, 1).reshape(Np, S, width)
                for p in planes]
        live = np.zeros((Np, S), bool)
        for v in vals:
            live |= np.abs(v).max(axis=-1) != 0.0
        rows = np.repeat(np.arange(Np), S).reshape(Np, S)[live]
        indptr, cols, data = csr_arrays(
            rows, cols[live], np.concatenate([v[live] for v in vals], 1), Np)
        return indptr, cols, [data[:, k * width:(k + 1) * width]
                              for k in range(len(vals))]

    np_dt = _np_dtype(dtype)
    n_levels = int(arrays["n_levels"])
    host = {"perm": np.asarray(arrays["perm"], np.int64),
            "n_nodes": int(arrays["n_nodes"]), "nu": int(arrays["nu"]),
            "n_levels": n_levels,
            "smoother": bytes(arrays["smoother"]).decode(),
            "coarse_inv": np.asarray(arrays["coarse_inv"], np_dt),
            "hb_indptr": np.asarray(arrays["hb_indptr"]),
            "hb_indices": np.asarray(arrays["hb_indices"]),
            "hb_data": np.asarray(arrays["hb_data"], np.float64)}
    for i in range(n_levels):
        S, Np = (int(x) for x in arrays[f"L{i}_meta"])
        planes = [arrays[f"L{i}_vals2"]]
        if i == 0 and "fine_vals2_lo" in arrays:
            planes.append(arrays["fine_vals2_lo"])
        indptr, cols, vals = ell_rows(arrays[f"L{i}_cols2"], planes, S, Np,
                                      9)
        host[f"L{i}_indptr"], host[f"L{i}_cols"] = indptr, cols
        host[f"L{i}_vals"] = vals[0].astype(np_dt)
        if len(vals) > 1:
            host["fine_vals_lo"] = vals[1].astype(np_dt)
        host[f"L{i}_mask"] = np.asarray(arrays[f"L{i}_mask"], np_dt)
        host[f"L{i}_binv9"] = np.asarray(arrays[f"L{i}_binv9"], np_dt)
        host[f"L{i}_lam_max"] = float(arrays[f"L{i}_lam_max"])
        pS, rS, nf_p, nc_p = (int(x) for x in arrays[f"L{i}_t_meta"])
        for tag, S_t, n in (("p", pS, nf_p), ("r", rS, nc_p)):
            indptr, cols, w = ell_rows(arrays[f"L{i}_t_{tag}cols"],
                                       [arrays[f"L{i}_t_{tag}w"]], S_t, n, 1)
            host[f"L{i}_{tag}_indptr"] = indptr
            host[f"L{i}_{tag}_cols"] = cols
            host[f"L{i}_{tag}_w"] = w[0][:, 0].astype(np_dt)
    return _from_host(host, dtype, device)


# ---------------------------------------------------------------------------
# Skeleton: the density-independent part of the hierarchy
# ---------------------------------------------------------------------------


class SkeletonMismatch(RuntimeError):
    """Coarse pattern from the value pass disagrees with the skeleton
    (should be impossible for s_e > 0 materials)."""


def build_bell_skeleton(mesh: Mesh,
                        free_mask: Optional[np.ndarray] = None,
                        order: int = 2,
                        max_coarse_dofs: int = 4000) -> dict:
    """Density-independent hierarchy skeleton for a solid mesh.

    Contains the RCM permutation; the element gradients and the sorted
    (element, local ij) contribution list that re-assemble the block
    values of any material (:func:`_skel_blocks`); the fine block-CSR
    structure; the voxel transfer chain (values included: transfers are
    geometric); per-level coarse patterns and masks; the P/P^T DOF
    matrices for the numeric Galerkin RAP.  A flat numpy dict, .npz-able
    via :func:`save_skeleton`.
    """
    import scipy.sparse as sp

    from ..ops.elements import element_tables
    from .multigrid import (build_transfer_tables, build_voxel_transfer,
                            propagate_fixed)

    t_all = time.perf_counter()
    phases = {}

    def tick(label, t0):
        phases[label] = round(time.perf_counter() - t0, 3)
        return time.perf_counter()

    C, k = mesh.conn.shape
    N = mesh.n_nodes
    if free_mask is None:
        free_mask = np.ones(mesh.n_dofs)
    mask_il = np.asarray(free_mask, np.float64).reshape(-1)

    # --- raw contribution structure + RCM ------------------------------------
    t0 = time.perf_counter()
    conn64 = np.asarray(mesh.conn, np.int64)
    r_raw = np.repeat(conn64, k, axis=1).reshape(-1)       # [C*k*k]
    c_raw = np.tile(conn64, (1, k)).reshape(-1)
    nnz_raw = r_raw.shape[0]
    key0 = r_raw * N + c_raw
    del r_raw, c_raw
    # groups are key-equality classes; each contribution carries its own
    # element and local index, so the order inside a group is free
    order0 = np.argsort(key0)
    key_s = key0[order0]
    newg = np.ones(nnz_raw, bool)
    np.not_equal(key_s[1:], key_s[:-1], out=newg[1:])
    starts0 = np.flatnonzero(newg)
    grp_s = np.cumsum(newg) - 1                            # sorted order
    rank_s = np.arange(nnz_raw) - starts0[grp_s]
    len_g = np.diff(np.append(starts0, nnz_raw))
    rows_d0 = key_s[starts0] // N
    cols_d0 = key_s[starts0] % N
    nnzb = len(starts0)
    grp_raw = np.empty(nnz_raw, np.int64)
    grp_raw[order0] = grp_s
    rank_raw = np.empty(nnz_raw, np.int64)
    rank_raw[order0] = rank_s
    del key0, order0, key_s, newg, grp_s, rank_s, starts0
    t0 = tick("structure_sort", t0)

    perm = rcm_order(rows_d0, cols_d0, N)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(N)
    rp, cp = inv[rows_d0], inv[cols_d0]
    g_order = np.lexsort((cp, rp))          # dedup groups, final order
    rows_d = rp[g_order]
    cols_d = cp[g_order]
    g_rank = np.empty(nnzb, np.int64)
    g_rank[g_order] = np.arange(nnzb)       # old group -> new position
    len_new = len_g[g_order]
    starts_new = np.zeros(nnzb, np.int64)
    np.cumsum(len_new[:-1], out=starts_new[1:])
    mask_p = mask_il.reshape(N, 3)[perm].reshape(-1)
    t0 = tick("rcm_permute", t0)

    # --- sorted contribution list + gradient-factorized element data ---------
    # Every contribution block factorizes through the physical gradients
    #   Kl[i,j](a,b) = sum_q wdet_q g_qi[a] g_qj[b]
    #   Km[i,j](a,b) = sum_q wdet_q (g_qi[b] g_qj[a] + (a==b) g_qi.g_qj)
    # so the skeleton stores g and wdet plus the sorted contribution list,
    # not expanded per-contribution planes.
    base2 = starts_new[g_rank[grp_raw]] + rank_raw     # [nnz_raw] sorted
    del grp_raw, rank_raw
    elem_sorted = np.empty(nnz_raw, np.int32)
    elem_sorted[base2] = np.repeat(np.arange(C, dtype=np.int32), k * k)
    ij_sorted = np.empty(nnz_raw, np.uint16)
    ij_sorted[base2] = np.tile(np.arange(k * k, dtype=np.uint16), C)
    grp_indptr = np.append(starts_new, nnz_raw).astype(np.int64)
    del base2
    t0 = tick("csr_structure", t0)

    _, dN_t, w_t = element_tables(
        mesh.element_type, 1 if mesh.element_type == "tet4" else order)
    dN_t = np.asarray(dN_t, np.float64)
    w_t = np.asarray(w_t, np.float64)
    nqp = dN_t.shape[0]
    g_el = np.empty((C, nqp, k, 3))
    wdet_el = np.empty((C, nqp))
    _host_gradients(mesh, dN_t, w_t, g_el, wdet_el)
    t0 = tick("unit_assembly", t0)

    sel = rows_d == cols_d
    bsr_indptr = np.zeros(N + 1, np.int64)
    np.cumsum(np.bincount(rows_d, minlength=N), out=bsr_indptr[1:])
    skel = {
        "version": np.int64(_SKEL_VERSION),
        "n_nodes": np.int64(N), "n_cells": np.int64(C),
        "order": np.int64(order),
        "perm": perm,
        "mask_p": mask_p,
        "g": g_el, "wdet": wdet_el, "k_nodes": np.int64(k),
        "elem_sorted": elem_sorted, "ij_sorted": ij_sorted,
        "grp_indptr": grp_indptr,
        "rows_d": rows_d.astype(np.int32),
        "cols_d": cols_d.astype(np.int32),
        "bsr_indptr": bsr_indptr,
        "diag_pos": np.flatnonzero(sel),
        "diag_rows": rows_d[sel].astype(np.int32),
    }

    # --- unit operator (pattern source for the level chain) ------------------
    ones = np.ones(C)
    A_unit = sp.bsr_matrix((_skel_blocks(skel, ones, ones).reshape(-1, 3, 3),
                            cols_d.astype(np.int64), bsr_indptr),
                           shape=(3 * N, 3 * N))
    t0 = tick("unit_operator", t0)

    # --- voxel lattice dims ---------------------------------------------------
    lo, hi = mesh.bounding_box()
    extent = np.maximum(np.asarray(hi) - np.asarray(lo), 1e-300)
    coords_p = np.asarray(mesh.coords, np.float64)[perm]
    h = _COARSEN * (float(np.prod(extent)) / max(N, 1)) ** (1.0 / 3.0)
    dims0 = np.maximum(np.round(extent / h).astype(int), 1)

    def rounded(L):
        f = 2 ** (L - 1)
        dr = ((dims0 + f - 1) // f) * f
        return dr, 3 * int(np.prod(dr // f + 1))

    L = 1
    while True:
        dims_r, ndc = rounded(L)
        if ndc <= max_coarse_dofs or L >= 12:
            break
        L += 1
    if ndc > max_coarse_dofs:
        raise ValueError(
            f"coarsest voxel level has {ndc} dofs > max_coarse_dofs="
            f"{max_coarse_dofs}")
    vx, vy, vz = (int(x) for x in dims_r)
    skel["n_chain"] = np.int64(L)

    # --- level chain structure (patterns from the UNIT operator, no value
    # pruning, so the pattern holds for every s_e > 0 material) --------------
    A_cur = A_unit
    mask_cur = mask_p
    n_cur = N
    lattice_dims = (vx, vy, vz)
    for li in range(L):
        if li == 0:
            parents, weights, _ = build_voxel_transfer(
                coords_p, lo, hi, lattice_dims)
        else:
            cnx, cny, cnz = lattice_dims
            parents, weights, _ = build_transfer_tables(cnx, cny, cnz)
            lattice_dims = (cnx // 2, cny // 2, cnz // 2)
            parents = parents[prev_lattice_perm]
            weights = weights[prev_lattice_perm]
        cnx2, cny2, cnz2 = lattice_dims if li else (vx, vy, vz)
        n_next = (cnx2 + 1) * (cny2 + 1) * (cnz2 + 1)

        live = (weights > 0) & (parents < n_next)
        p_rows = np.repeat(np.arange(parents.shape[0]),
                           parents.shape[1]).reshape(parents.shape)[live]
        p_cols = parents[live].astype(np.int64)
        p_w = weights[live]

        fixed_c = propagate_fixed(parents, weights,
                                  mask_cur.reshape(-1, 3) == 0, n_next)
        mask_next_lat = np.where(fixed_c, 0.0, 1.0).reshape(-1)

        # children-order coarse permutation: coarse nodes numbered by their
        # first fine child, so both transfers gather from nearby rows
        keys = np.full(n_next, np.iinfo(np.int64).max)
        np.minimum.at(keys, p_cols, p_rows)
        perm_c = np.argsort(keys, kind="stable")
        inv_c = np.empty_like(perm_c)
        inv_c[perm_c] = np.arange(n_next)
        p_cols = inv_c[p_cols]
        prev_lattice_perm = perm_c
        mask_next = mask_next_lat.reshape(n_next, 3)[perm_c].reshape(-1)

        # P in final coarse order, as a scalar matrix and as 3x3 blocks
        # (w * I3) for the blockwise Galerkin products
        P_node = sp.coo_matrix((p_w, (p_rows, p_cols)),
                               shape=(n_cur, n_next)).tocsr()
        P_node.sort_indices()
        PT_node = P_node.T.tocsr()
        PT_node.sort_indices()
        P_dof = sp.kron(P_node, sp.eye(3), format="csr").tobsr((3, 3))
        PT_dof = sp.kron(PT_node, sp.eye(3), format="csr").tobsr((3, 3))
        A_next = PT_dof @ (A_cur @ P_dof)
        A_next.sort_indices()
        # empty-diagonal dofs (voxel corners supporting no fine node): unit
        # values are sums of PSD element contributions, so a unit zero
        # diagonal is zero for EVERY s_e > 0 material
        d = A_next.diagonal()
        mask_next[d <= 0] = 0.0

        Ab = A_next
        nb = Ab.indptr.shape[0] - 1
        rows_c = np.repeat(np.arange(nb), Ab.indptr[1:] - Ab.indptr[:-1])
        sel_c = rows_c == Ab.indices
        indptr_c = np.zeros(n_next + 1, np.int64)
        indptr_c[:nb + 1] = Ab.indptr
        indptr_c[nb + 1:] = Ab.indptr[-1]

        skel.update({
            f"P{li}_indptr": P_dof.indptr.astype(np.int64),
            f"P{li}_indices": P_dof.indices.astype(np.int32),
            f"P{li}_data": P_dof.data,
            f"PT{li}_indptr": PT_dof.indptr.astype(np.int64),
            f"PT{li}_indices": PT_dof.indices.astype(np.int32),
            f"PT{li}_data": PT_dof.data,
            # the transfers themselves: row-wise scalar CSRs both ways
            f"Pn{li}_indptr": P_node.indptr.astype(np.int64),
            f"Pn{li}_indices": P_node.indices.astype(np.int32),
            f"Pn{li}_data": P_node.data,
            f"PTn{li}_indptr": PT_node.indptr.astype(np.int64),
            f"PTn{li}_indices": PT_node.indices.astype(np.int32),
            f"PTn{li}_data": PT_node.data,
            f"C{li}_n": np.int64(n_next),
            f"C{li}_cols_d": Ab.indices.astype(np.int32),
            f"C{li}_bsr_indptr": indptr_c,
            f"C{li}_diag_pos": np.flatnonzero(sel_c),
            f"C{li}_diag_rows": rows_c[sel_c].astype(np.int32),
            f"C{li}_mask": mask_next,
        })
        A_cur = A_next
        mask_cur = mask_next
        n_cur = n_next
    t0 = tick("level_chain", t0)

    skel["_phases"] = phases
    skel["skeleton_seconds"] = np.float64(
        round(time.perf_counter() - t_all, 3))
    return skel


def _host_gradients(mesh: Mesh, dN_t: np.ndarray, w_t: np.ndarray,
                    g_out: np.ndarray, wdet_out: np.ndarray,
                    chunk: int = 131072) -> None:
    """Physical gradients g [C, q, k, 3] and weights w*det [C, q] (an
    identity Jacobian and zero weight for degenerate cells)."""
    conn = np.asarray(mesh.conn)
    coords = np.asarray(mesh.coords, np.float64)
    C = conn.shape[0]
    for c0 in range(0, C, chunk):
        cn = conn[c0:c0 + chunk]
        x = coords[cn]                                  # [cc, k, 3]
        J = np.einsum("cka,qkb->cqab", x, dN_t)
        det = np.linalg.det(J)
        ghost = det == 0.0
        if ghost.any():
            J = J.copy()
            J[ghost] = np.eye(3)
        Ji = np.linalg.inv(J)
        g_out[c0:c0 + chunk] = np.einsum("qkb,cqba->cqka", dN_t, Ji)
        wdet_out[c0:c0 + chunk] = det * w_t[None, :]


def _skel_blocks(skel: dict, lam_e: np.ndarray,
                 mu_e: np.ndarray) -> np.ndarray:
    """Deduplicated global block values [nnzb, 9] for a material: the
    whole re-assembly of a density swap (reference semantics:
    assemble_stiffness_matrix_simp!, FiniteElementAnalysis.jl:654-707,
    without materializing K)."""
    g = skel["g"]
    wdet = skel["wdet"]
    elem = skel["elem_sorted"]
    ij = skel["ij_sorted"]
    indptr = skel["grp_indptr"]
    k = int(skel["k_nodes"])
    nnzb = indptr.shape[0] - 1
    out = np.empty((nnzb, 9))
    eye = np.eye(3).reshape(9)
    b0 = 0
    step = 4_000_000
    while b0 < nnzb:
        b1 = int(np.searchsorted(indptr, indptr[b0] + step, "left"))
        b1 = min(max(b1, b0 + 1), nnzb)
        t0, t1 = int(indptr[b0]), int(indptr[b1])
        e = elem[t0:t1]
        i = (ij[t0:t1] // k).astype(np.int64)
        j = (ij[t0:t1] % k).astype(np.int64)
        wd = wdet[e]                                    # [t, q]
        gi = g[e, :, i, :]                              # [t, q, 3]
        gj = g[e, :, j, :]
        kl = np.einsum("tq,tqa,tqb->tab", wd, gi, gj)
        km = kl.transpose(0, 2, 1).copy()               # wd * gi[b] * gj[a]
        dot = np.einsum("tq,tqa,tqa->t", wd, gi, gj)
        vals = (lam_e[e][:, None] * kl.reshape(-1, 9)
                + mu_e[e][:, None] * (km.reshape(-1, 9)
                                      + dot[:, None] * eye[None, :]))
        out[b0:b1] = np.add.reduceat(
            vals, (indptr[b0:b1] - t0).astype(np.int64), axis=0)
        b0 = b1
    return out


# ---------------------------------------------------------------------------
# Value pass: the hierarchy for one material on a skeleton
# ---------------------------------------------------------------------------


def build_bell_values(skel: dict, lam, mu, dtype=torch.float32,
                      device="cuda") -> Tuple[BellSystem, BellMG, dict]:
    """Hierarchy values for a material on a prebuilt skeleton: the block
    values re-assembled from the gradient factorization, the numeric
    Galerkin RAP chain on the frozen patterns, block-Jacobi inverses,
    Chebyshev bounds and the coarsest pseudo-inverse.  Returns
    ``(system, mg, info)``; ``info["host_arrays"]`` holds the host arrays
    :func:`save_hierarchy` writes."""
    import scipy.sparse as sp

    t_all = time.perf_counter()
    info = {"phases": {}}

    def tick(label, t0):
        info["phases"][label] = round(time.perf_counter() - t0, 3)
        return time.perf_counter()

    np_dt = _np_dtype(dtype)
    N = int(skel["n_nodes"])
    C = int(skel["n_cells"])
    L = int(skel["n_chain"])
    lam_e = np.ascontiguousarray(
        np.broadcast_to(np.asarray(lam, np.float64), (C,)))
    mu_e = np.ascontiguousarray(
        np.broadcast_to(np.asarray(mu, np.float64), (C,)))
    mask_p = skel["mask_p"]
    cols_d = skel["cols_d"]

    # --- re-assembly from the gradient factorization --------------------------
    t0 = time.perf_counter()
    blocks = _skel_blocks(skel, lam_e, mu_e)
    t0 = tick("values_matvec", t0)

    # --- fine operator (hi/lo split for fp32) ---------------------------------
    n_rows_p = pad_rows(N)
    host = {"perm": skel["perm"].astype(np.int64), "n_nodes": N,
            "nu": _NU, "smoother": "chebyshev", "n_levels": L,
            "L0_indptr": _pad_indptr(skel["bsr_indptr"], n_rows_p),
            "L0_cols": cols_d}
    if np_dt == np.float32:
        hi = blocks.astype(np.float32)
        host["L0_vals"] = hi
        host["fine_vals_lo"] = (blocks - hi).astype(np.float32)
    else:
        host["L0_vals"] = blocks
    host["L0_mask"] = _mask_cm_flat(mask_p, n_rows_p, dtype)

    diag = np.zeros((N, 3, 3))
    diag[skel["diag_rows"]] = blocks[skel["diag_pos"]].reshape(-1, 3, 3)
    binv = _block_jacobi_inv(diag, mask_p.reshape(N, 3))
    host["L0_binv9"] = _binv9_cm(binv, n_rows_p, dtype)
    A_bsr = sp.bsr_matrix(
        (blocks.reshape(-1, 3, 3), cols_d.astype(np.int64),
         skel["bsr_indptr"]), shape=(3 * N, 3 * N))
    # 12 power iterations + 20 % inflation: the Chebyshev band needs an
    # upper bound and power iteration converges from below
    host["L0_lam_max"] = _power_lambda_max(A_bsr, binv, mask_p, iters=12,
                                           inflate=1.2)
    host["hb_indptr"] = A_bsr.indptr
    host["hb_indices"] = A_bsr.indices
    host["hb_data"] = A_bsr.data.reshape(-1, 9)
    t0 = tick("fine_binv_lam_max", t0)

    # --- numeric RAP chain on the frozen pattern (blockwise products) --------
    A_cur = A_bsr
    mask_cur = mask_p
    n_cur = N
    for li in range(L):
        n_next = int(skel[f"C{li}_n"])
        nf_p, nc_p = pad_rows(n_cur), pad_rows(n_next)
        cols_c = skel[f"C{li}_cols_d"]
        P_dof = sp.bsr_matrix(
            (skel[f"P{li}_data"], skel[f"P{li}_indices"],
             skel[f"P{li}_indptr"]),
            shape=(3 * n_cur, 3 * n_next), copy=False)
        PT_dof = sp.bsr_matrix(
            (skel[f"PT{li}_data"], skel[f"PT{li}_indices"],
             skel[f"PT{li}_indptr"]),
            shape=(3 * n_next, 3 * n_cur), copy=False)
        A_next = PT_dof @ (A_cur @ P_dof)
        A_next.sort_indices()
        if (A_next.indices.shape[0] != cols_c.shape[0]
                or not np.array_equal(A_next.indices, cols_c)):
            raise SkeletonMismatch(
                f"level {li + 1} coarse pattern deviates from skeleton "
                f"({A_next.indices.shape[0]} vs {cols_c.shape[0]} blocks)")
        blocks_c = np.ascontiguousarray(A_next.data)      # [nnzb_c, 3, 3]
        mask_next = skel[f"C{li}_mask"]

        host[f"L{li}_p_indptr"] = _pad_indptr(skel[f"Pn{li}_indptr"], nf_p)
        host[f"L{li}_p_cols"] = skel[f"Pn{li}_indices"]
        host[f"L{li}_p_w"] = skel[f"Pn{li}_data"].astype(np_dt)
        host[f"L{li}_r_indptr"] = _pad_indptr(skel[f"PTn{li}_indptr"], nc_p)
        host[f"L{li}_r_cols"] = skel[f"PTn{li}_indices"]
        host[f"L{li}_r_w"] = skel[f"PTn{li}_data"].astype(np_dt)

        diag_c = np.zeros((n_next, 3, 3))
        diag_c[skel[f"C{li}_diag_rows"]] = blocks_c[skel[f"C{li}_diag_pos"]]
        binv_c = _block_jacobi_inv(diag_c, mask_next.reshape(n_next, 3))
        A_next_b = sp.bsr_matrix(
            (blocks_c, cols_c.astype(np.int64), skel[f"C{li}_bsr_indptr"]),
            shape=(3 * n_next, 3 * n_next))
        if li + 1 < L:              # a smoothed level of the V-cycle
            i = li + 1
            host[f"L{i}_indptr"] = _pad_indptr(skel[f"C{li}_bsr_indptr"],
                                               nc_p)
            host[f"L{i}_cols"] = cols_c
            host[f"L{i}_vals"] = blocks_c.reshape(-1, 9).astype(np_dt)
            host[f"L{i}_mask"] = _mask_cm_flat(mask_next, nc_p, dtype)
            host[f"L{i}_binv9"] = _binv9_cm(binv_c, nc_p, dtype)
            host[f"L{i}_lam_max"] = _power_lambda_max(
                A_next_b, binv_c, mask_next, iters=12, inflate=1.2)
        A_cur = A_next_b
        mask_cur = mask_next
        n_cur = n_next
    t0 = tick("rap_chain", t0)

    host["coarse_inv"] = _coarse_pinv_cm(A_cur.toarray(), mask_cur, n_cur,
                                         pad_rows(n_cur), dtype)
    t0 = tick("coarse_pinv", t0)

    system, mg = _from_host(host, dtype, device)
    if system.device.type == "cuda":
        torch.cuda.synchronize(system.device)
    t0 = tick("upload", t0)
    info["host_arrays"] = host
    info["value_seconds"] = round(time.perf_counter() - t_all, 3)
    info["skeleton_seconds"] = float(skel.get("skeleton_seconds", 0.0))
    info["skeleton_phases"] = dict(skel.get("_phases", {}))
    info["n_levels"] = L + 1
    info["level_nodes"] = [N] + [int(skel[f"C{li}_n"]) for li in range(L)]
    info["fine_blocks"] = int(cols_d.shape[0])
    info["device_bytes"] = _device_bytes(system, mg)
    return system, mg, info


def _device_bytes(system: BellSystem, mg: BellMG) -> int:
    """Bytes of the hierarchy's device tensors (shared ones counted once)."""
    seen = {}

    def add(t):
        if t is not None:
            seen[t.data_ptr()] = t.numel() * t.element_size()

    def add_csr(A):
        for t in (A.indptr, A.cols, A.vals):
            add(t)

    add_csr(system.matrix.A)
    add(system.matrix.vals_lo)
    add(system.matrix.free_mask)
    add(mg.coarse_inv)
    for L in mg.levels:
        add_csr(L.op.A)
        add(L.op.free_mask)
        add(L.binv9)
        add_csr(L.transfer.P)
        add_csr(L.transfer.R)
    return int(sum(seen.values()))


def build_bell_multigrid(
        mesh: Mesh, lam, mu,
        free_mask: Optional[np.ndarray] = None,
        dtype=torch.float32,
        max_coarse_dofs: int = 4000,
        order: int = 2,
        skeleton_path: Optional[str] = None,
        skeleton_cache: Optional[dict] = None,
        device="cuda",
) -> Tuple[BellSystem, BellMG, dict]:
    """The explicit BELL hierarchy for an arbitrary solid mesh: a skeleton
    (the in-process ``skeleton_cache``, the ``skeleton_path`` .npz, or a
    fresh build) and the value pass for this
    material.  ``info["skeleton_cached"]`` says whether the skeleton was
    reused.  Materials with lam or mu <= 0 and meshes over the skeleton
    byte budget need the monolithic build, which raises
    ``NotImplementedError`` here (ROADMAP Queue A item 6)."""
    from ..utils.terminal import log, print_warning

    C, k = mesh.conn.shape
    lam_e = np.broadcast_to(np.asarray(lam, np.float64), (C,))
    mu_e = np.broadcast_to(np.asarray(mu, np.float64), (C,))
    skel_bytes = C * k * k * 9 * 8 * 2.5
    if lam_e.min() <= 0 or mu_e.min() <= 0:
        raise NotImplementedError(
            f"multigrid for a material with lam or mu <= 0: {_NOT_PORTED}")
    if skel_bytes > _SKEL_MAX_BYTES:
        raise NotImplementedError(
            f"multigrid for a skeleton of {skel_bytes:.3g} bytes (budget "
            f"{_SKEL_MAX_BYTES:.3g}): {_NOT_PORTED}")
    skeleton = None
    ram_key = None
    if skeleton_cache is not None:
        # in-process RAM cache (one entry): the density-swap workflow
        ram_key = skeleton_cache_key(mesh, free_mask, order, max_coarse_dofs)
        skeleton = skeleton_cache.get(ram_key)
    skeleton_cached = skeleton is not None
    if skeleton is None and skeleton_path is not None \
            and os.path.exists(skeleton_path):
        try:
            t_l = time.perf_counter()
            skeleton = load_skeleton(skeleton_path)
            skeleton_cached = True
            log(f"hierarchy skeleton loaded from cache "
                f"({time.perf_counter() - t_l:.1f}s): {skeleton_path}")
        except (OSError, ValueError, KeyError) as e:   # stale/corrupt
            print_warning(f"skeleton cache load failed ({e}); rebuilding")
    if skeleton is None:
        skeleton = build_bell_skeleton(mesh, free_mask=free_mask,
                                       order=order,
                                       max_coarse_dofs=max_coarse_dofs)
        if skeleton_path is not None:
            try:
                save_skeleton(skeleton_path, skeleton)
            except OSError as e:
                print_warning(f"skeleton cache save failed: {e}")
    if ram_key is not None and ram_key not in skeleton_cache:
        skeleton_cache.clear()          # hold at most ONE skeleton
        skeleton_cache[ram_key] = skeleton
    try:
        system, mg, info = build_bell_values(skeleton, lam_e, mu_e,
                                             dtype=dtype, device=device)
    except SkeletonMismatch as e:
        raise NotImplementedError(
            f"multigrid: the value pass left the skeleton's pattern ({e}); "
            f"{_NOT_PORTED}") from e
    info["skeleton_cached"] = skeleton_cached
    return system, mg, info


# ---------------------------------------------------------------------------
# Caches: the skeleton (density-independent) and the whole hierarchy
# ---------------------------------------------------------------------------


def skeleton_cache_key(mesh: Mesh, free_mask, order: int = 2,
                       max_coarse_dofs: int = 4000) -> str:
    """Cache key for the density-independent part of the hierarchy."""
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(mesh.coords).tobytes())
    h.update(np.ascontiguousarray(mesh.conn).tobytes())
    if free_mask is None:
        free_mask = np.ones(mesh.n_dofs)
    h.update(np.asarray(free_mask, np.float64).tobytes())
    h.update(str((order, _COARSEN, max_coarse_dofs)).encode())
    h.update(f"{_HIER_FORMAT} skeleton {_SKEL_VERSION}".encode())
    return h.hexdigest()[:24]


def save_skeleton(path: str, skel: dict) -> str:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **{kk: v for kk, v in skel.items()
                      if not kk.startswith("_")})
    return path


def load_skeleton(path: str) -> dict:
    z = np.load(path, allow_pickle=False)
    if int(z["version"]) != _SKEL_VERSION:
        raise ValueError(f"skeleton version {int(z['version'])} != "
                         f"{_SKEL_VERSION}")
    return {kk: z[kk] for kk in z.files}


def hierarchy_cache_key(mesh: Mesh, lam, mu, free_mask, dtype,
                        order: int = 2) -> str:
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(mesh.coords).tobytes())
    h.update(np.ascontiguousarray(mesh.conn).tobytes())
    h.update(np.asarray(lam, np.float64).tobytes())
    h.update(np.asarray(mu, np.float64).tobytes())
    h.update(np.asarray(free_mask, np.float64).tobytes())
    h.update(str(dtype).encode())
    h.update(str(order).encode())
    h.update(f"{_HIER_FORMAT} {_HIER_VERSION}".encode())
    return h.hexdigest()[:24]


def save_hierarchy(path: str, info: dict) -> str:
    """Write the host arrays of a build (``info["host_arrays"]``) to one
    uncompressed .npz, tagged with the port's format."""
    arrs = dict(info["host_arrays"])
    arrs["format"] = np.str_(_HIER_FORMAT)
    arrs["format_version"] = np.int64(_HIER_VERSION)
    arrs["build_seconds"] = np.float64(
        info.get("value_seconds", 0.0) + info.get("skeleton_seconds", 0.0))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **arrs)
    return path


def load_hierarchy(path: str, dtype, device="cuda"
                   ) -> Tuple[BellSystem, BellMG, dict]:
    z = np.load(path, allow_pickle=False)
    if "format" not in z.files or str(z["format"]) != _HIER_FORMAT \
            or int(z["format_version"]) != _HIER_VERSION:
        raise ValueError(f"{path} is not a {_HIER_FORMAT} hierarchy of "
                         f"version {_HIER_VERSION}")
    host = {kk: z[kk] for kk in z.files}
    system, mg = _from_host(host, dtype, device)
    info = {"loaded_from": path, "cached": True,
            "build_seconds": float(z["build_seconds"]),
            "n_levels": int(z["n_levels"]) + 1,
            "fine_blocks": int(host["L0_cols"].shape[0]),
            "device_bytes": _device_bytes(system, mg)}
    return system, mg, info
