"""The robust solver ladder of the PyTorch port against the JAX package,
on the CPU in float64 (the cases of tests/test_solvers.py).

- MINRES, BiCGSTAB and GMRES on seeded dense SPD, symmetric-indefinite
  and non-symmetric matrices, with and without a Jacobi preconditioner:
  the port takes the JAX package's iteration count, its ``x`` agrees to
  rtol 1e-10, and its residual history to rtol 1e-10 of each entry (or
  1e-14 of the initial residual, the rounding of the dots).
- The inputs of tests/test_solvers.py (condition 1e3 to 1e4, tolerance
  1e-12, more iterations than rows) are decided by rounding: the JAX
  package's own count moves by several iterations when ``b`` moves by one
  part in 1e15, as dots summed in another order move it.  There the
  port's count must lie inside the JAX package's own spread over such
  moves, and ``x`` still agrees to rtol 1e-10.
- The robust layer: memory estimates, the property probe's decisions,
  method selection, condition number and bandwidth equal the JAX
  package's.  The ladder through ``solve_system`` is in
  tests/test_torch_robust_solve.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from topopteval_tpu import api as japi
from topopteval_tpu.config import SolverConfig as JaxSolverConfig
from topopteval_tpu.fem import robust as jrob
from topopteval_tpu.fem import solvers as jsol
from topopteval_tpu.fem.bc import nodes_at_plane as jax_nodes_at_plane
from topopteval_tpu.materials import lame_parameters
from topopteval_tpu.models.beams import generate_grid_tet as jax_grid_tet
import topopteval_tpu_torch as tt
from topopteval_tpu_torch.fem import robust
from topopteval_tpu_torch.fem import solvers

tt.set_verbosity(False)
torch.set_num_threads(1)

LAM, MU = lame_parameters(1.0, 0.3)


# ---------------------------------------------------------------------------
# Dense inputs
# ---------------------------------------------------------------------------


def _orth(rng, n):
    return np.linalg.qr(rng.standard_normal((n, n)))[0]


def _spd(rng, n=60, cond=10.0):
    Q = _orth(rng, n)
    return Q @ np.diag(np.logspace(0, np.log10(cond), n)) @ Q.T


def _indefinite(rng, n=60, top=3.0):
    Q = _orth(rng, n)
    d = np.concatenate([np.linspace(1, top, n // 2),
                        -np.linspace(1, top / 2, n - n // 2)])
    return Q @ np.diag(d) @ Q.T


def _nonsym(rng, n=40, shift=5.0):
    return rng.standard_normal((n, n)) * 0.3 + np.eye(n) * shift


def _dense(kind, seed, pre):
    """(K, b, |diag K|): with ``pre`` the matrix is rescaled by
    D = diag(sqrt(logspace(0, 2))) on both sides, so Jacobi matters."""
    rng = np.random.default_rng(seed)
    K = {"spd": _spd, "indefinite": _indefinite, "nonsym": _nonsym}[kind](rng)
    b = rng.standard_normal(K.shape[0])
    if pre:
        D = np.diag(np.sqrt(np.logspace(0, 2, K.shape[0])))
        K = D @ K @ D
    return K, b, np.abs(np.diag(K))


def _both(method, K, b, d, **kw):
    """The same call through both packages: (JAX result, port result)."""
    Mj = jsol.jacobi_preconditioner(jnp.asarray(d)) if d is not None \
        else None
    Mt = solvers.jacobi_preconditioner(torch.as_tensor(d)) \
        if d is not None else None
    ref = getattr(jsol, method)(jnp.asarray(K), jnp.asarray(b), M=Mj, **kw)
    ours = getattr(solvers, method)(torch.as_tensor(K), torch.as_tensor(b),
                                    M=Mt, **kw)
    return ref, ours


PARITY = [(m, kind, pre)
          for kind, methods in (("spd", ("minres", "bicgstab", "gmres")),
                                ("indefinite", ("minres", "gmres")),
                                ("nonsym", ("bicgstab", "gmres")))
          for m in methods for pre in (False, True)
          if not (kind == "indefinite" and pre and m == "minres")]


@pytest.mark.parametrize("method,kind,pre", PARITY)
@pytest.mark.parametrize("seed", [0, 1])
def test_krylov_matches_jax_counts_x_and_history(method, kind, pre, seed):
    K, b, d = _dense(kind, seed, pre)
    ref, ours = _both(method, K, b, d if pre else None, tol=1e-10,
                      maxiter=800, record_history=True)
    assert bool(ref.converged) and ours.converged
    assert ours.niter == int(ref.niter)
    x_ref = np.asarray(ref.x)
    np.testing.assert_allclose(ours.x.numpy(), x_ref, rtol=1e-10,
                               atol=1e-10 * np.abs(x_ref).max())
    h_ref = np.asarray(ref.history)[: int(ref.niter) + 1]
    assert len(ours.history) == len(h_ref)
    np.testing.assert_allclose(ours.history, h_ref, rtol=1e-10,
                               atol=1e-14 * h_ref[0])
    assert abs(ours.residual_norm - float(ref.residual_norm)) \
        <= 1e-10 * h_ref[0]
    np.testing.assert_allclose(ours.x.numpy(), np.linalg.solve(K, b),
                               rtol=0, atol=1e-7 * np.abs(x_ref).max())


def test_minres_on_the_indefinite_matrix_with_a_preconditioner():
    """The preconditioned indefinite case of the parity test above, left
    out there: the rescaled matrix takes MINRES past its row count and
    rounding decides the count.  The answer still matches."""
    K, b, d = _dense("indefinite", 0, True)
    ref, ours = _both("minres", K, b, d, tol=1e-10, maxiter=800)
    assert bool(ref.converged) and ours.converged
    assert abs(ours.niter - int(ref.niter)) <= 5
    np.testing.assert_allclose(ours.x.numpy(), np.asarray(ref.x),
                               rtol=1e-10,
                               atol=1e-10 * np.abs(np.asarray(ref.x)).max())


# the inputs of tests/test_solvers.py: (method, matrix, preconditioned,
# tolerance)
SENSITIVE = {
    "minres_spd": ("minres", lambda r: _spd(r, 60, 1e3), False, 1e-12),
    "minres_indefinite": ("minres", lambda r: _indefinite(r, 60, 10.0),
                          False, 1e-12),
    "minres_jacobi": ("minres", lambda r: _spd(r, 60, 1e4), True, 1e-10),
    "bicgstab_nonsym": ("bicgstab", lambda r: _nonsym(r), False, 1e-12),
    "gmres_nonsym": ("gmres", lambda r: _nonsym(r), False, 1e-10),
    "bicgstab_spd": ("bicgstab", lambda r: _spd(r, 60, 1e3), False, 1e-12),
}


@pytest.mark.parametrize("case", list(SENSITIVE))
def test_rounding_decided_counts_lie_in_the_jax_spread(case):
    """The count must lie inside the JAX package's own spread over twelve
    moves of ``b`` by one part in 1e15, and ``x`` within 1e-10 of the JAX
    answer or inside four times that spread's distance from it (at
    condition 1e4 and tolerance 1e-10 the iterates differ by about
    cond·tol, in either package alone)."""
    method, make, pre, tol = SENSITIVE[case]
    rng = np.random.default_rng(42)
    K = make(rng)
    x_true = rng.standard_normal(K.shape[0])
    b = K @ x_true
    d = np.abs(np.diag(K)) if pre else None
    ref, ours = _both(method, K, b, d, tol=tol, maxiter=800)
    assert bool(ref.converged) and ours.converged
    x_ref = np.asarray(ref.x)
    Mj = jsol.jacobi_preconditioner(jnp.asarray(d)) if pre else None
    spread, x_spread = [int(ref.niter)], 0.0
    for k in range(12):
        nudge = np.random.default_rng(100 + k).standard_normal(b.shape)
        bk = b * (1.0 + 1e-15 * nudge)
        rk = getattr(jsol, method)(jnp.asarray(K), jnp.asarray(bk), M=Mj,
                                   tol=tol, maxiter=800)
        spread.append(int(rk.niter))
        x_spread = max(x_spread, float(np.abs(np.asarray(rk.x)
                                              - x_ref).max()))
    assert min(spread) <= ours.niter <= max(spread), (ours.niter, spread)
    x_err = float(np.abs(ours.x.numpy() - x_ref).max())
    assert x_err <= max(1e-10 * np.abs(x_ref).max(), 4.0 * x_spread), \
        (x_err, x_spread)


def test_gmres_widened_retry_matches_jax():
    """GMRES(2) does not converge in 40 iterations; both packages retry
    from x0 with m = min(maxiter, n, 200) = 40 and count both runs."""
    K, b, _ = _dense("nonsym", 3, False)
    K = K - 4.0 * np.eye(K.shape[0])           # slower: GMRES(2) stalls
    ref, ours = _both("gmres", K, b, None, tol=1e-10, maxiter=40,
                      restart=2, record_history=True)
    assert ours.niter == int(ref.niter) > 40
    assert ours.converged == bool(ref.converged)
    np.testing.assert_allclose(ours.x.numpy(), np.asarray(ref.x),
                               rtol=1e-10,
                               atol=1e-10 * np.abs(np.asarray(ref.x)).max())
    # the JAX history of the retry is padded with zeros past its own run
    h_ref = np.asarray(ref.history)[: len(ours.history)]
    np.testing.assert_allclose(ours.history, h_ref, rtol=1e-10,
                               atol=1e-14 * h_ref[0])


def test_cg_takes_a_dense_matrix_as_the_jax_cg_does():
    K, b, _ = _dense("spd", 0, False)
    ref = jsol.cg(jnp.asarray(K), jnp.asarray(b), tol=1e-10, maxiter=500)
    ours = solvers.cg(torch.as_tensor(K), torch.as_tensor(b), tol=1e-10,
                      maxiter=500)
    assert ours.niter == int(ref.niter) and ours.converged
    np.testing.assert_allclose(ours.x.numpy(), np.asarray(ref.x),
                               rtol=1e-10)
    assert isinstance(solvers._wrap_operator(torch.as_tensor(K)),
                      solvers.DenseOperator)
    with pytest.raises(TypeError):
        solvers._wrap_operator(torch.zeros(3))


# ---------------------------------------------------------------------------
# Robust layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,nnz", [(10_000, 500_000), (200_000, 5_000_000),
                                   (600_000, 20_000_000),
                                   (2_000_000, 90_000_000)])
def test_memory_estimates_equal_jax(n, nnz):
    assert robust.estimate_memory_usage(n, nnz) \
        == jrob.estimate_memory_usage(n, nnz)


def _beam_pair(dtype=torch.float64):
    """The 4x2x2 beam clamped at x = 0 as operators of both packages."""
    mesh = jax_grid_tet(4, 2, 2)
    jp = japi.setup_problem(mesh, dtype=jnp.float64)
    japi.assemble_stiffness_matrix(jp, LAM, MU)
    japi.apply_fixed_boundary(jp, jax_nodes_at_plane(mesh, 0, 0.0))
    tmesh = tt.generate_grid_tet(4, 2, 2)
    tp = tt.setup_problem(tmesh, dtype=dtype, device="cpu")
    tt.assemble_stiffness_matrix(tp, LAM, MU)
    tt.apply_fixed_boundary(tp, tt.nodes_at_plane(tmesh, 0, 0.0))
    return jp.build_operator(with_bc=True), tp.build_operator(with_bc=True)


@dataclasses.dataclass
class _Skewed:
    """An operator plus a small skew part: the same non-symmetric
    operator for either package (``xp`` is its array module)."""
    op: object
    S: object

    def matvec(self, u):
        return self.op.matvec(u) + self.S @ u

    def diagonal(self):
        return self.op.diagonal()

    def __getattr__(self, name):
        return getattr(self.op, name)


def test_operator_probe_and_selection_match_jax():
    jop, top = _beam_pair()
    cases = [(jop, top)]
    n = top.n_dofs
    S = np.triu(np.random.default_rng(3).standard_normal((n, n)), 1) * 1e-3
    S = S - S.T
    cases.append((_Skewed(jop, jnp.asarray(S)),
                  _Skewed(top, torch.as_tensor(S))))
    Sym = np.diag(-np.abs(np.random.default_rng(4).standard_normal(n))) * 50
    cases.append((_Skewed(jop, jnp.asarray(Sym)),
                  _Skewed(top, torch.as_tensor(Sym))))
    mem = robust.estimate_memory_usage(n, robust.operator_nnz_estimate(top))
    configs = [dict(method="auto"), dict(method="auto", memory_limit=1e-9),
               dict(method="auto", memory_limit=1.5 * mem["gmres"]),
               dict(method="minres")]
    seen = []
    for j, t in cases:
        pj = jrob.check_operator_properties(j)
        pt = robust.check_operator_properties(t)
        assert (pt.symmetric, pt.positive_definite) \
            == (pj.symmetric, pj.positive_definite)
        for kw in configs:
            mj = jrob.select_solver_method(
                j, JaxSolverConfig(verbose=False, **kw), pj)
            mt = robust.select_solver_method(
                t, tt.SolverConfig(verbose=False, **kw), pt)
            assert mt == mj
            seen.append(mt)
    # every branch of the selection was taken
    assert set(seen) == {"direct", "cg", "minres", "gmres", "bicgstab"}
    assert robust.operator_nnz_estimate(top) \
        == jrob.operator_nnz_estimate(jop)


def test_float32_operator_probe_is_symmetric():
    """The dtype-scaled tolerance keeps a float32 operator symmetric."""
    _, top32 = _beam_pair(torch.float32)
    props = robust.check_operator_properties(top32)
    assert props.symmetric and props.positive_definite
    assert robust.check_operator_properties(top32, seed=5) == props


def test_condition_number_and_bandwidth_match_jax():
    from topopteval_tpu.fem.operator import assemble_scipy as jax_assemble
    from topopteval_tpu.mesh import element_dofs as jax_element_dofs
    from topopteval_tpu_torch.fem.operator import assemble_scipy
    rng = np.random.default_rng(0)
    A = rng.standard_normal((80, 80))
    K = sp.csr_matrix(A @ A.T + 80 * np.eye(80))
    assert robust.condition_number(K) == jrob.condition_number(K)
    n = 800
    T = sp.diags([-np.ones(n - 1), 2 * np.ones(n), -np.ones(n - 1)],
                 [-1, 0, 1], format="csc")
    dense = np.linalg.cond(T.toarray())
    assert abs(robust.condition_number(T) - dense) / dense < 1e-6
    assert abs(robust.condition_number(T) - jrob.condition_number(T)) \
        / dense < 1e-6
    mesh = tt.generate_grid_tet(4, 2, 2)
    bw = robust.estimate_bandwidth(tt.element_dofs(mesh.conn))
    assert bw == jrob.estimate_bandwidth(jax_element_dofs(
        jax_grid_tet(4, 2, 2).conn))
    Kc = assemble_scipy(mesh, LAM, MU).tocoo()
    assert bw == int(np.abs(Kc.row - Kc.col).max()) > 0
    Kj = jax_assemble(jax_grid_tet(4, 2, 2), LAM, MU).tocoo()
    assert bw == int(np.abs(Kj.row - Kj.col).max())
