"""The port's Tet10 route under a density-weighted body force against the
plain reference (tests/plain_tet10.py, written from the equations alone,
which builds its own quadratic mesh and finds the port's nodes by their
coordinates), on the CPU.

The case: a 6x2x2-hex Tet4 box raised to Tet10 by
``setup_problem(interpolation_order=2)``, random SIMP densities with one
cell under the 1e-6 void threshold, a random body-force direction.

- The Tet10 operator apply and ``apply_variable_density_volume_force``
  agree with the reference to float64 rounding (rtol 1e-12: sums of at
  most 10 x 4 terms an element over a node's few elements).
- The block-ELL ``solve_system(cg, multigrid)`` in float64, and in
  float32 under the float64 refinement, agree with the reference's direct
  solve of its own assembled matrix: displacements and energy to 1e-8
  (the solve's 1e-10 residual through the conditioning of the SIMP
  contrast); von Mises to 1e-6 relative in float64, and to 5e-5 in
  float32, whose stresses are computed in float32 from the certified
  displacements rounded to float32: float32's 1.2e-7 amplified by the
  cancellation of the strain's differences (|u| / (h |grad u|), about
  100 here; 5.7e-6 measured).
- The reference's own checks: a linear displacement field gives the exact
  constant stress in every Tet10 (the patch test), and the nodal weights
  sum to the integral of the density over the cells it loads.
- The volume-force calls' spans (``volume_force/quadrature``,
  ``volume_force/nodal_sum``) are in ``Problem.load_timings``, and are
  profiler ranges only while a profiler records; ``setup_problem`` times
  ``to_quadratic``.
"""

import os
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

import topopteval_tpu_torch as tt
from topopteval_tpu_torch.utils import profiling

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import plain_tet10 as plain  # noqa: E402

tt.set_verbosity(False)
torch.set_num_threads(1)

LAME = (1.0, 0.3, 1e-9, 3.0)          # E0, nu, Emin, p
LOAD_KEYS = {"volume_force", "volume_force/quadrature",
             "volume_force/nodal_sum"}


@pytest.fixture(scope="module")
def case():
    g = tt.generate_grid_tet(6, 2, 2, (0.0, 0.0, 0.0), (3.0, 1.0, 1.0))
    rng = np.random.default_rng(2 ** 31 + 101)
    rho = rng.uniform(0.1, 1.0, len(g.conn))
    rho[int(rng.integers(len(g.conn)))] = 1e-7          # skipped: void
    b = rng.normal(size=3)
    b /= np.linalg.norm(b)
    coords, conn = plain.tet10_mesh(g.coords, g.conn)
    ref = plain.Tet10Reference(coords, conn)
    E0, nu, Emin, p = LAME
    E = Emin + (E0 - Emin) * rho ** p
    lam, mu = E * nu / ((1 + nu) * (1 - 2 * nu)), E / (2 * (1 + nu))
    clamped = np.flatnonzero(np.abs(coords[:, 0]) < 1e-9)
    return dict(g=g, rho=rho, b=b, ref=ref, coords=coords, lam=lam, mu=mu,
                clamped=clamped)


def _problem(case, dtype):
    """The port's problem: the Tet4 mesh raised to Tet10, clamped at
    x = 0 (its own nodes there, mid-edge nodes included), SIMP, the
    density-weighted body force; and the reference's node of each of its
    nodes."""
    mesh = tt.Mesh(case["g"].coords, case["g"].conn, "tet4")
    p = tt.setup_problem(mesh, interpolation_order=2, dtype=dtype,
                         device="cpu")
    assert p.mesh.element_type == "tet10"
    tt.apply_fixed_boundary(p, np.flatnonzero(
        np.abs(p.mesh.coords[:, 0]) < 1e-9))
    tt.assemble_stiffness_matrix_simp(p, tt.SIMPMaterial(*LAME), case["rho"])
    tt.apply_variable_density_volume_force(p, list(case["b"]), case["rho"])
    return p, plain.match_nodes(case["coords"], p.mesh.coords)


def _to_ref(idx, v):
    out = np.zeros((len(idx), 3))
    out[idx] = np.asarray(v, np.float64).reshape(-1, 3)
    return out


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_operator_apply_matches_reference(case):
    p, idx = _problem(case, torch.float64)
    op = p.build_operator(with_bc=False)
    u = np.random.default_rng(7).normal(size=p.n_dofs)
    ours = op.matvec(torch.as_tensor(u)).numpy()
    lam = torch.as_tensor(case["lam"])[:, None]
    mu = torch.as_tensor(case["mu"])[:, None]
    want = case["ref"].apply(torch.as_tensor(_to_ref(idx, u))[..., None],
                             lam, mu)[..., 0].numpy()
    assert _rel(_to_ref(idx, ours), want) <= 1e-12


def test_volume_force_matches_reference(case):
    p, idx = _problem(case, torch.float64)
    want = case["ref"].body_force(case["b"], case["rho"]).reshape(-1, 3)
    assert _rel(_to_ref(idx, p.f), want) <= 1e-12


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_block_ell_solve_matches_reference_direct(case, dtype, monkeypatch):
    monkeypatch.setenv("TOPOPT_MG_CACHE_DIR", "off")
    p, idx = _problem(case, dtype)
    r = tt.solve_system(p, tt.SolverConfig(
        method="cg", preconditioner="multigrid", tolerance=1e-10,
        max_iterations=5000, verbose=False))
    assert r.converged and p._mg_build_info["route"] == "skeleton"
    assert (r.refinement_passes > 0) == (dtype == torch.float32)
    ref = case["ref"]
    K = ref.stiffness(case["lam"], case["mu"])
    m = np.ones((ref.n_nodes, 3))
    m[case["clamped"]] = 0.0
    m = m.reshape(-1)
    f = m * ref.body_force(case["b"], case["rho"])
    D = sp.diags(m)
    A = (D @ K @ D + sp.diags(1.0 - m)).tocsc()
    u_ref = spla.spsolve(A, f).reshape(-1, 3)
    u = _to_ref(idx, r.u)
    assert _rel(u, u_ref) <= 1e-8
    e_ref = 0.5 * float(f @ u_ref.reshape(-1))
    assert abs(r.energy - e_ref) <= 1e-8 * abs(e_ref)
    lam = torch.as_tensor(case["lam"])[:, None]
    mu = torch.as_tensor(case["mu"])[:, None]
    vm_ref = ref.von_mises(torch.as_tensor(u_ref)[..., None], lam,
                           mu)[:, 0].numpy()
    vm_tol = 1e-6 if dtype == torch.float64 else 5e-5
    assert _rel(np.asarray(r.von_mises, np.float64), vm_ref) <= vm_tol


@pytest.mark.parametrize("check", ["patch", "weights"])
def test_reference_own_checks(case, check):
    ref = case["ref"]
    if check == "patch":
        grad = np.random.default_rng(3).normal(size=(3, 3))
        u = case["coords"] @ grad.T + np.array([0.1, -0.2, 0.3])
        lam = torch.as_tensor(case["lam"])[:, None]
        mu = torch.as_tensor(case["mu"])[:, None]
        sig = ref.stress(torch.as_tensor(u)[..., None], lam, mu,
                         slice(None))[..., 0].numpy()       # [C, q, 3, 3]
        eps = 0.5 * (grad + grad.T)
        want = (2.0 * case["mu"][:, None, None] * eps
                + (case["lam"] * np.trace(eps))[:, None, None] * np.eye(3))
        assert np.abs(sig - want[:, None]).max() <= 1e-12 * np.abs(
            want).max()
    else:
        rho = case["rho"]
        w = ref.node_weights(rho)
        vol = ref.vol.numpy()
        loaded = rho >= 1e-6
        assert loaded.sum() == len(rho) - 1
        want = float((rho * vol)[loaded].sum())
        assert abs(w.sum() - want) <= 1e-12 * want
        # a straight-sided Tet10's integrals of N: -V/20 a corner, V/5 an
        # edge
        one = plain.Tet10Reference(case["coords"], ref.conn[:1].numpy())
        w1 = one.node_weights(np.ones(1))[ref.conn[0].numpy()]
        v = float(one.vol[0])
        assert np.allclose(w1, [-v / 20] * 4 + [v / 5] * 6, rtol=1e-13,
                           atol=0)


@pytest.mark.parametrize("profiled", [True, False])
def test_volume_force_spans(case, profiled, monkeypatch):
    mesh = tt.Mesh(case["g"].coords, case["g"].conn, "tet4")
    opened = []
    enter = profiling._range_enter
    monkeypatch.setattr(profiling, "_range_enter",
                        lambda *a: opened.append(a[0]) or enter(*a))

    def run():
        p = tt.setup_problem(mesh, interpolation_order=2,
                             dtype=torch.float64, device="cpu")
        tt.apply_variable_density_volume_force(p, [0.0, 0.0, -1.0],
                                               case["rho"])
        first = p.load_timings
        tt.apply_gravity(p, density=2.0)
        return p, first

    if profiled:
        acts = [torch.profiler.ProfilerActivity.CPU]
        with torch.profiler.profile(activities=acts) as prof:
            p, first = run()
        names = {e.name() for e in prof.profiler.kineto_results.events()
                 if e.is_user_annotation()}
        assert {"setup_problem", "to_quadratic",
                "apply_variable_density_volume_force", "apply_volume_force",
                } | LOAD_KEYS <= names
    else:
        p, first = run()
        assert opened == []
    # each call's own timings, replaced by the next call's
    assert set(first) == set(p.load_timings) == LOAD_KEYS
    assert p.load_timings is not first
    assert all(v >= 0 for v in p.load_timings.values())
    assert p.load_timings["volume_force"] >= (
        p.load_timings["volume_force/quadrature"]
        + p.load_timings["volume_force/nodal_sum"])
    assert set(p.setup_timings) == {"to_quadratic"}


_B = np.random.default_rng(1).normal(size=(6, 6))
#: a small SPD operator whose products float64 rounds
_M = _B @ _B.T + 6.0 * np.eye(6)


class _Dense:
    """A refinement system with the operator ``_M`` and no float64
    floor."""

    def matvec64(self, x):
        return _M @ x


class _DenseWithFloor(_Dense):
    """The same with a floor fixed by the test."""

    def __init__(self, floor):
        self.floor = floor

    def residual_floor64(self, x):
        return self.floor


def _system(floor):
    return _Dense() if floor is None else _DenseWithFloor(floor)


def _leaving(share):
    """An inner solve that leaves ``share`` of its right-hand side."""
    return lambda rhs, left, tol: (torch.as_tensor(
        (1.0 - share) * np.linalg.solve(_M, rhs.numpy())), 5, None)


@pytest.mark.parametrize("floor,converged", [(1e-12, True), (0.0, False),
                                              (None, False)])
def test_refinement_goes_on_while_it_gains_then_stops_at_the_floor(
        floor, converged):
    """Each inner solve leaves 1 % of its right-hand side: past the sixth
    pass the refinement goes on while a pass gains 10 times, until float64
    stops it; stalled, it is converged only at the system's floor."""
    from topopteval_tpu_torch import api

    f = np.random.default_rng(2).normal(size=6)
    x, its, rn, conv, _, passes = api._refined_generic(
        _system(floor), _leaving(0.01), f, 1e-30, 10_000,
        torch.device("cpu"), dtype=torch.float64)
    assert passes > 6 and its == 5 * passes
    assert 0 < rn < 1e-14 and conv is converged
    # a pass that gains too little after the sixth ends it
    x, its, rn, conv, _, passes = api._refined_generic(
        _system(floor), _leaving(0.5), f, 1e-30, 10_000,
        torch.device("cpu"), dtype=torch.float64)
    assert passes == 6 and conv is (floor is not None and rn <= floor)


def test_float32_solve_below_the_float64_floor_is_converged_there(
        case, monkeypatch):
    """Asked for a residual no float64 iterate reaches, the block-ELL
    float32 route refines until it stalls and is converged at its floor."""
    monkeypatch.setenv("TOPOPT_MG_CACHE_DIR", "off")
    floors = []
    from topopteval_tpu_torch.fem import bell
    real = bell.BellSystem.residual_floor64

    def kept(self, x64):
        floors.append(real(self, x64))
        return floors[-1]

    monkeypatch.setattr(bell.BellSystem, "residual_floor64", kept)
    p, _ = _problem(case, torch.float32)
    r = tt.solve_system(p, tt.SolverConfig(
        method="cg", preconditioner="multigrid", tolerance=1e-17,
        max_iterations=5000, verbose=False))
    assert r.converged and r.refinement_passes >= 6
    assert len(floors) == 1
    assert 1e-17 * (1 + np.linalg.norm(p.f)) < r.residual_norm <= floors[0]
    assert "solve/refine/floor" in r.timings
