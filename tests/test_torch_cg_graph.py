"""``fem.solvers.cg``'s CUDA-graph route, on the CPU.

On the block-ELL route (``BellSystem`` and ``BellMG``, both marked
``capturable``) ``cg`` captures one PCG iteration as a CUDA graph and
replays it; everywhere else it runs the eager loop.  Here:

- the engagement rule: a CPU tensor, a sharded ``SlabVector``, an
  unmarked operator and a tensor ``M`` take the eager loop;
- the eager loop gives the bits, counts and history of a frozen copy of
  the loop as it was before the graph route;
- the graph route's bookkeeping (buffers of its own, ``rz`` and ‖r‖
  written by the graph, the result's clone, one capture per hierarchy,
  the wrappers' launch counts, the spans) under a stand-in capture that
  records the iteration as a capture does (every launch issued once,
  under the spans) and whose replay runs it again without counting or
  timing, as a replayed graph does.  It gives the eager loop's bits.

The graph itself, on the card: ``-k graph`` in tests/test_torch_cuda.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import topopteval_tpu_torch as tt
from topopteval_tpu_torch.fem import bell, solvers
from topopteval_tpu_torch.fem.bc import free_mask_from_bcs
from topopteval_tpu_torch.fem.multigrid import MultigridPreconditioner
from topopteval_tpu_torch.fem.operator import StiffnessOperator
from topopteval_tpu_torch.fem.solvers import (KrylovResult, _dot,
                                              _wrap_operator, _zeros_like,
                                              apply_preconditioner, cg)
from topopteval_tpu_torch.ops import bell as ops_bell
from topopteval_tpu_torch.parallel.collectives import SlabVector
from topopteval_tpu_torch.parallel.halo import HaloShardedOperator
from topopteval_tpu_torch.parallel.halo_mg import HaloMG
from topopteval_tpu_torch.utils import profiling
from topopteval_tpu_torch.utils.profiling import PhaseTimer

tt.set_verbosity(False)
torch.set_num_threads(1)


def parent_cg(A, b, x0=None, M=None, tol=1e-8, maxiter=10000,
              record_history=False):
    """``cg`` as it was before the graph route (frozen copy, spans
    dropped: outside a timer they do nothing)."""
    A = _wrap_operator(A)
    x = _zeros_like(b) if x0 is None else x0.clone()
    r = b - A.matvec(x)
    z = apply_preconditioner(M, r)
    p = z.clone()
    rz = _dot(r, z)
    rnorm = float(torch.sqrt(_dot(r, r)))
    eps = tol + tol * rnorm
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
        rnorm_dev = torch.sqrt(_dot(r, r))
        it += 1
        rnorm = float(rnorm_dev)
        if record_history:
            hist.append(rnorm)
    return KrylovResult(x, it, rnorm, rnorm <= eps,
                        np.asarray(hist) if record_history else None)


def _problem(mesh, dtype):
    p = tt.setup_problem(mesh, dtype=dtype, device="cpu")
    tt.assemble_stiffness_matrix(p, *tt.lame_parameters(1.0, 0.3))
    tt.apply_fixed_boundary(p, tt.nodes_at_plane(mesh, 0, 0.0))
    tt.apply_force(p, tt.nodes_at_plane(mesh, 0, 6.0), [0.0, 0.0, -1.0])
    return p


@pytest.fixture(scope="module")
def box(tmp_path_factory):
    """An imported 12x4x4 box, to be clamped at x = 0 under a tip load."""
    g = tt.generate_grid_tet(12, 4, 4, (0, 0, 0), (6.0, 2.0, 2.0))
    path = tt.write_vtu(str(tmp_path_factory.mktemp("box") / "box.vtu"), g)
    return tt.import_mesh(path)


_HIERARCHIES = {}


def _hierarchy(mesh, dtype):
    """The box's block-ELL system and V-cycle (two smoothed levels above
    the dense coarse solve) and its load, component-major."""
    if dtype not in _HIERARCHIES:
        p = _problem(mesh, dtype)
        mask = free_mask_from_bcs(p.n_dofs, p.bcs)
        system, mg, _ = bell.build_bell_multigrid(
            mesh, p.lam, p.mu, free_mask=mask, dtype=dtype, device="cpu",
            max_coarse_dofs=100)
        b = torch.as_tensor(system.to_cm(p.f), dtype=dtype) \
            * system.free_mask
        _HIERARCHIES[dtype] = (system, mg, b)
    return _HIERARCHIES[dtype]


def _fresh_mg(mg):
    """A copy of the V-cycle without a captured iteration."""
    return dataclasses.replace(mg)


def _stand_in_capture(step, device):
    """A capture on the CPU: issues the iteration once, as a capture does
    (the wrappers count its launches, its spans time it); its replay runs
    the iteration again with the counts and the timer left alone, as a
    replayed graph does."""
    step()

    def replay():
        saved = [dict(c) for c in solvers._launch_counters()]
        token = profiling._CURRENT.set(None)
        try:
            step()
        finally:
            profiling._CURRENT.reset(token)
            for counter, old in zip(solvers._launch_counters(), saved):
                counter.update(old)

    return replay


@pytest.fixture
def graphed(monkeypatch):
    """cg takes the graph route on the CPU, under the stand-in capture;
    yields the list of captures made."""
    captures = []

    def capture(step, device):
        captures.append(step)
        assert device == torch.device("cpu")
        return _stand_in_capture(step, device)

    monkeypatch.setattr(solvers, "_captures", lambda A, b, M: True)
    monkeypatch.setattr(solvers, "_capture", capture)
    return captures


@pytest.fixture
def counted(monkeypatch):
    """The block-ELL operators' B4 and B5 calls counted in ops/bell's
    LAUNCHES, as their kernels count on the card."""
    def counting(name, fn):
        def wrapped(*args, **kw):
            ops_bell.LAUNCHES[name] += 1
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(bell, "bell_matvec",
                        counting("bell_matvec", bell.bell_matvec))
    monkeypatch.setattr(bell, "sell_matvec",
                        counting("sell_matvec", bell.sell_matvec))
    ops_bell.reset_launch_counts()
    yield ops_bell.LAUNCHES
    ops_bell.reset_launch_counts()


class _OnCard(torch.Tensor):
    """A CPU tensor that says it is on the card (for the rule's device
    test alone)."""

    @property
    def is_cuda(self):
        return True


def _blank(cls):
    return object.__new__(cls)


# ---------------------------------------------------------------------------
# The engagement rule
# ---------------------------------------------------------------------------


def test_rule_takes_the_graph_for_the_marked_block_ell_route(box):
    system, mg, b = _hierarchy(box, torch.float32)
    on_card = b.as_subclass(_OnCard)
    assert solvers._captures(system, on_card, mg)
    assert solvers._captures(system, on_card, None)
    assert solvers._captures(system.matrix, on_card, mg)


@pytest.mark.parametrize("case", ["cpu_tensor", "slab_vector",
                                  "stiffness_operator", "halo_operator",
                                  "dense_matrix", "tensor_M", "multigrid_M",
                                  "halo_M"])
def test_rule_keeps_the_eager_loop_elsewhere(box, case):
    system, mg, b = _hierarchy(box, torch.float32)
    on_card = b.as_subclass(_OnCard)
    A, rhs, M = system, on_card, mg
    if case == "cpu_tensor":
        rhs = b
    elif case == "slab_vector":
        rhs = SlabVector([on_card[:96], on_card[96:]])
    elif case == "stiffness_operator":
        A = _blank(StiffnessOperator)
    elif case == "halo_operator":
        A = _blank(HaloShardedOperator)
    elif case == "dense_matrix":
        A = solvers._wrap_operator(torch.eye(3))
    elif case == "tensor_M":
        M = torch.ones_like(b)
    elif case == "multigrid_M":         # the stencil and Galerkin V-cycles
        M = _blank(MultigridPreconditioner)
    elif case == "halo_M":
        M = _blank(HaloMG)
    assert not solvers._captures(A, rhs, M)
    if case in ("cpu_tensor", "tensor_M"):
        res = cg(A, rhs, M=M, tol=1e-6, maxiter=20)
        assert res.niter > 0 and res.graph_iters == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cpu_solves_report_no_graph_iterations(box, dtype):
    system, mg, b = _hierarchy(box, dtype)
    res = cg(system, b, M=mg, tol=1e-8, maxiter=200)
    assert res.converged and res.niter > 0 and res.graph_iters == 0
    assert "_cg_graphs" not in vars(mg)


def test_solve_system_reports_graph_iterations_on_the_cpu(box, monkeypatch):
    monkeypatch.setenv("TOPOPT_MG_CACHE_DIR", "off")
    r = tt.solve_system(_problem(box, torch.float32), tt.SolverConfig(
        method="cg", preconditioner="multigrid", tolerance=1e-10,
        verbose=False))
    assert r.converged and r.iterations > 0 and r.graph_iterations == 0
    assert not any(k.endswith("/capture") for k in r.timings)


# ---------------------------------------------------------------------------
# The eager loop against the parent's
# ---------------------------------------------------------------------------


def _same(res, ref, graph_iters):
    assert torch.equal(res.x, ref.x)
    assert (res.niter, res.residual_norm, res.converged) == \
        (ref.niter, ref.residual_norm, ref.converged)
    if ref.history is None:
        assert res.history is None
    else:
        assert np.array_equal(res.history, ref.history)
    assert res.graph_iters == graph_iters


CASES = [dict(tol=1e-8, maxiter=500, record_history=True),
         dict(tol=1e-6, maxiter=7),
         dict(tol=1e-8, maxiter=500, warm=True)]


def _args(b, case):
    kw = dict(case)
    x0 = 0.5 * b.flip(0) if kw.pop("warm", False) else None
    return dict(kw, x0=x0)


@pytest.mark.parametrize("case", range(len(CASES)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_eager_loop_gives_the_parents_bits(box, dtype, case):
    system, mg, b = _hierarchy(box, dtype)
    kw = _args(b, CASES[case])
    ref = parent_cg(system, b, M=mg, **kw)
    _same(cg(system, b, M=mg, **kw), ref, 0)


def test_eager_loop_without_a_preconditioner(box):
    system, _, b = _hierarchy(box, torch.float64)
    ref = parent_cg(system, b, tol=1e-6, maxiter=60, record_history=True)
    _same(cg(system, b, tol=1e-6, maxiter=60, record_history=True), ref, 0)


# ---------------------------------------------------------------------------
# The graph route's bookkeeping, under the stand-in capture
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", range(len(CASES)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_graph_route_gives_the_parents_bits(box, graphed, dtype, case):
    system, mg, b = _hierarchy(box, dtype)
    mg = _fresh_mg(mg)
    kw = _args(b, CASES[case])
    ref = parent_cg(system, b, M=mg, **kw)
    res = cg(system, b, M=mg, **kw)
    _same(res, ref, ref.niter)
    assert len(graphed) == 1
    # the parent's loop again, after the graph: nothing of it leaked
    _same(cg(system, b, M=mg, **kw), ref, ref.niter)
    assert len(graphed) == 1


def test_graph_result_is_not_a_buffer_the_next_call_writes(box, graphed):
    system, mg, b = _hierarchy(box, torch.float32)
    mg = _fresh_mg(mg)
    first = cg(system, b, M=mg, tol=1e-8, maxiter=500)
    kept = first.x.clone()
    graph = next(iter(vars(mg)["_cg_graphs"].values()))
    assert first.x.data_ptr() != graph.x.data_ptr()
    second = cg(system, b.flip(0), M=mg, tol=1e-8, maxiter=500)
    assert torch.equal(first.x, kept)
    assert not torch.equal(second.x, first.x)
    assert len(graphed) == 1


def test_one_capture_per_hierarchy_and_vector(box, graphed):
    system, mg, b = _hierarchy(box, torch.float32)
    mg = _fresh_mg(mg)
    for rhs in (b, 2.0 * b, b.flip(0)):
        assert cg(system, rhs, M=mg, tol=1e-6, maxiter=50).graph_iters > 0
    assert len(graphed) == 1
    # another hierarchy captures its own; so does another operator with
    # the same V-cycle, and an unpreconditioned solve on the operator
    cg(system, b, M=_fresh_mg(mg), tol=1e-6, maxiter=50)
    assert len(graphed) == 2
    cg(system.matrix, b, M=mg, tol=1e-6, maxiter=50)
    assert len(graphed) == 3
    cg(system.matrix, b, tol=1e-6, maxiter=5)
    assert len(graphed) == 4
    assert "_cg_graphs" in vars(system.matrix)


def test_converged_start_captures_nothing(box, graphed):
    system, mg, b = _hierarchy(box, torch.float32)
    mg = _fresh_mg(mg)
    res = cg(system, torch.zeros_like(b), M=mg, tol=1e-8)
    assert (res.niter, res.graph_iters) == (0, 0) and not graphed
    res = cg(system, b, M=mg, tol=1e-8, maxiter=0)
    assert (res.niter, res.graph_iters) == (0, 0) and not graphed


def test_graph_route_counts_the_eager_loops_launches(box, counted, graphed,
                                                     monkeypatch):
    system, mg, b = _hierarchy(box, torch.float32)
    mg = _fresh_mg(mg)
    res = cg(system, b, M=mg, tol=1e-8, maxiter=500)
    graph_counts = dict(counted)
    ops_bell.reset_launch_counts()
    monkeypatch.setattr(solvers, "_captures", lambda A, b, M: False)
    eager = cg(system, b, M=mg, tol=1e-8, maxiter=500)
    assert (eager.niter, eager.graph_iters) == (res.niter, 0)
    assert dict(counted) == graph_counts
    # per iteration: the fine matvec, and each smoothed level's matvecs
    # and both transfers
    assert graph_counts["bell_matvec"] > res.niter
    assert graph_counts["sell_matvec"] == 2 * len(mg.levels) * (
        res.niter + 1)


def test_graph_route_spans(box, graphed):
    system, mg, b = _hierarchy(box, torch.float32)
    mg = _fresh_mg(mg)
    timer = PhaseTimer()
    with timer.call("test"):
        with timer.phase("krylov"):
            first = cg(system, b, M=mg, tol=1e-8, maxiter=500)
        with timer.phase("krylov"):
            second = cg(system, 2.0 * b, M=mg, tol=1e-8, maxiter=500)
    counts = {k: rec.count for k, rec in timer.records.items()}
    K = "krylov"
    its = first.niter + second.niter
    assert counts[K + "/capture"] == 1
    assert counts[K + "/iter"] == counts[K + "/iter/sync"] == its
    assert counts[K + "/vcycle"] == 2             # each call's set-up
    assert counts[K + "/capture/vcycle"] == 1
    assert counts[K + "/capture/vcycle/L1"] == 2
    assert counts[K + "/capture/matvec"] == 1
    assert not any(k.startswith(K + "/iter/") and k != K + "/iter/sync"
                   for k in counts)


def test_graph_route_passes_through_solve_system(box, graphed, monkeypatch):
    monkeypatch.setenv("TOPOPT_MG_CACHE_DIR", "off")
    p = _problem(box, torch.float32)
    cfg = tt.SolverConfig(method="cg", preconditioner="multigrid",
                          tolerance=1e-10, verbose=False)
    r1 = tt.solve_system(p, cfg)
    r2 = tt.solve_system(p, cfg)
    assert r1.converged and r1.refinement_passes >= 2
    assert r1.graph_iterations == r1.iterations > 0
    assert "solve/krylov/capture" in r1.timings
    assert "solve/krylov/capture" not in r2.timings
    assert len(graphed) == 1
    monkeypatch.setattr(solvers, "_captures", lambda A, b, M: False)
    r3 = tt.solve_system(p, cfg)
    assert r3.graph_iterations == 0
    assert r3.iterations == r2.iterations == r1.iterations
    assert np.array_equal(r3.u, r1.u) and r3.energy == r1.energy
