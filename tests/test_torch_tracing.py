"""Spans inside the port's solve (``utils.profiling.span``,
``PhaseTimer.call``), on the CPU.

A float32 block-ELL multigrid solve of a small imported box (two smoothed
levels) runs under ``torch.profiler``: its ranges name the build's
phases, the MG-PCG loop, the V-cycle's levels, the refinement and the
tail, each inside its parent's range and all inside the call's range,
which carries the call's number.  Without a profiler the same solve opens
no range and gives the same bits.  A span outside any timer does nothing
and lets the body's errors through; spans on worker threads are dropped.
"""

import functools
import threading

import numpy as np
import pytest
import torch

import topopteval_tpu_torch as tt
from topopteval_tpu_torch import api
from topopteval_tpu_torch.fem import bell
from topopteval_tpu_torch.fem.bc import free_mask_from_bcs
from topopteval_tpu_torch.fem.multigrid import build_unstructured_multigrid
from topopteval_tpu_torch.parallel import sweep
from topopteval_tpu_torch.utils import profiling
from topopteval_tpu_torch.utils.profiling import PhaseTimer, span

tt.set_verbosity(False)
torch.set_num_threads(1)

CFG = tt.SolverConfig(method="cg", preconditioner="multigrid",
                      tolerance=1e-10, verbose=False)
K = "solve/krylov"
#: the keys the benchmark reads (build_s.designs, refine_host_s.loads)
EXISTING = {"build_operator", "solve", "postprocess",
            "refine_host_build_seconds", "refine_host_matvec_seconds"}


@pytest.fixture(scope="module")
def box(tmp_path_factory):
    g = tt.generate_grid_tet(12, 4, 4, (0, 0, 0), (6.0, 2.0, 2.0))
    path = tt.write_vtu(str(tmp_path_factory.mktemp("box") / "box.vtu"), g)
    return tt.import_mesh(path)


@pytest.fixture
def fresh(monkeypatch):
    """Every solve builds its hierarchy, skeleton included, with two
    smoothed levels (325, 81 nodes) above the dense coarse solve."""
    monkeypatch.setenv("TOPOPT_MG_CACHE_DIR", "off")
    monkeypatch.setattr(api, "_SKEL_RAM_CACHE", {})
    monkeypatch.setattr(bell, "build_bell_multigrid", functools.partial(
        bell.build_bell_multigrid, max_coarse_dofs=100))


def _problem(mesh):
    p = tt.setup_problem(mesh, dtype=torch.float32, device="cpu")
    tt.assemble_stiffness_matrix(p, *tt.lame_parameters(1.0, 0.3))
    tt.apply_fixed_boundary(p, tt.nodes_at_plane(mesh, 0, 0.0))
    tt.apply_force(p, tt.nodes_at_plane(mesh, 0, 6.0), [0.0, 0.0, -1.0])
    return p


def _profiled(fn):
    """fn()'s result and the trace's user ranges: (start_ns, end_ns, name,
    the range's arguments)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts, record_shapes=True) as prof:
        out = fn()
    ranges = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name(),
               list(e.concrete_inputs()))
              for e in prof.profiler.kineto_results.events()
              if e.is_user_annotation()]
    return out, ranges


def _names(ranges):
    return [name for _, _, name, _ in ranges]


def _assert_nested(ranges, outer):
    """Each range lies inside a range of its nearest enclosing path (the
    call's range ``outer`` for a top-level phase)."""
    spans = {}
    for s, e, name, _ in ranges:
        spans.setdefault(name, []).append((s, e))
    for s, e, name, _ in ranges:
        if name == outer:
            continue
        parent = name
        while "/" in parent:
            parent = parent.rsplit("/", 1)[0]
            if parent in spans:
                break
        else:
            parent = outer
        assert any(ps <= s and e <= pe for ps, pe in spans[parent]), \
            (name, parent)


def test_solve_spans_nest_under_the_profiler(box, fresh, monkeypatch):
    timers = []

    class Kept(PhaseTimer):
        def __init__(self):
            super().__init__()
            timers.append(self)

    monkeypatch.setattr(api, "PhaseTimer", Kept)
    r, ranges = _profiled(lambda: tt.solve_system(_problem(box), CFG))
    assert r.converged and r.refinement_passes >= 2
    names = set(_names(ranges))
    want = {"solve_system", "build_operator", "build_operator/skeleton",
            "build_operator/skeleton/unit_operator",
            "build_operator/values_matvec", "build_operator/rap_chain",
            "build_operator/coarse_pinv", "build_operator/upload", "solve",
            K, K + "/matvec", K + "/sync", K + "/vcycle", K + "/vcycle/L0",
            K + "/iter", K + "/iter/matvec", K + "/iter/update",
            K + "/iter/sync", K + "/iter/vcycle", K + "/iter/vcycle/L0",
            K + "/iter/vcycle/L1", K + "/iter/vcycle/coarse",
            "solve/refine/residual", "solve/refine/transfer", "verify",
            "relayout", "postprocess", "download"}
    assert want <= names, want - names
    _assert_nested(ranges, "solve_system")
    # the timings hold every span, under the same paths
    assert set(r.timings) == (names - {"solve_system"}) | EXISTING
    assert 0 < r.timings[K] <= r.timings["solve"] == r.solve_time
    # the V-cycle runs once before each cg loop and once an iteration
    counts = {k: rec.count for k, rec in timers[0].records.items()}
    vcycles = sum(c for k, c in counts.items() if k.endswith("/vcycle"))
    assert vcycles == r.iterations + r.refinement_passes
    assert sum(n.endswith("/vcycle") for n in _names(ranges)) == vcycles
    assert counts[K + "/iter"] == r.iterations
    assert counts[K + "/iter/sync"] == r.iterations
    assert counts[K] == r.refinement_passes
    # each level's own work: down and up once a V-cycle
    assert counts[K + "/iter/vcycle/L1"] == 2 * r.iterations
    assert counts[K + "/iter/vcycle/coarse"] == r.iterations


def test_call_number_is_the_outer_range_argument(box, fresh):
    p = _problem(box)
    _, ranges = _profiled(lambda: [tt.solve_system(p, CFG)
                                   for _ in range(2)])
    calls = [args for _, _, name, args in ranges if name == "solve_system"]
    assert len(calls) == 2
    (a,), (b,) = calls
    assert isinstance(a, int) and isinstance(b, int) and a != b
    # every span of a call inside that call's range
    (s0, e0), (s1, e1) = [(s, e) for s, e, n, _ in ranges
                          if n == "solve_system"]
    inner = [(s, e) for s, e, n, _ in ranges if n != "solve_system"]
    assert all(s0 <= s and e <= e0 or s1 <= s and e <= e1
               for s, e in inner)


def test_solve_without_profiler_opens_no_range(box, fresh, monkeypatch):
    traced, _ = _profiled(lambda: tt.solve_system(_problem(box), CFG))
    monkeypatch.setattr(api, "_SKEL_RAM_CACHE", {})
    opened = []
    enter = profiling._range_enter
    monkeypatch.setattr(profiling, "_range_enter",
                        lambda *a: opened.append(a) or enter(*a))
    rf_enter = torch.autograd.profiler.record_function.__enter__
    monkeypatch.setattr(torch.autograd.profiler.record_function, "__enter__",
                        lambda self: opened.append(self) or rf_enter(self))
    r = tt.solve_system(_problem(box), CFG)
    assert opened == []
    assert r.iterations == traced.iterations
    assert r.refinement_passes == traced.refinement_passes
    assert r.energy == traced.energy
    assert np.array_equal(r.u, traced.u)
    assert np.array_equal(r.von_mises, traced.von_mises)
    assert EXISTING <= set(r.timings) and set(r.timings) == set(
        traced.timings)


@pytest.mark.parametrize("case", ["no_timer", "errors_no_timer",
                                  "errors_in_timer"])
def test_span_outside_a_timer_is_a_no_op(case):
    """Outside any timer a span does nothing; in and out of one, it lets
    the body's errors through (the old ``trace`` test's case)."""
    assert profiling._CURRENT.get() is None
    if case == "no_timer":
        with span("phase-x") as s:
            x = 1 + 1
        assert x == 2 and not hasattr(s, "seconds")
    elif case == "errors_no_timer":
        with pytest.raises(ZeroDivisionError):
            with span("phase-y"):
                1 / 0
    else:
        t = PhaseTimer()
        with t.call("c"):
            with pytest.raises(ZeroDivisionError):
                with span("a"):
                    with span("b"):
                        1 / 0
            with span("after"):
                pass
        assert t._stack == []
        assert {k: r.count for k, r in t.records.items()} == {
            "a": 1, "a/b": 1, "after": 1}
    assert profiling._CURRENT.get() is None


def test_value_pass_phases_for_chip_smoke(box):
    """``info["phases"]`` and ``["skeleton_phases"]`` keep the names
    chip_smoke.py prints, from the build's spans, with or without a
    timer; the spans land on a current timer."""
    lam, mu = tt.lame_parameters(1.0, 0.3)
    p = _problem(box)
    mask = free_mask_from_bcs(p.n_dofs, p.bcs)
    kw = dict(free_mask=mask, dtype=torch.float32, device="cpu")
    _, _, info = bell.build_bell_multigrid(box, lam, mu, **kw)
    assert set(info["phases"]) == {"values_matvec", "fine_binv_lam_max",
                                   "rap_chain", "coarse_pinv", "upload"}
    assert set(info["skeleton_phases"]) == {
        "structure_sort", "rcm_permute", "csr_structure", "unit_assembly",
        "unit_operator", "level_chain"}
    assert all(v >= 0 for v in info["phases"].values())
    t = PhaseTimer()
    with t.call("c"):
        _, _, info2 = bell.build_bell_multigrid(box, lam, mu, **kw)
    assert set(info2["phases"]) == set(info["phases"])
    assert {"skeleton", "skeleton/unit_operator", "values_matvec",
            "upload"} <= set(t.records)
    assert info2["phases"]["rap_chain"] == round(
        t.records["rap_chain"].seconds, 3)
    # the monolithic build and its rap chain's sub-phases
    _, _, mono = bell._build_bell_multigrid_legacy(box, lam, mu, **kw)
    assert {"assemble_triplets", "rcm_permute", "fine_pack", "rap_chain",
            "coarse_pinv", "upload"} <= set(mono["phases"])
    assert set(mono["phases"]["rap_chain_sub"]) == {
        "tables", "rap_scipy", "reorder", "pack", "binv_lam_max"}
    # the Galerkin voxel build (chip_smoke.py 10b/10c)
    g = tt.generate_grid_tet(8, 2, 2, (0, 0, 0), (4.0, 1.0, 1.0))
    ginfo = {}
    build_unstructured_multigrid(g, lam, mu, device="cpu", info=ginfo)
    assert set(ginfo["phases"]) == {
        "fine_op_and_blocks", "transfer_and_fine_lambda_max", "probing",
        "coarse_levels", "coarsest_pinv"}


def test_worker_thread_spans_are_dropped():
    seen = []

    def job():
        with span("worker"):
            seen.append(threading.current_thread().name)
        return profiling._CURRENT.get()

    t = PhaseTimer()
    with t.call("c"):
        out = sweep.run_on_devices([(torch.device("cpu"), job),
                                    (torch.device("meta"), job)])
    assert len(seen) == 2 and out == [None, None]
    assert "worker" not in t.records and t._stack == []


def test_sweep_spans():
    mesh = tt.generate_grid_tet(6, 3, 3, (0, 0, 0), (2.0, 1.0, 1.0))
    p = tt.setup_problem(mesh, dtype=torch.float32, device="cpu")
    tt.apply_fixed_boundary(p, tt.nodes_at_plane(mesh, 0, 0.0))
    loads = np.zeros((2, p.n_dofs))
    tip = tt.nodes_at_plane(mesh, 0, 2.0)
    loads[0, 3 * tip + 2] = -1.0
    loads[1, 3 * tip + 1] = -1.0
    dens = np.random.default_rng(3).uniform(0.7, 1.0, (2, mesh.n_cells))
    mat = tt.SIMPMaterial(E0=1.0, nu=0.3, Emin=1e-9, p=3.0)
    (e, it, cv), ranges = _profiled(lambda: tt.evaluate_design_batch(
        p, dens, loads, material=mat, tol=1e-6, maxiter=500))
    assert cv.all()
    names = _names(ranges)
    assert {"evaluate_design_batch", "sweep", "sweep/prepare",
            "sweep/kernel_build", "sweep/upload", "sweep/pcg",
            "sweep/pcg/iter",
            "sweep/pcg/iter/sync", "sweep/energy"} <= set(names)
    _assert_nested(ranges, "evaluate_design_batch")
    # one iter a step of the slowest lane, and the last check
    assert names.count("sweep/pcg/iter") == int(it.max()) + 1
    args = [a for _, _, n, a in ranges if n == "evaluate_design_batch"]
    assert len(args) == 1 and isinstance(args[0][0], int)


def test_sharded_solve_spans(box, fresh):
    p = _problem(box)
    r, ranges = _profiled(lambda: tt.solve_system(p, CFG,
                                                  devices=["cpu"] * 2))
    assert r.converged and r.method == "cg(multigrid,sharded)"
    names = _names(ranges)
    assert {K, K + "/iter/vcycle/L0", K + "/iter/vcycle/L1",
            K + "/iter/vcycle/coarse", "solve/refine/residual",
            "build_operator/hierarchy", "build_operator/halo",
            "download"} <= set(names)
    _assert_nested(ranges, "solve_system")
    assert sum(n.endswith("/vcycle") for n in names) == (
        r.iterations + r.refinement_passes)
    assert r.timings[K] <= r.timings["solve"] == r.solve_time
