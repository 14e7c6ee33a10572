"""Phase timer, profiler hooks and device residency of the port (the cases
of tests/test_profiling.py), on the CPU.

``device_tree_bytes`` is held to the sum of an operator's tensors counted
by hand, a shared storage once; ``profile_to`` writes a Chrome trace that
names the operator's ops and the timer's phase.  Spans and their profiler
ranges: tests/test_torch_tracing.py.
"""

import json
import os
import time

import numpy as np
import pytest
import torch

import topopteval_tpu_torch as tt
from topopteval_tpu_torch.utils.profiling import (PhaseTimer,
                                                  device_tree_bytes,
                                                  profile_to)

tt.set_verbosity(False)
torch.set_num_threads(1)


def test_phase_timer_accumulates_and_reports():
    t = PhaseTimer()
    with t.phase("assemble"):
        time.sleep(0.01)
    for _ in range(3):
        with t.phase("solve"):
            time.sleep(0.005)
    with t.phase("solve"):
        with t.phase("inner"):
            time.sleep(0.002)
    d = t.as_dict()
    assert d["assemble"] >= 0.01
    assert d["solve"] >= 0.015
    assert "solve/inner" in d and t.records["solve"].count == 4
    rep = t.report()
    assert "assemble" in rep and "%" in rep
    assert t.total() >= d["assemble"] + d["solve"]


def test_solve_results_carry_timings():
    r = tt.solve_system(tt.models.cube_under_gravity(3, device="cpu"),
                        tt.SolverConfig(method="direct", verbose=False))
    assert r.timings is not None
    assert "solve" in r.timings and "postprocess" in r.timings


def _operator():
    mesh = tt.generate_grid_tet(4, 2, 2)
    p = tt.setup_problem(mesh, dtype=torch.float64, device="cpu")
    tt.assemble_stiffness_matrix(p, *tt.lame_parameters(1.0, 0.3))
    tt.apply_fixed_boundary(p, tt.nodes_at_plane(mesh, 0, 0.0))
    return p.build_operator(with_bc=True)


def _tensors(obj, seen=None):
    """Every tensor attribute of the operator's own objects, by hand."""
    out = []
    for v in vars(obj).values():
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif hasattr(v, "__dict__") and not isinstance(v, type):
            out.extend(_tensors(v))
    return out


def test_device_tree_bytes_counts_each_storage_once():
    op = _operator()
    tensors = _tensors(op)
    assert tensors
    by_storage = {t.untyped_storage().data_ptr():
                  t.untyped_storage().nbytes() for t in tensors}
    assert device_tree_bytes(op) == sum(by_storage.values())
    # views and aliases add nothing; nesting in containers is walked
    a = torch.zeros(100, dtype=torch.float64)
    holder = {"a": a, "views": [a[:10], a.reshape(10, 10)],
              "pair": (a, torch.ones(3, dtype=torch.float32))}
    assert device_tree_bytes(holder) == 800 + 12
    assert device_tree_bytes([op, op, holder]) \
        == sum(by_storage.values()) + 812
    assert device_tree_bytes(np.zeros(10)) == 0


def test_profile_to_writes_a_chrome_trace(tmp_path):
    op = _operator()
    u = torch.ones(op.n_dofs, dtype=torch.float64)
    with profile_to(str(tmp_path)) as prof:
        with PhaseTimer().phase("three-matvecs"):
            for _ in range(3):
                u = op.matvec(u)
    assert prof.path is not None and os.path.exists(prof.path)
    assert os.path.dirname(prof.path) == str(tmp_path)
    with open(prof.path) as fh:
        events = json.load(fh)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "three-matvecs" in names
    assert any(n and n.startswith("aten::") for n in names)
    with pytest.raises(RuntimeError):
        with profile_to(str(tmp_path / "err")):
            raise RuntimeError("the body's own error")
