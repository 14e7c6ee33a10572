"""``correct`` has to come out false where it should: for each cell's
control (the reference one precision below the configuration's, in the
program's place), and for a run whose timed path is broken underneath:
a solve that returns its state unchanged, an answer altered where it is
produced, half of a batch left out with the mean of the rest in its
place.  At a small size on the CPU; ``benchmark/controls.py`` runs the
controls at each cell's own size on the card."""

import numpy as np
import pytest

from benchmark import controls
from benchmark.core import harness
from benchmark.tests._tiny import TINY


@pytest.mark.parametrize("name", sorted(TINY))
def test_control_is_not_correct(name):
    spec = {"name": "precision", "kind": "precision"}
    assert spec in harness.cell(name)[0]["controls"]
    got, _ = controls.readings(name, spec, 2 ** 31 + 3, "cpu", TINY[name])
    assert controls.verdict(name, got, TINY[name]), got


def test_tolerance_control_runs():
    """The sweep's guarantee broken (its tolerance 1000 times looser)
    runs through the program and is judged like a run; its reading at the
    cell's size is in PERF.md."""
    name = "box_sweep_c5.batch"
    spec = next(c for c in harness.cell(name)[0]["controls"]
                if c["name"] == "tol_x1000")
    got, notes = controls.readings(name, spec, 2 ** 31 + 4, "cpu",
                                   TINY[name])
    assert set(got) == {"lane_err"} and np.isfinite(got["lane_err"])
    assert notes["failed"] == 0


def _solve_fault(kind):
    import topopteval_tpu_torch as tt
    real = tt.solve_system

    def broken(problem, config=None, **kw):
        r = real(problem, config, **kw)
        if kind == "unchanged":
            r.u = np.zeros_like(r.u)
            r.energy = 0.0
        elif kind == "displacement":
            r.u = r.u.copy()
            r.u[int(np.argmax(np.abs(r.u)))] *= 1.001
        elif kind == "energy":
            r.energy *= 1 + 1e-9
        elif kind == "stress":
            r.von_mises = r.von_mises.copy()
            r.von_mises[int(np.argmax(r.von_mises))] *= 1.5
        return r

    return broken


def _batch_fault(kind):
    import topopteval_tpu_torch as tt
    real = tt.evaluate_design_batch

    def broken(problem, densities, load_cases=None, **kw):
        if kind == "half":
            B = densities.shape[0]
            e, it, cv = real(problem, densities[: max(1, B // 2)],
                             load_cases, **kw)
            fill = e.mean(axis=0, keepdims=True)
            e = np.concatenate([e, np.repeat(fill, B - e.shape[0], 0)])
            it = np.concatenate([it, np.repeat(it[:1], B - it.shape[0], 0)])
            cv = np.concatenate([cv, np.repeat(cv[:1], B - cv.shape[0], 0)])
            return e, it, cv
        e, it, cv = real(problem, densities, load_cases, **kw)
        if kind == "unchanged":
            e = np.zeros_like(e)
        elif kind == "answer":
            e = e.copy()
            e[0, 0] *= 1.01
        return e, it, cv

    return broken


@pytest.mark.parametrize("fault", ["unchanged", "displacement", "energy",
                                   "stress"])
@pytest.mark.parametrize("name", ["beam1m_tet4.designs",
                                  "beam1m_tet4.loads"])
def test_broken_solve_is_not_correct(name, fault, monkeypatch):
    import topopteval_tpu_torch as tt
    monkeypatch.setattr(tt, "solve_system", _solve_fault(fault))
    code, r = harness.run_cell(name, 2 ** 31 + 21, 0.2, False,
                               device="cpu", overrides=TINY[name])
    assert code == 0 and r["correct"] is False, r["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "answer", "half"])
def test_broken_batch_is_not_correct(fault, monkeypatch):
    import topopteval_tpu_torch as tt
    name = "box_sweep_c5.batch"
    monkeypatch.setattr(tt, "evaluate_design_batch", _batch_fault(fault))
    code, r = harness.run_cell(name, 2 ** 31 + 23, 0.2, False,
                               device="cpu", overrides=TINY[name])
    assert code == 0 and r["correct"] is False, r["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("name,control", [
    (n, c["name"]) for n in sorted(TINY) for c in harness.cell(n)[0]["controls"]
    if c.get("fails", True)])
def test_control_on_card(name, control):
    """At the cell's own size: every control that has to fail does."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    spec = next(c for c in harness.cell(name)[0]["controls"]
                if c["name"] == control)
    got, _ = controls.readings(name, spec, 2 ** 31 + 3, "cuda")
    assert controls.verdict(name, got), got
