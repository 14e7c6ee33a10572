"""The cells ``box_sweep_c5.one`` and ``beam1m_tet10.selfweight`` on the
CPU, at sizes of their own: each runs and the reference agrees with the
port there; the Tet10 control and broken solves come out not correct;
the Tet10 reference's two copies agree and load nothing of either
package; the new readers read nothing from a program without the spans
they read."""

import importlib.util
import os
import tempfile
import types

import numpy as np
import pytest
import torch

from benchmark import controls
from benchmark.core import harness
from benchmark.reference import tet10
from benchmark.tests.test_bench_controls import _solve_fault
from benchmark.tests.test_bench_imports import JAX_SIDE, _modules

TET10 = "beam1m_tet10.selfweight"
ONE = "box_sweep_c5.one"
#: the beam cells' tiny box (tests/_tiny.py) and its soft void
TINY = {TET10: {"config": {"mesh": {"dims": [8, 4, 2],
                                    "hi": [6.0, 2.0, 2.0]},
                           "material": {"Emin": 1e-3}}},
        ONE: {"config": {"mesh": {"dims": [8, 4, 2]}}}}
KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


@pytest.mark.parametrize("trace_on", [0, 1])
@pytest.mark.parametrize("name", sorted(TINY))
def test_new_cell_runs_small(name, trace_on):
    code, r = harness.run_cell(name, 2 ** 31 + 31, 0.3, bool(trace_on),
                               device="cpu", overrides=TINY[name])
    assert code == 0
    assert set(r) == KEYS | ({"breakdown"} if trace_on else set())
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    w = harness.cell(name)[0]
    if trace_on:
        assert set(r["metrics"]) <= set(w["per_layer"])
    else:
        assert set(r["metrics"]) == set(w["end_to_end"])
        assert all(v["value"] > 0 for v in r["metrics"].values())
    if name == TET10 and trace_on:
        # the program's own counters and spans, read on the CPU too
        assert {"volume_load_s.selfweight", "refine_host_s.selfweight",
                "iters.selfweight"} <= set(r["metrics"])


def test_tet10_client_clamps_the_quadratic_plane():
    """Set-up raises the order, clamps every node of the x = 0 plane of
    the program's Tet10 mesh (mid-edge nodes included) and solves."""
    _, cfg, mix = harness.cell(TET10, TINY[TET10])
    import topopteval_tpu_torch as tt
    tt.set_verbosity(False)
    ctx = types.SimpleNamespace(tt=tt, torch=torch, cfg=cfg, mix=mix,
                                seed=2 ** 31 + 37, device=torch.device("cpu"),
                                tmp=None)
    with tempfile.TemporaryDirectory() as tmp:
        ctx.tmp = tmp
        client = harness.load_module("requests", mix["request"]).Client(ctx)
        client.setup()
    nx, ny, nz = cfg["mesh"]["dims"]
    assert client.problem.mesh.element_type == "tet10"
    assert len(client.clamped) == (2 * ny + 1) * (2 * nz + 1)
    assert client.sizes == {"n_cells": 6 * nx * ny * nz,
                            "n_nodes": client.problem.mesh.n_nodes}
    # the six directions, in an order drawn from the seed
    seen = {tuple(client.vector(i)) for i in range(6)}
    assert len(seen) == 6


def test_reference_copies_agree():
    path = os.path.join(os.path.dirname(harness.HERE), "tests",
                        "plain_tet10.py")
    spec = importlib.util.spec_from_file_location("_plain_tet10", path)
    plain = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(plain)
    from benchmark.core.meshgen import box_tet4
    c4, k4 = box_tet4((3, 2, 2), (0, 0, 0), (3.0, 1.0, 1.0))
    (ca, ka), (cb, kb) = plain.tet10_mesh(c4, k4), tet10.tet10_mesh(c4, k4)
    assert np.array_equal(ca, cb) and np.array_equal(ka, kb)
    rng = np.random.default_rng(5)
    rho = rng.uniform(0.0, 1.0, len(k4))
    u = torch.as_tensor(rng.normal(size=(len(ca), 3, 1)))
    lam = torch.as_tensor(rng.uniform(0.5, 1.0, (len(k4), 1)))
    mu = torch.as_tensor(rng.uniform(0.5, 1.0, (len(k4), 1)))
    a, b = plain.Tet10Reference(ca, ka), tet10.Tet10Reference(cb, kb)
    assert torch.equal(a.apply(u, lam, mu), b.apply(u, lam, mu))
    assert torch.equal(a.von_mises(u, lam, mu), b.von_mises(u, lam, mu))
    assert np.array_equal(a.body_force([0, 0, -1], rho),
                          b.body_force([0, 0, -1], rho))
    shuffled = rng.permutation(len(ca))
    assert np.array_equal(tet10.match_nodes(ca, ca[shuffled]), shuffled)


def test_tet10_reference_loads_nothing_of_either_package():
    names = _modules(
        "import sys, json\n"
        "sys.path.insert(0, '.')\n"
        "import benchmark.reference.tet10, benchmark.reference.control_tet10\n"
        "sys.path.insert(0, 'tests')\n"
        "import plain_tet10\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    assert not names & (JAX_SIDE | {"topopteval_tpu_torch"})


def test_tet10_control_is_not_correct():
    spec = {"name": "precision", "kind": "precision"}
    assert spec in harness.cell(TET10)[0]["controls"]
    got, notes = controls.readings(TET10, spec, 2 ** 31 + 3, "cpu",
                                   TINY[TET10])
    assert controls.verdict(TET10, got, TINY[TET10]), got
    assert notes["solve_steps"] > 0


@pytest.mark.parametrize("fault", ["unchanged", "displacement", "energy",
                                   "stress"])
def test_broken_tet10_solve_is_not_correct(fault, monkeypatch):
    import topopteval_tpu_torch as tt
    monkeypatch.setattr(tt, "solve_system", _solve_fault(fault))
    code, r = harness.run_cell(TET10, 2 ** 31 + 21, 0.2, False,
                               device="cpu", overrides=TINY[TET10])
    assert code == 0 and r["correct"] is False, r["checks"]


def test_new_readers_read_nothing_without_their_spans():
    run = types.SimpleNamespace(
        records=[{"timings": {}, "timings_before": {}, "iterations": 3,
                  "load_timings": {}}],
        trace=None, hooks={})
    for m in ("volume_load_s.selfweight", "refine_host_s.selfweight",
              "b4_roofline.selfweight", "idle_share.one"):
        assert harness.load_module("metrics", m).read(run) is None
    run.records[0]["load_timings"] = {"volume_force": 0.25}
    reader = harness.load_module("metrics", "volume_load_s.selfweight")
    assert reader.read(run) == 0.25 and reader.UNIT == "s"
