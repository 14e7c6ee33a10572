"""The harness on the CPU: its arguments, the files it finds by name,
each cell at a small size with the port's plain versions, the result
line's keys, the reference against the port, the trace reduction and the
frozen byte counts."""

import json
import os

import numpy as np
import pytest

from benchmark.core import harness, meshgen, trace
from benchmark.roofline import bell_matvec, peaks, sweep_iteration
from benchmark.tests._tiny import TINY

BENCH = os.path.join(harness.HERE, os.pardir, "BENCHMARK.json")
KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


def _bench():
    with open(BENCH) as fh:
        return json.load(fh)


def test_arguments(capsys):
    with pytest.raises(SystemExit):
        harness.main(["--workload", "beam1m_tet4.designs"])
    # no card here: a non-zero exit and no result line
    code = harness.main(["--workload", "beam1m_tet4.designs", "--seed",
                         str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"])
    assert code != 0 and capsys.readouterr().out == ""


def test_files_found_by_name():
    b = _bench()
    per_layer = {m["name"]: m for m in b["per_layer"]}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for c in b["configs"]:
        assert os.path.exists(os.path.join(harness.HERE, os.pardir,
                                           c["file"]))
        assert harness.load_json("configs", c["name"])["name"] == c["name"]
    for cell in b["workloads"]:
        w, cfg, mix = harness.cell(cell["name"])
        assert (w["config"], w["traffic"]) == (cell["config"],
                                               cell["traffic"])
        assert w["chips"] == cell["chips"] == 1
        harness.load_module("requests", mix["request"])
        for h in w.get("trace_hooks", []):
            harness.load_module("roofline", h)
        assert "setup_s" in w["end_to_end"]
        for m in w["end_to_end"]:
            spec = e2e[m]
            assert cell["name"] in spec.get("workloads", [cell["name"]])
            assert harness.load_module("metrics", m).UNIT == spec["unit"]
        for m in w["per_layer"]:
            spec = per_layer[m]
            assert cell["name"] in spec["workloads"]
            assert spec["moves"] in w["end_to_end"]
            assert harness.load_module("metrics", m).UNIT == spec["unit"]
    for m in per_layer.values():
        for cell in m["workloads"]:
            assert m["name"] in harness.cell(cell)[0]["per_layer"]


@pytest.mark.parametrize("trace_on", [0, 1])
@pytest.mark.parametrize("name", sorted(TINY))
def test_cell_runs_small(name, trace_on):
    code, r = harness.run_cell(name, 2 ** 31 + 11, 0.3, bool(trace_on),
                               device="cpu", overrides=TINY[name])
    assert code == 0
    assert set(r) == KEYS | ({"breakdown"} if trace_on else set())
    assert list(r)[-1] == "checks"
    # the reference agrees with the port at this size
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    w = harness.cell(name)[0]
    names = w["per_layer"] if trace_on else w["end_to_end"]
    assert set(r["metrics"]) <= set(names)
    if not trace_on:
        assert set(r["metrics"]) == set(names)
        assert all(v["value"] > 0 for v in r["metrics"].values())
    else:
        assert {"busy_s", "window_s"} <= set(r["device"])
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


def test_trace_reduce():
    ms = 1_000_000
    ranges = [(0, 100 * ms, "bench.request"),
              (10 * ms, 60 * ms, "build_operator"),
              (100 * ms, 140 * ms, "bench.request")]
    device = [(0, 10 * ms, "k1"), (60 * ms, 90 * ms, "k2"),
              (80 * ms, 100 * ms, "Memcpy DtoH"), (120 * ms, 130 * ms, "k1")]
    s = trace.reduce(ranges, device)
    assert s.window_s == pytest.approx(0.14)
    assert s.busy_s == pytest.approx(0.06)
    assert s.kernels == 3
    assert s.by_name["k1"] == (2, pytest.approx(0.02))
    assert s.idle_by_range["build_operator"] == pytest.approx(0.05)
    assert s.idle_by_range["bench.request"] == pytest.approx(0.03)
    assert trace.reduce([], device) is None


def test_trace_from_profiler():
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(trace.REQUEST_RANGE):
            with torch.profiler.record_function("build_operator"):
                torch.ones(64, 64) @ torch.ones(64, 64)
    s = trace.summarize(prof.profiler.kineto_results.events())
    assert s.busy_s == 0 and s.kernels == 0 and s.window_s > 0
    assert set(s.idle_by_range) == {"build_operator"}


def test_frozen_bounds():
    import torch
    from topopteval_tpu_torch.tools import _timing
    for nb, ops, item, dt in ((1e9, 1e9, 4, torch.float32),
                              (1e6, 1e12, 8, torch.float64)):
        assert peaks.bound_ms(nb, ops, item) == _timing.bound_ms(nb, ops, dt)
    # one fp32 launch of 10 rows, 30 blocks, no lo plane, on 12 columns
    assert bell_matvec.launch_bytes(10, 30, 30 * 36, 0, 12, 4) == (
        11 * 4 + 30 * 4 + 30 * 36 + 3 * 12 * 4 + 3 * 10 * 4)
    sizes = {"n_cells": 122880, "n_nodes": 24057, "itemsize": 4}
    per_lane = sweep_iteration.lane_bytes(122880, 24057, 4)
    assert 4.0e6 < per_lane < 4.5e6
    t = sweep_iteration.least_seconds(np.full((64, 4), 10), sizes)
    assert t == pytest.approx((2560 * per_lane + 10 * (3 * 24057 * 8
                               + 16 * 122880)) / peaks.HBM_BYTES_PER_S)


def test_mesh_is_the_generated_beam(tmp_path):
    import topopteval_tpu_torch as tt
    coords, conn = meshgen.box_tet4((6, 3, 2), (0, 0, 0), (3.0, 1.0, 1.0))
    g = tt.generate_grid_tet(6, 3, 2, (0, 0, 0), (3.0, 1.0, 1.0))
    assert np.array_equal(coords, g.coords) and np.array_equal(conn, g.conn)
    back = tt.import_mesh(meshgen.write_vtu(str(tmp_path / "m.vtu"),
                                            coords, conn))
    assert np.array_equal(back.coords, coords)
    assert np.array_equal(back.conn, conn)
    assert back.structured_info is None


def test_design_traffic():
    from benchmark.core import generator as gen
    spec = harness.load_json("traffic", "designs")["design"]
    mesh = {"dims": [20, 8, 4]}
    a = gen.design(spec, mesh, gen.rng(2 ** 31 + 7, gen.REQUEST, 0))
    b = gen.design(spec, mesh, gen.rng(2 ** 31 + 7, gen.REQUEST, 0))
    c = gen.design(spec, mesh, gen.rng(2 ** 31 + 7, gen.REQUEST, 1))
    assert a.shape == (20 * 8 * 4 * 6,) and np.array_equal(a, b)
    assert not np.array_equal(a, c)
    assert a.min() >= 0.0 and a.max() <= 1.0
    # void stays void; material moves by at most ``move`` of itself
    base_a = gen.design({**spec, "move": 0.0}, mesh, gen.rng(1, 0))
    assert np.array_equal(a == 0, base_a == 0)
    assert np.all(np.abs(a - base_a) <= spec["move"] * base_a + 1e-15)
    # six tets a hex share one density
    assert (a.reshape(-1, 6) == a.reshape(-1, 6)[:, :1]).all()
    # unmoved, each hex takes the source hex at its centroid
    base = harness.load_json("designs", spec["base"])
    src = np.asarray(base["density"]).reshape(base["dims"])
    raw = gen.design({**spec, "move": 0.0},
                     {"dims": base["dims"]}, gen.rng(1, 0))
    assert np.array_equal(raw[::6], src.reshape(-1))
    fine = gen.design({**spec, "move": 0.0},
                      {"dims": [120, 40, 8]}, gen.rng(1, 0))[::6]
    assert np.array_equal(fine.reshape(120, 40, 8)[::2, ::2, ::2], src)


def test_metric_found_by_quantity():
    assert harness.load_module("metrics", "idle_share.loads").UNIT == "%"
    assert harness.load_module("metrics", "iters.designs").UNIT == "count"
    with pytest.raises(FileNotFoundError):
        harness.load_module("metrics", "no_such_metric")


def test_b4_bytes_without_python_calls():
    hook = bell_matvec.Hook.__new__(bell_matvec.Hook)
    hook.calls, hook.launches = [], []
    with pytest.raises(RuntimeError):
        hook.least_seconds(3)
    hook.calls = [1.0, 2.0, 3.0, 2.0]
    hook.launches = [3.0, 2.0]
    assert hook.least_seconds(2) == 5.0
    # replayed launches (no Python call each): the calls' mean bound
    assert hook.least_seconds(10) == pytest.approx(20.0)


def test_load_directions_same_set_every_seed():
    from benchmark.core import generator as gen
    d = gen.direction_set(12)
    assert np.allclose(np.linalg.norm(d, axis=1), 1.0)
    assert np.abs(d.mean(axis=0)).max() < 0.1
    w, cfg, mix = harness.cell("beam1m_tet4.loads", TINY["beam1m_tet4.loads"])
    client = harness.load_module("requests", mix["request"]).Client
    import types
    seen = []
    for seed in (2 ** 31 + 1, 2 ** 33 + 7):
        c = client(types.SimpleNamespace(tt=None, torch=None, cfg=cfg,
                                         mix=mix, seed=seed, device=None,
                                         tmp=None))
        seen.append([tuple(c.vector(i)) for i in range(12)])
    assert sorted(seen[0]) == sorted(seen[1]) and seen[0] != seen[1]
