"""Run one cell once: set-up, a closed-loop window of ``--seconds``, the
reference's judgement, and one JSON line.

Everything that belongs to one cell, configuration, traffic mix, request
kind or metric is a file found by its name:

- ``workloads/<cell>.json``: the cell's configuration, traffic mix,
  metrics, trace length, trace hooks and the limits of its comparison;
- ``configs/<config>.json``: the deployment (mesh, material, clamp,
  solver settings, environment);
- ``traffic/<mix>.json``: the mix's parameters, read by
  ``core/generator.py``; its ``request`` names the client
  ``requests/<request>.py``;
- ``metrics/<metric>.py`` (or ``metrics/<quantity>.py`` for every
  ``<quantity>.<cell>``): a ``read(run)`` that returns the metric or None
  where it finds nothing to read;
- ``roofline/<hook>.py``: a ``Hook`` that records, in traced runs, what
  a roofline needs from each launch.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import os
import resource
import shutil
import sys
import tempfile
import time
import types
from typing import Optional

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "topopteval_tpu")


def load_json(kind: str, name: str) -> dict:
    with open(os.path.join(HERE, kind, f"{name}.json")) as fh:
        return json.load(fh)


def load_module(kind: str, name: str):
    """``<kind>/<name>.py``; for a metric without a file of its own,
    ``metrics/<quantity>.py`` of its name before the cell suffix
    (``idle_share.loads`` -> ``idle_share``)."""
    path = os.path.join(HERE, kind, f"{name}.py")
    if kind == "metrics" and not os.path.exists(path) and "." in name:
        return load_module(kind, name.rsplit(".", 1)[0])
    spec = importlib.util.spec_from_file_location(
        f"_bench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _merge(base: dict, over: Optional[dict]) -> dict:
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(
            out.get(k), dict) else v
    return out


def cell(name: str, overrides: Optional[dict] = None):
    """(workload, config, mix) of a cell, each with ``overrides`` (keys
    ``workload``, ``config``, ``traffic``) merged in: the CPU tests' small
    sizes."""
    overrides = overrides or {}
    w = _merge(load_json("workloads", name), overrides.get("workload"))
    cfg = _merge(load_json("configs", w["config"]), overrides.get("config"))
    mix = _merge(load_json("traffic", w["traffic"]), overrides.get("traffic"))
    return w, cfg, mix


def forbidden_modules() -> list:
    """Top-level names in ``sys.modules`` that belong to JAX or to the JAX
    package, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def _log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def _host_use(before) -> str:
    """The process's CPU seconds (all threads), page faults and context
    switches since ``before``: where a request's wall time went on the
    host."""
    now = resource.getrusage(resource.RUSAGE_SELF)
    return (f"cpu_user={now.ru_utime - before.ru_utime:.3f} "
            f"cpu_sys={now.ru_stime - before.ru_stime:.3f} "
            f"minflt={now.ru_minflt - before.ru_minflt} "
            f"majflt={now.ru_majflt - before.ru_majflt} "
            f"nvcsw={now.ru_nvcsw - before.ru_nvcsw} "
            f"nivcsw={now.ru_nivcsw - before.ru_nivcsw}")


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", overrides: Optional[dict] = None,
             t_start: Optional[float] = None):
    """Run the cell; returns (exit code, result dict or None)."""
    t_start = time.perf_counter() if t_start is None else t_start
    w, cfg, mix = cell(name, overrides)
    for k, v in cfg.get("environment", {}).items():
        os.environ[k] = str(v)
    import torch

    if device == "cuda":
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < int(w.get("chips", 1)):
            _log("no CUDA device, or fewer than the cell needs: no result")
            return 2, None
    dev = torch.device(device)
    import topopteval_tpu_torch as tt
    tt.set_verbosity(False)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    tmp = tempfile.mkdtemp(prefix="bench-")
    hooks = {}
    try:
        ctx = types.SimpleNamespace(tt=tt, torch=torch, cfg=cfg, mix=mix,
                                    seed=int(seed), device=dev, tmp=tmp)
        client = load_module("requests", mix["request"]).Client(ctx)
        # a traced run reports no set-up time: its hooks see set-up too
        hooks = {h: load_module("roofline", h).Hook(tt)
                 for h in (w.get("trace_hooks", []) if trace else [])}
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        client.setup()
        sync()
        setup_s = time.perf_counter() - t_start
        _log(f"set-up {setup_s:.3f} s")

        records, profiled = [], []
        prof, profiled_done = None, False
        if trace:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if dev.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.start()
            for h in hooks.values():
                h.active = True
        t_w0 = time.perf_counter()
        i = 0
        while True:
            u0 = resource.getrusage(resource.RUSAGE_SELF)
            t0 = time.perf_counter()
            with torch.profiler.record_function("bench.request"):
                rec = client.request(i)
                sync()
            rec["t0"], rec["t1"] = t0, time.perf_counter()
            records.append(rec)
            _log(f"request {i}: {rec['t1'] - t0:.3f} s "
                 f"{client.describe(rec)} {_host_use(u0)}")
            if prof is not None and not profiled_done:
                profiled.append(rec)
                if rec["t1"] - t_w0 >= float(w["trace_seconds"]):
                    prof.stop()
                    profiled_done = True
                    for h in hooks.values():
                        h.active = False
            i += 1
            if time.perf_counter() - t_w0 >= seconds:
                break
        window_s = records[-1]["t1"] - records[0]["t0"]
        peak = (torch.cuda.max_memory_allocated(dev)
                if dev.type == "cuda" else 0)
        summary = None
        if prof is not None:
            if not profiled_done:              # the window ended first
                prof.stop()
            from .trace import summarize
            summary = summarize(prof.profiler.kineto_results.events())
            prof = None
        client.release()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        t_j = time.perf_counter()
        checks, failed = client.judge(records)
        _log(f"reference judged {len(records)} requests in "
             f"{time.perf_counter() - t_j:.3f} s")

        run = types.SimpleNamespace(
            records=records, profiled=profiled, window_s=window_s,
            setup_s=setup_s, trace=summary, hooks=hooks,
            sizes=client.sizes)
        names = w["per_layer"] if trace else w["end_to_end"]
        metrics = {}
        for m in names:
            reader = load_module("metrics", m)
            value = reader.read(run)
            if value is not None and math.isfinite(value):
                metrics[m] = {"value": float(value), "unit": reader.UNIT}
        found = forbidden_modules()
        if found:
            _log(f"modules of JAX or the JAX package loaded: {found}; "
                 "no result")
            return 3, None
        limits = w["limits"]
        correct = (not failed and bool(records) and all(
            checks[k] <= limits[k] for k in limits))
        device_rec = {
            "platform": "gpu" if dev.type == "cuda" else "cpu",
            "kind": (torch.cuda.get_device_name(dev)
                     if dev.type == "cuda" else "cpu"),
            "count": 1, "memory_peak_bytes": int(peak)}
        result = {"correct": bool(correct),
                  "attempted": int(client.attempted(records)),
                  "failed": int(failed), "metrics": metrics,
                  "device": device_rec}
        if trace:
            device_rec["busy_s"] = summary.busy_s if summary else 0.0
            device_rec["window_s"] = summary.window_s if summary else 0.0
            if summary is not None:
                result["breakdown"] = {
                    "device_ops": summary.top_device_ops(),
                    "idle_gaps": summary.top_idle()}
        compared = {**{k: (checks[k], limits[k]) for k in limits},
                    "failed_requests": (int(failed), 0)}
        result["checks"] = {k: {"value": v, "limit": lim}
                            for k, (v, lim) in compared.items()}
        for k, (v, lim) in compared.items():
            print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr,
                  flush=True)
        return 0, result
    finally:
        for h in hooks.values():
            h.remove()
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None, t_start: Optional[float] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    with contextlib.redirect_stdout(sys.stderr):
        code, result = run_cell(args.workload, args.seed, args.seconds,
                                bool(args.trace), t_start=t_start)
    if result is not None:
        print(json.dumps(result), flush=True)
    return code
