"""The controls of each cell's comparison, at the cell's own size, each
judged like the program: the workload file's ``controls`` list, run by the
client's ``control`` method (the reference one precision below the
configuration's in the program's place, or the program with a guarantee
broken).  Every control has to come out not correct: at least one of its
numbers over the cell's limit, unless its entry says ``"fails": false``:
a reading kept to show what the comparison cannot see.

    python3 benchmark/controls.py --workload <cell> --seeds 11,12,13 [--only <control>,...]

One JSON line a seed and control, then a summary line.  The benchmark's
runs never call it; it runs on the card, and benchmark/tests runs it small.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.core import harness  # noqa: E402


def readings(name: str, spec: dict, seed: int, device: str = "cuda",
             overrides=None) -> tuple:
    """(the control's numbers for ``seed`` under the cell's own names,
    notes)."""
    import torch

    import topopteval_tpu_torch as tt

    w, cfg, mix = harness.cell(name, overrides)
    for k, v in cfg.get("environment", {}).items():
        os.environ[k] = str(v)
    tt.set_verbosity(False)
    tmp = tempfile.mkdtemp(prefix="bench-control-")
    try:
        ctx = types.SimpleNamespace(tt=tt, torch=torch, cfg=cfg, mix=mix,
                                    seed=int(seed),
                                    device=torch.device(device), tmp=tmp)
        client = harness.load_module("requests", mix["request"]).Client(ctx)
        return client.control(spec)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def verdict(name: str, got: dict, overrides=None) -> bool:
    """True where the control fails the cell's comparison, as it must."""
    limits = harness.cell(name, overrides)[0]["limits"]
    return any(not (got[k] <= limits[k]) for k in limits if k in got)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--only", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    w = harness.cell(args.workload)[0]
    only = set(filter(None, args.only.split(",")))
    fails = []
    for spec in w["controls"]:
        if only and spec["name"] not in only:
            continue
        for s in (int(x) for x in args.seeds.split(",")):
            t = time.perf_counter()
            got, notes = readings(args.workload, spec, s, args.device)
            failed = verdict(args.workload, got)
            if spec.get("fails", True):
                fails.append(failed)
            print(json.dumps({"workload": args.workload,
                              "control": spec["name"], "seed": s,
                              "numbers": got, "limits": w["limits"],
                              "control_fails": failed, "notes": notes,
                              "seconds": time.perf_counter() - t}),
                  flush=True)
    print(json.dumps({"workload": args.workload,
                      "control_fails_every_seed": all(fails)}), flush=True)
    return 0 if all(fails) else 1


if __name__ == "__main__":
    sys.exit(main())
