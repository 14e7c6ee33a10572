"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module name; the reference loads nothing of the port
either."""

import json
import os
import subprocess
import sys

from benchmark.core import harness

ROOT = os.path.dirname(harness.HERE)
JAX_SIDE = {"jax", "jaxlib", "flax", "topopteval_tpu"}


def _modules(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=600,
        env={**os.environ, "TOPOPTEVAL_VERBOSE": "0"})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    names = _modules(
        "import sys, json, torch\n"
        "torch.set_num_threads(1)\n"
        "sys.path.insert(0, '.')\n"
        "from benchmark.core import harness\n"
        "from benchmark.tests._tiny import TINY\n"
        "for cell in sorted(TINY):\n"
        "    code, r = harness.run_cell(cell, 7, 0.2, True, device='cpu',"
        " overrides=TINY[cell])\n"
        "    assert code == 0 and r['correct'], r\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    assert "topopteval_tpu_torch" in names
    assert not names & JAX_SIDE


def test_reference_loads_nothing_of_either_package():
    names = _modules(
        "import sys, json\n"
        "sys.path.insert(0, '.')\n"
        "import benchmark.reference.elasticity, benchmark.reference.judge\n"
        "import benchmark.reference.control\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    assert not names & (JAX_SIDE | {"topopteval_tpu_torch"})


def test_forbidden_names_are_whole(monkeypatch):
    here = sys.modules[__name__]
    monkeypatch.setitem(sys.modules, "topopteval_tpu_torch.fake", here)
    monkeypatch.setitem(sys.modules, "jaxfoo", here)
    assert not set(harness.forbidden_modules()) & {"topopteval_tpu_torch",
                                                    "jaxfoo"}
    monkeypatch.setitem(sys.modules, "jax.numpy", here)
    assert "jax" in harness.forbidden_modules()
