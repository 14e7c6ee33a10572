"""Build the CUDA sources under ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` becomes ``build/kernels/lib<name>-<hash>.so`` in
the repository root, where ``<hash>`` is taken from the source text, so an
edited source is rebuilt and an unchanged one is loaded as it is.  The
libraries have a plain C interface (no PyTorch headers), which keeps a
build to seconds.  Nothing is built at import time: a kernel wrapper calls
:func:`load` when it first launches, and :func:`build` compiles several
sources at once, one nvcc process each, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Iterable, Optional

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "build", "kernels")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LOADED: Dict[str, ctypes.CDLL] = {}
#: ptxas report (registers, spills) of each source built in this process
PTXAS_REPORT: Dict[str, str] = {}


def sources() -> list:
    """Names of the CUDA sources in ``csrc/``."""
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "first use and need the CUDA toolkit")
    return path


def _target(name: str, path: Optional[str] = None) -> str:
    with open(path or os.path.join(CSRC_DIR, f"{name}.cu"), "rb") as fh:
        digest = hashlib.sha256(fh.read()
                                + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"lib{name}-{digest[:16]}.so")


def build(names: Optional[Iterable[str]] = None,
          paths: Optional[Dict[str, str]] = None) -> Dict[str, float]:
    """Compile ``names`` (default: every source) that are not built yet,
    all nvcc processes at once; ``paths`` maps a name to a source outside
    ``csrc/`` (another tree's kernels, for an A/B timing).  Returns the
    seconds each build took (0.0 for a library that was already there);
    raises if any build fails."""
    paths = dict(paths or {})
    names = list(sources() if names is None and not paths else names or [])
    names += [n for n in paths if n not in names]
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        src = paths.get(name) or os.path.join(CSRC_DIR, f"{name}.cu")
        target = _target(name, src)
        if os.path.exists(target):
            continue
        tmp = f"{target}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True),
                       tmp, target)
    seconds = {name: 0.0 for name in names}
    failures = []
    for name, (proc, tmp, target) in procs.items():
        out, err = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        PTXAS_REPORT[name] = (out + err).strip()
        if proc.returncode != 0:
            # the -v report buries the errors: put their lines first
            lines = (out + err).splitlines()
            errors = [ln for ln in lines if "error" in ln.lower()]
            failures.append(f"{name}.cu (exit {proc.returncode}):\n"
                            + "\n".join(errors[:40]) + "\n"
                            + "\n".join(lines)[-2000:])
            continue
        os.replace(tmp, target)
    if failures:
        raise RuntimeError("nvcc failed for " + "\n".join(failures))
    return seconds


def load(name: str, path: Optional[str] = None) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu`` (or of the source ``path``,
    under the name ``name``), building it if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        target = _target(name, path)
        if not os.path.exists(target):
            build([name], {name: path} if path else None)
        lib = ctypes.CDLL(target)
        _LOADED[name] = lib
    return lib
