"""Build the CUDA sources under ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` becomes ``build/kernels/lib<name>-<hash>.so`` in
the repository root, where ``<hash>`` is taken from the source text, so an
edited source is rebuilt and an unchanged one is loaded as it is.  The
libraries have a plain C interface (no PyTorch headers), which keeps a
build to seconds.  Nothing is built at import time: a kernel wrapper calls
:func:`load` when it first launches, and :func:`build` compiles several
sources at once, one nvcc process each, all started together.

The host library ``csrc/host/topopt_native.cpp`` (io/native.py) is built
the same way with g++ by :func:`build_host` into
``build/native/libtopopt_native-<hash>.so``; its hash also covers the
host's CPU, since ``-march=native`` code may not run on another one.
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
HOST_SOURCE = os.path.join(CSRC_DIR, "host", "topopt_native.cpp")
HOST_BUILD_DIR = os.path.join(os.path.dirname(BUILD_DIR), "native")
#: the flags of native/Makefile's CXXFLAGS
HOST_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17")

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


def _cpu_identity() -> bytes:
    """The host CPU's model and feature flags (``-march=native`` builds
    for them)."""
    try:
        with open("/proc/cpuinfo", "rb") as fh:
            lines = [ln for ln in fh.read().splitlines()
                     if ln.startswith((b"model name", b"flags"))]
        return b"\n".join(lines[:2])
    except OSError:
        import platform
        return platform.processor().encode()


def host_target() -> str:
    """Path of the host library built from ``HOST_SOURCE`` with
    ``HOST_FLAGS`` for this CPU."""
    with open(HOST_SOURCE, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(HOST_FLAGS).encode()
                                + _cpu_identity()).hexdigest()
    return os.path.join(HOST_BUILD_DIR,
                        f"libtopopt_native-{digest[:16]}.so")


def build_host() -> float:
    """Compile the host library with g++ unless it is built already;
    returns the seconds the build took (0.0 if there was nothing to do).
    Raises if g++ is missing or the build fails."""
    target = host_target()
    if os.path.exists(target):
        return 0.0
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the host library is built on "
                           "first use and needs a C++ compiler")
    os.makedirs(HOST_BUILD_DIR, exist_ok=True)
    tmp = f"{target}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([cxx, *HOST_FLAGS, "-o", tmp, HOST_SOURCE],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {HOST_SOURCE} (exit "
                           f"{proc.returncode}):\n"
                           + (proc.stdout + proc.stderr)[-2000:])
    os.replace(tmp, target)
    return time.perf_counter() - t0
