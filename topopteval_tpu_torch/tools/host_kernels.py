"""Build a CUDA source of ``csrc/`` for the host CPU, to check a kernel's
index logic where there is no card and no nvcc.

    lib = host_kernels.build("stencil_apply", out_dir)

The source's text is rewritten for g++ against a small stand-in of the
CUDA runtime (``RUNTIME_H``): ``__global__``/``__device__`` vanish, a
launch ``kernel<<<grid, block, smem, stream>>>(args)`` runs the grid's
blocks one after another, each block's threads as ``std::thread``s with
``threadIdx``/``blockIdx`` thread-local, ``__syncthreads`` a
``std::barrier``, ``__shared__`` arrays static (one block at a time) and
dynamic shared memory one buffer, filled with NaN bytes before each
block; the ``cp.async`` helpers become ``memcpy``.  The library keeps the
source's C interface, so its entry points take host pointers (CPU
tensors' ``data_ptr()``) and a null stream.

It runs the kernels' own indexing, staging, barriers and order of sums,
with floating-point contraction off (``-ffp-contract=off``): where the
card fuses a multiply and an add, the host rounds twice.  It says
nothing of what only nvcc refuses, of registers, spills or time.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess

from .. import _build

#: the stand-in CUDA runtime, force-included before the source
RUNTIME_H = r"""
#pragma once
#include <algorithm>
#include <barrier>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>
using std::max;
using std::min;
struct dim3 {
    unsigned x, y, z;
    dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
inline std::barrier<>* host_barrier = nullptr;
alignas(16) inline unsigned char host_dynamic_smem[256 * 1024];
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
#define __align__(n) alignas(n)
inline void __syncthreads() { host_barrier->arrive_and_wait(); }
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaErrorInvalidConfiguration = 9 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum { cudaDevAttrMultiProcessorCount = 16,
       cudaDevAttrMaxSharedMemoryPerBlockOptin = 97 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "host"; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* v, int attr, int) {
    *v = attr == cudaDevAttrMultiProcessorCount ? 132 : 232448;
    return cudaSuccess;
}
template <typename K>
cudaError_t cudaFuncSetAttribute(K, int, int bytes) {
    return bytes > (int)sizeof(host_dynamic_smem)
               ? cudaErrorInvalidConfiguration : cudaSuccess;
}
struct float4 { float x, y, z, w; };
struct double2 { double x, y; };
template <typename K, typename... A>
void host_launch(K kernel, dim3 grid, dim3 block, size_t, cudaStream_t,
                 A... args) {
    gridDim = grid;
    blockDim = block;
    const unsigned nt = block.x * block.y * block.z;
    for (unsigned bz = 0; bz < grid.z; ++bz)
        for (unsigned by = 0; by < grid.y; ++by)
            for (unsigned bx = 0; bx < grid.x; ++bx) {
                std::memset(host_dynamic_smem, 0xff,
                            sizeof(host_dynamic_smem));
                std::barrier<> bar(nt);
                host_barrier = &bar;
                std::vector<std::thread> threads;
                for (unsigned t = 0; t < nt; ++t)
                    threads.emplace_back([=]() {
                        blockIdx = dim3(bx, by, bz);
                        threadIdx = dim3(t % block.x, t / block.x % block.y,
                                         t / (block.x * block.y));
                        kernel(args...);
                    });
                for (auto& th : threads) th.join();
            }
}
"""

#: the body each cp.async helper gets on the host
_CP_ASYNC = {"cp_async": "std::memcpy(smem, gmem, bytes);",
             "cp_async_commit": "", "cp_async_wait_all": ""}


def host_source(text: str) -> str:
    """``text`` (a ``csrc/*.cu`` source) rewritten for the stand-in."""
    for name, body in _CP_ASYNC.items():
        text = re.sub(r"(__device__ __forceinline__ void " + name
                      + r"\([^)]*\) \{).*?\n\}\n",
                      lambda m: f"{m.group(1)} {body} }}\n", text,
                      flags=re.S)
    text = re.sub(r"extern __shared__ __align__\(16\) unsigned char "
                  r"(\w+)\[\];", r"unsigned char* \1 = host_dynamic_smem;",
                  text)
    text = re.sub(r"([\w:]+(?:<[^<>;]*?>)?)\s*<<<(.*?)>>>\(",
                  lambda m: f"host_launch({m.group(1)}, {m.group(2)}, ",
                  text, flags=re.S)
    return text.replace("__device__ constexpr", "constexpr")


def build(name: str, out_dir: str, path: str = None) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` (or ``path``) for the host into
    ``out_dir`` with g++ and load it; raises if g++ is missing or
    fails."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("host_kernels: g++ not found")
    os.makedirs(out_dir, exist_ok=True)
    with open(path or os.path.join(_build.CSRC_DIR, f"{name}.cu")) as fh:
        text = fh.read()
    header = os.path.join(out_dir, "cuda_runtime.h")
    with open(header, "w") as fh:
        fh.write(RUNTIME_H)
    cpp = os.path.join(out_dir, f"{name}_host.cpp")
    with open(cpp, "w") as fh:
        fh.write(host_source(text))
    lib = os.path.join(out_dir, f"lib{name}_host.so")
    cmd = [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fPIC",
           "-shared", "-I", out_dir, "-include", "cuda_runtime.h", "-o",
           lib, cpp, "-lpthread"]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"host_kernels: g++ failed for {name}:\n"
                           f"{res.stderr[-3000:]}")
    return ctypes.CDLL(lib)
