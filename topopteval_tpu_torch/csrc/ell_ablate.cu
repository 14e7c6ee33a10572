// The block-ELL ablation probe's kernel, for Hopper (sm_90a).
//
// ell_ablate<T, MODE> replaces make_kernel(mode) run through run()
// (tools/tpu_bell_ablate.py:56 and :118, pallas_call at :140): the TPU
// probe that splits the grouped-gather 3x3-block ELL matvec (B9a,
// topopteval_tpu/ops/pallas_bsr.py:119) into its two stages to see where
// the time goes.  Like the TPU kernel it keeps the two stages apart: a
// gather stage writes every slot's gathered u into a scratch
// gacc[3][S][128] in shared memory (the TPU's VMEM (3S, 128) scratch), and
// a value stage reduces the scratch against the values:
//
//     out[a, n] = sum_s sum_b vals2[(9t + 3a+b)*S + s][l] * gacc[b][s][l]
//
// It reads the layout of ops/ell.pack_ell_rows as ell_apply.cu's B9a does:
// one thread per row n = 128 t + l, the slot rows of a tile coalesced
// across the lanes; a column outside [128 wblk[t], 128 (wblk[t] + kc)), or
// at or past n_cols, is masked to zero.  Vectors are component-major
// [3, n_cols] with component stride u_cs; out is [3, n_rows].
//
// The modes compute what the TPU modes compute:
//   FULL      the gather, each slot's window test standing in for the TPU's
//             pl.when skip of a (group, chunk) pair, then the value stage:
//             B9a's matvec;
//   NOSKIP    no test before the load: every slot reads u at its column
//             clamped into the window and multiplies by the mask, as the TPU
//             visits every chunk and masks; the same output;
//   NOGATHER  each slot reads u[b, 128 floor(col/128) + l], its column's
//             128-chunk at the row's own lane (a coalesced read), under the
//             same mask; u past n_cols reads as the TPU's zero padding;
//   NOFINAL   the gather, then out[k, n] = gacc[0][k][l] for k = 0, 1, 2
//             (S >= 3: every pack has S a multiple of 8), with no read of
//             the values.  The compiler drops a gathered value that only
//             lives in registers and is never read, but it keeps stores to
//             shared memory, so the gathers of every slot stay in the run;
//   EMPTY     the value stage over a zeroed scratch: the values are read,
//             the output is 0.
//
// Bound: memory.  FULL and NOSKIP move what B9a moves: every real entry's
// column and values, u and out once (scale-16 fine operator, S 16: 0.0397
// ms fp32, 0.0756 fp64 at 3.35 TB/s); the other modes' functions need
// less (chip_smoke.py and tools/ell_ablate.py print each mode's bytes).
// The scratch costs 3 S 128 values a block, 24 KB fp32 and 48 KB fp64 at
// S = 16, 221 KB fp64 at S = 72 (Galerkin level 1), which passes the
// 227 KB opt-in limit only through cudaFuncSetAttribute; it bounds the
// blocks an SM holds at large S, which is part of what the probe measures.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 128;

enum Mode { FULL = 0, NOSKIP = 1, NOGATHER = 2, NOFINAL = 3, EMPTY = 4 };

template <typename T, int MODE>
__global__ void __launch_bounds__(LANES)
ell_ablate_kernel(const int* __restrict__ cols2, const T* __restrict__ vals,
                  const int* __restrict__ wblk, const T* __restrict__ u,
                  T* __restrict__ out, int S, int kc, int n_rows, int n_cols,
                  int64_t u_cs) {
    extern __shared__ __align__(16) unsigned char ell_ablate_smem[];
    T* gacc = reinterpret_cast<T*>(ell_ablate_smem);    // [3][S][LANES]
    const int t = blockIdx.x;
    const int l = threadIdx.x;
    const int n = t * LANES + l;
    const int64_t plane = (int64_t)S * LANES;
    // gather stage: each thread fills its own lane of the scratch
    if (MODE == EMPTY) {
        for (int s = 0; s < 3 * S; ++s) gacc[s * LANES + l] = T(0);
    } else {
        const int64_t lo = (int64_t)wblk[t] * LANES;
        const int64_t end = lo + (int64_t)kc * LANES;
        const int64_t hi = end < (int64_t)n_cols ? end : (int64_t)n_cols;
        const int* __restrict__ c_t = cols2 + (int64_t)t * plane + l;
        for (int s = 0; s < S; ++s) {
            const int64_t c = c_t[(int64_t)s * LANES];
            const bool inb = c >= lo && c < hi;
            T x = T(0), y = T(0), z = T(0);
            if (MODE == NOSKIP) {
                const int64_t cc = c < lo ? lo : (c >= hi ? hi - 1 : c);
                const T m = inb ? T(1) : T(0);
                if (hi > lo) {
                    x = m * u[cc];
                    y = m * u[u_cs + cc];
                    z = m * u[2 * u_cs + cc];
                }
            } else if (MODE == NOGATHER) {
                const int64_t addr = c - c % LANES + l;
                if (inb && addr < n_cols) {
                    x = u[addr];
                    y = u[u_cs + addr];
                    z = u[2 * u_cs + addr];
                }
            } else if (inb) {           // FULL, NOFINAL
                x = u[c];
                y = u[u_cs + c];
                z = u[2 * u_cs + c];
            }
            gacc[(0 * S + s) * LANES + l] = x;
            gacc[(1 * S + s) * LANES + l] = y;
            gacc[(2 * S + s) * LANES + l] = z;
        }
    }
    __syncthreads();
    if (n >= n_rows) return;
    if (MODE == NOFINAL) {
        for (int k = 0; k < 3; ++k)
            out[k * (int64_t)n_rows + n] = gacc[(0 * S + k) * LANES + l];
        return;
    }
    // value stage
    const T* __restrict__ v_t = vals + (int64_t)t * 9 * plane + l;
    T a0 = T(0), a1 = T(0), a2 = T(0);
    for (int s = 0; s < S; ++s) {
        const T x = gacc[(0 * S + s) * LANES + l];
        const T y = gacc[(1 * S + s) * LANES + l];
        const T z = gacc[(2 * S + s) * LANES + l];
        const T* __restrict__ v = v_t + (int64_t)s * LANES;
        a0 += v[0] * x + v[plane] * y + v[2 * plane] * z;
        a1 += v[3 * plane] * x + v[4 * plane] * y + v[5 * plane] * z;
        a2 += v[6 * plane] * x + v[7 * plane] * y + v[8 * plane] * z;
    }
    out[n] = a0;
    out[(int64_t)n_rows + n] = a1;
    out[2 * (int64_t)n_rows + n] = a2;
}

// the scratch bytes of one block, and the card's opt-in limit
int scratch_limit() {
    int dev = 0, limit = 0;
    if (cudaGetDevice(&dev) != cudaSuccess) return -1;
    if (cudaDeviceGetAttribute(&limit,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev) != cudaSuccess)
        return -1;
    return limit;
}

template <typename T, int MODE>
int launch(const void* cols2, const void* vals, const void* wblk,
           const void* u, void* out, int S, int kc, int n_tiles, int n_rows,
           int n_cols, long long u_cs, void* stream) {
    if (n_rows <= 0) return 0;
    if (S < 3 || kc <= 0 || n_rows > n_tiles * LANES)
        return (int)cudaErrorInvalidValue;
    const size_t bytes = (size_t)3 * S * LANES * sizeof(T);
    if (bytes > 48 * 1024) {
        const int limit = scratch_limit();
        if (limit < 0 || bytes > (size_t)limit)
            return (int)cudaErrorInvalidConfiguration;
        const cudaError_t err = cudaFuncSetAttribute(
            ell_ablate_kernel<T, MODE>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
        if (err != cudaSuccess) return (int)err;
    }
    const unsigned blocks = (unsigned)((n_rows + LANES - 1) / LANES);
    ell_ablate_kernel<T, MODE><<<blocks, LANES, bytes,
                                 (cudaStream_t)stream>>>(
        (const int*)cols2, (const T*)vals, (const int*)wblk, (const T*)u,
        (T*)out, S, kc, n_rows, n_cols, (int64_t)u_cs);
    return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int mode, const void* cols2, const void* vals, const void* wblk,
             const void* u, void* out, int S, int kc, int n_tiles,
             int n_rows, int n_cols, long long u_cs, void* stream) {
    switch (mode) {
#define ELL_ABLATE_CASE(M)                                                  \
    case M:                                                                 \
        return launch<T, M>(cols2, vals, wblk, u, out, S, kc, n_tiles,      \
                            n_rows, n_cols, u_cs, stream);
        ELL_ABLATE_CASE(FULL)
        ELL_ABLATE_CASE(NOSKIP)
        ELL_ABLATE_CASE(NOGATHER)
        ELL_ABLATE_CASE(NOFINAL)
        ELL_ABLATE_CASE(EMPTY)
#undef ELL_ABLATE_CASE
        default:
            return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// Plain C interface, bound with ctypes in ops/ell.py.  All pointers are
// device pointers; ``mode`` is 0 full, 1 noskip, 2 nogather, 3 nofinal,
// 4 empty.  Each entry point returns cudaGetLastError() after its launch,
// 0 when n_rows is 0 (nothing launched), and
// cudaErrorInvalidConfiguration when the scratch exceeds the card's
// shared memory (the wrapper checks that first and names the sizes).
extern "C" {

int ell_ablate_f32(int mode, const void* cols2, const void* vals,
                   const void* wblk, const void* u, void* out, int S, int kc,
                   int n_tiles, int n_rows, int n_cols, long long u_cs,
                   void* stream) {
    return dispatch<float>(mode, cols2, vals, wblk, u, out, S, kc, n_tiles,
                           n_rows, n_cols, u_cs, stream);
}

int ell_ablate_f64(int mode, const void* cols2, const void* vals,
                   const void* wblk, const void* u, void* out, int S, int kc,
                   int n_tiles, int n_rows, int n_cols, long long u_cs,
                   void* stream) {
    return dispatch<double>(mode, cols2, vals, wblk, u, out, S, kc, n_tiles,
                            n_rows, n_cols, u_cs, stream);
}

int ell_ablate_scratch_limit() { return scratch_limit(); }

const char* ell_ablate_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
