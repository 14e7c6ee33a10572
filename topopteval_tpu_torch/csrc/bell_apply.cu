// Block-sparse matvecs of the block-ELL multigrid hierarchy, for Hopper (sm_90a).
//
// Both kernels take a row-compressed matrix (indptr [n_rows+1], cols [nnz],
// int32, columns sorted within each row) and component-major vectors
// u [3, n_cols] -> out [3, n_rows].  Rows with no entries (lane padding,
// voxel corners that support no fine node) write zeros.
//
// bell_matvec  replaces _bell_aligned_kernel (topopteval_tpu/ops/pallas_bsr.py:287,
//              via bell_matvec_aligned :353): the 3x3-block SpMV of every
//              multigrid level and of the system operator,
//
//     out[a, n] = sum_{j in row n} sum_b vals[j, 3a+b] * u[b, cols[j]]
//
//   with an optional second value plane vals_lo (the float32 remainder of
//   float64 values): it accumulates in its own registers and is added once
//   per output after the row loop.  Adding lo per term, in float32, would
//   round it straight back into hi (pallas_bsr.py:323-345 records the TPU
//   seeing bit-identical output with and without it).  Values may be
//   stored in bf16 (the float32 V-cycle's smoother copies) and are
//   widened to the vector type before the multiply.
//   Instantiated for (float vectors, float values), (float, float + lo
//   plane), (float, bf16) and (double, double).
//
// sell_matvec  replaces _sell_aligned_kernel (pallas_bsr.py:399, via
//              sell_matvec_aligned :428): the scalar-weight transfers,
//              prolongation P (fine rows) and restriction R = P^T (coarse
//              rows), both stored row-wise so the kernel only gathers,
//
//     out[a, n] = sum_{j in row n} w[j] * u[a, cols[j]]
//
//   Instantiated for (float, float), (float, bf16) and (double, double).
//
// The TPU kernels pad every 128-row tile to a common slot count aligned to
// 128-lane source chunks (88 slots per row on the 1.23M-tet fine operator,
// which has at most 15 blocks per row).  This card gathers by address, so
// the matrix stays in plain block-CSR with no padding slots.
//
// Bound (both): memory.  Every value, column index and row pointer is read
// once, u once, out written once.  Fine level at 1,228,800 tets (222,208
// rows, 3,192,009 blocks), float32 with the lo plane: 230 MB of values,
// 12.8 MB of columns, 0.9 MB of row pointers, 5.3 MB of vectors, 0.074 ms
// at 3.35 TB/s; 18 flops per block (57 MFLOP) do not bind.
//
// bell_matvec.  The earlier design, one thread per row, read a row's
// blocks as scalars 36 B apart while neighbouring threads' rows lay ~14
// blocks (~520 B) apart: each warp load touched 32 sectors for 128 useful
// bytes and leaned on L1 for the next eight.  On the fine operator above
// it took 0.381 ms fp32 + lo, 0.064 bf16 and 0.252 fp64, 20-36 % of the
// bound (H100 SXM at 700 W).  Now a block of 256 threads takes 256 / G
// consecutive rows, G lanes a row, G from the mean row length (bell_lanes
// in ops/bell.py: 4 on the fine level, 16 at 58-72 blocks a row).  The
// tile's blocks are one contiguous run of cols and vals (and vals_lo): the
// block stages it in chunks of 512 blocks with 16-byte cp.async copies,
// every load coalesced, and lane l of row r sums blocks indptr[r] + l,
// + l + G, ... in order from shared memory.  A xor butterfly adds the G
// partial sums, so the summation order is fixed by the matrix alone and
// the output repeats bit for bit (it is not the earlier sequential
// order).  Several resident blocks overlap one tile's copy with another's
// sums.  Result on the fine operator, timed in turns with the earlier
// design (tools/kernel_ab.py, H100 SXM at 700 W): 0.104 ms fp32 + lo,
// 0.040 bf16 and 0.101 fp64, 71 %, 56 % and 75 % of the bound (3.6x,
// 1.5x, 2.4x); 0.039 ms fp32 at the Galerkin route's level 1 (58 blocks a
// row), 1.75x.
//
// sell_matvec: one thread per row computing its three outputs, columns
// walked in sorted order (a fixed summation order).  Neighbouring threads
// read neighbouring rows; a row's weights come in through L1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 128;       // sell_matvec: one thread per row
constexpr int BELL_THREADS = 256;  // bell_matvec: G lanes per row
constexpr int BELL_CHUNK = 512;    // blocks of a row tile staged at a time

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ double widen(double v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Stage src[0, n) into shared memory at dst[shift + i], shift the element
// offset of src inside its 16-byte segment, so that both sides of every
// 16-byte copy are aligned: the aligned body goes by cp.async, the
// unaligned head and tail (under 16 bytes each) by plain loads.  Returns
// shift.  The caller waits (cp_async_wait_all) and synchronises.
template <typename V>
__device__ __forceinline__ int stage(V* __restrict__ dst,
                                     const V* __restrict__ src, int n) {
    constexpr int VEC = 16 / sizeof(V);
    const int shift = (int)(((uintptr_t)src & 15) / sizeof(V));
    const int head = min(shift ? VEC - shift : 0, n);
    const int nvec = (n - head) / VEC;
    const int tail = head + nvec * VEC;
    const int tid = threadIdx.x;
    if (tid < head) dst[shift + tid] = src[tid];
    for (int v = tid; v < nvec; v += BELL_THREADS)
        cp_async16(dst + shift + head + v * VEC, src + head + v * VEC);
    if (tid < n - tail) dst[shift + tail + tid] = src[tail + tid];
    return shift;
}

// out[:, r] for the G-lane sub-warps of a block, one row each: a tile of
// R = BELL_THREADS / G consecutive rows.  Their blocks are one contiguous
// run [indptr[r0], indptr[r0 + R]) of cols and of vals (and vals_lo); the
// block stages it in chunks of BELL_CHUNK blocks, 16 bytes a copy, and
// each lane l of row r sums blocks indptr[r] + l, + l + G, ... in order,
// in registers that persist across chunks.  A xor butterfly over the G
// lanes then gives every row the same summation order from run to run.
// The lo plane has its own sums, reduced the same way and added once.
template <typename T, typename V, bool LO, int G>
__global__ void __launch_bounds__(BELL_THREADS)
bell_matvec_kernel(const int* __restrict__ indptr, const int* __restrict__ cols,
                   const V* __restrict__ vals, const V* __restrict__ vals_lo,
                   const T* __restrict__ u, T* __restrict__ out, int n_rows,
                   int n_cols) {
    constexpr int R = BELL_THREADS / G;
    constexpr int PAD = 16 / sizeof(V);
    // raw bytes: bf16 has constructors, which __shared__ arrays may not
    __shared__ __align__(16) unsigned char s_raw[
        (LO ? 2 : 1) * (9 * BELL_CHUNK + PAD) * sizeof(V)
        + (BELL_CHUNK + 4) * sizeof(int)];
    V* s_v = reinterpret_cast<V*>(s_raw);
    V* s_lo = s_v + 9 * BELL_CHUNK + PAD;
    int* s_c = reinterpret_cast<int*>(s_raw + (LO ? 2 : 1)
                                                  * (9 * BELL_CHUNK + PAD)
                                                  * sizeof(V));
    const int tid = threadIdx.x;
    const int lane = tid % G;
    const int r0 = blockIdx.x * R;
    const int r = r0 + tid / G;
    const int J0 = indptr[r0];
    const int J1 = indptr[min(r0 + R, n_rows)];
    const int p0 = r < n_rows ? indptr[r] : J1;
    const int p1 = r < n_rows ? indptr[r + 1] : J1;
    const T* __restrict__ u0 = u;
    const T* __restrict__ u1 = u + n_cols;
    const T* __restrict__ u2 = u + 2 * (int64_t)n_cols;
    T h0 = T(0), h1 = T(0), h2 = T(0);
    T l0 = T(0), l1 = T(0), l2 = T(0);
    int j = p0 + lane;                     // this lane's next block
    for (int jc = J0; jc < J1; jc += BELL_CHUNK) {
        const int n = min(BELL_CHUNK, J1 - jc);
        const int sv = stage(s_v, vals + 9 * (int64_t)jc, 9 * n);
        const int sl = LO ? stage(s_lo, vals_lo + 9 * (int64_t)jc, 9 * n) : 0;
        const int sc = stage(s_c, cols + jc, n);
        cp_async_wait_all();
        __syncthreads();
        const int end = min(p1, jc + n);
        for (; j < end; j += G) {
            const int c = s_c[sc + j - jc];
            const T x = u0[c], y = u1[c], z = u2[c];
            const V* v = s_v + sv + 9 * (j - jc);
            h0 += T(widen(v[0])) * x + T(widen(v[1])) * y + T(widen(v[2])) * z;
            h1 += T(widen(v[3])) * x + T(widen(v[4])) * y + T(widen(v[5])) * z;
            h2 += T(widen(v[6])) * x + T(widen(v[7])) * y + T(widen(v[8])) * z;
            if (LO) {
                const V* w = s_lo + sl + 9 * (j - jc);
                l0 += T(widen(w[0])) * x + T(widen(w[1])) * y + T(widen(w[2])) * z;
                l1 += T(widen(w[3])) * x + T(widen(w[4])) * y + T(widen(w[5])) * z;
                l2 += T(widen(w[6])) * x + T(widen(w[7])) * y + T(widen(w[8])) * z;
            }
        }
        __syncthreads();                   // the next chunk reuses the buffers
    }
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1) {
        h0 += __shfl_xor_sync(0xffffffffu, h0, off);
        h1 += __shfl_xor_sync(0xffffffffu, h1, off);
        h2 += __shfl_xor_sync(0xffffffffu, h2, off);
        if (LO) {
            l0 += __shfl_xor_sync(0xffffffffu, l0, off);
            l1 += __shfl_xor_sync(0xffffffffu, l1, off);
            l2 += __shfl_xor_sync(0xffffffffu, l2, off);
        }
    }
    if (lane == 0 && r < n_rows) {
        if (LO) {
            h0 += l0;
            h1 += l1;
            h2 += l2;
        }
        out[r] = h0;
        out[n_rows + r] = h1;
        out[2 * (int64_t)n_rows + r] = h2;
    }
}

template <typename T, typename V>
__global__ void __launch_bounds__(THREADS)
sell_matvec_kernel(const int* __restrict__ indptr, const int* __restrict__ cols,
                   const V* __restrict__ w, const T* __restrict__ u,
                   T* __restrict__ out, int n_rows, int n_cols) {
    const int n = blockIdx.x * THREADS + threadIdx.x;
    if (n >= n_rows) return;
    const T* __restrict__ u0 = u;
    const T* __restrict__ u1 = u + n_cols;
    const T* __restrict__ u2 = u + 2 * (int64_t)n_cols;
    T a0 = T(0), a1 = T(0), a2 = T(0);
    const int end = indptr[n + 1];
    for (int j = indptr[n]; j < end; ++j) {
        const int c = cols[j];
        const T wj = T(widen(w[j]));
        a0 += wj * u0[c];
        a1 += wj * u1[c];
        a2 += wj * u2[c];
    }
    out[n] = a0;
    out[n_rows + n] = a1;
    out[2 * (int64_t)n_rows + n] = a2;
}

inline unsigned blocks_for(int n_rows) {
    return (unsigned)((n_rows + THREADS - 1) / THREADS);
}

template <typename T, typename V, int G>
void launch_bell_g(const void* indptr, const void* cols, const void* vals,
                   const void* vals_lo, const void* u, void* out, int n_rows,
                   int n_cols, cudaStream_t stream) {
    constexpr int R = BELL_THREADS / G;
    const unsigned blocks = (unsigned)((n_rows + R - 1) / R);
    // the lo plane comes with float values only (the C entry points
    // refuse it elsewhere), so only that instantiation carries its buffer
    if constexpr (std::is_same<V, float>::value) {
        if (vals_lo != nullptr) {
            bell_matvec_kernel<T, V, true, G><<<blocks, BELL_THREADS, 0, stream>>>(
                (const int*)indptr, (const int*)cols, (const V*)vals,
                (const V*)vals_lo, (const T*)u, (T*)out, n_rows, n_cols);
            return;
        }
    }
    bell_matvec_kernel<T, V, false, G><<<blocks, BELL_THREADS, 0, stream>>>(
        (const int*)indptr, (const int*)cols, (const V*)vals, nullptr,
        (const T*)u, (T*)out, n_rows, n_cols);
}

template <typename T, typename V>
int launch_bell(const void* indptr, const void* cols, const void* vals,
                const void* vals_lo, const void* u, void* out, int n_rows,
                int n_cols, int lanes, void* stream) {
    if (n_rows <= 0) return 0;
    const cudaStream_t st = (cudaStream_t)stream;
#define BELL_LANES(G)                                                        \
    case G:                                                                  \
        launch_bell_g<T, V, G>(indptr, cols, vals, vals_lo, u, out, n_rows,  \
                               n_cols, st);                                  \
        break;
    switch (lanes) {
        BELL_LANES(2)
        BELL_LANES(4)
        BELL_LANES(8)
        BELL_LANES(16)
        BELL_LANES(32)
        default: return (int)cudaErrorInvalidValue;
    }
#undef BELL_LANES
    return (int)cudaGetLastError();
}

template <typename T, typename V>
int launch_sell(const void* indptr, const void* cols, const void* w,
                const void* u, void* out, int n_rows, int n_cols, void* stream) {
    if (n_rows <= 0) return 0;
    sell_matvec_kernel<T, V><<<blocks_for(n_rows), THREADS, 0,
                               (cudaStream_t)stream>>>(
        (const int*)indptr, (const int*)cols, (const V*)w, (const T*)u, (T*)out,
        n_rows, n_cols);
    return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, bound with ctypes in ops/bell.py.  All pointers are
// device pointers; vals_lo may be null (the lo plane is taken only by the
// float32 instantiation: the wrapper refuses it elsewhere).  Each entry
// point returns cudaGetLastError() after its launch, 0 when n_rows is 0
// (nothing launched).
extern "C" {

int bell_matvec_f32(const void* indptr, const void* cols, const void* vals,
                    const void* vals_lo, const void* u, void* out, int n_rows,
                    int n_cols, int lanes, void* stream) {
    return launch_bell<float, float>(indptr, cols, vals, vals_lo, u, out, n_rows,
                                     n_cols, lanes, stream);
}

int bell_matvec_f32_bf16(const void* indptr, const void* cols, const void* vals,
                         const void* vals_lo, const void* u, void* out,
                         int n_rows, int n_cols, int lanes, void* stream) {
    if (vals_lo != nullptr) return (int)cudaErrorInvalidValue;
    return launch_bell<float, __nv_bfloat16>(indptr, cols, vals, nullptr, u, out,
                                             n_rows, n_cols, lanes, stream);
}

int bell_matvec_f64(const void* indptr, const void* cols, const void* vals,
                    const void* vals_lo, const void* u, void* out, int n_rows,
                    int n_cols, int lanes, void* stream) {
    if (vals_lo != nullptr) return (int)cudaErrorInvalidValue;
    return launch_bell<double, double>(indptr, cols, vals, nullptr, u, out,
                                       n_rows, n_cols, lanes, stream);
}

int sell_matvec_f32(const void* indptr, const void* cols, const void* w,
                    const void* u, void* out, int n_rows, int n_cols,
                    void* stream) {
    return launch_sell<float, float>(indptr, cols, w, u, out, n_rows, n_cols,
                                     stream);
}

int sell_matvec_f32_bf16(const void* indptr, const void* cols, const void* w,
                         const void* u, void* out, int n_rows, int n_cols,
                         void* stream) {
    return launch_sell<float, __nv_bfloat16>(indptr, cols, w, u, out, n_rows,
                                             n_cols, stream);
}

int sell_matvec_f64(const void* indptr, const void* cols, const void* w,
                    const void* u, void* out, int n_rows, int n_cols,
                    void* stream) {
    return launch_sell<double, double>(indptr, cols, w, u, out, n_rows, n_cols,
                                       stream);
}

const char* bell_apply_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
