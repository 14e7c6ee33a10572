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
// Design: one thread per row computing its three outputs, columns walked
// in sorted order, so the summation order is fixed and solver iteration
// counts repeat from run to run.  Neighbouring threads read neighbouring
// rows, which lie next to each other in memory; a row's 9 values per block
// come in through L1.  A warp- or sub-warp-per-row layout with coalesced
// value loads is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ double widen(double v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T, typename V, bool LO>
__global__ void __launch_bounds__(THREADS)
bell_matvec_kernel(const int* __restrict__ indptr, const int* __restrict__ cols,
                   const V* __restrict__ vals, const V* __restrict__ vals_lo,
                   const T* __restrict__ u, T* __restrict__ out, int n_rows,
                   int n_cols) {
    const int n = blockIdx.x * THREADS + threadIdx.x;
    if (n >= n_rows) return;
    const T* __restrict__ u0 = u;
    const T* __restrict__ u1 = u + n_cols;
    const T* __restrict__ u2 = u + 2 * (int64_t)n_cols;
    T h0 = T(0), h1 = T(0), h2 = T(0);
    T l0 = T(0), l1 = T(0), l2 = T(0);
    const int end = indptr[n + 1];
    for (int j = indptr[n]; j < end; ++j) {
        const int c = cols[j];
        const T x = u0[c], y = u1[c], z = u2[c];
        const V* v = vals + 9 * (int64_t)j;
        h0 += T(widen(v[0])) * x + T(widen(v[1])) * y + T(widen(v[2])) * z;
        h1 += T(widen(v[3])) * x + T(widen(v[4])) * y + T(widen(v[5])) * z;
        h2 += T(widen(v[6])) * x + T(widen(v[7])) * y + T(widen(v[8])) * z;
        if (LO) {
            const V* w = vals_lo + 9 * (int64_t)j;
            l0 += T(widen(w[0])) * x + T(widen(w[1])) * y + T(widen(w[2])) * z;
            l1 += T(widen(w[3])) * x + T(widen(w[4])) * y + T(widen(w[5])) * z;
            l2 += T(widen(w[6])) * x + T(widen(w[7])) * y + T(widen(w[8])) * z;
        }
    }
    if (LO) {
        h0 += l0;
        h1 += l1;
        h2 += l2;
    }
    out[n] = h0;
    out[n_rows + n] = h1;
    out[2 * (int64_t)n_rows + n] = h2;
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

template <typename T, typename V>
int launch_bell(const void* indptr, const void* cols, const void* vals,
                const void* vals_lo, const void* u, void* out, int n_rows,
                int n_cols, void* stream) {
    if (n_rows <= 0) return 0;
    if (vals_lo != nullptr)
        bell_matvec_kernel<T, V, true><<<blocks_for(n_rows), THREADS, 0,
                                         (cudaStream_t)stream>>>(
            (const int*)indptr, (const int*)cols, (const V*)vals, (const V*)vals_lo,
            (const T*)u, (T*)out, n_rows, n_cols);
    else
        bell_matvec_kernel<T, V, false><<<blocks_for(n_rows), THREADS, 0,
                                          (cudaStream_t)stream>>>(
            (const int*)indptr, (const int*)cols, (const V*)vals, nullptr,
            (const T*)u, (T*)out, n_rows, n_cols);
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
                    int n_cols, void* stream) {
    return launch_bell<float, float>(indptr, cols, vals, vals_lo, u, out, n_rows,
                                     n_cols, stream);
}

int bell_matvec_f32_bf16(const void* indptr, const void* cols, const void* vals,
                         const void* vals_lo, const void* u, void* out,
                         int n_rows, int n_cols, void* stream) {
    if (vals_lo != nullptr) return (int)cudaErrorInvalidValue;
    return launch_bell<float, __nv_bfloat16>(indptr, cols, vals, nullptr, u, out,
                                             n_rows, n_cols, stream);
}

int bell_matvec_f64(const void* indptr, const void* cols, const void* vals,
                    const void* vals_lo, const void* u, void* out, int n_rows,
                    int n_cols, void* stream) {
    if (vals_lo != nullptr) return (int)cudaErrorInvalidValue;
    return launch_bell<double, double>(indptr, cols, vals, nullptr, u, out,
                                       n_rows, n_cols, stream);
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
