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
// sell_matvec: the same kernel over a body of one weight an entry (the
// three outputs of a row share it), chunks of 2,048 entries, and each
// lane takes its entries eight at a time: their eight columns from shared
// memory, then their 24 gathers of u, then the sums in order.  G from
// the mean row length (sell_lanes in ops/bell.py: 1 below 8 weights a
// row, as on the prolongation's ~5.6, else bell_matvec's rule: 8 on the
// restriction's ~34, so a lane sums its four or five weights in one
// batch).  G = 1 is the earlier design's loop, kept with
// its bits: one thread a row reading cols and w straight from device
// memory, in entry order; on short rows staging costs more than it
// saves.  The earlier design ran the restriction (36,352 rows, 1,240,625
// weights) as a chain of 34 column loads and the gathers they feed a
// thread, neighbouring threads' rows ~136 B apart: 0.0121 ms bf16 and
// 0.0182 fp64 warm, 26 / 34 % of the bound (NVIDIA H100 80GB HBM3 at
// 700 W).  At G > 1 the order is the butterfly's, fixed by the matrix
// alone.  Result, timed in turns with the earlier design
// (tools/kernel_ab.py, same card, inputs cold in L2): the restriction
// 0.0164 -> 0.0112 ms bf16, 0.0299 -> 0.0178 fp64 (28 / 36 % of the
// bound; warm 0.0091 / 0.0140); G = 4 and 16 20-36 % slower than 8; the
// prolongation at G = 1 unchanged (0.0080 / 0.0123), its bits the same.

// Both kernels are csr_matvec_kernel over a body (Block: 9 values an
// entry, with the optional lo plane; Weight: one value), as the element
// applies share one tile kernel (element_apply.cu).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BELL_THREADS = 256;  // threads of a block: G lanes a row

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

// What one entry of a row holds and how it adds into the row's three
// sums (x, y, z: the gathered u[:, c]).
//   Block: a 3x3 block, row-major, out[a] += sum_b v[3a+b] u[b]
//   Weight: one weight, out[a] += w u[a]
// CHUNK: entries of a row tile staged at a time.
// ILP: entries a lane takes at a time (their columns, then their gathers,
// then the sums in order), to keep several gathers in flight.
template <typename V_>
struct Block {
    using V = V_;
    static constexpr int NV = 9, CHUNK = 512, ILP = 1;
    template <typename T>
    __device__ __forceinline__ static void add(const V* v, T x, T y, T z,
                                               T& a0, T& a1, T& a2) {
        a0 += T(widen(v[0])) * x + T(widen(v[1])) * y + T(widen(v[2])) * z;
        a1 += T(widen(v[3])) * x + T(widen(v[4])) * y + T(widen(v[5])) * z;
        a2 += T(widen(v[6])) * x + T(widen(v[7])) * y + T(widen(v[8])) * z;
    }
};

template <typename V_>
struct Weight {
    using V = V_;
    static constexpr int NV = 1, CHUNK = 2048, ILP = 8;
    template <typename T>
    __device__ __forceinline__ static void add(const V* v, T x, T y, T z,
                                               T& a0, T& a1, T& a2) {
        const T w = T(widen(v[0]));
        a0 += w * x;
        a1 += w * y;
        a2 += w * z;
    }
};

// out[:, r] for the G-lane sub-warps of a block, one row each: a tile of
// R = BELL_THREADS / G consecutive rows.  Their entries are one contiguous
// run [indptr[r0], indptr[r0 + R)) of cols and of vals (and vals_lo); the
// block stages it in chunks of B::CHUNK entries, 16 bytes a copy, and
// each lane l of row r sums entries indptr[r] + l, + l + G, ... in order,
// B::ILP at a time, in registers that persist across chunks.  A xor
// butterfly over the G lanes then gives every row the same summation
// order from run to run.  The lo plane (Block only) has its own sums,
// reduced the same way and added once.  G = 1 is the one-thread-a-row
// loop of the earlier design: the row's entries read in order straight
// from device memory, nothing staged.
template <typename T, typename B, bool LO, int G>
__global__ void __launch_bounds__(BELL_THREADS)
csr_matvec_kernel(const int* __restrict__ indptr, const int* __restrict__ cols,
                  const typename B::V* __restrict__ vals,
                  const typename B::V* __restrict__ vals_lo,
                  const T* __restrict__ u, T* __restrict__ out, int n_rows,
                  int n_cols) {
    using V = typename B::V;
    constexpr int R = BELL_THREADS / G;
    constexpr int NV = B::NV, CHUNK = B::CHUNK, ILP = B::ILP;
    const int tid = threadIdx.x;
    const int lane = tid % G;
    const int r0 = blockIdx.x * R;
    const int r = r0 + tid / G;
    const T* __restrict__ u0 = u;
    const T* __restrict__ u1 = u + n_cols;
    const T* __restrict__ u2 = u + 2 * (int64_t)n_cols;
    T h0 = T(0), h1 = T(0), h2 = T(0);
    T l0 = T(0), l1 = T(0), l2 = T(0);
    if constexpr (G == 1) {
        if (r >= n_rows) return;
        const int end = indptr[r + 1];
        for (int j = indptr[r]; j < end; ++j) {
            const int c = cols[j];
            const T x = u0[c], y = u1[c], z = u2[c];
            B::add(vals + NV * (int64_t)j, x, y, z, h0, h1, h2);
            if (LO) B::add(vals_lo + NV * (int64_t)j, x, y, z, l0, l1, l2);
        }
    } else {
        constexpr int PAD = 16 / sizeof(V);
        // raw bytes: bf16 has constructors, which __shared__ arrays may not
        __shared__ __align__(16) unsigned char s_raw[
            (LO ? 2 : 1) * (NV * CHUNK + PAD) * sizeof(V)
            + (CHUNK + 4) * sizeof(int)];
        V* s_v = reinterpret_cast<V*>(s_raw);
        V* s_lo = s_v + NV * CHUNK + PAD;
        int* s_c = reinterpret_cast<int*>(s_raw + (LO ? 2 : 1)
                                                      * (NV * CHUNK + PAD)
                                                      * sizeof(V));
        const int J0 = indptr[r0];
        const int J1 = indptr[min(r0 + R, n_rows)];
        const int p0 = r < n_rows ? indptr[r] : J1;
        const int p1 = r < n_rows ? indptr[r + 1] : J1;
        int j = p0 + lane;                 // this lane's next entry
        for (int jc = J0; jc < J1; jc += CHUNK) {
            const int n = min(CHUNK, J1 - jc);
            const int sv = stage(s_v, vals + NV * (int64_t)jc, NV * n);
            const int sl = LO ? stage(s_lo, vals_lo + NV * (int64_t)jc,
                                      NV * n)
                              : 0;
            const int sc = stage(s_c, cols + jc, n);
            cp_async_wait_all();
            __syncthreads();
            const int end = min(p1, jc + n);
            while (j < end) {
                int c[ILP];
                T x[ILP][3];
#pragma unroll
                for (int k = 0; k < ILP; ++k)
                    c[k] = j + k * G < end ? s_c[sc + j + k * G - jc] : -1;
#pragma unroll
                for (int k = 0; k < ILP; ++k) {
                    const bool in = c[k] >= 0;
                    x[k][0] = in ? u0[c[k]] : T(0);
                    x[k][1] = in ? u1[c[k]] : T(0);
                    x[k][2] = in ? u2[c[k]] : T(0);
                }
#pragma unroll
                for (int k = 0; k < ILP; ++k) {
                    if (j + k * G >= end) break;
                    const int e = NV * (j + k * G - jc);
                    B::add(s_v + sv + e, x[k][0], x[k][1], x[k][2], h0, h1,
                           h2);
                    if (LO) B::add(s_lo + sl + e, x[k][0], x[k][1], x[k][2],
                                   l0, l1, l2);
                }
                // on to the first entry not summed (a chunk may end inside
                // a batch)
                j += G * min(ILP, (end - j + G - 1) / G);
            }
            __syncthreads();               // the next chunk reuses the buffers
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

template <typename T, typename B, int G>
void launch_g(const void* indptr, const void* cols, const void* vals,
              const void* vals_lo, const void* u, void* out, int n_rows,
              int n_cols, cudaStream_t stream) {
    using V = typename B::V;
    constexpr int R = BELL_THREADS / G;
    const unsigned blocks = (unsigned)((n_rows + R - 1) / R);
    // the lo plane comes with float blocks only (the C entry points
    // refuse it elsewhere), so only that instantiation carries its buffer
    if constexpr (std::is_same<B, Block<float>>::value) {
        if (vals_lo != nullptr) {
            csr_matvec_kernel<T, B, true, G><<<blocks, BELL_THREADS, 0, stream>>>(
                (const int*)indptr, (const int*)cols, (const V*)vals,
                (const V*)vals_lo, (const T*)u, (T*)out, n_rows, n_cols);
            return;
        }
    }
    csr_matvec_kernel<T, B, false, G><<<blocks, BELL_THREADS, 0, stream>>>(
        (const int*)indptr, (const int*)cols, (const V*)vals, nullptr,
        (const T*)u, (T*)out, n_rows, n_cols);
}

template <typename T, typename B>
int launch(const void* indptr, const void* cols, const void* vals,
           const void* vals_lo, const void* u, void* out, int n_rows,
           int n_cols, int lanes, void* stream) {
    if (n_rows <= 0) return 0;
    const cudaStream_t st = (cudaStream_t)stream;
#define CSR_LANES(G)                                                         \
    case G:                                                                  \
        launch_g<T, B, G>(indptr, cols, vals, vals_lo, u, out, n_rows,       \
                          n_cols, st);                                       \
        break;
    switch (lanes) {
        CSR_LANES(1)
        CSR_LANES(2)
        CSR_LANES(4)
        CSR_LANES(8)
        CSR_LANES(16)
        CSR_LANES(32)
        default: return (int)cudaErrorInvalidValue;
    }
#undef CSR_LANES
    return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, bound with ctypes in ops/bell.py.  All pointers are
// device pointers; vals_lo may be null (the lo plane is taken only by the
// float32 block instantiation: the wrapper refuses it elsewhere).  lanes
// is G, 1 to 32 (ops/bell.bell_lanes, sell_lanes).  Each entry point
// returns cudaGetLastError() after its launch, 0 when n_rows is 0
// (nothing launched).
extern "C" {

int bell_matvec_f32(const void* indptr, const void* cols, const void* vals,
                    const void* vals_lo, const void* u, void* out, int n_rows,
                    int n_cols, int lanes, void* stream) {
    return launch<float, Block<float>>(indptr, cols, vals, vals_lo, u, out,
                                       n_rows, n_cols, lanes, stream);
}

int bell_matvec_f32_bf16(const void* indptr, const void* cols, const void* vals,
                         const void* vals_lo, const void* u, void* out,
                         int n_rows, int n_cols, int lanes, void* stream) {
    if (vals_lo != nullptr) return (int)cudaErrorInvalidValue;
    return launch<float, Block<__nv_bfloat16>>(indptr, cols, vals, nullptr, u,
                                               out, n_rows, n_cols, lanes,
                                               stream);
}

int bell_matvec_f64(const void* indptr, const void* cols, const void* vals,
                    const void* vals_lo, const void* u, void* out, int n_rows,
                    int n_cols, int lanes, void* stream) {
    if (vals_lo != nullptr) return (int)cudaErrorInvalidValue;
    return launch<double, Block<double>>(indptr, cols, vals, nullptr, u, out,
                                         n_rows, n_cols, lanes, stream);
}

int sell_matvec_f32(const void* indptr, const void* cols, const void* w,
                    const void* u, void* out, int n_rows, int n_cols,
                    int lanes, void* stream) {
    return launch<float, Weight<float>>(indptr, cols, w, nullptr, u, out,
                                        n_rows, n_cols, lanes, stream);
}

int sell_matvec_f32_bf16(const void* indptr, const void* cols, const void* w,
                         const void* u, void* out, int n_rows, int n_cols,
                         int lanes, void* stream) {
    return launch<float, Weight<__nv_bfloat16>>(indptr, cols, w, nullptr, u,
                                                out, n_rows, n_cols, lanes,
                                                stream);
}

int sell_matvec_f64(const void* indptr, const void* cols, const void* w,
                    const void* u, void* out, int n_rows, int n_cols,
                    int lanes, void* stream) {
    return launch<double, Weight<double>>(indptr, cols, w, nullptr, u, out,
                                          n_rows, n_cols, lanes, stream);
}

const char* bell_apply_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
