// Scan-window ELL matvecs of the Galerkin voxel multigrid, for Hopper (sm_90a).
//
// Both kernels read the row-slot ELL layout of ops/ell.pack_ell_rows (the
// JAX package's pack_ell_rows, array for array).  Rows come in tiles of 128;
// every row has S slots, and slot s of row n = 128 t + l sits at lane l:
//
//     cols2 [Nt*S, 128] int32    cols2[t*S + s][l]
//     vals2 [Nt*9*S, 128]        3x3 blocks, plane-major: [(9t + 3a+b)*S + s][l]
//     w2    [Nt*S, 128]          scalar weights, slot-major
//     wblk  [Nt] int32           window base of tile t, in 128-column chunks
//
// A slot whose column lies outside [128 wblk[t], 128 (wblk[t] + kc)), or at
// or past n_cols, contributes zero: the TPU kernel gathers only those kc
// chunks.  On pack_ell_rows output the window holds every column.
//
// bell_window replaces _bell_kernel with _grouped_gather
//             (topopteval_tpu/ops/pallas_bsr.py:119 and :76, via
//             bell_matvec_pallas :143): the 3x3-block SpMV of the coarse
//             Galerkin levels,
//
//     out[a, n] = sum_s sum_b vals2[(9t + 3a+b)*S + s][l] * u[b, cols2[t*S + s][l]]
//
// sell_window replaces _sell_kernel (pallas_bsr.py:204, via
//             sell_matvec_pallas :220): the transfers, prolongation P and
//             restriction P^T, both stored row-wise,
//
//     out[a, n] = sum_s w2[t*S + s][l] * u[a, cols2[t*S + s][l]]
//
// Vectors are strided views: element (a, n) of u is u[a*u_cs + n*u_ns], of
// out out[a*o_cs + n*o_ns].  Component-major [3, Np] (the JAX layout: cs = Np,
// ns = 1) and node-major [N, 3] (the V-cycle's layout: cs = 1, ns = 3) are
// the two layouts measured (chip_smoke.py phase 10).  Rows n >= n_rows are
// not written.  Instantiated for float and double, values in the vectors'
// type.
//
// The TPU kernel scans each tile's kc-chunk window with lane gathers,
// because the TPU cannot gather by address.  This card can: the layout is
// already a sliced ELL format whose consecutive lanes are consecutive
// addresses, so one thread per row reads its slot's column and values in
// coalesced 128-lane rows, with no repacking, and gathers u by address.
//
// Bound (both): memory.  The padded cols2 and values are read once, u once,
// out written once.  Scale-16 fine operator (222,208 padded rows, S = 16):
// cols 14.2 MB, values 128 MB float / 256 MB double, so 0.044 / 0.084 ms
// at 3.35 TB/s; 18 flops per block do not bind.  Summation runs over the
// slots in order (columns sorted within each row), so the result is the
// same every run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 128;

template <typename T, bool BLOCK>
__global__ void __launch_bounds__(LANES)
ell_window_kernel(const int* __restrict__ cols2, const T* __restrict__ vals,
                  const int* __restrict__ wblk, const T* __restrict__ u,
                  T* __restrict__ out, int S, int kc, int n_rows, int n_cols,
                  int64_t u_cs, int64_t u_ns, int64_t o_cs, int64_t o_ns) {
    const int t = blockIdx.x;
    const int l = threadIdx.x;
    const int n = t * LANES + l;
    if (n >= n_rows) return;
    const int64_t lo = (int64_t)wblk[t] * LANES;
    const int64_t end = lo + (int64_t)kc * LANES;
    const int64_t hi = end < (int64_t)n_cols ? end : (int64_t)n_cols;
    const int* __restrict__ c_t = cols2 + (int64_t)t * S * LANES + l;
    const int64_t plane = (int64_t)S * LANES;
    const T* __restrict__ v_t =
        vals + (int64_t)t * (BLOCK ? 9 : 1) * plane + l;
    T a0 = T(0), a1 = T(0), a2 = T(0);
    for (int s = 0; s < S; ++s) {
        const int64_t c = c_t[(int64_t)s * LANES];
        T x = T(0), y = T(0), z = T(0);
        if (c >= lo && c < hi) {
            const T* __restrict__ uc = u + c * u_ns;
            x = uc[0];
            y = uc[u_cs];
            z = uc[2 * u_cs];
        }
        const T* __restrict__ v = v_t + (int64_t)s * LANES;
        if (BLOCK) {
            a0 += v[0] * x + v[plane] * y + v[2 * plane] * z;
            a1 += v[3 * plane] * x + v[4 * plane] * y + v[5 * plane] * z;
            a2 += v[6 * plane] * x + v[7 * plane] * y + v[8 * plane] * z;
        } else {
            const T w = v[0];
            a0 += w * x;
            a1 += w * y;
            a2 += w * z;
        }
    }
    T* __restrict__ o = out + (int64_t)n * o_ns;
    o[0] = a0;
    o[o_cs] = a1;
    o[2 * o_cs] = a2;
}

template <typename T, bool BLOCK>
int launch(const void* cols2, const void* vals, const void* wblk, const void* u,
           void* out, int S, int kc, int n_tiles, int n_rows, int n_cols,
           long long u_cs, long long u_ns, long long o_cs, long long o_ns,
           void* stream) {
    if (n_rows <= 0) return 0;
    if (S <= 0 || kc <= 0 || n_rows > n_tiles * LANES)
        return (int)cudaErrorInvalidValue;
    const unsigned blocks = (unsigned)((n_rows + LANES - 1) / LANES);
    ell_window_kernel<T, BLOCK><<<blocks, LANES, 0, (cudaStream_t)stream>>>(
        (const int*)cols2, (const T*)vals, (const int*)wblk, (const T*)u,
        (T*)out, S, kc, n_rows, n_cols, u_cs, u_ns, o_cs, o_ns);
    return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, bound with ctypes in ops/ell.py.  All pointers are
// device pointers.  Each entry point returns cudaGetLastError() after its
// launch, 0 when n_rows is 0 (nothing launched).
extern "C" {

#define ELL_ENTRY(NAME, T, BLOCK)                                              \
    int NAME(const void* cols2, const void* vals, const void* wblk,            \
             const void* u, void* out, int S, int kc, int n_tiles, int n_rows, \
             int n_cols, long long u_cs, long long u_ns, long long o_cs,       \
             long long o_ns, void* stream) {                                   \
        return launch<T, BLOCK>(cols2, vals, wblk, u, out, S, kc, n_tiles,     \
                                n_rows, n_cols, u_cs, u_ns, o_cs, o_ns,        \
                                stream);                                       \
    }

ELL_ENTRY(bell_window_f32, float, true)
ELL_ENTRY(bell_window_f64, double, true)
ELL_ENTRY(sell_window_f32, float, false)
ELL_ENTRY(sell_window_f64, double, false)

#undef ELL_ENTRY

const char* ell_apply_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
