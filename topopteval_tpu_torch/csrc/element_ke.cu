// Element-stiffness batches for linear elasticity on Hopper (sm_90a).
//
// Ke[(i,a),(j,b)] = sum_q w det_q (lam g_ia g_jb + mu g_ib g_ja
//                                  + mu delta_ab g_i . g_j)
// for every element, written element-major as Ke [C, 3k, 3k].  Each
// block gathers its elements' node rows of coords [N,3] through
// conn [C,k] (int32) into shared memory.  Both kernels are templated on
// float and double.
//
// tet4_ke  replaces _tet4_ke_kernel (topopteval_tpu/ops/pallas_kernels.py:71,
//          via tet4_element_stiffness_pallas :94).  Constant strain, so the
//          1-point rule is exact at any order: adjugate geometry of the
//          edge matrix with the det == 0 -> 1 guard, V = det/6.
//   Bound: memory.  Per element it writes 144 values (576 B fp32) and
//   reads 4 node rows, 16 B of conn and lam/mu: ~650 B against ~1,000
//   flops, far below the card's ~20 flop/B fp32 ridge.  At 1,228,800
//   tets that is ~0.8 GB, ~0.24 ms at 3.35 TB/s.
//   Design: phase 1, one thread per element, puts g [4][3], lam V and
//   mu V into shared memory; phase 2, the whole block writes the block's
//   contiguous run of Ke entries, consecutive threads on consecutive
//   entries, so every store of a warp is one coalesced 128 B (fp32)
//   line.  The entry's (i, a, j, b) come from its index.
//
// iso_ke<K, NQ>  replaces _make_iso_ke_kernel (pallas_kernels.py:381) and
//          _make_iso_ke_kernel_stream (:425), via _iso_ke :509,
//          hex8_element_stiffness_pallas :556 and
//          tet10_element_stiffness_pallas :568.  Both TPU kernels compute
//          the same function (the stream variant only works around Mosaic
//          spilling 9k^2 live accumulators); this one kernel ports both.
//          Instantiated for hex8 (K = 8, NQ = 8, 2x2x2 Gauss) and tet10
//          (K = 10, NQ = 4).  dN [NQ][K][3] and w [NQ] arrive as a table
//          argument built from ops/elements.element_tables, so the kernel
//          carries no numbers of its rule.  Isoparametric: J, J^-1 and
//          det at every point (the _inv3x3 adjugate formulas, same guard);
//          no constant-J shortcut, since tet10 mid-edge nodes may be
//          curved.
//   Bound: memory.  Ke is 9k^2 values per element (hex8 2,304 B, tet10
//   3,600 B fp32) against ~20-30 B of node rows, conn and material; the
//   arithmetic (about 9k^2 NQ 5 flops) stays under the write time at
//   fp32.  At 153,600 tet10 elements: 553 MB of Ke, 0.165 ms.
//   Design: the trap the TPU kernel hit is register pressure: one thread
//   per element would keep 9k^2 = 900 (tet10) accumulators live.  Here a
//   block takes ISO_KE_ELEMS elements; phase 1 puts every point's J^-1
//   and w det into shared memory, phase 2 every point's physical
//   gradients g [NQ][K][3]; phase 3 gives one thread each (element, node
//   pair i, j), which sums its own 3x3 block over the points in 9
//   registers and writes it once.  Consecutive threads take consecutive
//   j, so a warp's stores cover runs of 3k values of one Ke row.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TET4_KE_ELEMS = 128;
constexpr int TET4_KE_THREADS = 256;
constexpr int ISO_KE_ELEMS = 8;
constexpr int ISO_KE_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(TET4_KE_THREADS)
tet4_ke_kernel(const T* __restrict__ coords, const int* __restrict__ conn,
               const T* __restrict__ lam, const T* __restrict__ mu,
               T* __restrict__ out, int64_t C) {
    __shared__ T s_g[TET4_KE_ELEMS][4][3];
    __shared__ T s_lv[TET4_KE_ELEMS];
    __shared__ T s_mv[TET4_KE_ELEMS];
    const int64_t c0 = (int64_t)blockIdx.x * TET4_KE_ELEMS;
    const int ne = (int)(C - c0 < TET4_KE_ELEMS ? C - c0 : TET4_KE_ELEMS);
    for (int e = threadIdx.x; e < ne; e += blockDim.x) {
        const int64_t c = c0 + e;
        T x[4][3];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const int64_t n = conn[4 * c + k];
#pragma unroll
            for (int a = 0; a < 3; ++a) x[k][a] = coords[3 * n + a];
        }
        // edge matrix E = [p1-p0, p2-p0, p3-p0] (rows)
        T ed[3][3];
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
            for (int a = 0; a < 3; ++a) ed[i][a] = x[i + 1][a] - x[0][a];
        const T c0_ = ed[1][1] * ed[2][2] - ed[1][2] * ed[2][1];
        const T c1_ = ed[1][2] * ed[2][0] - ed[1][0] * ed[2][2];
        const T c2_ = ed[1][0] * ed[2][1] - ed[1][1] * ed[2][0];
        const T det = ed[0][0] * c0_ + ed[0][1] * c1_ + ed[0][2] * c2_;
        const T inv_det = T(1) / (det == T(0) ? T(1) : det);
        // rows of E^{-1} (adjugate / det)
        const T adj[3][3] = {
            {c0_, ed[0][2] * ed[2][1] - ed[0][1] * ed[2][2],
             ed[0][1] * ed[1][2] - ed[0][2] * ed[1][1]},
            {c1_, ed[0][0] * ed[2][2] - ed[0][2] * ed[2][0],
             ed[0][2] * ed[1][0] - ed[0][0] * ed[1][2]},
            {c2_, ed[0][1] * ed[2][0] - ed[0][0] * ed[2][1],
             ed[0][0] * ed[1][1] - ed[0][1] * ed[1][0]}};
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
            for (int a = 0; a < 3; ++a) s_g[e][i + 1][a] = adj[a][i] * inv_det;
#pragma unroll
        for (int a = 0; a < 3; ++a)
            s_g[e][0][a] = -(s_g[e][1][a] + s_g[e][2][a] + s_g[e][3][a]);
        const T vol = det / T(6);
        s_lv[e] = lam[c] * vol;
        s_mv[e] = mu[c] * vol;
    }
    __syncthreads();
    T* o = out + c0 * 144;
    const int n_out = ne * 144;
    for (int idx = threadIdx.x; idx < n_out; idx += blockDim.x) {
        const int e = idx / 144;
        const int r = idx - 144 * e;
        const int row = r / 12;
        const int col = r - 12 * row;
        const int i = row / 3, a = row - 3 * i;
        const int j = col / 3, b = col - 3 * j;
        const T* gi = s_g[e][i];
        const T* gj = s_g[e][j];
        const T mv = s_mv[e];
        T v = s_lv[e] * (gi[a] * gj[b]) + mv * (gi[b] * gj[a]);
        if (a == b) v += mv * (gi[0] * gj[0] + gi[1] * gj[1] + gi[2] * gj[2]);
        o[idx] = v;
    }
}

template <typename T, int K, int NQ>
__global__ void __launch_bounds__(ISO_KE_THREADS)
iso_ke_kernel(const T* __restrict__ coords, const int* __restrict__ conn,
              const T* __restrict__ lam, const T* __restrict__ mu,
              const T* __restrict__ table, T* __restrict__ out, int64_t C) {
    constexpr int EK = 3 * K;
    __shared__ T s_dn[NQ][K][3];
    __shared__ T s_w[NQ];
    __shared__ T s_x[ISO_KE_ELEMS][K][3];
    __shared__ T s_inv[ISO_KE_ELEMS][NQ][3][3];
    __shared__ T s_lw[ISO_KE_ELEMS][NQ];
    __shared__ T s_mw[ISO_KE_ELEMS][NQ];
    __shared__ T s_g[ISO_KE_ELEMS][NQ][K][3];
    const int64_t c0 = (int64_t)blockIdx.x * ISO_KE_ELEMS;
    const int ne = (int)(C - c0 < ISO_KE_ELEMS ? C - c0 : ISO_KE_ELEMS);
    const int tid = threadIdx.x;
    for (int t = tid; t < NQ * K * 3; t += blockDim.x)
        (&s_dn[0][0][0])[t] = table[t];
    for (int t = tid; t < NQ; t += blockDim.x) s_w[t] = table[NQ * K * 3 + t];
    for (int t = tid; t < ne * K; t += blockDim.x) {
        const int e = t / K, k = t - K * e;
        const int64_t n = conn[(c0 + e) * K + k];
#pragma unroll
        for (int a = 0; a < 3; ++a) s_x[e][k][a] = coords[3 * n + a];
    }
    __syncthreads();
    // phase 1: J, J^-1 and the weights at each (element, point)
    for (int t = tid; t < ne * NQ; t += blockDim.x) {
        const int e = t / NQ, q = t - NQ * e;
        T J[3][3];
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
            for (int b = 0; b < 3; ++b) {
                T s = T(0);
#pragma unroll
                for (int k = 0; k < K; ++k) s += s_x[e][k][a] * s_dn[q][k][b];
                J[a][b] = s;
            }
        const T A = J[1][1] * J[2][2] - J[1][2] * J[2][1];
        const T B = J[0][2] * J[2][1] - J[0][1] * J[2][2];
        const T Cc = J[0][1] * J[1][2] - J[0][2] * J[1][1];
        const T det = J[0][0] * A + J[1][0] * B + J[2][0] * Cc;
        const T idet = T(1) / (det == T(0) ? T(1) : det);
        T (*inv)[3] = s_inv[e][q];
        inv[0][0] = A * idet;
        inv[0][1] = B * idet;
        inv[0][2] = Cc * idet;
        inv[1][0] = (J[1][2] * J[2][0] - J[1][0] * J[2][2]) * idet;
        inv[1][1] = (J[0][0] * J[2][2] - J[0][2] * J[2][0]) * idet;
        inv[1][2] = (J[0][2] * J[1][0] - J[0][0] * J[1][2]) * idet;
        inv[2][0] = (J[1][0] * J[2][1] - J[1][1] * J[2][0]) * idet;
        inv[2][1] = (J[0][1] * J[2][0] - J[0][0] * J[2][1]) * idet;
        inv[2][2] = (J[0][0] * J[1][1] - J[0][1] * J[1][0]) * idet;
        const T wdet = s_w[q] * det;
        s_lw[e][q] = lam[c0 + e] * wdet;
        s_mw[e][q] = mu[c0 + e] * wdet;
    }
    __syncthreads();
    // phase 2: g[k][a] = sum_b dN[q][k][b] J^-1[b][a]
    for (int t = tid; t < ne * NQ * K; t += blockDim.x) {
        const int e = t / (NQ * K);
        const int r = t - NQ * K * e;
        const int q = r / K, k = r - K * q;
        const T* dn = s_dn[q][k];
        const T (*inv)[3] = s_inv[e][q];
#pragma unroll
        for (int a = 0; a < 3; ++a)
            s_g[e][q][k][a] = dn[0] * inv[0][a] + dn[1] * inv[1][a] +
                              dn[2] * inv[2][a];
    }
    __syncthreads();
    // phase 3: one thread per (element, node pair), its 3x3 block summed
    // over the points
    for (int t = tid; t < ne * K * K; t += blockDim.x) {
        const int e = t / (K * K);
        const int p = t - K * K * e;
        const int i = p / K, j = p - K * i;
        T acc[3][3];
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
            for (int b = 0; b < 3; ++b) acc[a][b] = T(0);
#pragma unroll 1
        for (int q = 0; q < NQ; ++q) {
            const T* gi = s_g[e][q][i];
            const T* gj = s_g[e][q][j];
            const T lw = s_lw[e][q], mw = s_mw[e][q];
            const T d = mw * (gi[0] * gj[0] + gi[1] * gj[1] + gi[2] * gj[2]);
#pragma unroll
            for (int a = 0; a < 3; ++a)
#pragma unroll
                for (int b = 0; b < 3; ++b)
                    acc[a][b] += lw * (gi[a] * gj[b]) + mw * (gi[b] * gj[a]) +
                                 (a == b ? d : T(0));
        }
        T* o = out + (c0 + e) * (EK * EK) + (3 * i) * EK + 3 * j;
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
            for (int b = 0; b < 3; ++b) o[a * EK + b] = acc[a][b];
    }
}

template <typename T>
int launch_tet4_ke(const void* coords, const void* conn, const void* lam,
                   const void* mu, void* out, long long C, void* stream) {
    if (C > 0) {
        const long long blocks = (C + TET4_KE_ELEMS - 1) / TET4_KE_ELEMS;
        tet4_ke_kernel<T><<<(unsigned)blocks, TET4_KE_THREADS, 0,
                            (cudaStream_t)stream>>>(
            (const T*)coords, (const int*)conn, (const T*)lam, (const T*)mu,
            (T*)out, (int64_t)C);
    }
    return (int)cudaGetLastError();
}

template <typename T, int K, int NQ>
int launch_iso_ke(const void* coords, const void* conn, const void* lam,
                  const void* mu, const void* table, void* out, long long C,
                  void* stream) {
    if (C > 0) {
        const long long blocks = (C + ISO_KE_ELEMS - 1) / ISO_KE_ELEMS;
        iso_ke_kernel<T, K, NQ><<<(unsigned)blocks, ISO_KE_THREADS, 0,
                                  (cudaStream_t)stream>>>(
            (const T*)coords, (const int*)conn, (const T*)lam, (const T*)mu,
            (const T*)table, (T*)out, (int64_t)C);
    }
    return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, bound with ctypes in ops/ke_kernels.py.  Every
// pointer is a device pointer; ``table`` holds dN [NQ][K][3] then w [NQ]
// of the element's order-2 rule.  Each entry point returns
// cudaGetLastError() after its launch.
extern "C" {

int tet4_ke_f32(const void* coords, const void* conn, const void* lam,
                const void* mu, void* out, long long C, void* stream) {
    return launch_tet4_ke<float>(coords, conn, lam, mu, out, C, stream);
}

int tet4_ke_f64(const void* coords, const void* conn, const void* lam,
                const void* mu, void* out, long long C, void* stream) {
    return launch_tet4_ke<double>(coords, conn, lam, mu, out, C, stream);
}

int hex8_ke_f32(const void* coords, const void* conn, const void* lam,
                const void* mu, const void* table, void* out, long long C,
                void* stream) {
    return launch_iso_ke<float, 8, 8>(coords, conn, lam, mu, table, out, C,
                                      stream);
}

int hex8_ke_f64(const void* coords, const void* conn, const void* lam,
                const void* mu, const void* table, void* out, long long C,
                void* stream) {
    return launch_iso_ke<double, 8, 8>(coords, conn, lam, mu, table, out, C,
                                       stream);
}

int tet10_ke_f32(const void* coords, const void* conn, const void* lam,
                 const void* mu, const void* table, void* out, long long C,
                 void* stream) {
    return launch_iso_ke<float, 10, 4>(coords, conn, lam, mu, table, out, C,
                                       stream);
}

int tet10_ke_f64(const void* coords, const void* conn, const void* lam,
                 const void* mu, const void* table, void* out, long long C,
                 void* stream) {
    return launch_iso_ke<double, 10, 4>(coords, conn, lam, mu, table, out, C,
                                        stream);
}

const char* element_ke_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
