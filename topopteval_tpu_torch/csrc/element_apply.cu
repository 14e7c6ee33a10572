// Matrix-free element applies for linear elasticity on Hopper (sm_90a).
//
// f_e = Ke(coords, lam, mu) @ u_e for every element, without forming Ke.
// One thread per element; each thread gathers its own node rows of
// coords [N,3] and u [3N] through conn [C,k] (int32) and writes its
// element forces f_e [C,k,3].  The node scatter-sum stays outside, in the
// deterministic incidence gather-sum of ops/scatter.py.  Both kernels are
// templated on float and double.
//
// tet4_apply  replaces _tet4_apply_kernel (topopteval_tpu/ops/pallas_kernels.py:137,
//             via _tet4_apply_call :159 and tet4_apply_pallas :196).
//             Constant strain, so the 1-point rule is exact: adjugate
//             geometry with the det == 0 -> 1 guard, V = det/6,
//             eps = sym grad u, sigma = lam tr(eps) I + 2 mu eps,
//             f = V sigma g.
//   Bound: memory.  Per element it reads 16 B of conn, 2 values of
//   lam/mu, and writes 12 values; its 4 coordinate and 4 displacement
//   rows (96 B fp32) are gathered from arrays of ~30k nodes that stay in
//   the 50 MB L2.  The function needs about 166 flops per element (the
//   count is itemised in chip_smoke.py) against ~77 B of device-memory
//   traffic (fp32), far below the card's ~20 flop/B ridge: at 153,600
//   tets it moves ~12 MB, 3.5 us at 3.35 TB/s, about the cost of one
//   launch.
//   Design: no shared memory and no staging; the gather is fused so each
//   element costs one 16 B conn load plus L2-resident row loads, and the
//   only device-memory stream is conn/lam/mu in and f_e out.
//
// hex8_apply  replaces _hex8_apply_kernel (topopteval_tpu/ops/pallas_kernels.py:256,
//             via hex8_apply_pallas :288).  2x2x2 Gauss, all weights 1:
//             at each point J, J^-1 and det (the _inv3_scalars :237
//             formulas, same guard), sigma, and f += det sigma g.
//   Bound: memory.  Per element it reads 32 B of conn and 2 values of
//   lam/mu, writes 24 values, and shares ~1.2 node rows of coords and u:
//   ~164 B (fp32), so 4.2 MB at 25,600 hexes, 1.25 us at 3.35 TB/s
//   (fp64: 7.6 MB, 2.27 us).  The function needs about 2,256 flops per
//   element when the reference gradients are sum-factorised over the
//   two-point rule (itemised in chip_smoke.py): 58 MFLOP, 0.86 us at
//   67 TFLOP/s fp32 (1.70 us at 34 TFLOP/s fp64), below the bytes time.
//   This kernel does not sum-factorise: it forms every g_k = dN_k J^-1
//   at every point, twice, about 5,000 flops per element, so its own
//   arithmetic sits above the byte time; the sum-factorised form is
//   later work.
//   Design: the 8x8x3 reference-gradient table sits in __constant__
//   memory (every thread of a warp reads the same entry, so each read is
//   a broadcast); the 24 force accumulators stay in registers; the
//   physical gradients g_k are recomputed in the force loop rather than
//   kept (24 registers saved), and the quadrature loop is not unrolled,
//   to hold register pressure down.
//
// tet10_apply replaces _make_iso_apply_kernel (topopteval_tpu/ops/pallas_kernels.py:343,
//             via _iso_apply :474 and tet10_apply_pallas :544).
//             Isoparametric with the 4-point order-2 rule: at each point
//             J, J^-1 and det (same formulas and guard), sigma, and
//             f += w det sigma g.  J varies from point to point (mid-edge
//             nodes may be curved), so nothing is taken as constant.  dN
//             [4][10][3] and w [4] arrive as a table argument built from
//             ops/elements.element_tables.
//   Bound: memory.  Per element it reads 40 B of conn and 2 values of
//   lam/mu and writes 30 values, and shares ~1.4 node rows of coords and
//   u: ~200 B (fp32), so ~31 MB at 153,600 elements, 0.009 ms at 3.35
//   TB/s (fp64 ~0.017 ms).  The function needs about 2,600 flops per
//   element (itemised in chip_smoke.py): 0.006 ms at 67 TFLOP/s fp32,
//   0.012 ms at 34 TFLOP/s fp64, both under the byte time.
//   Design: one thread per element would hold coords and u (60 values),
//   g (30), f (30) and J/J^-1: past 255 registers in fp64.  Instead four
//   threads take an element, one per point; the block stages its
//   elements' coords and u rows in shared memory (read through conn by
//   the whole block, so the conn loads coalesce); each thread forms its
//   point's J, J^-1, grad u and sigma, recomputes g_k in the force loop,
//   and the four point contributions to f_k are summed by two xor
//   shuffles inside the warp.  Registers hold J^-1, grad u, sigma and one
//   g_k at a time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// dN/dxi of the 8 trilinear shape functions at the 8 Gauss points, in the
// order of topopteval_tpu_torch/ops/elements.py QUADRATURE[("hex", 2)]:
// (1 +- 1/sqrt3)^2 / 8, (1 - 1/3) / 8 and (1 -+ 1/sqrt3)^2 / 8, rounded
// to double exactly as NumPy computes them.
#define HA 0.31100423396407312
#define HB 0.083333333333333315
#define HC 0.022329099369260218
#define HEX_DN_TABLE {                                                              \
    {{-HA,-HA,-HA}, { HA,-HB,-HB}, { HB, HB,-HC}, {-HB, HA,-HB}, {-HB,-HB, HA}, { HB,-HC, HB}, { HC, HC, HC}, {-HC, HB, HB}}, \
    {{-HA,-HB,-HB}, { HA,-HA,-HA}, { HB, HA,-HB}, {-HB, HB,-HC}, {-HB,-HC, HB}, { HB,-HB, HA}, { HC, HB, HB}, {-HC, HC, HC}}, \
    {{-HB,-HA,-HB}, { HB,-HB,-HC}, { HA, HB,-HB}, {-HA, HA,-HA}, {-HC,-HB, HB}, { HC,-HC, HC}, { HB, HC, HB}, {-HB, HB, HA}}, \
    {{-HB,-HB,-HC}, { HB,-HA,-HB}, { HA, HA,-HA}, {-HA, HB,-HB}, {-HC,-HC, HC}, { HC,-HB, HB}, { HB, HB, HA}, {-HB, HC, HB}}, \
    {{-HB,-HB,-HA}, { HB,-HC,-HB}, { HC, HC,-HC}, {-HC, HB,-HB}, {-HA,-HA, HA}, { HA,-HB, HB}, { HB, HB, HC}, {-HB, HA, HB}}, \
    {{-HB,-HC,-HB}, { HB,-HB,-HA}, { HC, HB,-HB}, {-HC, HC,-HC}, {-HA,-HB, HB}, { HA,-HA, HA}, { HB, HA, HB}, {-HB, HB, HC}}, \
    {{-HC,-HB,-HB}, { HC,-HC,-HC}, { HB, HC,-HB}, {-HB, HB,-HA}, {-HB,-HA, HB}, { HB,-HB, HC}, { HA, HB, HB}, {-HA, HA, HA}}, \
    {{-HC,-HC,-HC}, { HC,-HB,-HB}, { HB, HB,-HA}, {-HB, HC,-HB}, {-HB,-HB, HC}, { HB,-HA, HB}, { HA, HA, HA}, {-HA, HB, HB}}, \
}

__constant__ double c_hex_dn_f64[8][8][3] = HEX_DN_TABLE;
__constant__ float c_hex_dn_f32[8][8][3] = HEX_DN_TABLE;

template <typename T> __device__ __forceinline__ T hex_dn(int q, int k, int b);
template <> __device__ __forceinline__ float hex_dn<float>(int q, int k, int b) {
    return c_hex_dn_f32[q][k][b];
}
template <> __device__ __forceinline__ double hex_dn<double>(int q, int k, int b) {
    return c_hex_dn_f64[q][k][b];
}

constexpr int TET4_THREADS = 256;
constexpr int HEX8_THREADS = 128;
constexpr int TET10_ELEMS = 32;                 // 4 threads per element
constexpr int TET10_THREADS = 4 * TET10_ELEMS;

template <typename T>
__global__ void __launch_bounds__(TET4_THREADS)
tet4_apply_kernel(const T* __restrict__ coords, const int4* __restrict__ conn,
                  const T* __restrict__ u, const T* __restrict__ lam,
                  const T* __restrict__ mu, T* __restrict__ out, int64_t C) {
    const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (c >= C) return;
    const int4 nd = conn[c];
    const int64_t n[4] = {nd.x, nd.y, nd.z, nd.w};
    T x[4][3], uu[4][3];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            x[k][a] = coords[3 * n[k] + a];
            uu[k][a] = u[3 * n[k] + a];
        }
    }
    // edge matrix E = [p1-p0, p2-p0, p3-p0] (rows)
    T e[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int a = 0; a < 3; ++a) e[i][a] = x[i + 1][a] - x[0][a];
    const T c0 = e[1][1] * e[2][2] - e[1][2] * e[2][1];
    const T c1 = e[1][2] * e[2][0] - e[1][0] * e[2][2];
    const T c2 = e[1][0] * e[2][1] - e[1][1] * e[2][0];
    const T det = e[0][0] * c0 + e[0][1] * c1 + e[0][2] * c2;
    const T inv_det = T(1) / (det == T(0) ? T(1) : det);
    // rows of E^{-1} (adjugate / det)
    const T adj[3][3] = {
        {c0, e[0][2] * e[2][1] - e[0][1] * e[2][2],
         e[0][1] * e[1][2] - e[0][2] * e[1][1]},
        {c1, e[0][0] * e[2][2] - e[0][2] * e[2][0],
         e[0][2] * e[1][0] - e[0][0] * e[1][2]},
        {c2, e[0][1] * e[2][0] - e[0][0] * e[2][1],
         e[0][0] * e[1][1] - e[0][1] * e[1][0]}};
    // g[k][a] = dN_k/dx_a
    T g[4][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int a = 0; a < 3; ++a) g[i + 1][a] = adj[a][i] * inv_det;
#pragma unroll
    for (int a = 0; a < 3; ++a) g[0][a] = -(g[1][a] + g[2][a] + g[3][a]);
    const T vol = det / T(6);
    // gu[a][b] = du_a/dx_b = sum_k u[k][a] g[k][b]
    T gu[3][3];
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int b = 0; b < 3; ++b)
            gu[a][b] = uu[0][a] * g[0][b] + uu[1][a] * g[1][b] +
                       uu[2][a] * g[2][b] + uu[3][a] * g[3][b];
    const T lam_tr = lam[c] * (gu[0][0] + gu[1][1] + gu[2][2]);
    const T two_mu = T(2) * mu[c];
    T sig[3][3];
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int b = 0; b < 3; ++b)
            sig[a][b] = two_mu * (T(0.5) * (gu[a][b] + gu[b][a])) +
                        (a == b ? lam_tr : T(0));
    T* o = out + 12 * c;
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int a = 0; a < 3; ++a)
            o[3 * k + a] = vol * (sig[a][0] * g[k][0] + sig[a][1] * g[k][1] +
                                  sig[a][2] * g[k][2]);
}

template <typename T>
__global__ void __launch_bounds__(HEX8_THREADS)
hex8_apply_kernel(const T* __restrict__ coords, const int4* __restrict__ conn,
                  const T* __restrict__ u, const T* __restrict__ lam,
                  const T* __restrict__ mu, T* __restrict__ out, int64_t C) {
    const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (c >= C) return;
    const int4 lo = conn[2 * c];
    const int4 hi = conn[2 * c + 1];
    const int64_t n[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    T x[8][3], uu[8][3], f[8][3];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            x[k][a] = coords[3 * n[k] + a];
            uu[k][a] = u[3 * n[k] + a];
            f[k][a] = T(0);
        }
    }
    const T lm = lam[c];
    const T m = mu[c];
#pragma unroll 1
    for (int q = 0; q < 8; ++q) {
        // J[a][b] = sum_k x[k][a] dN[q][k][b]
        T J[3][3];
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
            for (int b = 0; b < 3; ++b) {
                T s = T(0);
#pragma unroll
                for (int k = 0; k < 8; ++k) s += x[k][a] * hex_dn<T>(q, k, b);
                J[a][b] = s;
            }
        const T A = J[1][1] * J[2][2] - J[1][2] * J[2][1];
        const T B = J[0][2] * J[2][1] - J[0][1] * J[2][2];
        const T Cc = J[0][1] * J[1][2] - J[0][2] * J[1][1];
        const T det = J[0][0] * A + J[1][0] * B + J[2][0] * Cc;
        const T idet = T(1) / (det == T(0) ? T(1) : det);
        const T inv[3][3] = {
            {A * idet, B * idet, Cc * idet},
            {(J[1][2] * J[2][0] - J[1][0] * J[2][2]) * idet,
             (J[0][0] * J[2][2] - J[0][2] * J[2][0]) * idet,
             (J[0][2] * J[1][0] - J[0][0] * J[1][2]) * idet},
            {(J[1][0] * J[2][1] - J[1][1] * J[2][0]) * idet,
             (J[0][1] * J[2][0] - J[0][0] * J[2][1]) * idet,
             (J[0][0] * J[1][1] - J[0][1] * J[1][0]) * idet}};
        // gu[a][b] = sum_k u[k][a] g[k][b],  g[k][a] = sum_b dN[q][k][b] inv[b][a]
        T gu[3][3];
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
            for (int b = 0; b < 3; ++b) gu[a][b] = T(0);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
            T gk[3];
#pragma unroll
            for (int a = 0; a < 3; ++a)
                gk[a] = hex_dn<T>(q, k, 0) * inv[0][a] +
                        hex_dn<T>(q, k, 1) * inv[1][a] +
                        hex_dn<T>(q, k, 2) * inv[2][a];
#pragma unroll
            for (int a = 0; a < 3; ++a)
#pragma unroll
                for (int b = 0; b < 3; ++b) gu[a][b] += uu[k][a] * gk[b];
        }
        const T lam_tr = lm * (gu[0][0] + gu[1][1] + gu[2][2]);
        T sig[3][3];
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
            for (int b = 0; b < 3; ++b)
                sig[a][b] = m * (gu[a][b] + gu[b][a]) + (a == b ? lam_tr : T(0));
#pragma unroll
        for (int k = 0; k < 8; ++k) {
            T gk[3];
#pragma unroll
            for (int a = 0; a < 3; ++a)
                gk[a] = hex_dn<T>(q, k, 0) * inv[0][a] +
                        hex_dn<T>(q, k, 1) * inv[1][a] +
                        hex_dn<T>(q, k, 2) * inv[2][a];
#pragma unroll
            for (int a = 0; a < 3; ++a)
                f[k][a] += det * (sig[a][0] * gk[0] + sig[a][1] * gk[1] +
                                  sig[a][2] * gk[2]);
        }
    }
    T* o = out + 24 * c;
#pragma unroll
    for (int k = 0; k < 8; ++k)
#pragma unroll
        for (int a = 0; a < 3; ++a) o[3 * k + a] = f[k][a];
}

template <typename T>
__global__ void __launch_bounds__(TET10_THREADS)
tet10_apply_kernel(const T* __restrict__ coords, const int* __restrict__ conn,
                   const T* __restrict__ u, const T* __restrict__ lam,
                   const T* __restrict__ mu, const T* __restrict__ table,
                   T* __restrict__ out, int64_t C) {
    __shared__ T s_dn[4][10][3];
    __shared__ T s_w[4];
    __shared__ T s_x[TET10_ELEMS][10][3];
    __shared__ T s_u[TET10_ELEMS][10][3];
    const int64_t c0 = (int64_t)blockIdx.x * TET10_ELEMS;
    const int ne = (int)(C - c0 < TET10_ELEMS ? C - c0 : TET10_ELEMS);
    const int tid = threadIdx.x;
    for (int t = tid; t < 120; t += blockDim.x) (&s_dn[0][0][0])[t] = table[t];
    if (tid < 4) s_w[tid] = table[120 + tid];
    for (int t = tid; t < ne * 10; t += blockDim.x) {
        const int e = t / 10, k = t - 10 * e;
        const int64_t n = conn[(c0 + e) * 10 + k];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            s_x[e][k][a] = coords[3 * n + a];
            s_u[e][k][a] = u[3 * n + a];
        }
    }
    __syncthreads();
    // lanes of a missing element (the ragged last block) shadow element 0
    // so that every lane takes part in the shuffles; they write nothing
    const int el = tid >> 2, q = tid & 3;
    const bool live = el < ne;
    const int e = live ? el : 0;
    T J[3][3];
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int b = 0; b < 3; ++b) {
            T s = T(0);
#pragma unroll
            for (int k = 0; k < 10; ++k) s += s_x[e][k][a] * s_dn[q][k][b];
            J[a][b] = s;
        }
    const T A = J[1][1] * J[2][2] - J[1][2] * J[2][1];
    const T B = J[0][2] * J[2][1] - J[0][1] * J[2][2];
    const T Cc = J[0][1] * J[1][2] - J[0][2] * J[1][1];
    const T det = J[0][0] * A + J[1][0] * B + J[2][0] * Cc;
    const T idet = T(1) / (det == T(0) ? T(1) : det);
    const T inv[3][3] = {
        {A * idet, B * idet, Cc * idet},
        {(J[1][2] * J[2][0] - J[1][0] * J[2][2]) * idet,
         (J[0][0] * J[2][2] - J[0][2] * J[2][0]) * idet,
         (J[0][2] * J[1][0] - J[0][0] * J[1][2]) * idet},
        {(J[1][0] * J[2][1] - J[1][1] * J[2][0]) * idet,
         (J[0][1] * J[2][0] - J[0][0] * J[2][1]) * idet,
         (J[0][0] * J[1][1] - J[0][1] * J[1][0]) * idet}};
    T gu[3][3];
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int b = 0; b < 3; ++b) gu[a][b] = T(0);
#pragma unroll 2
    for (int k = 0; k < 10; ++k) {
        const T* dn = s_dn[q][k];
        T gk[3];
#pragma unroll
        for (int a = 0; a < 3; ++a)
            gk[a] = dn[0] * inv[0][a] + dn[1] * inv[1][a] + dn[2] * inv[2][a];
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
            for (int b = 0; b < 3; ++b) gu[a][b] += s_u[e][k][a] * gk[b];
    }
    const T m = mu[c0 + e];
    const T lam_tr = lam[c0 + e] * (gu[0][0] + gu[1][1] + gu[2][2]);
    const T wdet = s_w[q] * det;
    T sig[3][3];
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int b = 0; b < 3; ++b)
            sig[a][b] = wdet * (m * (gu[a][b] + gu[b][a]) +
                                (a == b ? lam_tr : T(0)));
    T* o = out + (c0 + e) * 30;
#pragma unroll 2
    for (int k = 0; k < 10; ++k) {
        const T* dn = s_dn[q][k];
        T gk[3];
#pragma unroll
        for (int a = 0; a < 3; ++a)
            gk[a] = dn[0] * inv[0][a] + dn[1] * inv[1][a] + dn[2] * inv[2][a];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            T f = sig[a][0] * gk[0] + sig[a][1] * gk[1] + sig[a][2] * gk[2];
            f += __shfl_xor_sync(0xffffffffu, f, 1);
            f += __shfl_xor_sync(0xffffffffu, f, 2);
            if (live && (k & 3) == q) o[3 * k + a] = f;
        }
    }
}

template <typename T>
int launch_tet4(const void* coords, const void* conn, const void* u,
                const void* lam, const void* mu, void* out, long long C,
                void* stream) {
    if (C > 0) {
        const long long blocks = (C + TET4_THREADS - 1) / TET4_THREADS;
        tet4_apply_kernel<T><<<(unsigned)blocks, TET4_THREADS, 0,
                               (cudaStream_t)stream>>>(
            (const T*)coords, (const int4*)conn, (const T*)u, (const T*)lam,
            (const T*)mu, (T*)out, (int64_t)C);
    }
    return (int)cudaGetLastError();
}

template <typename T>
int launch_hex8(const void* coords, const void* conn, const void* u,
                const void* lam, const void* mu, void* out, long long C,
                void* stream) {
    if (C > 0) {
        const long long blocks = (C + HEX8_THREADS - 1) / HEX8_THREADS;
        hex8_apply_kernel<T><<<(unsigned)blocks, HEX8_THREADS, 0,
                               (cudaStream_t)stream>>>(
            (const T*)coords, (const int4*)conn, (const T*)u, (const T*)lam,
            (const T*)mu, (T*)out, (int64_t)C);
    }
    return (int)cudaGetLastError();
}

template <typename T>
int launch_tet10(const void* coords, const void* conn, const void* u,
                 const void* lam, const void* mu, const void* table, void* out,
                 long long C, void* stream) {
    if (C > 0) {
        const long long blocks = (C + TET10_ELEMS - 1) / TET10_ELEMS;
        tet10_apply_kernel<T><<<(unsigned)blocks, TET10_THREADS, 0,
                                (cudaStream_t)stream>>>(
            (const T*)coords, (const int*)conn, (const T*)u, (const T*)lam,
            (const T*)mu, (const T*)table, (T*)out, (int64_t)C);
    }
    return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, bound with ctypes in ops/element_kernels.py.  Every
// pointer is a device pointer; conn must be 16-byte aligned.  Each entry
// point returns cudaGetLastError() after its launch.  tet10_apply's
// ``table`` holds dN [4][10][3] then w [4] of the 4-point rule; its conn
// needs no alignment.
extern "C" {

int tet4_apply_f32(const void* coords, const void* conn, const void* u,
                   const void* lam, const void* mu, void* out, long long C,
                   void* stream) {
    return launch_tet4<float>(coords, conn, u, lam, mu, out, C, stream);
}

int tet4_apply_f64(const void* coords, const void* conn, const void* u,
                   const void* lam, const void* mu, void* out, long long C,
                   void* stream) {
    return launch_tet4<double>(coords, conn, u, lam, mu, out, C, stream);
}

int hex8_apply_f32(const void* coords, const void* conn, const void* u,
                   const void* lam, const void* mu, void* out, long long C,
                   void* stream) {
    return launch_hex8<float>(coords, conn, u, lam, mu, out, C, stream);
}

int hex8_apply_f64(const void* coords, const void* conn, const void* u,
                   const void* lam, const void* mu, void* out, long long C,
                   void* stream) {
    return launch_hex8<double>(coords, conn, u, lam, mu, out, C, stream);
}

int tet10_apply_f32(const void* coords, const void* conn, const void* u,
                    const void* lam, const void* mu, const void* table,
                    void* out, long long C, void* stream) {
    return launch_tet10<float>(coords, conn, u, lam, mu, table, out, C,
                               stream);
}

int tet10_apply_f64(const void* coords, const void* conn, const void* u,
                    const void* lam, const void* mu, const void* table,
                    void* out, long long C, void* stream) {
    return launch_tet10<double>(coords, conn, u, lam, mu, table, out, C,
                                stream);
}

const char* element_apply_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
