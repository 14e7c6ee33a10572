// Matrix-free element applies for linear elasticity on Hopper (sm_90a).
//
// f_e = Ke(coords, lam, mu) @ u_e for every element, without forming Ke.
// One thread per element gathers the node rows of coords [N,3] and u [3N]
// named by conn [C,k] (int32) and writes its element forces f_e [C,k,3].
// The node scatter-sum stays outside, in the deterministic incidence
// gather-sum of ops/scatter.py.  The kernels are templated on float and
// double.
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
//             Isoparametric with the symmetric 4-point order-2 rule (point
//             q at barycentric L_q = b, L_i = a): at each point J, its
//             adjugate and det, sigma, and f += w det sigma g.  J varies
//             from point to point (mid-edge nodes may be curved), so
//             nothing is taken as constant.  A point with det == 0 adds
//             nothing, as in the plain version (its guard divides by 1 and
//             weighs by w det = 0).
//   Bound: memory.  Per element it reads 40 B of conn and 2 values of
//   lam/mu and writes 30 values, and shares ~1.4 node rows of coords and
//   u: ~200 B (fp32), so ~31 MB at 153,600 elements, 0.0093 ms at 3.35
//   TB/s (fp64 0.0168 ms).  The function needs 1,122 flops per element
//   (itemised in chip_smoke.py): 0.0026 ms at 67 TFLOP/s fp32, 0.0051 ms
//   at 34 TFLOP/s fp64, both under the byte time.
//   The earlier design (four threads an element, one per point, 32
//   elements a block) took 0.0407 ms fp32 and 0.0567 ms fp64 on the
//   scale-8 tet10 beam, 23 % and 30 % of the bound (H100 SXM at 700 W,
//   tools/kernel_ab.py).  Its ablations there: without the force loop
//   48 % / 44 % faster, without the force stores 25 % / 16 %, with the
//   gather on rows 0-9 14 % / 20 %.  Its arithmetic held it first (about
//   4,000 flops an element: J from the table, every g_k formed twice, 60
//   shuffles and ~150 shared loads a thread), then its (k & 3) == q store
//   pattern, then a gather that nothing overlapped.
//   Design:
//   - arithmetic: one thread per element.  du/dxi is a part common to the
//     four points plus one neighbour difference per point (the tet10
//     derivatives are linear in the barycentric coordinates), and the
//     forces are assembled the same way from four corner sums of
//     P = w det sigma J^-T: no g_k is formed.  J alone comes from the dN
//     table, summed over the nodes in order on absolute coordinates as the
//     plain version sums it: in float32 its rounding of J is then the
//     plain version's.  (J from node differences is the more exact, and
//     it differs from the plain version by 2e-5 of the largest force in
//     float32 on the scale-8 beam, past the 1e-5 parity tolerance.)
//   - gather: the wrapper lists each tile's distinct nodes once, sorted
//     (ops/element_kernels.Tet10Tiles, built once per conn: a tile of 64
//     elements names 3.3 times fewer rows than its conn), so a warp's copy
//     reads neighbouring rows; elements address them by int16 local ids.
//   - overlap: persistent blocks in two cp.async stages: the next tile's
//     node rows, and the node list after it, arrive while this tile
//     computes.
//   - stores: the forces are staged in shared memory in their output
//     order and leave as one contiguous run of 16-byte stores.
//   Tiles of 64 elements (32 when there would be fewer than two tiles an
//   SM).  ptxas: 128 registers fp32, 244 fp64, no spills.
//   Result (same beam and harness): 0.0165 ms fp32 and 0.0316 ms fp64,
//   56 % and 53 % of the bound, 2.46x and 1.78x the earlier design.  What
//   holds it now, by its ablations (tools/kernel_ab.py): in fp32 the
//   arithmetic (33 % of the time: ~900 instructions an element, issue-
//   bound at 16 warps an SM), then the gather (12 %) and the stores (8 %);
//   in fp64 the stores (28 %), the arithmetic and the gather (22 % each):
//   at 244 registers an SM holds 8 warps, too few to overlap the stages.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

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

// dN/dxi of the 10 tet10 shape functions at the 4 points of the order-2
// rule, element_tables("tet10", 2) of ops/elements.py as NumPy rounds it
// (the CPU tests compare this table with it entry for entry)
#define TET10_DN_TABLE {                                                    \
    {                                                                       \
        {-1.3416407864998736, -1.3416407864998736, -1.3416407864998736},    \
        {-0.447213595499958, -0.0, -0.0},                                   \
        {-0.0, -0.447213595499958, -0.0},                                   \
        {-0.0, -0.0, -0.447213595499958},                                   \
        {1.7888543819998315, -0.552786404500042, -0.552786404500042},       \
        {0.552786404500042, 0.552786404500042, 0.0},                        \
        {-0.552786404500042, 1.7888543819998315, -0.552786404500042},       \
        {-0.552786404500042, -0.552786404500042, 1.7888543819998315},       \
        {0.552786404500042, 0.0, 0.552786404500042},                        \
        {0.0, 0.552786404500042, 0.552786404500042}                         \
    },                                                                      \
    {                                                                       \
        {0.4472135954999582, 0.4472135954999582, 0.4472135954999582},       \
        {1.341640786499874, 0.0, 0.0},                                      \
        {-0.0, -0.447213595499958, -0.0},                                   \
        {-0.0, -0.0, -0.447213595499958},                                   \
        {-1.7888543819998324, -2.341640786499874, -2.341640786499874},      \
        {0.552786404500042, 2.341640786499874, 0.0},                        \
        {-0.552786404500042, -2.220446049250313e-16, -0.552786404500042},   \
        {-0.552786404500042, -0.552786404500042, -2.220446049250313e-16},   \
        {0.552786404500042, 0.0, 2.341640786499874},                        \
        {0.0, 0.552786404500042, 0.552786404500042}                         \
    },                                                                      \
    {                                                                       \
        {0.4472135954999582, 0.4472135954999582, 0.4472135954999582},       \
        {-0.447213595499958, -0.0, -0.0},                                   \
        {0.0, 1.341640786499874, 0.0},                                      \
        {-0.0, -0.0, -0.447213595499958},                                   \
        {-2.220446049250313e-16, -0.552786404500042, -0.552786404500042},   \
        {2.341640786499874, 0.552786404500042, 0.0},                        \
        {-2.341640786499874, -1.7888543819998324, -2.341640786499874},      \
        {-0.552786404500042, -0.552786404500042, -2.220446049250313e-16},   \
        {0.552786404500042, 0.0, 0.552786404500042},                        \
        {0.0, 0.552786404500042, 2.341640786499874}                         \
    },                                                                      \
    {                                                                       \
        {0.4472135954999583, 0.4472135954999583, 0.4472135954999583},       \
        {-0.447213595499958, -0.0, -0.0},                                   \
        {-0.0, -0.447213595499958, -0.0},                                   \
        {0.0, 0.0, 1.341640786499874},                                      \
        {-3.3306690738754696e-16, -0.552786404500042, -0.552786404500042},  \
        {0.552786404500042, 0.552786404500042, 0.0},                        \
        {-0.552786404500042, -3.3306690738754696e-16, -0.552786404500042},  \
        {-2.341640786499874, -2.341640786499874, -1.7888543819998324},      \
        {2.341640786499874, 0.0, 0.552786404500042},                        \
        {0.0, 2.341640786499874, 0.552786404500042}                         \
    }                                                                       \
}

__constant__ double c_tet10_dn_f64[4][10][3] = TET10_DN_TABLE;
__constant__ float c_tet10_dn_f32[4][10][3] = TET10_DN_TABLE;

template <typename T> __device__ __forceinline__ T hex_dn(int q, int k, int b);
template <> __device__ __forceinline__ float hex_dn<float>(int q, int k, int b) {
    return c_hex_dn_f32[q][k][b];
}
template <> __device__ __forceinline__ double hex_dn<double>(int q, int k, int b) {
    return c_hex_dn_f64[q][k][b];
}
template <typename T> __device__ __forceinline__ T tet10_dn(int q, int k, int b);
template <> __device__ __forceinline__ float tet10_dn<float>(int q, int k, int b) {
    return c_tet10_dn_f32[q][k][b];
}
template <> __device__ __forceinline__ double tet10_dn<double>(int q, int k, int b) {
    return c_tet10_dn_f64[q][k][b];
}

constexpr int TET4_THREADS = 256;
constexpr int HEX8_THREADS = 128;

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

// Node of tet10 in the barycentric derivative of point q: corner i where
// i == q, else the mid-edge node of edge {i, q} (VTK order: (0,1) 4,
// (1,2) 5, (0,2) 6, (0,3) 7, (1,3) 8, (2,3) 9).
__host__ __device__ constexpr int tet10_node(int i, int q) {
    return i == q ? i
         : (i + q == 1) ? 4
         : (i * q == 2) ? 5
         : (i + q == 2) ? 6
         : (i * q == 0) ? 7
         : (i + q == 4) ? 8 : 9;
}

// f_e of one element.  Its node rows sit in the tile's node tables in
// shared memory, row l of x at nx[l + a] (l = 3 x the node's local id),
// and are read into registers first; the forces go to the element's 30
// values of f, value (k, a) at f[3k + a].  ca = 4a - 1, cb = 4a,
// cd = 4(b - a) for the rule's barycentric values a (three coordinates)
// and b (the fourth).
template <typename T>
__device__ __forceinline__ void tet10_element(const T* __restrict__ nx,
                                              const T* __restrict__ nu,
                                              const int (&l)[10],
                                              T* __restrict__ f,
                                              const T lm, const T m,
                                              const T ca, const T cb,
                                              const T cd, const T w) {
    T xr[10][3], ur[10][3];
#pragma unroll
    for (int k = 0; k < 10; ++k)
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            xr[k][a] = nx[l[k] + a];
            ur[k][a] = nu[l[k] + a];
        }
#define X_(k, a) xr[k][a]
#define U_(k, a) ur[k][a]
    // Du[b][a] = D_b: the part of column b of du/dxi common to the four
    // points, (4a-1)(u_{b+1} - u_0) + 4a (S_{b+1} - S_0), S_i the sum of
    // the mid-edge nodes at corner i; differences of neighbours first
    T Du[3][3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        const T u0 = U_(0, a), u4 = U_(4, a), u5 = U_(5, a), u6 = U_(6, a),
                u7 = U_(7, a), u8 = U_(8, a), u9 = U_(9, a);
        Du[0][a] = ca * (U_(1, a) - u0) + cb * ((u5 - u6) + (u8 - u7));
        Du[1][a] = ca * (U_(2, a) - u0) + cb * ((u5 - u4) + (u9 - u7));
        Du[2][a] = ca * (U_(3, a) - u0) + cb * ((u8 - u4) + (u9 - u6));
    }
    // T_i = sum_q Q_i(q); Rc_i = cd Q_i(i); Re_n = cd (Q_i(j) + Q_j(i)) for
    // the mid-edge node n of edge {i, j}
    T Ts[4][3], Rc[4][3], Re[6][3];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int a = 0; a < 3; ++a) Ts[i][a] = T(0);
#pragma unroll
    for (int n = 0; n < 6; ++n)
#pragma unroll
        for (int a = 0; a < 3; ++a) Re[n][a] = T(0);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        // J[a][b] = sum_k x_k[a] dN_k(q)[b] from the table, k in order,
        // as the plain version forms it: on absolute coordinates its
        // rounding is the plain version's, which float32 parity needs
        T J[3][3];
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
            for (int b = 0; b < 3; ++b) {
                T acc = T(0);
#pragma unroll
                for (int k = 0; k < 10; ++k)
                    acc += X_(k, a) * tet10_dn<T>(q, k, b);
                J[a][b] = acc;
            }
        // adjugate (inverse times det) with the det == 0 -> 1 guard: a
        // zero det gives w det = 0, so the point adds nothing (s = 0)
        const T A = J[1][1] * J[2][2] - J[1][2] * J[2][1];
        const T B = J[0][2] * J[2][1] - J[0][1] * J[2][2];
        const T Cc = J[0][1] * J[1][2] - J[0][2] * J[1][1];
        const T det = J[0][0] * A + J[1][0] * B + J[2][0] * Cc;
        const T adj[3][3] = {
            {A, B, Cc},
            {J[1][2] * J[2][0] - J[1][0] * J[2][2],
             J[0][0] * J[2][2] - J[0][2] * J[2][0],
             J[0][2] * J[1][0] - J[0][0] * J[1][2]},
            {J[1][0] * J[2][1] - J[1][1] * J[2][0],
             J[0][1] * J[2][0] - J[0][0] * J[2][1],
             J[0][0] * J[1][1] - J[0][1] * J[1][0]}};
        const T s = det == T(0) ? T(0) : w / det;
        // H = du/dxi: the common part and one neighbour difference,
        // H[a][b] = Du[b][a] + cd (u_{n(b+1,q)} - u_{n(0,q)})[a];
        // M = H adj = det grad u
        T H[3][3];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            const T o = U_(tet10_node(0, q), a);
#pragma unroll
            for (int b = 0; b < 3; ++b)
                H[a][b] = Du[b][a] + cd * (U_(tet10_node(b + 1, q), a) - o);
        }
        T M[3][3];
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
            for (int c = 0; c < 3; ++c)
                M[a][c] = H[a][0] * adj[0][c] + H[a][1] * adj[1][c] +
                          H[a][2] * adj[2][c];
        // S = (w / det) sigma(M) = w det sigma(grad u) / det^2
        const T ls = lm * s * (M[0][0] + M[1][1] + M[2][2]);
        const T ms = m * s;
        const T S[3][3] = {
            {ls + T(2) * ms * M[0][0], ms * (M[0][1] + M[1][0]), ms * (M[0][2] + M[2][0])},
            {ms * (M[0][1] + M[1][0]), ls + T(2) * ms * M[1][1], ms * (M[1][2] + M[2][1])},
            {ms * (M[0][2] + M[2][0]), ms * (M[1][2] + M[2][1]), ls + T(2) * ms * M[2][2]}};
        // P = S adj^T = w det sigma J^-T; Q_{b+1} = P[:, b],
        // Q_0 = -(P[:, 0] + P[:, 1] + P[:, 2])
        T Q[4][3];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
#pragma unroll
            for (int b = 0; b < 3; ++b)
                Q[b + 1][a] = S[a][0] * adj[b][0] + S[a][1] * adj[b][1] +
                              S[a][2] * adj[b][2];
            Q[0][a] = -(Q[1][a] + Q[2][a] + Q[3][a]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int a = 0; a < 3; ++a) {
                Ts[i][a] += Q[i][a];
                if (i == q) Rc[i][a] = cd * Q[i][a];
                else Re[tet10_node(i, q) - 4][a] += cd * Q[i][a];
            }
    }
    // f_i = (4a-1) T_i + Rc_i; f_n = 4a (T_i + T_j) + Re_n, n on edge {i, j}
#define F_(k, a) f[3 * (k) + (a)]
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
        for (int i = 0; i < 4; ++i) F_(i, a) = ca * Ts[i][a] + Rc[i][a];
        F_(4, a) = cb * (Ts[0][a] + Ts[1][a]) + Re[0][a];
        F_(5, a) = cb * (Ts[1][a] + Ts[2][a]) + Re[1][a];
        F_(6, a) = cb * (Ts[0][a] + Ts[2][a]) + Re[2][a];
        F_(7, a) = cb * (Ts[0][a] + Ts[3][a]) + Re[3][a];
        F_(8, a) = cb * (Ts[1][a] + Ts[3][a]) + Re[4][a];
        F_(9, a) = cb * (Ts[2][a] + Ts[3][a]) + Re[5][a];
    }
#undef F_
#undef X_
#undef U_
}

__device__ __forceinline__ void cp_async(void* smem, const void* gmem,
                                         const int bytes) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(smem);
    if (bytes == 8)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                     "l"(gmem));
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                     "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Persistent blocks of TE threads, one thread per element, walking tiles
// t = blockIdx.x, + gridDim.x, ... of TE elements.  Tile t's distinct
// nodes are tnodes[t][0, max_nodes) (sorted, -1 past the end); each
// element names its nodes by position in that list (lconn, int16).  Two
// stages: while the block computes tile t from one pair of shared node
// tables, cp.async fills the other pair with tile t + gridDim.x's node
// rows (thread j copies row j, so a warp copies ~32 neighbouring rows)
// and brings in the node list of the tile after it.  The forces are
// staged in their output order and stored as one contiguous run.
template <typename T, int TE>
__global__ void __launch_bounds__(TE)
tet10_apply_kernel(const T* __restrict__ coords, const int* __restrict__ tnodes,
                   const short* __restrict__ lconn, const T* __restrict__ u,
                   const T* __restrict__ lam, const T* __restrict__ mu,
                   T* __restrict__ out, int64_t C, int n_tiles, int max_nodes,
                   const T ca, const T cb, const T cd, const T w) {
    extern __shared__ __align__(16) unsigned char smem[];
    T* s_f = reinterpret_cast<T*>(smem);                 // [TE][30]
    T* s_rows = s_f + 30 * TE;                 // [2 stages][x, u][3 max_nodes]
    int* s_nid = reinterpret_cast<int*>(s_rows + 12 * max_nodes);  // [2][max]
    const int tid = threadIdx.x;
    const int stride = gridDim.x;
    const int nv = 3 * max_nodes;

    // cp.async of tile tt's node rows into stage st from node ids ids[]
    auto issue_rows = [&](int tt, int st, const int* ids) {
        if (tt >= n_tiles) return;
        T* sx = s_rows + 2 * st * nv;
        T* su = sx + nv;
        for (int j = tid; j < max_nodes; j += TE) {
            const int n = ids[j];
            if (n < 0) continue;
#pragma unroll
            for (int a = 0; a < 3; ++a) {
                cp_async(sx + 3 * j + a, coords + 3 * (int64_t)n + a, sizeof(T));
                cp_async(su + 3 * j + a, u + 3 * (int64_t)n + a, sizeof(T));
            }
        }
    };
    auto issue_ids = [&](int tt, int st) {
        if (tt >= n_tiles) return;
        const int* src = tnodes + (int64_t)tt * max_nodes;
        for (int j = tid; j < max_nodes; j += TE)
            cp_async(s_nid + st * max_nodes + j, src + j, 4);
    };
    // this thread's element of tile tt: local ids (5 words of 2), lam, mu
    unsigned lw[5] = {0, 0, 0, 0, 0};
    T lm = T(0), m = T(0);
    auto load_element = [&](int tt) {
        const int64_t c = (int64_t)tt * TE + tid;
        if (tt < n_tiles && c < C) {
            const unsigned* src = reinterpret_cast<const unsigned*>(lconn) + 5 * c;
#pragma unroll
            for (int i = 0; i < 5; ++i) lw[i] = src[i];
            lm = lam[c];
            m = mu[c];
        }
    };

    int t = blockIdx.x;
    {   // prologue: tile t's rows from its node list read directly, and the
        // node list of the next tile
        const int* ids = tnodes + (int64_t)t * max_nodes;
        issue_rows(t, 0, ids);
        issue_ids(t + stride, 1);
        cp_async_commit();
        load_element(t);
    }
    for (int i = 0; t < n_tiles; ++i, t += stride) {
        const int st = i & 1;
        cp_async_wait_all();
        __syncthreads();
        // stage 2: the next tile's rows and the node list after it
        issue_rows(t + stride, st ^ 1, s_nid + (st ^ 1) * max_nodes);
        issue_ids(t + 2 * stride, st);
        cp_async_commit();
        const int64_t c0 = (int64_t)t * TE;
        const int ne = (int)(C - c0 < TE ? C - c0 : TE);
        if (tid < ne) {
            int l[10];
#pragma unroll
            for (int k = 0; k < 5; ++k) {
                l[2 * k] = 3 * (int)(short)(lw[k] & 0xffffu);
                l[2 * k + 1] = 3 * (int)(short)(lw[k] >> 16);
            }
            const T* sx = s_rows + 2 * st * nv;
            tet10_element<T>(sx, sx + nv, l, s_f + 30 * tid, lm, m, ca, cb, cd,
                             w);
        }
        load_element(t + stride);
        __syncthreads();
        // f_e [ne, 10, 3] is one contiguous run of 30 ne values, in shared
        // memory as in device memory: 16-byte loads and stores
        constexpr int VEC = 16 / sizeof(T);
        const int nval = 30 * ne, nvec = nval / VEC;
        using V = typename std::conditional<VEC == 4, float4, double2>::type;
        V* __restrict__ o = reinterpret_cast<V*>(out + 30 * c0);
        const V* s_v = reinterpret_cast<const V*>(s_f);
        for (int v = tid; v < nvec; v += TE) o[v] = s_v[v];
        for (int idx = VEC * nvec + tid; idx < nval; idx += TE)
            out[30 * c0 + idx] = s_f[idx];
    }
    cp_async_wait_all();
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

template <typename T, int TE>
int launch_tet10_tiles(const void* coords, const void* tnodes,
                       const void* lconn, const void* u, const void* lam,
                       const void* mu, void* out, long long C, int max_nodes,
                       double a, double b, double w, cudaStream_t stream) {
    static int sms = 0;
    static bool attr = false;
    if (sms == 0) {
        int dev = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (!attr) {    // up to 227 KB of shared memory (10 TE distinct nodes)
        cudaFuncSetAttribute(tet10_apply_kernel<T, TE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             227 * 1024);
        attr = true;
    }
    const int n_tiles = (int)((C + TE - 1) / TE);
    const size_t smem = (30 * TE + 12 * (size_t)max_nodes) * sizeof(T)
                        + 2 * (size_t)max_nodes * sizeof(int);
    static size_t last_smem = 0;
    static int per_sm = 0;
    if (smem != last_smem) {
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, tet10_apply_kernel<T, TE>, TE, smem);
        last_smem = smem;
    }
    if (per_sm < 1) return (int)cudaErrorInvalidValue;
    const int grid = (int)std::min<long long>(n_tiles, (long long)per_sm * sms);
    tet10_apply_kernel<T, TE><<<grid, TE, smem, stream>>>(
        (const T*)coords, (const int*)tnodes, (const short*)lconn, (const T*)u,
        (const T*)lam, (const T*)mu, (T*)out, (int64_t)C, n_tiles, max_nodes,
        T(4.0 * a - 1.0), T(4.0 * a), T(4.0 * (b - a)), T(w));
    return 0;
}

template <typename T>
int launch_tet10(const void* coords, const void* tnodes, const void* lconn,
                 const void* u, const void* lam, const void* mu, void* out,
                 long long C, int tile, int max_nodes, double a, double b,
                 double w, void* stream) {
    if (C <= 0) return 0;
    int err = (int)cudaErrorInvalidValue;
    if (tile == 32)
        err = launch_tet10_tiles<T, 32>(coords, tnodes, lconn, u, lam, mu, out,
                                        C, max_nodes, a, b, w,
                                        (cudaStream_t)stream);
    else if (tile == 64)
        err = launch_tet10_tiles<T, 64>(coords, tnodes, lconn, u, lam, mu, out,
                                        C, max_nodes, a, b, w,
                                        (cudaStream_t)stream);
    return err ? err : (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, bound with ctypes in ops/element_kernels.py.  Every
// pointer is a device pointer; conn must be 16-byte aligned.  Each entry
// point returns cudaGetLastError() after its launch.  tet10_apply takes
// its conn as the per-tile node lists and int16 local ids of
// ops/element_kernels.Tet10Tiles (tile 32 or 64), and the rule's a, b and
// w by value.
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

int tet10_apply_f32(const void* coords, const void* tnodes, const void* lconn,
                    const void* u, const void* lam, const void* mu, void* out,
                    long long C, int tile, int max_nodes, double a, double b,
                    double w, void* stream) {
    return launch_tet10<float>(coords, tnodes, lconn, u, lam, mu, out, C, tile,
                               max_nodes, a, b, w, stream);
}

int tet10_apply_f64(const void* coords, const void* tnodes, const void* lconn,
                    const void* u, const void* lam, const void* mu, void* out,
                    long long C, int tile, int max_nodes, double a, double b,
                    double w, void* stream) {
    return launch_tet10<double>(coords, tnodes, lconn, u, lam, mu, out, C, tile,
                                max_nodes, a, b, w, stream);
}

const char* element_apply_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
