// Matrix-free element applies for linear elasticity on Hopper (sm_90a).
//
// f_e = Ke(coords, lam, mu) @ u_e for every element, without forming Ke:
// coords [N,3], u [3N] and per-element lam, mu [C] in, element forces
// f_e [C,k,3] out.  The node scatter-sum stays outside, in the
// deterministic incidence gather-sum of ops/scatter.py.  The kernels are
// templated on float and double.
//
// All three are one kernel, tile_apply_kernel, over an element body
// (Tet4Body, Hex8Body, Tet10Body below):
// - gather: the wrapper lists each tile of consecutive elements' distinct
//   nodes once, sorted (ops/element_kernels.ElementTiles, built once per
//   conn), so a warp's copy reads neighbouring rows; elements address the
//   rows by int16 local ids;
// - overlap: persistent blocks in two cp.async stages: the next tile's
//   node rows, and the node list after it, arrive while this tile
//   computes;
// - stores: the forces are staged in shared memory in their output order
//   and leave as one contiguous run of 16-byte stores.
// Every time below is CUDA events over a replayed CUDA graph.
//
// tet4_apply  replaces _tet4_apply_kernel (topopteval_tpu/ops/pallas_kernels.py:137,
//             via _tet4_apply_call :159 and tet4_apply_pallas :196).
//             Constant strain, so the 1-point rule is exact: adjugate
//             geometry with the det == 0 -> 1 guard, V = det/6,
//             eps = sym grad u, sigma = lam tr(eps) I + 2 mu eps,
//             f = V sigma g.
//   Bound: memory.  Per element it reads 16 B of conn, 2 values of
//   lam/mu, and writes 12 values; its node rows come from arrays that
//   stay in the 50 MB L2.  The function needs 166 flops per element
//   (itemised in chip_smoke.py), far below the card's ~20 flop/B ridge:
//   at 153,600 tets 11.8 MB, 0.0035 ms at 3.35 TB/s (fp64 0.0063).
//   The earlier design (one thread per element, 256 a block, no shared
//   memory) gathered 24 scattered scalars an element and stored 12 at a
//   48-byte stride: 0.0199 ms fp32 and 0.0317 fp64 at 153,600 tets, 18
//   and 20 % of the bound, held by the L1/L2 transactions of its gather
//   and stores, not by device memory.
//   Design: one thread per element, tiles of 128 (64 when there would be
//   fewer than two tiles an SM); the arithmetic is the earlier kernel's,
//   expression for expression, so the forces keep their bits.  ptxas: 56
//   registers fp32, 72 fp64, no spills.
//   Result (NVIDIA H100 80GB HBM3 at 700 W, tools/kernel_ab.py, in turns
//   with the earlier design): 0.0055-0.0056 ms fp32 and 0.0086-0.0087
//   fp64 at 153,600 tets (3.6-3.8x, 63-64 % and 72-73 % of the bound),
//   0.036-0.037 and 0.063-0.066 at 1,228,800 (3.3-3.7x, 76-80 %),
//   0.0034-0.0035 and 0.0039-0.0040 at the 8,121-tet fixture (1.4x,
//   1.6x); bit for bit the earlier forces.  At 1,228,800
//   tets the stores are 42-49 % of the time (the forces are most of the
//   bytes), the gather 8-10 %, the arithmetic under 5 %.
//
// hex8_apply  replaces _hex8_apply_kernel (topopteval_tpu/ops/pallas_kernels.py:256,
//             via hex8_apply_pallas :288).  2x2x2 Gauss, all weights 1:
//             at each point J, its adjugate and det (the _inv3_scalars
//             :237 guard: a point of det 0 adds nothing), sigma, and
//             f += det sigma g.
//   Bound: memory.  Per element it reads 32 B of conn and 2 values of
//   lam/mu, writes 24 values, and shares ~1.2 node rows of coords and u:
//   ~164 B (fp32), so 4.2 MB at 25,600 hexes, 1.25 us at 3.35 TB/s
//   (fp64: 7.6 MB, 2.27 us).  The function needs 2,256 flops per element
//   when the reference gradients are sum-factorised over the two-point
//   rule (itemised in chip_smoke.py): 58 MFLOP, 0.86 us at 67 TFLOP/s
//   fp32 (1.70 us at 34 TFLOP/s fp64), below the bytes time.
//   The earlier design (one thread per element, 128 a block, the 8 points
//   in series, every g_k formed twice: ~5,000 flops an element) took
//   0.0157-0.0173 ms fp32 and 0.0206-0.0210 fp64 at 25,600 hexes, 7-11 %
//   of the bound: one long dependent chain per element on a card that
//   held ~6 warps an SM (1.1 at the 4,800-hex SIMP fixture).
//   Design: eight threads an element, one per Gauss point (Hex8Body):
//   du/dxi and the forces are sum-factorised butterflies across the eight
//   lanes, no g_k is formed; J is summed from the dN table as the plain
//   version sums it (float32 parity); tiles of 16 elements (128 threads;
//   8 when there would be fewer than two tiles an SM; tiles of 8 and 32
//   ran 12 % slower to 6 % faster).  ptxas: 56-64 registers fp32, 94
//   fp64, no spills.
//   Result (same card and harness): 0.0077-0.0079 ms fp32 and
//   0.0093-0.0102 fp64 at 25,600 hexes (2.0-2.2x, 16 % and 22-24 % of
//   the bound), 0.0035-0.0039 and 0.0040-0.0041 at the 4,800-hex SIMP
//   fixture (2.2-2.9x).  Its arithmetic holds it: without it the kernel
//   is 46-52 % faster at 25,600 hexes, without the stores or the
//   scattered gather 0-10 %.
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
//   Design: one thread per element.  du/dxi is a part common to the
//   four points plus one neighbour difference per point (the tet10
//   derivatives are linear in the barycentric coordinates), and the
//   forces are assembled the same way from four corner sums of
//   P = w det sigma J^-T: no g_k is formed.  J alone comes from the dN
//   table, summed over the nodes in order on absolute coordinates as the
//   plain version sums it: in float32 its rounding of J is then the
//   plain version's.  (J from node differences is the more exact, and
//   it differs from the plain version by 2e-5 of the largest force in
//   float32 on the scale-8 beam, past the 1e-5 parity tolerance.)  Tiles
//   of 64 elements (32 when there would be fewer than two tiles an SM).
//   On the scale-8 tet10 beam (H100 SXM at 700 W, tools/kernel_ab.py):
//   0.0165 ms fp32 and 0.0316 ms fp64, 56 % and 53 % of the bound; the
//   earlier four-threads-an-element design took 0.0407 and 0.0567.  In
//   fp32 the arithmetic holds it (~900 instructions an element), in fp64
//   (244 registers, 8 warps an SM) stores, arithmetic and gather alike.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

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

template <typename T> __device__ __forceinline__ T tet10_dn(int q, int k, int b);
template <> __device__ __forceinline__ float tet10_dn<float>(int q, int k, int b) {
    return c_tet10_dn_f32[q][k][b];
}
template <> __device__ __forceinline__ double tet10_dn<double>(int q, int k, int b) {
    return c_tet10_dn_f64[q][k][b];
}

// (1 +- 1/sqrt3) / 2: the 1-D linear shape functions at the two Gauss
// points, on the near and the far node, as NumPy rounds them
#define HEX_NEAR 0.7886751345948129
#define HEX_FAR 0.21132486540518708
// |dN_k/dxi_b| at a Gauss point, element_tables("hex8", 2) as NumPy rounds
// it: (1 +- 1/sqrt3)^2 / 8 and (1 - 1/3) / 8 by how many of the two other
// directions put node k on the point's side (2, 1 or 0)
#define HEX_DN_NEAR2 0.3110042339640731
#define HEX_DN_NEAR1 0.08333333333333331
#define HEX_DN_NEAR0 0.022329099369260218

// An element body of tile_apply_kernel: K nodes an element, TPE threads
// an element, tiles of TILE elements (SMALL_TILE where tiles of TILE would
// not give every SM two; ops/element_kernels.TILES names the same pairs).
// run() reads the element's node rows from the tile's tables in shared
// memory (row l of x at nx[l + a], l = 3 x the node's local id) and
// writes its 3K forces to f, value (k, a) at f[3k + a].

// Tet4, one thread an element.  The arithmetic is the earlier one-thread
// kernel's, expression for expression, so the forces keep its bits.
template <typename T>
struct Tet4Body {
    static constexpr int K = 4, TPE = 1, TILE = 128, SMALL_TILE = 64;
    struct Args {};
    __device__ __forceinline__ static void run(const T* __restrict__ nx,
                                               const T* __restrict__ nu,
                                               const int (&l)[K],
                                               T* __restrict__ f, int,
                                               const T lm, const T mu,
                                               const Args&) {
        T x[4][3], uu[4][3];
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
            for (int a = 0; a < 3; ++a) {
                x[k][a] = nx[l[k] + a];
                uu[k][a] = nu[l[k] + a];
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
        const T lam_tr = lm * (gu[0][0] + gu[1][1] + gu[2][2]);
        const T two_mu = T(2) * mu;
        T sig[3][3];
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
            for (int b = 0; b < 3; ++b)
                sig[a][b] = two_mu * (T(0.5) * (gu[a][b] + gu[b][a])) +
                            (a == b ? lam_tr : T(0));
        T o[12];
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
            for (int a = 0; a < 3; ++a)
                o[3 * k + a] = vol * (sig[a][0] * g[k][0] +
                                      sig[a][1] * g[k][1] +
                                      sig[a][2] * g[k][2]);
        // the element's 48 (fp64 96) bytes at a 16-byte aligned offset
        constexpr int VEC = 16 / sizeof(T);
        using V = typename std::conditional<VEC == 4, float4, double2>::type;
#pragma unroll
        for (int i = 0; i < 12 / VEC; ++i)
            reinterpret_cast<V*>(f)[i] = reinterpret_cast<const V*>(o)[i];
    }
};

template <typename T>
__device__ __forceinline__ T lane_xor(const T v, const int mask) {
    return __shfl_xor_sync(0xffffffffu, v, mask);
}

// Hex8, 2x2x2 Gauss (all weights 1), eight threads an element: thread q
// of the element's eight lanes computes Gauss point q (bit d of q the
// point's sign along reference direction d, QUADRATURE[("hex", 2)]
// order) and ends with the forces of the corner of the same signs, VTK
// node q ^ ((q >> 1) & 1).  du/dxi and the forces are sum-factorised over
// the two-point rule and run as butterflies across the eight lanes, one
// direction a stage: the node values to the point's gradients (the
// derivative along a direction is half the edge difference, the other
// two directions interpolate with the near and far weights), and the
// point values P = det sigma J^-T back onto the nodes (transposed).  No
// g_k = dN_k J^-1 is formed.  J alone is summed from the dN table over
// the nodes in order, on absolute coordinates, as the plain version forms
// it: in float32 its rounding of J is then the plain version's.  (J by
// the butterfly, from edge differences, is the more exact, and it
// differs from the float32 plain version by 1.2e-5 of the largest force
// on a distorted 25,600-hex box, past the 1e-5 parity tolerance.)  All
// eight lanes of an element take part in every exchange; a lane past the
// batch computes on node row 0 and its forces are not stored.
template <typename T>
struct Hex8Body {
    static constexpr int K = 8, TPE = 8, TILE = 16, SMALL_TILE = 8;
    struct Args {};

    // d/dxi_b of one node field at this lane's point, b = 0, 1, 2, from
    // the value v of this lane's node; hs[d] = +-1/2 by the sign along d
    __device__ __forceinline__ static void gradient(const T v, const T (&hs)[3],
                                                    T (&g)[3]) {
        const T n = T(HEX_NEAR), r = T(HEX_FAR);
        const T px = lane_xor(v, 1);
        const T ix = n * v + r * px, dx = hs[0] * (v - px);
        const T pix = lane_xor(ix, 2), pdx = lane_xor(dx, 2);
        const T ixy = n * ix + r * pix, ixdy = hs[1] * (ix - pix),
                dxiy = n * dx + r * pdx;
        const T pixy = lane_xor(ixy, 4), pixdy = lane_xor(ixdy, 4),
                pdxiy = lane_xor(dxiy, 4);
        g[0] = n * dxiy + r * pdxiy;
        g[1] = n * ixdy + r * pixdy;
        g[2] = hs[2] * (ixy - pixy);
    }

    __device__ __forceinline__ static void run(const T* __restrict__ nx,
                                               const T* __restrict__ nu,
                                               const int (&l)[K],
                                               T* __restrict__ f,
                                               const int q, const T lm,
                                               const T m, const Args&) {
        const int node = q ^ ((q >> 1) & 1);
        int own = l[0];
#pragma unroll
        for (int k = 1; k < 8; ++k)
            if (k == node) own = l[k];
        const int t[3] = {q & 1, (q >> 1) & 1, q >> 2};
        const T hs[3] = {t[0] ? T(0.5) : T(-0.5), t[1] ? T(0.5) : T(-0.5),
                         t[2] ? T(0.5) : T(-0.5)};
        // H[a][b] = du_a/dxi_b at the point
        T H[3][3];
#pragma unroll
        for (int a = 0; a < 3; ++a) gradient(nu[own + a], hs, H[a]);
        // J[a][b] = dx_a/dxi_b = sum_k x_k[a] dN_k(q)[b], k in order;
        // |dN_k(q)[b]| by the sides of node k's two other signs s1, s2
        // (mag), its sign node k's along b.  (A [3][2][2] array of the
        // twelve magnitudes made ptxas spill in float64.)
        auto mag = [&](const int b, const int s1, const int s2) -> T {
            const int near = (s1 == t[b == 0 ? 1 : 0])
                             + (s2 == t[b == 2 ? 1 : 2]);
            return near == 2 ? T(HEX_DN_NEAR2)
                 : near == 1 ? T(HEX_DN_NEAR1) : T(HEX_DN_NEAR0);
        };
        T J[3][3] = {};
#pragma unroll
        for (int k = 0; k < 8; ++k) {
            // VTK node k's signs along x, y, z (1 for +)
            const int sk[3] = {(k & 3) == 1 || (k & 3) == 2, (k & 3) >= 2,
                               k >= 4};
#pragma unroll
            for (int a = 0; a < 3; ++a) {
                const T xk = nx[l[k] + a];
#pragma unroll
                for (int b = 0; b < 3; ++b) {
                    const T m_ = mag(b, sk[b == 0 ? 1 : 0], sk[b == 2 ? 1 : 2]);
                    J[a][b] += xk * (sk[b] ? m_ : -m_);
                }
            }
        }
        // adjugate with the det == 0 guard: a zero det weighs the point by
        // det = 0, as the plain version's guard does (s = 0)
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
        const T s = det == T(0) ? T(0) : T(1) / det;
        // M = H adj = det grad u; S = sigma(M) / det = sigma(grad u)
        T M[3][3];
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
            for (int c = 0; c < 3; ++c)
                M[a][c] = H[a][0] * adj[0][c] + H[a][1] * adj[1][c] +
                          H[a][2] * adj[2][c];
        const T ls = lm * s * (M[0][0] + M[1][1] + M[2][2]);
        const T ms = m * s;
        const T S[3][3] = {
            {ls + T(2) * ms * M[0][0], ms * (M[0][1] + M[1][0]), ms * (M[0][2] + M[2][0])},
            {ms * (M[0][1] + M[1][0]), ls + T(2) * ms * M[1][1], ms * (M[1][2] + M[2][1])},
            {ms * (M[0][2] + M[2][0]), ms * (M[1][2] + M[2][1]), ls + T(2) * ms * M[2][2]}};
        // f_node[a] = sum_b (transposed butterfly of P[a][b]), P = S adj^T
        // = det sigma J^-T; directions b = 0 and 1 share the last stage
        const T n = T(HEX_NEAR), r = T(HEX_FAR);
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            T P[3];
#pragma unroll
            for (int b = 0; b < 3; ++b)
                P[b] = S[a][0] * adj[b][0] + S[a][1] * adj[b][1] +
                       S[a][2] * adj[b][2];
            const T q0 = lane_xor(P[0], 1), q1 = lane_xor(P[1], 1),
                    q2 = lane_xor(P[2], 1);
            const T x0 = hs[0] * (P[0] + q0), x1 = n * P[1] + r * q1,
                    x2 = n * P[2] + r * q2;
            const T r0 = lane_xor(x0, 2), r1 = lane_xor(x1, 2),
                    r2 = lane_xor(x2, 2);
            const T y01 = (n * x0 + r * r0) + hs[1] * (x1 + r1),
                    y2 = n * x2 + r * r2;
            const T s01 = lane_xor(y01, 4), s2 = lane_xor(y2, 4);
            f[3 * node + a] = (n * y01 + r * s01) + hs[2] * (y2 + s2);
        }
    }
};

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

// Tet10, one thread an element (tet10_element above).
template <typename T>
struct Tet10Body {
    static constexpr int K = 10, TPE = 1, TILE = 64, SMALL_TILE = 32;
    struct Args { T ca, cb, cd, w; };
    __device__ __forceinline__ static void run(const T* __restrict__ nx,
                                               const T* __restrict__ nu,
                                               const int (&l)[K],
                                               T* __restrict__ f, int,
                                               const T lm, const T m,
                                               const Args& r) {
        tet10_element<T>(nx, nu, l, f, lm, m, r.ca, r.cb, r.cd, r.w);
    }
};

// The element's K local ids, as K / 2 words of two int16 each: one 8- or
// 16-byte load where K / 2 is 2 or 4
template <int NW>
__device__ __forceinline__ void load_words(const unsigned* __restrict__ src,
                                           unsigned (&w)[NW]) {
    if constexpr (NW == 2) {
        const uint2 v = *reinterpret_cast<const uint2*>(src);
        w[0] = v.x; w[1] = v.y;
    } else if constexpr (NW == 4) {
        const uint4 v = *reinterpret_cast<const uint4*>(src);
        w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    } else {
#pragma unroll
        for (int i = 0; i < NW; ++i) w[i] = src[i];
    }
}

// Persistent blocks of TE elements (B::TPE threads each), walking tiles
// t = blockIdx.x, + gridDim.x, ... of TE elements.  Tile t's distinct
// nodes are tnodes[t][0, max_nodes) (sorted, -1 past the end); each
// element names its nodes by position in that list (lconn, int16).  Two
// stages: while the block computes tile t from one pair of shared node
// tables, cp.async fills the other pair with tile t + gridDim.x's node
// rows (thread j copies row j, so a warp copies ~32 neighbouring rows)
// and brings in the node list of the tile after it.  The forces are
// staged in their output order and stored as one contiguous run.
template <typename T, int TE, class B>
__global__ void __launch_bounds__(TE * B::TPE)
tile_apply_kernel(const T* __restrict__ coords, const int* __restrict__ tnodes,
                  const short* __restrict__ lconn, const T* __restrict__ u,
                  const T* __restrict__ lam, const T* __restrict__ mu,
                  T* __restrict__ out, int64_t C, int n_tiles, int max_nodes,
                  const typename B::Args args) {
    constexpr int K = B::K, NT = TE * B::TPE, NF = 3 * K;
    extern __shared__ __align__(16) unsigned char smem[];
    T* s_f = reinterpret_cast<T*>(smem);                 // [TE][3K]
    T* s_rows = s_f + NF * TE;                 // [2 stages][x, u][3 max_nodes]
    int* s_nid = reinterpret_cast<int*>(s_rows + 12 * max_nodes);  // [2][max]
    const int tid = threadIdx.x;
    const int e = tid / B::TPE, sub = tid % B::TPE;  // element, its thread
    const int stride = gridDim.x;
    const int nv = 3 * max_nodes;

    // cp.async of tile tt's node rows into stage st from node ids ids[]
    auto issue_rows = [&](int tt, int st, const int* ids) {
        if (tt >= n_tiles) return;
        T* sx = s_rows + 2 * st * nv;
        T* su = sx + nv;
        for (int j = tid; j < max_nodes; j += NT) {
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
        for (int j = tid; j < max_nodes; j += NT)
            cp_async(s_nid + st * max_nodes + j, src + j, 4);
    };
    // this thread's element of tile tt: local ids (K / 2 words of 2), lam,
    // mu; past the batch, node 0 of the tile and no material
    unsigned lw[K / 2];
    T lm, m;
    auto load_element = [&](int tt) {
        const int64_t c = (int64_t)tt * TE + e;
        if (tt < n_tiles && c < C) {
            load_words<K / 2>(reinterpret_cast<const unsigned*>(lconn)
                              + (K / 2) * c, lw);
            lm = lam[c];
            m = mu[c];
        } else {
#pragma unroll
            for (int i = 0; i < K / 2; ++i) lw[i] = 0;
            lm = m = T(0);
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
        // an element of several threads computes past the batch too: its
        // lanes exchange values, and its forces are not stored
        if (B::TPE > 1 || e < ne) {
            int l[K];
#pragma unroll
            for (int k = 0; k < K / 2; ++k) {
                l[2 * k] = 3 * (int)(short)(lw[k] & 0xffffu);
                l[2 * k + 1] = 3 * (int)(short)(lw[k] >> 16);
            }
            const T* sx = s_rows + 2 * st * nv;
            B::run(sx, sx + nv, l, s_f + NF * e, sub, lm, m, args);
        }
        load_element(t + stride);
        __syncthreads();
        // f_e [ne, K, 3] is one contiguous run of 3K ne values, in shared
        // memory as in device memory: 16-byte loads and stores
        constexpr int VEC = 16 / sizeof(T);
        const int nval = NF * ne, nvec = nval / VEC;
        using V = typename std::conditional<VEC == 4, float4, double2>::type;
        V* __restrict__ o = reinterpret_cast<V*>(out + NF * c0);
        const V* s_v = reinterpret_cast<const V*>(s_f);
        for (int v = tid; v < nvec; v += NT) o[v] = s_v[v];
        for (int idx = VEC * nvec + tid; idx < nval; idx += NT)
            out[NF * c0 + idx] = s_f[idx];
    }
    cp_async_wait_all();
}

constexpr int MAX_DEVICES = 64;

template <typename T, int TE, class B>
int launch_tiles(const void* coords, const void* tnodes, const void* lconn,
                 const void* u, const void* lam, const void* mu, void* out,
                 long long C, int max_nodes, const typename B::Args& args,
                 cudaStream_t stream) {
    // a function's attributes and the card's figures are per device: the
    // launch sets them up once on each card it runs on (the current one)
    static int sms[MAX_DEVICES] = {};
    static bool attr[MAX_DEVICES] = {};
    static size_t last_smem[MAX_DEVICES] = {};
    static int per_sm[MAX_DEVICES] = {};
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidValue;
    if (sms[dev] == 0)
        cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                               dev);
    if (!attr[dev]) {   // up to 227 KB of shared memory (K TE distinct nodes)
        cudaFuncSetAttribute(tile_apply_kernel<T, TE, B>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             227 * 1024);
        attr[dev] = true;
    }
    const int n_tiles = (int)((C + TE - 1) / TE);
    const size_t smem = (3 * B::K * TE + 12 * (size_t)max_nodes) * sizeof(T)
                        + 2 * (size_t)max_nodes * sizeof(int);
    if (smem != last_smem[dev]) {
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm[dev], tile_apply_kernel<T, TE, B>, TE * B::TPE, smem);
        last_smem[dev] = smem;
    }
    if (per_sm[dev] < 1) return (int)cudaErrorInvalidValue;
    const int grid = (int)std::min<long long>(n_tiles,
                                              (long long)per_sm[dev] * sms[dev]);
    tile_apply_kernel<T, TE, B><<<grid, TE * B::TPE, smem, stream>>>(
        (const T*)coords, (const int*)tnodes, (const short*)lconn, (const T*)u,
        (const T*)lam, (const T*)mu, (T*)out, (int64_t)C, n_tiles, max_nodes,
        args);
    return 0;
}

// The launch at tile TILE or SMALL_TILE (any other is refused)
template <typename T, class B>
int launch_apply(const void* coords, const void* tnodes, const void* lconn,
                 const void* u, const void* lam, const void* mu, void* out,
                 long long C, int tile, int max_nodes,
                 const typename B::Args& args, void* stream) {
    if (C <= 0) return 0;
    int err = (int)cudaErrorInvalidValue;
    if (tile == B::TILE)
        err = launch_tiles<T, B::TILE, B>(coords, tnodes, lconn, u, lam, mu,
                                          out, C, max_nodes, args,
                                          (cudaStream_t)stream);
    else if (tile == B::SMALL_TILE)
        err = launch_tiles<T, B::SMALL_TILE, B>(coords, tnodes, lconn, u, lam,
                                                mu, out, C, max_nodes, args,
                                                (cudaStream_t)stream);
    return err ? err : (int)cudaGetLastError();
}

template <typename T>
typename Tet10Body<T>::Args tet10_args(double a, double b, double w) {
    return {T(4.0 * a - 1.0), T(4.0 * a), T(4.0 * (b - a)), T(w)};
}

}  // namespace

// Plain C interface, bound with ctypes in ops/element_kernels.py.  Every
// pointer is a device pointer.  Each entry point returns
// cudaGetLastError() after its launch.  All three take their conn as the
// per-tile node lists and int16 local ids of
// ops/element_kernels.ElementTiles (tile the body's TILE or SMALL_TILE);
// tet10_apply also takes the rule's a, b and w by value.
extern "C" {

#define TILE_APPLY_ENTRY(name, T, Body)                                       \
    int name(const void* coords, const void* tnodes, const void* lconn,       \
             const void* u, const void* lam, const void* mu, void* out,       \
             long long C, int tile, int max_nodes, void* stream) {            \
        return launch_apply<T, Body<T>>(coords, tnodes, lconn, u, lam, mu,    \
                                        out, C, tile, max_nodes, {}, stream); \
    }

TILE_APPLY_ENTRY(tet4_apply_f32, float, Tet4Body)
TILE_APPLY_ENTRY(tet4_apply_f64, double, Tet4Body)
TILE_APPLY_ENTRY(hex8_apply_f32, float, Hex8Body)
TILE_APPLY_ENTRY(hex8_apply_f64, double, Hex8Body)
#undef TILE_APPLY_ENTRY

int tet10_apply_f32(const void* coords, const void* tnodes, const void* lconn,
                    const void* u, const void* lam, const void* mu, void* out,
                    long long C, int tile, int max_nodes, double a, double b,
                    double w, void* stream) {
    return launch_apply<float, Tet10Body<float>>(
        coords, tnodes, lconn, u, lam, mu, out, C, tile, max_nodes,
        tet10_args<float>(a, b, w), stream);
}

int tet10_apply_f64(const void* coords, const void* tnodes, const void* lconn,
                    const void* u, const void* lam, const void* mu, void* out,
                    long long C, int tile, int max_nodes, double a, double b,
                    double w, void* stream) {
    return launch_apply<double, Tet10Body<double>>(
        coords, tnodes, lconn, u, lam, mu, out, C, tile, max_nodes,
        tet10_args<double>(a, b, w), stream);
}

const char* element_apply_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
