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
// sym_ke<K, NQ, E>  replaces _make_iso_ke_kernel (pallas_kernels.py:381)
//          and _make_iso_ke_kernel_stream (:425), via _iso_ke :509,
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
//   3,600 B fp32) against ~20-30 B of node rows, conn and material.  At
//   153,600 tet10 elements: 553 MB of Ke, 0.165 ms.  The arithmetic is
//   not far behind in float64: the least formulation (chip_smoke.py) is
//   18,264 flops a hex8, 0.014 ms at 34 TFLOP/s for the 25,600-hex box
//   against 0.036 of bytes.
//   Design: the trap the TPU kernel hit is register pressure: one thread
//   per element would keep 9k^2 = 900 (tet10) accumulators live.  A block
//   takes E elements; phase 1 puts every point's J^-1 and w det into
//   shared memory, phase 2 every point's physical gradients
//   g [NQ][K][3]; phase 3 gives one thread each (element, node pair
//   i <= j): E k(k+1)/2 threads (hex8 288 at E 8).  Per point it forms
//   lw g_i and mw g_i once and adds two multiply-adds an entry and the
//   mu g_i . g_j term on the diagonal, sums its 3x3 block over the points
//   in 9 registers, and writes the block and its transpose at (j, i) (a
//   diagonal block its upper triangle twice) into the block's Ke in
//   shared memory, so Ke is exactly symmetric; the block then stores its
//   contiguous run of E Ke with 16-byte coalesced stores.
//   The earlier kernel (every pair i, j, five operations an entry and the
//   pair's dot product, 256 threads for 8 elements, each block written
//   from registers at a stride of 3) took 0.01325 ms float32 and 0.01793
//   float64 for hex8 at the SIMP Hex8 fixture (4,800 hexes; 27 / 39 % of
//   the bound) and 0.299 / 0.662 for tet10 at 153,600 elements (NVIDIA
//   H100 80GB HBM3 at 700 W, PERF.md); in float64 its pair sums, not its
//   stores, held it.  This one takes 0.0090 / 0.0151 and 0.223 / 0.396
//   in turns with it (tools/kernel_ab.py).

// tet4_ke_cse, tet4_ke_lanes  replace make_variant over _tet4_ke_kernel_cse
//          (:27) and _tet4_ke_kernel_stack (:48) of tools/tpu_ke_probe.py:71,
//          the TPU probe of two formulations of tet4_ke's function.  Both
//          compute B6's Ke in the probe's layout: from pre-gathered element
//          coordinates ct [12, Cp] (row 3k+a holds node k's coordinate a of
//          every element), lam2 [1, Cp] and mu2 [1, Cp] they write
//          out [144, Cp], entry-major: out[((3i+a)*12 + 3j+b) * Cp + c].
//          Cp is a multiple of the elements per block E (128, 256 or 512,
//          the template argument standing for the probe's block of 512 /
//          1024 / 2048 lanes), so no block is ragged.
//   Bound: memory, as B6: 14 values read and 144 written per element, 632
//   B fp32; at 1,228,800 tets 776.6 MB, 0.232 ms at 3.35 TB/s (0.464 fp64).
//   cse design: B6's two phases, with the common subexpressions of the
//     probe's cse variant moved into phase 1.  Phase 1 (one thread per
//     element) puts lam V g [4][3], mu V g [4][3], g [4][3] and the table
//     mu V g_i . g_j [4][4] into shared memory, element-minor so that a
//     warp reads 32 consecutive words; phase 2 writes the block's
//     144 x E tile row by row, consecutive threads on consecutive elements
//     of one entry row (coalesced stores), at 2 multiplies and 1-2 adds an
//     entry against B6's ~7.  The tile's 52 E values take 26.6 KB (fp32,
//     E = 128) to 213 KB (fp64, E = 512) of dynamic shared memory, set
//     above 48 KB with cudaFuncSetAttribute.
//   lanes design (the probe's "stack": one stacked [144, block] store):
//     one thread per element keeps g, lam V g and mu V g in registers and
//     writes its 144 values down the entry rows; for each entry all the
//     threads of a warp store 32 consecutive elements, so every store is
//     coalesced with no shared-memory tile at all.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int TET4_KE_ELEMS = 128;
constexpr int TET4_KE_THREADS = 256;
// elements a sym_ke block takes: hex8 in float32 and float64, tet10
constexpr int HEX_KE_ELEMS_F32 = 8, HEX_KE_ELEMS_F64 = 4;
constexpr int TET10_KE_ELEMS = 4;

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

// The node pair (i, j), i <= j, of pair index p = 0 .. K(K+1)/2 - 1, row
// by row: (0, 0), (0, 1), ..., (0, K-1), (1, 1), ...
template <int K>
__device__ __forceinline__ void node_pair(int p, int& i, int& j) {
    i = 0;
    while (p >= K - i) {
        p -= K - i;
        ++i;
    }
    j = i + p;
}

template <typename T, int K, int NQ, int E>
__global__ void __launch_bounds__(E * K * (K + 1) / 2)
sym_ke_kernel(const T* __restrict__ coords, const int* __restrict__ conn,
              const T* __restrict__ lam, const T* __restrict__ mu,
              const T* __restrict__ table, T* __restrict__ out, int64_t C) {
    constexpr int EK = 3 * K, KE = EK * EK, NP = K * (K + 1) / 2;
    constexpr int NTH = E * NP;
    // 16-byte vectors of T, for the coalesced store of the block's Ke
    using V = typename std::conditional<sizeof(T) == 4, float4, double2>::type;
    constexpr int VT = 16 / sizeof(T);
    extern __shared__ __align__(16) unsigned char sym_ke_smem[];
    T* s_ke = reinterpret_cast<T*>(sym_ke_smem);  // [E][KE]
    T* next = s_ke + E * KE;
    auto take = [&](int n) { T* p = next; next += n; return p; };
    auto s_g = reinterpret_cast<T (*)[NQ][K][3]>(take(E * NQ * K * 3));
    auto s_inv = reinterpret_cast<T (*)[NQ][3][3]>(take(E * NQ * 9));
    auto s_x = reinterpret_cast<T (*)[K][3]>(take(E * K * 3));
    auto s_dn = reinterpret_cast<T (*)[K][3]>(take(NQ * K * 3));
    T* s_w = take(NQ);
    auto s_lw = reinterpret_cast<T (*)[NQ]>(take(E * NQ));
    auto s_mw = reinterpret_cast<T (*)[NQ]>(take(E * NQ));
    const int64_t c0 = (int64_t)blockIdx.x * E;
    const int ne = (int)(C - c0 < E ? C - c0 : E);
    const int tid = threadIdx.x;
    for (int t = tid; t < NQ * K * 3; t += NTH) (&s_dn[0][0][0])[t] = table[t];
    for (int t = tid; t < NQ; t += NTH) s_w[t] = table[NQ * K * 3 + t];
    for (int t = tid; t < ne * K; t += NTH) {
        const int e = t / K, k = t - K * e;
        const int64_t n = conn[(c0 + e) * K + k];
#pragma unroll
        for (int a = 0; a < 3; ++a) s_x[e][k][a] = coords[3 * n + a];
    }
    __syncthreads();
    // phase 1: J, J^-1 and the weights at each (element, point)
    for (int t = tid; t < ne * NQ; t += NTH) {
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
    for (int t = tid; t < ne * NQ * K; t += NTH) {
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
    // phase 3: one thread per (element, node pair i <= j), its 3x3 block
    // summed over the points from lw g_i, mw g_i (two multiply-adds an
    // entry, the mu g_i . g_j term on the diagonal); block (i, j) and its
    // transpose at (j, i)
    if (tid < ne * NP) {
        const int e = tid / NP;
        int i, j;
        node_pair<K>(tid - NP * e, i, j);
        T acc[3][3];
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
            for (int b = 0; b < 3; ++b) acc[a][b] = T(0);
#pragma unroll 2
        for (int q = 0; q < NQ; ++q) {
            const T* gi = s_g[e][q][i];
            const T lw = s_lw[e][q], mw = s_mw[e][q];
            T li[3], mi[3], gj[3];
#pragma unroll
            for (int a = 0; a < 3; ++a) {
                li[a] = lw * gi[a];
                mi[a] = mw * gi[a];
                gj[a] = s_g[e][q][j][a];
            }
            const T d = mi[0] * gj[0] + mi[1] * gj[1] + mi[2] * gj[2];
#pragma unroll
            for (int a = 0; a < 3; ++a) {
#pragma unroll
                for (int b = 0; b < 3; ++b) {
                    acc[a][b] += li[a] * gj[b];
                    acc[a][b] += mi[b] * gj[a];
                }
                acc[a][a] += d;
            }
        }
        // a diagonal block (i == j) takes its upper triangle for both
        // halves: its (a, b) and (b, a) sums round apart
        T* o = s_ke + e * KE;
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
            for (int b = 0; b < 3; ++b) {
                const T v = (i == j && b < a) ? acc[b][a] : acc[a][b];
                o[(3 * i + a) * EK + 3 * j + b] = v;
                if (i != j) o[(3 * j + b) * EK + 3 * i + a] = v;
            }
    }
    __syncthreads();
    // the block's run of ne Ke, 16 bytes a thread and store
    const V* src = reinterpret_cast<const V*>(s_ke);
    V* dst = reinterpret_cast<V*>(out + c0 * KE);
    for (int t = tid; t < ne * KE / VT; t += NTH) dst[t] = src[t];
}

// Shared memory of a sym_ke block: E Ke, then g, J^-1, the node rows,
// the rule's table and the weights.
template <typename T, int K, int NQ, int E>
constexpr size_t sym_ke_smem() {
    return sizeof(T) * ((size_t)E * 9 * K * K + E * NQ * K * 3 + E * NQ * 9 +
                        E * K * 3 + NQ * K * 3 + NQ + 2 * E * NQ);
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

// Geometry of one tet from its 12 coordinates (node-major x0,y0,z0,x1,...):
// g[i][a] = dN_i/dx_a and V = det/6, with the det == 0 -> 1 guard, in the
// order of _tet4_geometry (topopteval_tpu/ops/pallas_kernels.py:40).
template <typename T>
__device__ __forceinline__ void tet4_geometry(const T (&x)[12], T (&g)[4][3],
                                              T& vol) {
    T e[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int a = 0; a < 3; ++a) e[i][a] = x[3 * (i + 1) + a] - x[a];
    const T c0 = e[1][1] * e[2][2] - e[1][2] * e[2][1];
    const T c1 = e[1][2] * e[2][0] - e[1][0] * e[2][2];
    const T c2 = e[1][0] * e[2][1] - e[1][1] * e[2][0];
    const T det = e[0][0] * c0 + e[0][1] * c1 + e[0][2] * c2;
    const T inv_det = T(1) / (det == T(0) ? T(1) : det);
    const T adj[3][3] = {
        {c0, e[0][2] * e[2][1] - e[0][1] * e[2][2],
         e[0][1] * e[1][2] - e[0][2] * e[1][1]},
        {c1, e[0][0] * e[2][2] - e[0][2] * e[2][0],
         e[0][2] * e[1][0] - e[0][0] * e[1][2]},
        {c2, e[0][1] * e[2][0] - e[0][0] * e[2][1],
         e[0][0] * e[1][1] - e[0][1] * e[1][0]}};
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int a = 0; a < 3; ++a) g[i + 1][a] = adj[a][i] * inv_det;
#pragma unroll
    for (int a = 0; a < 3; ++a) g[0][a] = -(g[1][a] + g[2][a] + g[3][a]);
    vol = det / T(6);
}

template <typename T, int E>
__device__ __forceinline__ void load_lanes(const T* __restrict__ ct,
                                           const T* __restrict__ lam2,
                                           const T* __restrict__ mu2,
                                           int64_t Cp, int64_t c, T (&g)[4][3],
                                           T& lv, T& mv) {
    T x[12];
#pragma unroll
    for (int r = 0; r < 12; ++r) x[r] = ct[r * Cp + c];
    T vol;
    tet4_geometry(x, g, vol);
    lv = lam2[c] * vol;
    mv = mu2[c] * vol;
}

// Shared tile of tet4_ke_cse, element-minor: [52][E] values per block
constexpr int KE_CSE_THREADS = 256;
constexpr int KE_CSE_ROWS = 52;     // lam V g 12, mu V g 12, g 12, table 16

template <typename T, int E>
__global__ void __launch_bounds__(KE_CSE_THREADS)
tet4_ke_cse_kernel(const T* __restrict__ ct, const T* __restrict__ lam2,
                   const T* __restrict__ mu2, T* __restrict__ out,
                   int64_t Cp) {
    extern __shared__ __align__(16) unsigned char ke_cse_smem[];
    T* s = reinterpret_cast<T*>(ke_cse_smem);
    T* s_lg = s;                   // [12][E]  lam V g_ia
    T* s_mg = s + 12 * E;          // [12][E]  mu V g_ia
    T* s_g = s + 24 * E;           // [12][E]  g_ia
    T* s_md = s + 36 * E;          // [16][E]  mu V g_i . g_j
    const int64_t c0 = (int64_t)blockIdx.x * E;
    for (int e = threadIdx.x; e < E; e += KE_CSE_THREADS) {
        T g[4][3], lv, mv;
        load_lanes<T, E>(ct, lam2, mu2, Cp, c0 + e, g, lv, mv);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int a = 0; a < 3; ++a) {
                s_lg[(3 * i + a) * E + e] = lv * g[i][a];
                s_mg[(3 * i + a) * E + e] = mv * g[i][a];
                s_g[(3 * i + a) * E + e] = g[i][a];
            }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
                s_md[(4 * i + j) * E + e] =
                    mv * g[i][0] * g[j][0] + mv * g[i][1] * g[j][1] +
                    mv * g[i][2] * g[j][2];
    }
    __syncthreads();
    // entry row r = (3i+a)*12 + 3j+b; E is a multiple of the warp, so a
    // warp's 32 entries share r (and a == b) and cover 32 elements
    for (int idx = threadIdx.x; idx < 144 * E; idx += KE_CSE_THREADS) {
        const int r = idx / E, e = idx - r * E;
        const int row = r / 12, col = r - 12 * row;
        const int i = row / 3, a = row - 3 * i;
        const int j = col / 3, b = col - 3 * j;
        T v = s_lg[row * E + e] * s_g[(3 * j + b) * E + e] +
              s_mg[(3 * i + b) * E + e] * s_g[(3 * j + a) * E + e];
        if (a == b) v += s_md[(4 * i + j) * E + e];
        out[r * Cp + c0 + e] = v;
    }
}

template <typename T, int E>
__global__ void __launch_bounds__(E)
tet4_ke_lanes_kernel(const T* __restrict__ ct, const T* __restrict__ lam2,
                     const T* __restrict__ mu2, T* __restrict__ out,
                     int64_t Cp) {
    const int64_t c = (int64_t)blockIdx.x * E + threadIdx.x;
    T g[4][3], lv, mv;
    load_lanes<T, E>(ct, lam2, mu2, Cp, c, g, lv, mv);
    T lg[4][3], mg[4][3];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            lg[i][a] = lv * g[i][a];
            mg[i][a] = mv * g[i][a];
        }
    T* o = out + c;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const T md = mg[i][0] * g[j][0] + mg[i][1] * g[j][1] +
                         mg[i][2] * g[j][2];
#pragma unroll
            for (int a = 0; a < 3; ++a)
#pragma unroll
                for (int b = 0; b < 3; ++b) {
                    T v = lg[i][a] * g[j][b] + mg[i][b] * g[j][a];
                    if (a == b) v += md;
                    o[((3 * i + a) * 12 + 3 * j + b) * Cp] = v;
                }
        }
}

constexpr int MAX_DEVICES = 64;

// cudaFuncSetAttribute for a dynamic tile above 48 KB; an error if the
// card's opt-in limit is smaller than the tile
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    int dev = 0, limit = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&limit,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    if (bytes > (size_t)limit) return cudaErrorInvalidConfiguration;
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)bytes);
}

template <typename T, int K, int NQ, int E>
int launch_sym_ke(const void* coords, const void* conn, const void* lam,
                  const void* mu, const void* table, void* out, long long C,
                  void* stream) {
    constexpr size_t bytes = sym_ke_smem<T, K, NQ, E>();
    // the attribute is per device: set once on each card that launches
    static bool ready[MAX_DEVICES] = {};
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidValue;
    if (!ready[dev]) {
        const cudaError_t err = allow_smem(sym_ke_kernel<T, K, NQ, E>, bytes);
        if (err != cudaSuccess) return (int)err;
        ready[dev] = true;
    }
    if (C > 0) {
        const long long blocks = (C + E - 1) / E;
        sym_ke_kernel<T, K, NQ, E><<<(unsigned)blocks, E * K * (K + 1) / 2,
                                     bytes, (cudaStream_t)stream>>>(
            (const T*)coords, (const int*)conn, (const T*)lam, (const T*)mu,
            (const T*)table, (T*)out, (int64_t)C);
    }
    return (int)cudaGetLastError();
}

template <typename T, int E>
int launch_tet4_ke_t1(bool cse, const void* ct, const void* lam2,
                      const void* mu2, void* out, long long Cp, void* stream) {
    if (Cp <= 0) return 0;
    if (Cp % E != 0) return (int)cudaErrorInvalidValue;
    const unsigned blocks = (unsigned)(Cp / E);
    if (cse) {
        const size_t bytes = (size_t)KE_CSE_ROWS * E * sizeof(T);
        const cudaError_t err = allow_smem(tet4_ke_cse_kernel<T, E>, bytes);
        if (err != cudaSuccess) return (int)err;
        tet4_ke_cse_kernel<T, E><<<blocks, KE_CSE_THREADS, bytes,
                                   (cudaStream_t)stream>>>(
            (const T*)ct, (const T*)lam2, (const T*)mu2, (T*)out,
            (int64_t)Cp);
    } else {
        tet4_ke_lanes_kernel<T, E><<<blocks, E, 0, (cudaStream_t)stream>>>(
            (const T*)ct, (const T*)lam2, (const T*)mu2, (T*)out,
            (int64_t)Cp);
    }
    return (int)cudaGetLastError();
}

template <typename T>
int dispatch_tet4_ke_t1(bool cse, const void* ct, const void* lam2,
                        const void* mu2, void* out, long long Cp, int E,
                        void* stream) {
    switch (E) {
        case 128:
            return launch_tet4_ke_t1<T, 128>(cse, ct, lam2, mu2, out, Cp,
                                             stream);
        case 256:
            return launch_tet4_ke_t1<T, 256>(cse, ct, lam2, mu2, out, Cp,
                                             stream);
        case 512:
            return launch_tet4_ke_t1<T, 512>(cse, ct, lam2, mu2, out, Cp,
                                             stream);
        default:
            return (int)cudaErrorInvalidValue;
    }
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
    return launch_sym_ke<float, 8, 8, HEX_KE_ELEMS_F32>(coords, conn, lam, mu,
                                                        table, out, C, stream);
}

int hex8_ke_f64(const void* coords, const void* conn, const void* lam,
                const void* mu, const void* table, void* out, long long C,
                void* stream) {
    return launch_sym_ke<double, 8, 8, HEX_KE_ELEMS_F64>(coords, conn, lam, mu,
                                                         table, out, C, stream);
}

int tet10_ke_f32(const void* coords, const void* conn, const void* lam,
                 const void* mu, const void* table, void* out, long long C,
                 void* stream) {
    return launch_sym_ke<float, 10, 4, TET10_KE_ELEMS>(coords, conn, lam, mu,
                                                       table, out, C, stream);
}

int tet10_ke_f64(const void* coords, const void* conn, const void* lam,
                 const void* mu, const void* table, void* out, long long C,
                 void* stream) {
    return launch_sym_ke<double, 10, 4, TET10_KE_ELEMS>(coords, conn, lam, mu,
                                                        table, out, C, stream);
}

// The probe variants (T1): ct [12, Cp], lam2 [1, Cp], mu2 [1, Cp] ->
// out [144, Cp]; E (128, 256 or 512) elements per block divides Cp.
#define KE_T1_ENTRY(NAME, T, CSE)                                              \
    int NAME(const void* ct, const void* lam2, const void* mu2, void* out,     \
             long long Cp, int E, void* stream) {                              \
        return dispatch_tet4_ke_t1<T>(CSE, ct, lam2, mu2, out, Cp, E, stream); \
    }

KE_T1_ENTRY(tet4_ke_cse_f32, float, true)
KE_T1_ENTRY(tet4_ke_cse_f64, double, true)
KE_T1_ENTRY(tet4_ke_lanes_f32, float, false)
KE_T1_ENTRY(tet4_ke_lanes_f64, double, false)

#undef KE_T1_ENTRY

const char* element_ke_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
