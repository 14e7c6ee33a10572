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
// addresses, so a warp reads a slot's columns and values of 32 rows as
// one coalesced 128-byte run and gathers u by address.
//
// bell_window: the kernel of sell_window below over a body of 3x3 blocks
//   (Block: a slot's nine values sit in nine planes S*128 apart; each is
//   a coalesced 128-byte run of 32 rows in float).  W from S and the row
//   count (ops/ell.window_warps): the fewest warps that fill the card
//   with one wave (32 warps an SM) or leave a warp at most 8 slots; 4 at
//   the Galerkin route's level 1 (36,297 rows, S 72: 18 slots a warp), 16
//   at its level 2 (5,225 rows: 164 groups of 32 rows on 132 SMs).  Warp
//   w issues the column loads of a batch of 8 slots, then their gathers
//   of u (three components), then the nine values of each slot as it
//   sums them.
//   Bound: memory.  The real blocks' columns and values are read once, u
//   once, out written once; 18 flops a block do not bind.  Level 1:
//   0.0256 / 0.0486 ms float / double at 3.35 TB/s (0.0315 / 0.0603 on
//   every slot: 58.4 of its 72 slots a row are real).
//   The earlier design (one thread a row, 128 a block, its S slots in
//   order: a column load, the gather that needs it, then nine values, 72
//   times in series) took 0.0736 ms float at level 1 (35 % of the bound,
//   1.9x slower than B4 on the same matrix) and 0.0674 at level 2 (41
//   blocks on 132 SMs): latency-bound.  At W = 1 (S <= 8) the kernel
//   still runs that loop and gives its bits; at W > 1 the sum runs in
//   warp order, so float results differ from the earlier kernel's and
//   from the plain version's in the last bits.  Result, timed in turns
//   with the earlier design (tools/kernel_ab.py, same card, cold in L2):
//   level 1 0.0740 -> 0.0406 ms float, 0.0952 -> 0.0769 double (63 % of
//   the bound; W = 8 0.0498, W = 2 0.0471), B4 on the same blocks
//   0.0379; level 2 0.0676 -> 0.0095 float (W = 8 0.0139), 0.0787 ->
//   0.0187 double (W = 8 0.0162: 79 registers leave one 512-thread block
//   an SM).  Nearly all of it is the value planes: without their loads
//   level 1 takes 0.0078 ms.  A pad slot (zero values
//   after a row's last real column) is read like a real one: telling it
//   apart needs the previous slot's column, and a row may hold one
//   column twice.

// sell_window: W warps a block of 32 consecutive rows of a tile (one row
//   a lane); warp w takes slots w, w + W, w + 2W, ... of the 32 rows and
//   keeps SLOTS = 8 of them in flight: their 8 column loads, then their 8
//   gathers of u, then the products in slot order.  The W partial sums of
//   a row meet in shared memory and are added in warp order 0..W-1, so
//   the order of the sum is fixed by S and W alone and the result repeats
//   bit for bit; for W > 1 it is not the serial slot order of the plain
//   version and of the earlier design, so float32 results differ from
//   both in the last bits.  W comes from S (ops/ell.sell_warps): enough
//   warps that each holds at most 8 slots, up to 8 (the restriction, S
//   48: 8; the prolongation, S 8: 1, which runs the earlier kernel's
//   one-thread-a-row loop in slot order and keeps its bits).
//   Bound: memory.  A transfer's real weights and their columns are read
//   once, u once, out written once (6 flops a weight do not bind): the
//   scale-16 Galerkin restriction (36,297 rows, S 48, 1.24 M weights)
//   0.0039 / 0.0063 ms float / double, 0.0051 / 0.0081 on every padded
//   slot.
//   The earlier design (one thread a row, 128 a block, the S slots in one
//   loop: a column load, then the gather that needs it, 48 times in
//   series) took 0.0286 / 0.0275 ms cold on the restriction (14 / 23 % of
//   the bound, 1.75x slower than the CSR kernel B5 on the same matrix):
//   latency-bound, about 9 warps an SM each waiting on 48 round trips.
//   Result (NVIDIA H100 80GB HBM3 at 700 W, tools/kernel_ab.py in turns
//   with the earlier design, inputs cold in L2; PERF.md): the restriction
//   0.0108 / 0.0162 ms (2.6x / 1.7x, 36 / 39 % of the bound), now faster
//   than B5 (0.0160 / 0.0249); W = 4 within 10 % of W = 8 either way, W =
//   2 20 % and W = 1 2x slower.  The prolongation (W = 1) keeps the
//   earlier kernel's loop and its bits: 0.0091 / 0.0116 ms.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 128;
constexpr int ROWS = 32;        // rows of a group (one a lane)
constexpr int SLOTS = 8;        // slots a warp keeps in flight

// What one slot holds and how it adds into the row's three sums (x, y,
// z: the gathered u[:, c]); v points at the slot's first value, the
// others plane apart.
//   Block: a 3x3 block in nine planes, out[a] += sum_b v[3a+b] u[b]
//   Weight: one weight, out[a] += w u[a]
struct Block {
    static constexpr int NV = 9;
    template <typename T>
    __device__ __forceinline__ static void add(const T* __restrict__ v,
                                               int64_t plane, T x, T y, T z,
                                               T& a0, T& a1, T& a2) {
        a0 += v[0] * x + v[plane] * y + v[2 * plane] * z;
        a1 += v[3 * plane] * x + v[4 * plane] * y + v[5 * plane] * z;
        a2 += v[6 * plane] * x + v[7 * plane] * y + v[8 * plane] * z;
    }
};

struct Weight {
    static constexpr int NV = 1;
    template <typename T>
    __device__ __forceinline__ static void add(const T* __restrict__ v,
                                               int64_t, T x, T y, T z,
                                               T& a0, T& a1, T& a2) {
        const T w = v[0];
        a0 += w * x;
        a1 += w * y;
        a2 += w * z;
    }
};

// W warps for each group of 32 rows (one row a lane), G = 4 / W groups a
// block (one when W >= 4); warp w of a group sums slots w, w + W, ... of
// its lane's row, SLOTS of them in flight at a time (their column loads,
// then their gathers, then the body's values and sums); the W partial
// sums of a row meet in shared memory and are added in warp order.  W =
// 1 is the one-thread-a-row loop: the slots in order, one column load
// and its gather at a time (as many rows in flight as the SM holds
// threads).
template <int W>
__host__ __device__ constexpr int groups() { return W >= 4 ? 1 : 4 / W; }

template <typename T, typename B, int W>
__global__ void __launch_bounds__(W * 32 * groups<W>())
window_kernel(const int* __restrict__ cols2, const T* __restrict__ vals,
              const int* __restrict__ wblk, const T* __restrict__ u,
              T* __restrict__ out, int S, int kc, int n_rows, int n_cols,
              int64_t u_cs, int64_t u_ns, int64_t o_cs, int64_t o_ns) {
    constexpr int G = groups<W>();
    const int warp = (threadIdx.x >> 5) % W, group = (threadIdx.x >> 5) / W;
    const int lane = threadIdx.x & 31;
    const int r0 = (blockIdx.x * G + group) * ROWS;
    const int t = r0 / LANES;
    const int n = r0 + lane;
    // groups past the last row (the last block's) read nothing
    const bool live = r0 < n_rows;
    const int64_t lo = live ? (int64_t)wblk[t] * LANES : 0;
    const int64_t end = lo + (int64_t)kc * LANES;
    const int64_t hi = end < (int64_t)n_cols ? end : (int64_t)n_cols;
    // slot s of this row sits at [t*S + s][r0 % 128 + lane], value plane p
    // of a block at [(9t + p)*S + s][r0 % 128 + lane]
    const int64_t plane = (int64_t)S * LANES;
    const int* __restrict__ c_t = cols2 + t * plane + (r0 % LANES) + lane;
    const T* __restrict__ v_t = vals + t * B::NV * plane + (r0 % LANES) + lane;
    T a0 = T(0), a1 = T(0), a2 = T(0);
    if (W == 1) {
        if (n >= n_rows) return;
        for (int s = 0; s < S; ++s) {
            const int64_t c = c_t[(int64_t)s * LANES];
            T x = T(0), y = T(0), z = T(0);
            if (c >= lo && c < hi) {
                const T* __restrict__ uc = u + c * u_ns;
                x = uc[0];
                y = uc[u_cs];
                z = uc[2 * u_cs];
            }
            B::add(v_t + (int64_t)s * LANES, plane, x, y, z, a0, a1, a2);
        }
        T* __restrict__ o = out + (int64_t)n * o_ns;
        o[0] = a0;
        o[o_cs] = a1;
        o[2 * o_cs] = a2;
        return;
    }
    for (int s0 = warp; live && s0 < S; s0 += W * SLOTS) {
        int64_t c[SLOTS];
#pragma unroll
        for (int k = 0; k < SLOTS; ++k) {
            const int s = s0 + k * W;
            c[k] = s < S ? (int64_t)c_t[(int64_t)s * LANES] : (int64_t)-1;
        }
        T x[SLOTS][3];
#pragma unroll
        for (int k = 0; k < SLOTS; ++k) {
            const bool in = c[k] >= lo && c[k] < hi;
            const T* __restrict__ uc = u + (in ? c[k] : 0) * u_ns;
            x[k][0] = in ? uc[0] : T(0);
            x[k][1] = in ? uc[u_cs] : T(0);
            x[k][2] = in ? uc[2 * u_cs] : T(0);
        }
#pragma unroll
        for (int k = 0; k < SLOTS; ++k) {
            const int s = s0 + k * W;
            if (s < S)
                B::add(v_t + (int64_t)s * LANES, plane, x[k][0], x[k][1],
                       x[k][2], a0, a1, a2);
        }
    }
    __shared__ T part[G][W][3][ROWS];
    part[group][warp][0][lane] = a0;
    part[group][warp][1][lane] = a1;
    part[group][warp][2][lane] = a2;
    __syncthreads();
    // warp w adds components w, w + W, ... of its group's 32 rows, warps
    // in order
    if (n < n_rows) {
        for (int a = warp; a < 3; a += W) {
            T sum = part[group][0][a][lane];
#pragma unroll
            for (int v = 1; v < W; ++v) sum += part[group][v][a][lane];
            out[(int64_t)n * o_ns + a * o_cs] = sum;
        }
    }
}

template <typename T, typename B, int W>
void launch_w(const void* cols2, const void* vals, const void* wblk,
              const void* u, void* out, int S, int kc, int n_rows, int n_cols,
              long long u_cs, long long u_ns, long long o_cs, long long o_ns,
              cudaStream_t stream) {
    constexpr int rows = ROWS * groups<W>();
    const unsigned blocks = (unsigned)((n_rows + rows - 1) / rows);
    window_kernel<T, B, W><<<blocks, W * 32 * groups<W>(), 0, stream>>>(
        (const int*)cols2, (const T*)vals, (const int*)wblk, (const T*)u,
        (T*)out, S, kc, n_rows, n_cols, u_cs, u_ns, o_cs, o_ns);
}

template <typename T, typename B>
int launch(const void* cols2, const void* vals, const void* wblk,
           const void* u, void* out, int S, int kc, int n_tiles, int n_rows,
           int n_cols, long long u_cs, long long u_ns, long long o_cs,
           long long o_ns, int warps, void* stream) {
    if (n_rows <= 0) return 0;
    if (S <= 0 || kc <= 0 || n_rows > n_tiles * LANES)
        return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
#define WINDOW_WARPS(W)                                                      \
    case W:                                                                  \
        launch_w<T, B, W>(cols2, vals, wblk, u, out, S, kc, n_rows, n_cols,  \
                          u_cs, u_ns, o_cs, o_ns, st);                       \
        break;
    switch (warps) {
        WINDOW_WARPS(1)
        WINDOW_WARPS(2)
        WINDOW_WARPS(4)
        WINDOW_WARPS(8)
        WINDOW_WARPS(16)
        default: return (int)cudaErrorInvalidValue;
    }
#undef WINDOW_WARPS
    return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, bound with ctypes in ops/ell.py.  All pointers are
// device pointers.  Each entry point returns cudaGetLastError() after its
// launch, 0 when n_rows is 0 (nothing launched).  Both take their warps
// for every 32 rows (1, 2, 4, 8 or 16; ops/ell.sell_warps) last before
// the stream.
extern "C" {

int bell_window_f32(const void* cols2, const void* vals, const void* wblk,
                    const void* u, void* out, int S, int kc, int n_tiles,
                    int n_rows, int n_cols, long long u_cs, long long u_ns,
                    long long o_cs, long long o_ns, int warps, void* stream) {
    return launch<float, Block>(cols2, vals, wblk, u, out, S, kc, n_tiles,
                                n_rows, n_cols, u_cs, u_ns, o_cs, o_ns, warps,
                                stream);
}

int bell_window_f64(const void* cols2, const void* vals, const void* wblk,
                    const void* u, void* out, int S, int kc, int n_tiles,
                    int n_rows, int n_cols, long long u_cs, long long u_ns,
                    long long o_cs, long long o_ns, int warps, void* stream) {
    return launch<double, Block>(cols2, vals, wblk, u, out, S, kc, n_tiles,
                                 n_rows, n_cols, u_cs, u_ns, o_cs, o_ns, warps,
                                 stream);
}

int sell_window_f32(const void* cols2, const void* w2, const void* wblk,
                    const void* u, void* out, int S, int kc, int n_tiles,
                    int n_rows, int n_cols, long long u_cs, long long u_ns,
                    long long o_cs, long long o_ns, int warps, void* stream) {
    return launch<float, Weight>(cols2, w2, wblk, u, out, S, kc, n_tiles,
                                 n_rows, n_cols, u_cs, u_ns, o_cs, o_ns, warps,
                                 stream);
}

int sell_window_f64(const void* cols2, const void* w2, const void* wblk,
                    const void* u, void* out, int S, int kc, int n_tiles,
                    int n_rows, int n_cols, long long u_cs, long long u_ns,
                    long long o_cs, long long o_ns, int warps, void* stream) {
    return launch<double, Weight>(cols2, w2, wblk, u, out, S, kc, n_tiles,
                                  n_rows, n_cols, u_cs, u_ns, o_cs, o_ns,
                                  warps, stream);
}

const char* ell_apply_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
