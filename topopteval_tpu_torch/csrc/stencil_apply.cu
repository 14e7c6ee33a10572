// Fused stencil matvec on structured boxes of 6-tet hexes, for Hopper (sm_90a).
//
// y = K_raw u on an (nx, ny, nz)-cell box.  The flat DOF vector is numbered
// dof = ((z*NY + y)*NX + x)*3 + a over the (NZ, NY, NX) = (nz+1, ny+1, nx+1)
// node lattice.  For every node n = (z, y, x) and component a
//
//   y[n,a] = sum over the <= 8 cells c touching n, n being corner j of c:
//            esc[c] * sum_k sum_b Ke[3j+a, 3k+b] * (u[node_k(c), b] - u[n, b])
//
// with Ke the assembled 24x24 stiffness of the hex's six tets (VTK
// corner-major, k*3+b) and esc the per-hex scale grid [nz, ny, nx] (a null
// pointer means 1).  The two kernels compute this function in one form,
// through the hex's six tets, and sum every node in one fixed order: each
// repeats its output bit for bit, and they give the same bits.
//
// stencil_plane   replaces _stencil_kernel (topopteval_tpu/ops/pallas_stencil.py:156,
//                 via _stencil_matvec :219 and stencil_matvec :338), which
//                 produced one output z-plane per grid step from lane rolls
//                 and a period-3 coefficient table.
//   Form: cell by cell through the six tets.  On a box each tet of the
//   split (grid._TET_SPLIT) is a path 0 -> P1 -> P2 -> 6 along the three
//   axes in some order, so its displacement gradient has the path's three
//   edges over their lengths as columns: the cell forms its twelve edge
//   differences once, then per tet sigma = lt tr(H) I + mt (H + H^T) (lt,
//   mt: esc times vol*lam, vol*mu), s_k = sigma e_k / h_k, and the vertex
//   forces -s_0, s_0 - s_1, s_1 - s_2, s_2 (vol sigma g_i).  The level's
//   table is 1/dx, 1/dy, 1/dz, vol*lam, vol*mu (ops/stencil.cell_table);
//   the differences keep float32 accurate, as u_k - u_n did for Ke.
//   Data flow: a block computes a CX x CY tile of cells (one thread a
//   cell) for the (CX-1) x (CY-1) nodes after its first column and row,
//   marching a chunk of zn node planes along z: it first stages every
//   node plane the chunk reads by cp.async (one wait on device memory a
//   block), then for each cell layer writes the cells' bottom and top face
//   forces to shared memory, and each node sums corners 0-3 of layer z in
//   order plus the sum of corners 4-7 of layer z - 1, kept in registers.
//   The chunk (stencil_plane_chunk) spreads the blocks over the SMs; the
//   tile and chunk fix no order, so every chunk gives the same bits.
//   Bound: memory.  It reads u once and esc once and writes y once: at
//   200x64x16 cells, 2 * 666,315 * 4 B (+ 204,800 * 4 B of esc) = 5.3 MB
//   (6.2), 1.59 us (1.84) at 3.35 TB/s in float32, 3.18 us (3.67) in
//   float64.  The least arithmetic is about 372 flops a cell (itemised in
//   chip_smoke.py), 76 MFLOP: 1.1 us at 67 TFLOP/s float32, 2.2 us at 34
//   float64.  This kernel does about 310 a cell, on 1.37x the box's cells
//   at 200x64x16 (tiles of 16 x 8 cells for 15 x 7 nodes, a halo layer a
//   z chunk), and its idle lanes (cells outside the box) take issue slots
//   too: 1.84x the box's cells in all.
//   The earlier design (one thread a node, Ke as 56 3x3 blocks: 1,008
//   multiply-adds a node) took 0.0206 ms float32 and 0.0326 float64 at
//   200x64x16 (7.7 / 9.8 % of the bound), 40 % of it arithmetic.
//   Result (NVIDIA H100 80GB HBM3 at 700 W, tools/kernel_ab.py in turns
//   with the earlier design; PERF.md): 0.0126 ms float32 and 0.0160
//   float64 at 200x64x16 (1.6x / 2.0x, 13 / 20 % of the bound).  Without
//   its arithmetic it still takes 0.0109 / 0.0140: a block's march is a
//   chain of dependent steps (about 0.9 us a step for a block alone on
//   its SM, from the z-chunk sweep), and four blocks an SM fill the issue
//   slots.  Tiles of 32 x 4, 64 x 4 and 32 x 8 ran 2-11 % slower.
//
// stencil_window  replaces _window_kernel (pallas_stencil.py:97), the
//                 z-blocked variant (NB planes per grid step).  Opt-in.
//   Form: stencil_plane's cell form (cell_forces, the same cell table) and
//   its node order: a node sums corners 0-3 of cell layer z in order, then
//   adds the sum of corners 4-7 of layer z - 1 in order, so the two
//   kernels give the same bits.
//   Data flow: a block owns a WX x WY x WZ tile of cells, one thread a
//   cell, and computes the (WX-1) x (WY-1) x (WZ-1) nodes after its first
//   column, row and layer: it stages the WZ + 1 node planes it reads by
//   cp.async (a row a warp) and its own cell's scale, computes every
//   cell's bottom and top face forces into shared memory at once, and
//   after one barrier each node sums its eight corners.  No march: a
//   block waits on device memory once and on two barriers, where
//   stencil_plane's march is a chain of dependent steps.  The price is
//   the halo on three faces: 16 x 4 x 4 cells for 15 x 3 x 3 nodes
//   compute 1.9x the box's cells (stencil_plane: 1.37x at 200x64x16).
//   The earlier design (Ke as 56 3x3 blocks a node, 1,008 multiply-adds a
//   node, one thread a node of a 32 x 2 x 4 tile) took 0.0387 ms float32
//   and 0.0470 float64 at 200x64x16 (4.1 / 6.8 % of the bound; NVIDIA
//   H100 80GB HBM3 at 700 W, PERF.md), this one 0.0148 / 0.0200 in turns
//   with it (tools/kernel_ab.py): faster than stencil_plane at 100x32x8
//   and 50x16x4, slower at 200x64x16.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// stencil_plane: cells a tile computes along x and y (one thread each);
// its nodes are the tile less its first row and column.  NT: values in
// the cell table (ops/stencil.cell_table).
constexpr int CX = 16, CY = 8;
constexpr int PT = CX * CY;
// blocks an SM keeps (128 registers a thread at most)
constexpr int MIN_BLOCKS = 512 / PT;
constexpr int NT = 5;
constexpr int RX = 3 * (CX + 1);   // values in a staged row of nodes
constexpr int RY = CY + 1;         // staged rows of a plane

// stencil_window: cells a tile computes along x, y and z (one thread
// each); its nodes are the tile less its first column, row and layer.
constexpr int WX = 16, WY = 4, WZ = 4;
constexpr int WT = WX * WY * WZ;
constexpr int WIN_MIN_BLOCKS = WT >= 512 ? 1 : 512 / WT;
constexpr int WRX = 3 * (WX + 1);  // values in a staged row of nodes
constexpr int WRY = WY + 1;        // staged rows of a plane
constexpr int WRZ = WZ + 1;        // staged node planes

// hex corner offsets (iz, iy, ix) in VTK order, as in grid.py
__device__ constexpr int OZ[8] = {0, 0, 0, 0, 1, 1, 1, 1};
__device__ constexpr int OY[8] = {0, 0, 1, 1, 0, 0, 1, 1};
__device__ constexpr int OX[8] = {0, 1, 1, 0, 0, 1, 1, 0};

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

// Stage n_planes node planes from p0 on into shared memory, each as SR
// rows (y0 - 1 onwards) of SX values (nodes x0 - 1 onwards), a row a warp
// of the NTHREADS; zero outside the lattice.  The copies are cp.async,
// committed as one group.
template <typename T, int SX, int SR, int NTHREADS>
__device__ __forceinline__ void stage_planes(T* __restrict__ planes,
                                             const T* __restrict__ u, int p0,
                                             int n_planes, int y0, int x0,
                                             int NX, int NY, int NZ,
                                             int tid) {
    constexpr int STEPS = (SX + 31) / 32;
    const int lane = tid & 31, warp = tid >> 5;
    unsigned col_in = 0;     // bit k: value lane + 32k lies in the row
#pragma unroll
    for (int k = 0; k < STEPS; ++k) {
        const int c = lane + 32 * k, xx = x0 - 1 + c / 3;
        if (c < SX && xx >= 0 && xx < NX) col_in |= 1u << k;
    }
    const int n_rows = n_planes * SR;
    for (int row = warp; row < n_rows; row += NTHREADS / 32) {
        const int q = row / SR, r = row - q * SR;
        const int p = p0 + q, yy = y0 - 1 + r;
        const bool in = p >= 0 && p < NZ && yy >= 0 && yy < NY;
        T* dst = planes + row * SX;
        const T* src = u + (((int64_t)p * NY + yy) * NX + x0 - 1) * 3;
#pragma unroll
        for (int k = 0; k < STEPS; ++k) {
            const int c = lane + 32 * k;
            if (in && (col_in >> k & 1u))
                cp_async(dst + c, src + c, (int)sizeof(T));
            else if (c < SX)
                dst[c] = T(0);
        }
    }
    cp_async_commit();
}

// One tet of the split: the path 0 -> P1 -> P2 -> 6 along axes A, B, C
// (corners in VTK order; the six permutations of x, y, z are the six tets
// of grid._TET_SPLIT).  Its gradient has column A = e1, B = e2, C = e3,
// the path's edges over their lengths; sigma = lt tr(H) I + mt (H + H^T)
// with lt, mt the cell's scale times vol*lam, vol*mu; s_k = sigma e_axis
// / h_axis for the path's three axes.  The vertex forces are -s_0,
// s_0 - s_1, s_1 - s_2 and s_2: vol sigma g_i for g_0 = -e_A/h_A,
// g_P1 = e_A/h_A - e_B/h_B, g_P2 = e_B/h_B - e_C/h_C, g_6 = e_C/h_C.
template <typename T, int A, int B, int C>
__device__ __forceinline__ void tet_columns(const T (&e1)[3],
                                            const T (&e2)[3],
                                            const T (&e3)[3], T lt, T mt,
                                            const T (&ih)[3], T (&s)[3][3]) {
    T H[3][3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        H[a][A] = e1[a];
        H[a][B] = e2[a];
        H[a][C] = e3[a];
    }
    const T ltr = lt * (H[0][0] + H[1][1] + H[2][2]);
    const T m2 = mt + mt;
    T sg[3][3];
#pragma unroll
    for (int a = 0; a < 3; ++a) sg[a][a] = ltr + m2 * H[a][a];
    sg[0][1] = sg[1][0] = mt * (H[0][1] + H[1][0]);
    sg[0][2] = sg[2][0] = mt * (H[0][2] + H[2][0]);
    sg[1][2] = sg[2][1] = mt * (H[1][2] + H[2][1]);
#pragma unroll
    for (int b = 0; b < 3; ++b) {
        s[0][b] = sg[b][A] * ih[A];
        s[1][b] = sg[b][B] * ih[B];
        s[2][b] = sg[b][C] * ih[C];
    }
}

// The forces of one cell on its 8 corners through its six tets.  p0 / p1
// point at the cell's corner (0, 0, 0) / (1, 0, 0) in the staged planes,
// whose rows hold SX values; lt, mt the cell's scale times vol*lam,
// vol*mu; ih = 1/dx, 1/dy, 1/dz.  Corner j's forces go to fb[(3j + a) * FS]
// (j < 4) or ft[(3(j - 4) + a) * FS].  The twelve edges are formed once (each over
// its length); the tets run in the order of grid._TET_SPLIT; corner 0
// sums -s_0 and corner 6 s_2 over the tets in order, a corner shared by
// two tets takes the first tet's force, then adds the second's.
template <typename T, int SX, int FS>
__device__ __forceinline__ void cell_forces(const T* __restrict__ p0,
                                            const T* __restrict__ p1, T lt,
                                            T mt, const T (&ih)[3],
                                            T* __restrict__ fb,
                                            T* __restrict__ ft) {
    T c[8][3];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int a = 0; a < 3; ++a)
            c[j][a] = (OZ[j] ? p1 : p0)[OY[j] * SX + 3 * OX[j] + a];
    // edges: X01 is corner 1 - corner 0 (along x) over dx, and so on
    T X01[3], Y03[3], Z04[3], Y12[3], X32[3], Z37[3], Y47[3], X45[3],
        Z15[3], Z26[3], X76[3], Y56[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        X01[a] = (c[1][a] - c[0][a]) * ih[0];
        Y03[a] = (c[3][a] - c[0][a]) * ih[1];
        Z04[a] = (c[4][a] - c[0][a]) * ih[2];
        Y12[a] = (c[2][a] - c[1][a]) * ih[1];
        X32[a] = (c[2][a] - c[3][a]) * ih[0];
        Z37[a] = (c[7][a] - c[3][a]) * ih[2];
        Y47[a] = (c[7][a] - c[4][a]) * ih[1];
        X45[a] = (c[5][a] - c[4][a]) * ih[0];
        Z15[a] = (c[5][a] - c[1][a]) * ih[2];
        Z26[a] = (c[6][a] - c[2][a]) * ih[2];
        X76[a] = (c[6][a] - c[7][a]) * ih[0];
        Y56[a] = (c[6][a] - c[5][a]) * ih[1];
    }
    auto put = [&](int j, const T (&v)[3]) {
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            if (j < 4) fb[(3 * j + a) * FS] = v[a];
            else ft[(3 * (j - 4) + a) * FS] = v[a];
        }
    };
    T F0[3], F6[3], F1[3], F2[3], F3[3], F7[3], F4[3], F5[3], v[3];
    T s[3][3];
    // tet 0: 0 -> 1 -> 2 -> 6 (x, y, z)
    tet_columns<T, 0, 1, 2>(X01, Y12, Z26, lt, mt, ih, s);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        F0[a] = -s[0][a];
        F1[a] = s[0][a] - s[1][a];
        F2[a] = s[1][a] - s[2][a];
        F6[a] = s[2][a];
    }
    // tet 1: 0 -> 3 -> 2 -> 6 (y, x, z)
    tet_columns<T, 1, 0, 2>(Y03, X32, Z26, lt, mt, ih, s);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        F0[a] -= s[0][a];
        F3[a] = s[0][a] - s[1][a];
        v[a] = F2[a] + (s[1][a] - s[2][a]);
        F6[a] += s[2][a];
    }
    put(2, v);
    // tet 2: 0 -> 3 -> 7 -> 6 (y, z, x)
    tet_columns<T, 1, 2, 0>(Y03, Z37, X76, lt, mt, ih, s);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        F0[a] -= s[0][a];
        v[a] = F3[a] + (s[0][a] - s[1][a]);
        F7[a] = s[1][a] - s[2][a];
        F6[a] += s[2][a];
    }
    put(3, v);
    // tet 3: 0 -> 4 -> 7 -> 6 (z, y, x)
    tet_columns<T, 2, 1, 0>(Z04, Y47, X76, lt, mt, ih, s);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        F0[a] -= s[0][a];
        F4[a] = s[0][a] - s[1][a];
        v[a] = F7[a] + (s[1][a] - s[2][a]);
        F6[a] += s[2][a];
    }
    put(7, v);
    // tet 4: 0 -> 4 -> 5 -> 6 (z, x, y)
    tet_columns<T, 2, 0, 1>(Z04, X45, Y56, lt, mt, ih, s);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        F0[a] -= s[0][a];
        v[a] = F4[a] + (s[0][a] - s[1][a]);
        F5[a] = s[1][a] - s[2][a];
        F6[a] += s[2][a];
    }
    put(4, v);
    // tet 5: 0 -> 1 -> 5 -> 6 (x, z, y)
    tet_columns<T, 0, 2, 1>(X01, Z15, Y56, lt, mt, ih, s);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        F0[a] -= s[0][a];
        F1[a] += s[0][a] - s[1][a];
        F5[a] += s[1][a] - s[2][a];
        F6[a] += s[2][a];
    }
    put(1, F1);
    put(5, F5);
    put(0, F0);
    put(6, F6);
}

// One block: a CX x CY tile of cells (x, y), marching in z over the cell
// layers z0 - 1 .. z1 - 1 that touch its node planes [z0, z1).  All the
// node planes z0 - 1 .. z1 it reads arrive first, by cp.async (so the
// march waits on device memory once, not once a layer); each cell layer's
// forces on its bottom (corners 0-3) and top (4-7) faces go to shared
// memory; a node of plane z sums corners 0-3 of layer z in order, plus
// the sum of corners 4-7 of layer z - 1 (in order), which it kept in
// registers from the step before.  A cell's scale is loaded one layer
// ahead.
template <typename T>
__global__ void __launch_bounds__(PT, MIN_BLOCKS)
stencil_plane_kernel(const T* __restrict__ u, const T* __restrict__ esc,
                     const T* __restrict__ table, T* __restrict__ y, int nx,
                     int ny, int nz, int zn) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* planes = reinterpret_cast<T*>(smem_raw);  // [zn + 2][RY][RX]
    T* fbot = planes + (zn + 2) * (RY * RX);     // [12][PT]
    T* ftop = fbot + 12 * PT;                    // [12][PT]

    const int NX = nx + 1, NY = ny + 1, NZ = nz + 1;
    const int tid = threadIdx.x;
    const int lx = tid % CX, ly = tid / CX;
    // the tile's first cell is (x0 - 1, y0 - 1); its nodes start at x0, y0
    const int x0 = blockIdx.x * (CX - 1), y0 = blockIdx.y * (CY - 1);
    const int z0 = blockIdx.z * zn;
    const int z1 = min(z0 + zn, NZ);
    const T ih[3] = {table[0], table[1], table[2]};
    const T vlam = table[3], vmu = table[4];

    // node planes z0 - 1 .. z1, nodes x0-1 .. x0+CX-1 by y0-1 .. y0+CY-1
    stage_planes<T, RX, RY, PT>(planes, u, z0 - 1, z1 - z0 + 2, y0, x0, NX,
                                NY, NZ, tid);

    const int cx = x0 - 1 + lx, cy = y0 - 1 + ly;
    const bool in_xy = cx >= 0 && cx < nx && cy >= 0 && cy < ny;
    const int cell = ly * CX + lx;
    // the node of this thread is (cx, cy): corner 0 of its own cell
    const bool node = lx >= 1 && ly >= 1 && cx < NX && cy < NY;
    int cj[8];   // the tile index of the cell of which this node is corner j
#pragma unroll
    for (int j = 0; j < 8; ++j) cj[j] = (ly - OY[j]) * CX + (lx - OX[j]);
    auto scale_of = [&](int cz) -> T {
        return (esc != nullptr && in_xy && cz >= 0 && cz < nz)
                   ? esc[((int64_t)cz * ny + cy) * nx + cx] : T(1);
    };

    T e_next = scale_of(z0 - 1);
    T ptop[3] = {T(0), T(0), T(0)};
    cp_async_wait_all();
    __syncthreads();
    for (int cz = z0 - 1; cz < z1; ++cz) {
        const T e = e_next;
        e_next = scale_of(cz + 1);
        if (in_xy && cz >= 0 && cz < nz) {
            const T* p0 = planes + (cz - z0 + 1) * (RY * RX) + ly * RX + 3 * lx;
            cell_forces<T, RX, PT>(p0, p0 + RY * RX, e * vlam, e * vmu, ih,
                                   fbot + cell, ftop + cell);
        } else {
#pragma unroll
            for (int i = 0; i < 12; ++i) {
                fbot[i * PT + cell] = T(0);
                ftop[i * PT + cell] = T(0);
            }
        }
        __syncthreads();
        if (node) {
            if (cz >= z0) {
                const int64_t n = ((int64_t)cz * NY + cy) * NX + cx;
#pragma unroll
                for (int a = 0; a < 3; ++a) {
                    T acc = fbot[a * PT + cj[0]];
#pragma unroll
                    for (int j = 1; j < 4; ++j) acc += fbot[(3 * j + a) * PT + cj[j]];
                    y[3 * n + a] = acc + ptop[a];
                }
            }
#pragma unroll
            for (int a = 0; a < 3; ++a) {
                T acc = ftop[a * PT + cj[4]];
#pragma unroll
                for (int j = 5; j < 8; ++j)
                    acc += ftop[(3 * (j - 4) + a) * PT + cj[j]];
                ptop[a] = acc;
            }
        }
        __syncthreads();
    }
}

// One block: a WX x WY x WZ tile of cells, one thread a cell, for the
// nodes after its first column, row and layer.  The node planes it reads
// and its own cell's scale arrive first; every cell's bottom (corners
// 0-3) and top (4-7) face forces go to shared memory at once; after one
// barrier a node of plane z sums corners 0-3 of layer z in order plus the
// sum of corners 4-7 of layer z - 1 in order, as stencil_plane does.
template <typename T>
__global__ void __launch_bounds__(WT, WIN_MIN_BLOCKS)
stencil_window_kernel(const T* __restrict__ u, const T* __restrict__ esc,
                      const T* __restrict__ table, T* __restrict__ y, int nx,
                      int ny, int nz) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* planes = reinterpret_cast<T*>(smem_raw);  // [WRZ][WRY][WRX]
    T* fbot = planes + WRZ * WRY * WRX;          // [12][WT]
    T* ftop = fbot + 12 * WT;                    // [12][WT]

    const int NX = nx + 1, NY = ny + 1, NZ = nz + 1;
    const int tid = threadIdx.x;
    const int lx = tid % WX, ly = (tid / WX) % WY, lz = tid / (WX * WY);
    // the tile's first cell is (z0 - 1, y0 - 1, x0 - 1); its nodes start
    // at z0, y0, x0
    const int x0 = blockIdx.x * (WX - 1), y0 = blockIdx.y * (WY - 1),
              z0 = blockIdx.z * (WZ - 1);
    const T ih[3] = {table[0], table[1], table[2]};
    const T vlam = table[3], vmu = table[4];
    stage_planes<T, WRX, WRY, WT>(planes, u, z0 - 1, WRZ, y0, x0, NX, NY, NZ,
                                  tid);

    const int cx = x0 - 1 + lx, cy = y0 - 1 + ly, cz = z0 - 1 + lz;
    const bool in_box = cx >= 0 && cx < nx && cy >= 0 && cy < ny && cz >= 0 &&
                        cz < nz;
    const T e = (esc != nullptr && in_box)
                    ? esc[((int64_t)cz * ny + cy) * nx + cx] : T(1);
    cp_async_wait_all();
    __syncthreads();
    if (in_box) {
        const T* p0 = planes + (lz * WRY + ly) * WRX + 3 * lx;
        cell_forces<T, WRX, WT>(p0, p0 + WRY * WRX, e * vlam, e * vmu, ih,
                                fbot + tid, ftop + tid);
    } else {
#pragma unroll
        for (int i = 0; i < 12; ++i) {
            fbot[i * WT + tid] = T(0);
            ftop[i * WT + tid] = T(0);
        }
    }
    __syncthreads();
    // the node of this thread is (cz, cy, cx): corner 0 of its own cell,
    // corner j of the cell tid - cj[j]
    if (lx >= 1 && ly >= 1 && lz >= 1 && cx < NX && cy < NY && cz < NZ) {
        int cj[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
            cj[j] = tid - (OZ[j] * WY + OY[j]) * WX - OX[j];
        const int64_t n = ((int64_t)cz * NY + cy) * NX + cx;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            T top = ftop[a * WT + cj[4]];
#pragma unroll
            for (int j = 5; j < 8; ++j) top += ftop[(3 * (j - 4) + a) * WT + cj[j]];
            T acc = fbot[a * WT + cj[0]];
#pragma unroll
            for (int j = 1; j < 4; ++j) acc += fbot[(3 * j + a) * WT + cj[j]];
            y[3 * n + a] = acc + top;
        }
    }
}

// Shared memory of a stencil_plane block: zn + 2 staged planes and the
// two face-force buffers.  PLANE_SMEM keeps MIN_BLOCKS blocks an SM (of
// the 228 KB, 1 KB a block reserved), which caps the z chunk (6 planes
// in double).
constexpr size_t PLANE_SMEM = 228 * 1024 / MIN_BLOCKS - 1024;

template <typename T>
constexpr size_t plane_smem(int zn) {
    return sizeof(T) * ((size_t)(zn + 2) * RY * RX + 24 * PT);
}

template <typename T>
constexpr int plane_chunk_max() {
    return (int)((PLANE_SMEM / sizeof(T) - 24 * PT) / (RY * RX)) - 2;
}

constexpr int MAX_DEVICES = 64;

// Node planes a block marches over: within the shared-memory cap, the z
// chunk that spreads the (zn + 1)-layer blocks most evenly over the SMs
// (ties: the longer chunk, which recomputes fewer halo layers).
int plane_chunk(int nx, int ny, int nz, int zn_max) {
    static int sms_of[MAX_DEVICES] = {};
    int dev = 0;
    cudaGetDevice(&dev);
    int sms = 132;
    if (dev >= 0 && dev < MAX_DEVICES) {
        if (sms_of[dev] == 0) {
            cudaDeviceGetAttribute(&sms_of[dev],
                                   cudaDevAttrMultiProcessorCount, dev);
            if (sms_of[dev] <= 0) sms_of[dev] = 132;
        }
        sms = sms_of[dev];
    }
    const long long xy = (long long)((nx + CX - 1) / (CX - 1)) *
                         ((ny + CY - 1) / (CY - 1));
    const int NZ = nz + 1;
    int best = 1;
    long long best_cost = -1;
    for (int zn = 1; zn <= min(NZ, zn_max); ++zn) {
        const long long blocks = xy * ((NZ + zn - 1) / zn);
        const long long cost = ((blocks + sms - 1) / sms) * (zn + 1);
        if (best_cost < 0 || cost <= best_cost) {
            best = zn;
            best_cost = cost;
        }
    }
    return best;
}

template <typename T>
int launch_plane(const void* u, const void* esc, const void* table, void* y,
                 int nx, int ny, int nz, int zn, void* stream) {
    constexpr int zn_max = plane_chunk_max<T>();
    // the attribute is per device: set once on each card that launches
    static bool ready[MAX_DEVICES] = {};
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidValue;
    if (!ready[dev]) {
        const cudaError_t err = cudaFuncSetAttribute(
            stencil_plane_kernel<T>,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)plane_smem<T>(zn_max));
        if (err != cudaSuccess) return (int)err;
        ready[dev] = true;
    }
    const int NZ = nz + 1;
    if (zn <= 0) zn = plane_chunk(nx, ny, nz, zn_max);
    zn = min(zn, min(NZ, zn_max));
    const dim3 grid((nx + 1 + CX - 2) / (CX - 1), (ny + 1 + CY - 2) / (CY - 1),
                    (NZ + zn - 1) / zn);
    stencil_plane_kernel<T><<<grid, PT, plane_smem<T>(zn),
                              (cudaStream_t)stream>>>(
        (const T*)u, (const T*)esc, (const T*)table, (T*)y, nx, ny, nz, zn);
    return (int)cudaGetLastError();
}

// Shared memory of a stencil_window block: its staged node planes and the
// two face-force buffers (float64: above the 48 KB a block gets without
// asking).
template <typename T>
constexpr size_t window_smem() {
    return sizeof(T) * ((size_t)WRZ * WRY * WRX + 24 * WT);
}

template <typename T>
int launch_window(const void* u, const void* esc, const void* table, void* y,
                  int nx, int ny, int nz, void* stream) {
    static bool ready = false;
    if (!ready) {
        const cudaError_t err = cudaFuncSetAttribute(
            stencil_window_kernel<T>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)window_smem<T>());
        if (err != cudaSuccess) return (int)err;
        ready = true;
    }
    const dim3 grid((nx + 1 + WX - 2) / (WX - 1), (ny + 1 + WY - 2) / (WY - 1),
                    (nz + 1 + WZ - 2) / (WZ - 1));
    stencil_window_kernel<T><<<grid, WT, window_smem<T>(),
                               (cudaStream_t)stream>>>(
        (const T*)u, (const T*)esc, (const T*)table, (T*)y, nx, ny, nz);
    return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, bound with ctypes in ops/stencil.py.  u, table and y
// are device pointers, esc a device pointer or null; nx,
// ny, nz count cells; zn is the plane kernel's z chunk in node planes (0:
// stencil_plane_chunk's choice for the type; larger values are cut to
// what two blocks an SM can stage).  Each entry point returns
// cudaGetLastError() after its launch.
extern "C" {

int stencil_plane_f32(const void* u, const void* esc, const void* table,
                      void* y, int nx, int ny, int nz, int zn, void* stream) {
    return launch_plane<float>(u, esc, table, y, nx, ny, nz, zn, stream);
}

int stencil_plane_f64(const void* u, const void* esc, const void* table,
                      void* y, int nx, int ny, int nz, int zn, void* stream) {
    return launch_plane<double>(u, esc, table, y, nx, ny, nz, zn, stream);
}

int stencil_plane_chunk(int nx, int ny, int nz, int is_double) {
    return is_double ? plane_chunk(nx, ny, nz, plane_chunk_max<double>())
                     : plane_chunk(nx, ny, nz, plane_chunk_max<float>());
}

int stencil_window_f32(const void* u, const void* esc, const void* table,
                       void* y, int nx, int ny, int nz, void* stream) {
    return launch_window<float>(u, esc, table, y, nx, ny, nz, stream);
}

int stencil_window_f64(const void* u, const void* esc, const void* table,
                       void* y, int nx, int ny, int nz, void* stream) {
    return launch_window<double>(u, esc, table, y, nx, ny, nz, stream);
}

const char* stencil_apply_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
