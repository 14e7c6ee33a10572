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
// pointer means 1).  The two kernels compute this function in two forms,
// each in a fixed order (so each repeats its output bit for bit), and agree
// with each other to rounding, not bit for bit.
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
//   Form: Ke, in shared memory (576 values in the working type, read at
//   warp-uniform addresses), applied as 56 3x3 blocks a node to the 27 x 3
//   neighbour differences u[m] - u[n], formed once a node in registers:
//   inner sum per cell over k then b, times esc, cells in corner order j.
//   Data flow: a block owns WIN_NB z-planes x WIN_TY x WIN_TX nodes, one
//   thread a node; it first stages the tile of u with a one-node halo, and
//   the touching esc cells, in shared memory, then each thread reads its
//   neighbours from there (a warp along x reads with a stride of 3 values,
//   coprime with the 32 banks).  0.039 ms float32, 0.048 float64 at
//   200x64x16 (PERF.md): slower than stencil_plane, hence opt-in.

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
// values a lane stages of a row of RX (RX <= 32 * ROW_STEPS)
constexpr int NT = 5;
constexpr int RX = 3 * (CX + 1);   // values in a staged row of nodes
constexpr int RY = CY + 1;         // staged rows of a plane
constexpr int ROW_STEPS = (RX + 31) / 32;
constexpr int WIN_TX = 32;   // nodes per tile along x (one warp)
constexpr int WIN_TY = 2;    // nodes per tile along y
constexpr int WIN_NB = 4;    // z-planes per tile
constexpr int WIN_THREADS = WIN_TX * WIN_TY * WIN_NB;

// hex corner offsets (iz, iy, ix) in VTK order, as in grid.py
__device__ constexpr int OZ[8] = {0, 0, 0, 0, 1, 1, 1, 1};
__device__ constexpr int OY[8] = {0, 0, 1, 1, 0, 0, 1, 1};
__device__ constexpr int OX[8] = {0, 1, 1, 0, 0, 1, 1, 0};

// One node's three outputs.  d[dz][dy][dx][b] = u[n + (dz-1, dy-1, dx-1), b]
// - u[n, b] (any value where that neighbour lies outside the lattice: only
// cells outside the box would read it).  Cell j is the one of which n is
// corner j; valid bit j says it lies inside the box, e[j] is its scale.
template <typename T>
__device__ __forceinline__ void node_apply(const T (&d)[3][3][3][3],
                                           const T (&e)[8], unsigned valid,
                                           const T* __restrict__ ke_s,
                                           T (&acc)[3]) {
    acc[0] = acc[1] = acc[2] = T(0);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        if (!(valid & (1u << j))) continue;
        T inner[3] = {T(0), T(0), T(0)};
#pragma unroll
        for (int k = 0; k < 8; ++k) {
            if (k == j) continue;          // its difference is zero
            const T(&dk)[3] = d[OZ[k] - OZ[j] + 1][OY[k] - OY[j] + 1]
                               [OX[k] - OX[j] + 1];
#pragma unroll
            for (int a = 0; a < 3; ++a)
#pragma unroll
                for (int b = 0; b < 3; ++b)
                    inner[a] += ke_s[(3 * j + a) * 24 + 3 * k + b] * dk[b];
        }
#pragma unroll
        for (int a = 0; a < 3; ++a) acc[a] += e[j] * inner[a];
    }
}

// Which of the 8 cells around node (z, y, x) lie inside the box, and their
// flat indices into esc [nz, ny, nx].
__device__ __forceinline__ unsigned cells_of_node(int z, int y, int x, int nx,
                                                  int ny, int nz,
                                                  int64_t (&cell)[8]) {
    unsigned valid = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        const int cz = z - OZ[j], cy = y - OY[j], cx = x - OX[j];
        const bool in = cz >= 0 && cz < nz && cy >= 0 && cy < ny && cx >= 0 &&
                        cx < nx;
        cell[j] = ((int64_t)cz * ny + cy) * nx + cx;
        if (in) valid |= 1u << j;
    }
    return valid;
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
// point at the cell's corner (0, 0, 0) / (1, 0, 0) in the staged planes;
// lt, mt the cell's scale times vol*lam, vol*mu; ih = 1/dx, 1/dy, 1/dz.
// Corner j's forces go to fb[(3j + a) * PT] (j < 4) or
// ft[(3(j - 4) + a) * PT].  The twelve edges are formed once (each over
// its length); the tets run in the order of grid._TET_SPLIT; corner 0
// sums -s_0 and corner 6 s_2 over the tets in order, a corner shared by
// two tets takes the first tet's force, then adds the second's.
template <typename T>
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
            c[j][a] = (OZ[j] ? p1 : p0)[OY[j] * RX + 3 * OX[j] + a];
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
            if (j < 4) fb[(3 * j + a) * PT] = v[a];
            else ft[(3 * (j - 4) + a) * PT] = v[a];
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

    // node planes z0 - 1 .. z1, nodes x0-1 .. x0+CX-1 by y0-1 .. y0+CY-1,
    // a row of RX values a warp; zero outside the lattice
    {
        const int lane = tid & 31, warp = tid >> 5;
        unsigned col_in = 0;     // bit k: value lane + 32k lies in the row
#pragma unroll
        for (int k = 0; k < ROW_STEPS; ++k) {
            const int c = lane + 32 * k, xx = x0 - 1 + c / 3;
            if (c < RX && xx >= 0 && xx < NX) col_in |= 1u << k;
        }
        const int n_rows = (z1 - z0 + 2) * RY;
        for (int row = warp; row < n_rows; row += PT / 32) {
            const int q = row / RY, r = row - q * RY;
            const int p = z0 - 1 + q, yy = y0 - 1 + r;
            const bool in = p >= 0 && p < NZ && yy >= 0 && yy < NY;
            T* dst = planes + row * RX;
            const T* src = u + (((int64_t)p * NY + yy) * NX + x0 - 1) * 3;
#pragma unroll
            for (int k = 0; k < ROW_STEPS; ++k) {
                const int c = lane + 32 * k;
                if (in && (col_in >> k & 1u))
                    cp_async(dst + c, src + c, (int)sizeof(T));
                else if (c < RX)
                    dst[c] = T(0);
            }
        }
    }
    cp_async_commit();

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
            cell_forces<T>(p0, p0 + RY * RX, e * vlam, e * vmu, ih,
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

template <typename T>
__global__ void __launch_bounds__(WIN_THREADS)
stencil_window_kernel(const T* __restrict__ u, const T* __restrict__ esc,
                      const T* __restrict__ ke, T* __restrict__ y, int nx,
                      int ny, int nz) {
    constexpr int SX = 3 * (WIN_TX + 2);          // values per staged row
    constexpr int SY = WIN_TY + 2, SZ = WIN_NB + 2;
    constexpr int EX = WIN_TX + 1, EY = WIN_TY + 1, EZ = WIN_NB + 1;
    __shared__ T ke_s[576];
    __shared__ T u_s[SZ][SY][SX];
    __shared__ T e_s[EZ][EY][EX];

    const int NX = nx + 1, NY = ny + 1, NZ = nz + 1;
    const int x0 = blockIdx.x * WIN_TX, y0 = blockIdx.y * WIN_TY,
              z0 = blockIdx.z * WIN_NB;
    const int tid = (threadIdx.z * WIN_TY + threadIdx.y) * WIN_TX + threadIdx.x;

    for (int i = tid; i < 576; i += WIN_THREADS) ke_s[i] = ke[i];
    // the tile of u with its one-node halo; zero outside the lattice
    for (int i = tid; i < SZ * SY * SX; i += WIN_THREADS) {
        const int c = i % SX, r = i / SX;
        const int sy = r % SY, sz = r / SY;
        const int zz = z0 - 1 + sz, yy = y0 - 1 + sy, xx = x0 - 1 + c / 3;
        const bool in = zz >= 0 && zz < NZ && yy >= 0 && yy < NY && xx >= 0 &&
                        xx < NX;
        u_s[sz][sy][c] =
            in ? u[3 * (((int64_t)zz * NY + yy) * NX + xx) + c % 3] : T(0);
    }
    // the cells touching the tile: cell (z0-1+ez, y0-1+ey, x0-1+ex)
    if (esc != nullptr) {
        for (int i = tid; i < EZ * EY * EX; i += WIN_THREADS) {
            const int ex = i % EX, r = i / EX;
            const int ey = r % EY, ez = r / EY;
            const int cz = z0 - 1 + ez, cy = y0 - 1 + ey, cx = x0 - 1 + ex;
            const bool in = cz >= 0 && cz < nz && cy >= 0 && cy < ny &&
                            cx >= 0 && cx < nx;
            e_s[ez][ey][ex] = in ? esc[((int64_t)cz * ny + cy) * nx + cx] : T(1);
        }
    }
    __syncthreads();

    const int x = x0 + threadIdx.x, y_ = y0 + threadIdx.y, z = z0 + threadIdx.z;
    if (x >= NX || y_ >= NY || z >= NZ) return;
    // this node in the staged tile
    const int lx = threadIdx.x + 1, ly = threadIdx.y + 1, lz = threadIdx.z + 1;
    T uc[3];
#pragma unroll
    for (int b = 0; b < 3; ++b) uc[b] = u_s[lz][ly][3 * lx + b];
    T d[3][3][3][3];
#pragma unroll
    for (int dz = 0; dz < 3; ++dz)
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
            for (int dx = 0; dx < 3; ++dx)
#pragma unroll
                for (int b = 0; b < 3; ++b)
                    d[dz][dy][dx][b] =
                        u_s[lz + dz - 1][ly + dy - 1][3 * (lx + dx - 1) + b] - uc[b];
    int64_t cell[8];
    const unsigned valid = cells_of_node(z, y_, x, nx, ny, nz, cell);
    T e[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
        e[j] = esc != nullptr ? e_s[lz - OZ[j]][ly - OY[j]][lx - OX[j]] : T(1);
    T acc[3];
    node_apply<T>(d, e, valid, ke_s, acc);
    const int64_t n = ((int64_t)z * NY + y_) * NX + x;
#pragma unroll
    for (int a = 0; a < 3; ++a) y[3 * n + a] = acc[a];
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

// Node planes a block marches over: within the shared-memory cap, the z
// chunk that spreads the (zn + 1)-layer blocks most evenly over the SMs
// (ties: the longer chunk, which recomputes fewer halo layers).
int plane_chunk(int nx, int ny, int nz, int zn_max) {
    static int sms = 0;
    if (sms == 0) {
        int dev = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (sms <= 0) sms = 132;
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
    static bool ready = false;
    if (!ready) {
        const cudaError_t err = cudaFuncSetAttribute(
            stencil_plane_kernel<T>,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)plane_smem<T>(zn_max));
        if (err != cudaSuccess) return (int)err;
        ready = true;
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

template <typename T>
int launch_window(const void* u, const void* esc, const void* ke, void* y,
                  int nx, int ny, int nz, void* stream) {
    const dim3 grid((nx + 1 + WIN_TX - 1) / WIN_TX, (ny + 1 + WIN_TY - 1) / WIN_TY,
                    (nz + 1 + WIN_NB - 1) / WIN_NB);
    const dim3 block(WIN_TX, WIN_TY, WIN_NB);
    stencil_window_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
        (const T*)u, (const T*)esc, (const T*)ke, (T*)y, nx, ny, nz);
    return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, bound with ctypes in ops/stencil.py.  u, table (plane),
// ke (window) and y are device pointers, esc a device pointer or null; nx,
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

int stencil_window_f32(const void* u, const void* esc, const void* ke, void* y,
                       int nx, int ny, int nz, void* stream) {
    return launch_window<float>(u, esc, ke, y, nx, ny, nz, stream);
}

int stencil_window_f64(const void* u, const void* esc, const void* ke, void* y,
                       int nx, int ny, int nz, void* stream) {
    return launch_window<double>(u, esc, ke, y, nx, ny, nz, stream);
}

const char* stencil_apply_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
