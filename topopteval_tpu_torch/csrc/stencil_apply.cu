// Fused stencil matvec on structured boxes of 6-tet hexes, for Hopper (sm_90a).
//
// y = K_raw u on an (nx, ny, nz)-cell box.  The flat DOF vector is numbered
// dof = ((z*NY + y)*NX + x)*3 + a over the (NZ, NY, NX) = (nz+1, ny+1, nx+1)
// node lattice.  For every node n = (z, y, x) and component a
//
//   y[n,a] = sum over the <= 8 cells c touching n, n being corner j of c:
//            esc[c] * sum_k sum_b Ke[3j+a, 3k+b] * (u[node_k(c), b] - u[n, b])
//
// Ke is the assembled 24x24 hex stiffness (VTK corner-major, k*3+b), 576
// values in device memory in the working type: it differs per multigrid
// level and per material, and levels alternate inside one V-cycle, so it is
// an argument that each block copies to shared memory.  esc is the per-hex
// scale grid [nz, ny, nx]; a null pointer means 1.  Subtracting u[n, b] is
// exact (the rows of Ke sum to zero over the corners) and is what keeps
// float32 accurate: the sum runs over differences of neighbouring values.
// Order of accumulation in both kernels: inner sum per cell over k then b,
// times esc, then added to the node's accumulator, cells in corner order j.
// Both kernels call the same node_apply(), so they agree bit for bit.
//
// stencil_plane   replaces _stencil_kernel (topopteval_tpu/ops/pallas_stencil.py:156,
//                 via _stencil_matvec :219 and stencil_matvec :338), which
//                 produced one output z-plane per grid step from lane rolls
//                 and a period-3 coefficient table.
//   Here: one thread per node, x fastest, three accumulators.  A thread
//   computes its own indices, tests 0 <= cz < nz (etc.) for each of its 8
//   cells, and reads its 27-node neighbourhood straight from global memory;
//   the 26 reloads of each value come from L1/L2.
//
// stencil_window  replaces _window_kernel (pallas_stencil.py:97), the
//                 z-blocked variant (NB planes per grid step).
//   Here: a block owns a tile of WIN_NB z-planes x WIN_TY x WIN_TX nodes,
//   one thread per node.  It first stages the tile of u with a one-node
//   halo, and the touching esc cells, in shared memory, then each thread
//   reads its neighbours from there.
//
//   Bound (both): memory.  The function reads u once and esc once and
//   writes y once: at 200x64x16 cells in float32, 2 * 666,315 * 4 B +
//   204,800 * 4 B = 6.15 MB, 1.8 us at 3.35 TB/s.  Its least arithmetic is
//   about 372 flops per cell through the six constant-gradient tets
//   (itemised in chip_smoke.py), 76 MFLOP, 1.1 us at 67 TFLOP/s float32
//   (2.2 us at 34 TFLOP/s float64, against 3.7 us of bytes).  These kernels
//   do not take the six-tet route: they apply Ke as 56 3x3 blocks per
//   node (8 cells x 7 neighbours), 1,008 multiply-adds per node, about
//   2,200 flops per cell, so their own arithmetic sits near 7 us in
//   float32: above the byte time.  A factorised form is later work.
//   Design: Ke in shared memory is read at warp-uniform addresses (a
//   broadcast, no bank conflict); the 27 x 3 neighbour differences are
//   formed once per node in registers and reused by all 8 cells; in the
//   window kernel a warp lies along x and reads the staged tile with a
//   stride of 3 values, which is coprime with the 32 banks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PLANE_THREADS = 128;
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

template <typename T>
__global__ void __launch_bounds__(PLANE_THREADS)
stencil_plane_kernel(const T* __restrict__ u, const T* __restrict__ esc,
                     const T* __restrict__ ke, T* __restrict__ y, int nx,
                     int ny, int nz) {
    __shared__ T ke_s[576];
    for (int i = threadIdx.x; i < 576; i += blockDim.x) ke_s[i] = ke[i];
    __syncthreads();

    const int NX = nx + 1, NY = ny + 1, NZ = nz + 1;
    const int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (n >= (int64_t)NX * NY * NZ) return;
    const int x = (int)(n % NX);
    const int y_ = (int)((n / NX) % NY);
    const int z = (int)(n / ((int64_t)NX * NY));

    T uc[3];
#pragma unroll
    for (int b = 0; b < 3; ++b) uc[b] = u[3 * n + b];
    T d[3][3][3][3];
#pragma unroll
    for (int dz = 0; dz < 3; ++dz)
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
            for (int dx = 0; dx < 3; ++dx) {
                const int zz = z + dz - 1, yy = y_ + dy - 1, xx = x + dx - 1;
                const bool in = zz >= 0 && zz < NZ && yy >= 0 && yy < NY &&
                                xx >= 0 && xx < NX;
                const int64_t m = ((int64_t)zz * NY + yy) * NX + xx;
#pragma unroll
                for (int b = 0; b < 3; ++b)
                    d[dz][dy][dx][b] = in ? u[3 * m + b] - uc[b] : T(0);
            }

    int64_t cell[8];
    const unsigned valid = cells_of_node(z, y_, x, nx, ny, nz, cell);
    T e[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
        e[j] = (esc != nullptr && (valid & (1u << j))) ? esc[cell[j]] : T(1);

    T acc[3];
    node_apply<T>(d, e, valid, ke_s, acc);
#pragma unroll
    for (int a = 0; a < 3; ++a) y[3 * n + a] = acc[a];
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

template <typename T>
int launch_plane(const void* u, const void* esc, const void* ke, void* y,
                 int nx, int ny, int nz, void* stream) {
    const long long nodes = (long long)(nx + 1) * (ny + 1) * (nz + 1);
    const long long blocks = (nodes + PLANE_THREADS - 1) / PLANE_THREADS;
    stencil_plane_kernel<T><<<(unsigned)blocks, PLANE_THREADS, 0,
                              (cudaStream_t)stream>>>(
        (const T*)u, (const T*)esc, (const T*)ke, (T*)y, nx, ny, nz);
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

// Plain C interface, bound with ctypes in ops/stencil.py.  u, ke and y are
// device pointers, esc a device pointer or null; nx, ny, nz count cells.
// Each entry point returns cudaGetLastError() after its launch.
extern "C" {

int stencil_plane_f32(const void* u, const void* esc, const void* ke, void* y,
                      int nx, int ny, int nz, void* stream) {
    return launch_plane<float>(u, esc, ke, y, nx, ny, nz, stream);
}

int stencil_plane_f64(const void* u, const void* esc, const void* ke, void* y,
                      int nx, int ny, int nz, void* stream) {
    return launch_plane<double>(u, esc, ke, y, nx, ny, nz, stream);
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
