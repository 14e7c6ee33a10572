// topopt_native — host-side native kernels for mesh preprocessing and the
// block-ELL hierarchy build.
//
// The port's own copy of the package's host library (same entry points,
// same arithmetic).  The device path is CUDA (csrc/*.cu); the host hot
// spots run here: hash-based surface-face counting (reference algorithm
// SelectNodesForBC.jl:59-91), element gradients, the deduplicated block
// values of a material, the scalar-P Galerkin RAP on a frozen pattern,
// and FTZ/DAZ control.  Every entry point has a NumPy/scipy fallback.
//
// Build: topopteval_tpu_torch/_build.py builds it at first use with
//   g++ -O3 -march=native -fPIC -shared -std=c++17
// into build/native/libtopopt_native-<hash>.so.
// Binding: ctypes (topopteval_tpu_torch/io/native.py)

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct FaceKey {
    uint32_t n[4];
    bool operator==(const FaceKey& o) const {
        return n[0] == o.n[0] && n[1] == o.n[1] && n[2] == o.n[2] &&
               n[3] == o.n[3];
    }
};

struct FaceKeyHash {
    size_t operator()(const FaceKey& k) const {
        // splitmix64-style mixing of the four node ids
        uint64_t h = 0x9e3779b97f4a7c15ull;
        for (int i = 0; i < 4; ++i) {
            uint64_t x = k.n[i] + 0x9e3779b97f4a7c15ull + h;
            x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ull;
            x = (x ^ (x >> 27)) * 0x94d049bb133111ebull;
            h = x ^ (x >> 31);
        }
        return static_cast<size_t>(h);
    }
};

inline FaceKey make_key(const int32_t* cell, const int32_t* face,
                        int32_t face_k) {
    uint32_t v[4] = {0xffffffffu, 0xffffffffu, 0xffffffffu, 0xffffffffu};
    for (int32_t j = 0; j < face_k; ++j)
        v[j] = static_cast<uint32_t>(cell[face[j]]);
    // sorting network for <=4 entries (canonical face representation,
    // same role as the reference's sorted tuples)
    if (v[0] > v[1]) std::swap(v[0], v[1]);
    if (v[2] > v[3]) std::swap(v[2], v[3]);
    if (v[0] > v[2]) std::swap(v[0], v[2]);
    if (v[1] > v[3]) std::swap(v[1], v[3]);
    if (v[1] > v[2]) std::swap(v[1], v[2]);
    return FaceKey{{v[0], v[1], v[2], v[3]}};
}

}  // namespace

extern "C" {

// Surface faces = faces referenced by exactly one cell.
// Writes flat indices (cell * n_faces + local_face) of surface faces to
// out_idx (capacity n_cells*n_faces); returns their count.
int64_t topopt_extract_surface_faces(const int32_t* conn, int64_t n_cells,
                                     int32_t nodes_per_cell,
                                     const int32_t* face_table,
                                     int32_t n_faces, int32_t face_k,
                                     int64_t* out_idx) {
    std::unordered_map<FaceKey, int64_t, FaceKeyHash> first;  // key -> flat
    first.reserve(static_cast<size_t>(n_cells) * n_faces * 2);
    // second occurrence flips the stored index negative (face is interior)
    for (int64_t c = 0; c < n_cells; ++c) {
        const int32_t* cell = conn + c * nodes_per_cell;
        for (int32_t f = 0; f < n_faces; ++f) {
            FaceKey key = make_key(cell, face_table + f * face_k, face_k);
            int64_t flat = c * n_faces + f;
            auto it = first.find(key);
            if (it == first.end())
                first.emplace(key, flat);
            else
                it->second = -1;  // seen >=2 times -> interior
        }
    }
    int64_t n_out = 0;
    for (const auto& kv : first)
        if (kv.second >= 0) out_idx[n_out++] = kv.second;
    std::sort(out_idx, out_idx + n_out);
    return n_out;
}

// Mark surface nodes: nodes[i]=1 for every node referenced by a surface
// face. Inputs are the flat surface-face indices from the call above.
void topopt_mark_face_nodes(const int32_t* conn, int32_t nodes_per_cell,
                            const int32_t* face_table, int32_t n_faces,
                            int32_t face_k, const int64_t* face_idx,
                            int64_t n_faces_out, uint8_t* node_mark) {
    for (int64_t i = 0; i < n_faces_out; ++i) {
        int64_t c = face_idx[i] / n_faces;
        int32_t f = static_cast<int32_t>(face_idx[i] % n_faces);
        const int32_t* cell = conn + c * nodes_per_cell;
        const int32_t* face = face_table + f * face_k;
        for (int32_t j = 0; j < face_k; ++j) node_mark[cell[face[j]]] = 1;
    }
}

// --------------------------------------------------------------------------
// Flush-to-zero / denormals-are-zero control (MXCSR).  The SIMP value
// pass multiplies element blocks by densities down to Emin=1e-8; the
// Galerkin RAP chain can then spend most of its time in hardware
// denormal assists unless FTZ is on.  MXCSR is per thread: this sets the
// calling thread's only.  Returns the previous MXCSR so callers can
// restore it.
#include <xmmintrin.h>

uint32_t topopt_set_ftz(int32_t enable) {
    uint32_t prev = _mm_getcsr();
    const uint32_t FTZ = 1u << 15, DAZ = 1u << 6;
    if (enable)
        _mm_setcsr(prev | FTZ | DAZ);
    else
        _mm_setcsr(prev & ~(FTZ | DAZ));
    return prev;
}

void topopt_restore_csr(uint32_t csr) { _mm_setcsr(csr); }

// --------------------------------------------------------------------------
// Unit element-stiffness contribution planes, component-major.
//
// For isotropic elasticity the Lame parameters enter Ke linearly
// (reference constitutive law FiniteElementAnalysis.jl:126-129):
//   Ke = lam_e * kl + mu_e * km.
// This fills the component-major contribution matrix
//   out[(a*3+b)      * ld + c*k*k + i*k + j] = kl[c,i,j,a,b]
//   out[(9 + a*3+b)  * ld + c*k*k + i*k + j] = km[c,i,j,a,b]
// exactly mirroring fem/bell._host_ke_blocks_unit's einsum chain
// (numpy fallback).
//
// coords: [n_nodes, 3] float64; conn: [n_cells, k] int32;
// dn: [nqp, k, 3] reference shape-function gradients; w: [nqp] weights.
// Padded ghost cells (detJ == 0) mirror the numpy path: J is replaced by
// the identity for inversion and wdet stays 0, so they are inert.
// dest: optional [n_cells*k*k] map from raw contribution index to its
// final (sorted, deduplicated-group) column — folding the downstream
// gather into the write pass, so the raw-order matrix, its gather and
// its copy never touch their pages.  NULL keeps raw order.
void topopt_unit_ke_cm_dest(const double* coords, const int32_t* conn,
                            int64_t n_cells, int32_t k,
                            const double* dn, const double* w, int32_t nqp,
                            double* out, int64_t ld, const int32_t* dest) {
    const int32_t kk = k * k;
    std::vector<double> g(static_cast<size_t>(k) * 3);
    for (int64_t c = 0; c < n_cells; ++c) {
        const int32_t* cell = conn + c * k;
        const int64_t base = c * kk;
        for (int32_t q = 0; q < nqp; ++q) {
            const double* dq = dn + static_cast<int64_t>(q) * k * 3;
            // J[a][b] = sum_k x[k][a] * dn[k][b]
            double J[3][3] = {{0, 0, 0}, {0, 0, 0}, {0, 0, 0}};
            for (int32_t kk_ = 0; kk_ < k; ++kk_) {
                const double* x = coords + 3 * static_cast<int64_t>(cell[kk_]);
                const double* d = dq + 3 * kk_;
                for (int a = 0; a < 3; ++a)
                    for (int b = 0; b < 3; ++b) J[a][b] += x[a] * d[b];
            }
            double A = J[1][1] * J[2][2] - J[1][2] * J[2][1];
            double B = J[0][2] * J[2][1] - J[0][1] * J[2][2];
            double Cc = J[0][1] * J[1][2] - J[0][2] * J[1][1];
            double det = J[0][0] * A + J[1][0] * B + J[2][0] * Cc;
            double Ji[3][3];
            if (det == 0.0) {
                // ghost cell: identity J for inversion, zero weight
                Ji[0][0] = Ji[1][1] = Ji[2][2] = 1.0;
                Ji[0][1] = Ji[0][2] = Ji[1][0] = 0.0;
                Ji[1][2] = Ji[2][0] = Ji[2][1] = 0.0;
            } else {
                double inv = 1.0 / det;
                Ji[0][0] = A * inv;
                Ji[0][1] = B * inv;
                Ji[0][2] = Cc * inv;
                Ji[1][0] = (J[1][2] * J[2][0] - J[1][0] * J[2][2]) * inv;
                Ji[1][1] = (J[0][0] * J[2][2] - J[0][2] * J[2][0]) * inv;
                Ji[1][2] = (J[0][2] * J[1][0] - J[0][0] * J[1][2]) * inv;
                Ji[2][0] = (J[1][0] * J[2][1] - J[1][1] * J[2][0]) * inv;
                Ji[2][1] = (J[0][1] * J[2][0] - J[0][0] * J[2][1]) * inv;
                Ji[2][2] = (J[0][0] * J[1][1] - J[0][1] * J[1][0]) * inv;
            }
            // g[k][a] = sum_b dn[k][b] * Ji[b][a]
            for (int32_t kk_ = 0; kk_ < k; ++kk_) {
                const double* d = dq + 3 * kk_;
                for (int a = 0; a < 3; ++a)
                    g[kk_ * 3 + a] = d[0] * Ji[0][a] + d[1] * Ji[1][a] +
                                     d[2] * Ji[2][a];
            }
            const double wdet = det * w[q];
            for (int32_t i = 0; i < k; ++i) {
                const double* gi = &g[i * 3];
                for (int32_t j = 0; j < k; ++j) {
                    const double* gj = &g[j * 3];
                    const int64_t raw = base + i * k + j;
                    const int64_t col = dest ? dest[raw] : raw;
                    const double dot =
                        wdet * (gi[0] * gj[0] + gi[1] * gj[1] + gi[2] * gj[2]);
                    for (int a = 0; a < 3; ++a) {
                        for (int b = 0; b < 3; ++b) {
                            const int comp = a * 3 + b;
                            double kl = wdet * gi[a] * gj[b];
                            double km = wdet * gi[b] * gj[a];
                            if (a == b) km += dot;
                            if (q == 0) {
                                out[comp * ld + col] = kl;
                                out[(9 + comp) * ld + col] = km;
                            } else {
                                out[comp * ld + col] += kl;
                                out[(9 + comp) * ld + col] += km;
                            }
                        }
                    }
                }
            }
        }
    }
}

// --------------------------------------------------------------------------
// Scalar-P Galerkin block RAP on a FROZEN coarse pattern.
//
// Computes Ac = P^T A P where A is 3x3-block BSR (data as 9 doubles per
// block, row-major blocks) and P is a SCALAR CSR (trilinear voxel
// weights; P_dof = kron(P, I3), so the block product reduces to
// scalar-weighted block sums — scipy's generic bsr@bsr spends 3x the
// flops plus symbolic work; this is the density-swap hot loop,
// fem/bell.build_bell_values rap_chain).  Output blocks land in the
// skeleton's frozen pattern (out_indptr/out_indices, sorted cols).
// Returns 0 on success, 1 if the numeric product produced a column
// outside the frozen pattern (SkeletonMismatch in the caller).
int32_t topopt_bsr_rap_scalar(
    int64_t n_f, int64_t n_c,
    const int64_t* A_indptr, const int32_t* A_indices, const double* A_data,
    const int64_t* P_indptr, const int32_t* P_indices, const double* P_w,
    const int64_t* PT_indptr, const int32_t* PT_indices, const double* PT_w,
    const int64_t* out_indptr, const int32_t* out_indices,
    double* out_data) {
    // phase 1: B = A @ P  (block rows, scalar cols), Gustavson with a
    // dense marker over the n_c coarse columns.  Workspaces are
    // thread_local and only ever grow, so the B buffers are not faulted
    // in afresh for every level of every density swap.
    static thread_local std::vector<int64_t> B_indptr;
    static thread_local std::vector<int32_t> B_indices;
    static thread_local std::vector<double> B_data;
    static thread_local std::vector<int64_t> marker;
    static thread_local std::vector<double> acc;
    B_indptr.assign(n_f + 1, 0);
    if (static_cast<int64_t>(marker.size()) < n_c) marker.resize(n_c);
    std::fill(marker.begin(), marker.begin() + n_c, int64_t{-1});
    if (static_cast<int64_t>(acc.size()) < n_c * 9) acc.resize(n_c * 9);
    std::vector<int32_t> cols_row;
    cols_row.reserve(256);
    // symbolic pass: exact nnz(B) so the value buffers are sized once
    int64_t nnzB = 0;
    for (int64_t i = 0; i < n_f; ++i) {
        for (int64_t p = A_indptr[i]; p < A_indptr[i + 1]; ++p) {
            const int32_t j = A_indices[p];
            for (int64_t t = P_indptr[j]; t < P_indptr[j + 1]; ++t) {
                const int32_t J = P_indices[t];
                if (marker[J] != i) {
                    marker[J] = i;
                    ++nnzB;
                }
            }
        }
        B_indptr[i + 1] = nnzB;
    }
    if (static_cast<int64_t>(B_indices.size()) < nnzB)
        B_indices.resize(nnzB);
    if (static_cast<int64_t>(B_data.size()) < nnzB * 9)
        B_data.resize(nnzB * 9);
    std::fill(marker.begin(), marker.begin() + n_c, int64_t{-1});
    for (int64_t i = 0; i < n_f; ++i) {
        cols_row.clear();
        for (int64_t p = A_indptr[i]; p < A_indptr[i + 1]; ++p) {
            const int32_t j = A_indices[p];
            const double* a9 = A_data + p * 9;
            for (int64_t t = P_indptr[j]; t < P_indptr[j + 1]; ++t) {
                const int32_t J = P_indices[t];
                const double wv = P_w[t];
                double* dst = &acc[static_cast<size_t>(J) * 9];
                if (marker[J] != i) {
                    marker[J] = i;
                    cols_row.push_back(J);
                    for (int m = 0; m < 9; ++m) dst[m] = wv * a9[m];
                } else {
                    for (int m = 0; m < 9; ++m) dst[m] += wv * a9[m];
                }
            }
        }
        std::sort(cols_row.begin(), cols_row.end());
        int64_t o = B_indptr[i];
        for (int32_t J : cols_row) {
            B_indices[o] = J;
            const double* src = &acc[static_cast<size_t>(J) * 9];
            double* dst = &B_data[static_cast<size_t>(o) * 9];
            for (int m = 0; m < 9; ++m) dst[m] = src[m];
            ++o;
        }
    }
    // phase 2: Ac = PT @ B into the frozen pattern
    std::fill(marker.begin(), marker.end(), -1);
    for (int64_t I = 0; I < n_c; ++I) {
        cols_row.clear();
        for (int64_t t = PT_indptr[I]; t < PT_indptr[I + 1]; ++t) {
            const int32_t i = PT_indices[t];
            const double wv = PT_w[t];
            for (int64_t p = B_indptr[i]; p < B_indptr[i + 1]; ++p) {
                const int32_t J = B_indices[p];
                const double* b9 = &B_data[static_cast<size_t>(p) * 9];
                double* dst = &acc[static_cast<size_t>(J) * 9];
                if (marker[J] != I) {
                    marker[J] = I;
                    cols_row.push_back(J);
                    for (int m = 0; m < 9; ++m) dst[m] = wv * b9[m];
                } else {
                    for (int m = 0; m < 9; ++m) dst[m] += wv * b9[m];
                }
            }
        }
        // scatter into the frozen (sorted) pattern row; produced cols
        // must be a subset of the frozen cols
        const int64_t o0 = out_indptr[I], o1 = out_indptr[I + 1];
        for (int64_t o = o0; o < o1; ++o) {
            const int32_t J = out_indices[o];
            double* dst = out_data + o * 9;
            if (marker[J] == I) {
                const double* src = &acc[static_cast<size_t>(J) * 9];
                for (int m = 0; m < 9; ++m) dst[m] = src[m];
                marker[J] = -2 - I;  // consumed
            } else {
                for (int m = 0; m < 9; ++m) dst[m] = 0.0;
            }
        }
        for (int32_t J : cols_row)
            if (marker[J] == I) return 1;  // produced col not in pattern
    }
    return 0;
}

// --------------------------------------------------------------------------
// Gradient-factorized element data: physical shape-function gradients
// g[c, q, k, a] and quadrature weights wdet[c, q] per element.
//
// For isotropic elasticity every contribution block factorizes as
//   Kl[i,j](a,b) = sum_q wdet_q * g_qi[a] * g_qj[b]
//   Km[i,j](a,b) = sum_q wdet_q * (g_qi[b] * g_qj[a] + (a==b) g_qi.g_qj)
// (reference constitutive law FiniteElementAnalysis.jl:126-129), so the
// skeleton needs only g/wdet (~130 MB at 1.23M tets) instead of the
// per-contribution Kl/Km planes (2.8 GB).
// Ghost cells (detJ == 0) keep wdet = 0 and are inert.
void topopt_element_gradients(const double* coords, const int32_t* conn,
                              int64_t n_cells, int32_t k,
                              const double* dn, const double* w, int32_t nqp,
                              double* g_out, double* wdet_out) {
    for (int64_t c = 0; c < n_cells; ++c) {
        const int32_t* cell = conn + c * k;
        for (int32_t q = 0; q < nqp; ++q) {
            const double* dq = dn + static_cast<int64_t>(q) * k * 3;
            double J[3][3] = {{0, 0, 0}, {0, 0, 0}, {0, 0, 0}};
            for (int32_t kk_ = 0; kk_ < k; ++kk_) {
                const double* x = coords + 3 * static_cast<int64_t>(cell[kk_]);
                const double* d = dq + 3 * kk_;
                for (int a = 0; a < 3; ++a)
                    for (int b = 0; b < 3; ++b) J[a][b] += x[a] * d[b];
            }
            double A = J[1][1] * J[2][2] - J[1][2] * J[2][1];
            double B = J[0][2] * J[2][1] - J[0][1] * J[2][2];
            double Cc = J[0][1] * J[1][2] - J[0][2] * J[1][1];
            double det = J[0][0] * A + J[1][0] * B + J[2][0] * Cc;
            double Ji[3][3];
            if (det == 0.0) {
                Ji[0][0] = Ji[1][1] = Ji[2][2] = 1.0;
                Ji[0][1] = Ji[0][2] = Ji[1][0] = 0.0;
                Ji[1][2] = Ji[2][0] = Ji[2][1] = 0.0;
            } else {
                double inv = 1.0 / det;
                Ji[0][0] = A * inv;
                Ji[0][1] = B * inv;
                Ji[0][2] = Cc * inv;
                Ji[1][0] = (J[1][2] * J[2][0] - J[1][0] * J[2][2]) * inv;
                Ji[1][1] = (J[0][0] * J[2][2] - J[0][2] * J[2][0]) * inv;
                Ji[1][2] = (J[0][2] * J[1][0] - J[0][0] * J[1][2]) * inv;
                Ji[2][0] = (J[1][0] * J[2][1] - J[1][1] * J[2][0]) * inv;
                Ji[2][1] = (J[0][1] * J[2][0] - J[0][0] * J[2][1]) * inv;
                Ji[2][2] = (J[0][0] * J[1][1] - J[0][1] * J[1][0]) * inv;
            }
            double* gq = g_out + ((c * nqp + q) * k) * 3;
            for (int32_t kk_ = 0; kk_ < k; ++kk_) {
                const double* d = dq + 3 * kk_;
                for (int a = 0; a < 3; ++a)
                    gq[kk_ * 3 + a] = d[0] * Ji[0][a] + d[1] * Ji[1][a] +
                                      d[2] * Ji[2][a];
            }
            wdet_out[c * nqp + q] = det * w[q];
        }
    }
}

// --------------------------------------------------------------------------
// Global block values from gradient-factorized element data.
//
// For each deduplicated block b, sums its contributions
// t in [indptr[b], indptr[b+1]) with per-element material:
//   blocks[b] += lam[e_t] * Kl(i_t, j_t) + mu[e_t] * Km(i_t, j_t)
// where (i, j) = (ij_t / k, ij_t % k).  Output is node-major [nnzb, 9]
// (row-major 3x3 blocks) — the layout build_bell_values consumes, so no
// transpose pass exists.  This replaces the Rl/Rm contribution-CSR
// matvecs (scipy) whose index+data traffic was ~4.2 GB per density swap.
void topopt_blocks_from_g(const double* g, const double* wdet, int32_t nqp,
                          int32_t k, const int32_t* elem,
                          const uint16_t* ij, const int64_t* indptr,
                          int64_t nnzb, const double* lam, const double* mu,
                          double* blocks) {
    for (int64_t b = 0; b < nnzb; ++b) {
        double acc[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
        for (int64_t t = indptr[b]; t < indptr[b + 1]; ++t) {
            const int64_t e = elem[t];
            const int32_t i = ij[t] / k, j = ij[t] % k;
            const double le = lam[e], me = mu[e];
            const double* ge = g + (e * nqp) * k * 3;
            const double* we = wdet + e * nqp;
            for (int32_t q = 0; q < nqp; ++q) {
                const double* gi = ge + (q * k + i) * 3;
                const double* gj = ge + (q * k + j) * 3;
                const double wd = we[q];
                const double dot =
                    wd * (gi[0] * gj[0] + gi[1] * gj[1] + gi[2] * gj[2]);
                for (int a = 0; a < 3; ++a)
                    for (int bb = 0; bb < 3; ++bb) {
                        double v = le * wd * gi[a] * gj[bb] +
                                   me * wd * gi[bb] * gj[a];
                        if (a == bb) v += me * dot;
                        acc[a * 3 + bb] += v;
                    }
            }
        }
        for (int m = 0; m < 9; ++m) blocks[b * 9 + m] = acc[m];
    }
}

// Back-compat entry without the dest map.
void topopt_unit_ke_cm(const double* coords, const int32_t* conn,
                       int64_t n_cells, int32_t k,
                       const double* dn, const double* w, int32_t nqp,
                       double* out, int64_t ld) {
    topopt_unit_ke_cm_dest(coords, conn, n_cells, k, dn, w, nqp, out, ld,
                           nullptr);
}

int topopt_version() { return 4; }

}  // extern "C"
