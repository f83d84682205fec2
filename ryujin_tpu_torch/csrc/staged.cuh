// Staged tiles, shared by the kernels that read a neighbour's state and
// flux in every slot (pk1_stream, pk2_stream, pk3_stream and the stacked
// pk2 and pk3).
//
// A block owns a tile of cells, TILE_TX along x and a few rows along y (in
// 3D at one or a few z), and first stages, for the tile and its halo of
// the lattice reach h, what a slot reads at its neighbour j: one shared
// array per value, cells along x, ns cells a window.  A state is staged
// as U (rho, m_1 .. m_dim, E) and the parts of its flux: v = m (1/rho),
// p and E + p, the operands `flux` (euler.cuh) forms every entry from, so
// the flux of a staged cell is rebuilt bit for bit with multiplies and no
// division, and each flux is formed once per staged cell, not once per
// slot.  A stage state is staged as the parts of its flux alone (m, v, p,
// E + p).
//
// Staged cells wrap on every axis of the canvas with a full modulo: where
// an output cell reads them, at most the reach past the canvas edge, that
// is nbr_k's single wrap; a ragged or narrow tile wraps further, and only
// cells no output reads lie past a single wrap.
#pragma once

#include "statics.cuh"

namespace ryujin {

constexpr int TILE_TX = 32;  // cells of a tile row; mirrored by the wrappers' tile()

// Values a staged cell holds: U and the parts of f(U); the parts of the
// flux of a stage state.
__host__ __device__ constexpr int u_vals(int dim) { return 2 * dim + 4; }
__host__ __device__ constexpr int stage_vals(int dim) { return 2 * dim + 2; }
// PK3 (pk3_stream and the stacked pk3) also stages F, m_j and alpha_j
__host__ __device__ constexpr int pk3_vals(int dim, int stages) {
  return u_vals(dim) + stages * stage_vals(dim) + dim + 4;
}

// PK2 (pk2_stream and the stacked pk2): U and the parts of f(U), alpha_j,
// s_j, then the parts of f(sU_s) of each stage
__host__ __device__ constexpr int pk2_vals(int dim, int stages) {
  return u_vals(dim) + 2 + stages * stage_vals(dim);
}
// PK1 (pk1_stream): U and the parts of f(U), the rest of the Riemann
// precompute (a, 1/rho, 1/p, log2 p; its p is the flux's) and eta_j / rho_j
__host__ __device__ constexpr int pk1_vals(int dim) { return u_vals(dim) + 5; }

// The parts of the flux of u as flux() forms them: v = m (1/rho), p and
// E + p.
template <typename T, int NC>
__device__ __forceinline__ void flux_parts(const EqConsts<T>& e, const T (&u)[NC], T (&v)[NC - 2],
                                           T& p, T& Ep) {
  const T rho_inv = T(1) / u[0];
  p = e.gm1 * internal_energy(u);
#pragma unroll
  for (int d = 0; d < NC - 2; ++d) v[d] = u[1 + d] * rho_inv;
  Ep = u[NC - 1] + p;
}

// The flux tensor from its parts, entry by entry as flux() forms it.
template <typename T, int DIM>
__device__ __forceinline__ void flux_from_parts(const T (&m)[DIM], const T (&v)[DIM], T p, T Ep,
                                                T (&f)[DIM + 2][DIM]) {
#pragma unroll
  for (int d = 0; d < DIM; ++d) f[0][d] = m[d];
#pragma unroll
  for (int a = 0; a < DIM; ++a) {
#pragma unroll
    for (int b = 0; b < DIM; ++b) f[1 + a][b] = a == b ? m[a] * v[b] + p : m[a] * v[b];
  }
#pragma unroll
  for (int d = 0; d < DIM; ++d) f[DIM + 1][d] = v[d] * Ep;
}

// The flux of the state whose parts begin at value `at` of staged cell s
// (m first, as a stage's parts lie), or, with m given, of U's parts.
template <typename T, int DIM>
__device__ __forceinline__ void staged_flux(const T* sm, int ns, int at, int s,
                                            const T (&m)[DIM], T (&f)[DIM + 2][DIM]) {
  T v[DIM];
#pragma unroll
  for (int d = 0; d < DIM; ++d) v[d] = sm[(at + d) * ns + s];
  flux_from_parts(m, v, sm[(at + DIM) * ns + s], sm[(at + DIM + 1) * ns + s], f);
}

template <typename T, int DIM>
__device__ __forceinline__ void staged_stage_flux(const T* sm, int ns, int at, int s,
                                                  T (&f)[DIM + 2][DIM]) {
  T m[DIM];
#pragma unroll
  for (int d = 0; d < DIM; ++d) m[d] = sm[(at + d) * ns + s];
  staged_flux(sm, ns, at + DIM, s, m, f);
}

__device__ __forceinline__ int wrap_any(int v, int N) { return ((v % N) + N) % N; }

// The flat canvas index of staged cell s of the window SX wide and SY high
// whose first cell is (x0 - h, y0 - h, z0 - h), wrapped on every axis.
template <int DIM, typename T>
__device__ __forceinline__ int64_t staged_cell(const EqConsts<T>& e, int x0, int y0, int z0, int h,
                                               int SX, int SY, int s) {
  const int sx = s % SX, sy = (s / SX) % SY, sz = s / (SX * SY);
  const int xg = wrap_any(x0 - h + sx, e.W), yg = wrap_any(y0 - h + sy, e.H);
  const int zg = DIM == 3 ? wrap_any(z0 - h + sz, e.D) : 0;
  return (int64_t(zg) * e.H + yg) * e.W + xg;
}

// Stage U at canvas cell gi and the parts of its flux as values 0 ..
// u_vals - 1 of staged cell s.
template <typename T, int DIM>
__device__ __forceinline__ void stage_state(const EqConsts<T>& e, const T* __restrict__ U,
                                            int64_t gi, int64_t n, T* sm, int ns, int s) {
  constexpr int NC = DIM + 2;
  T u[NC], v[DIM], p, Ep;
  load_state(U, gi, n, u);
  flux_parts(e, u, v, p, Ep);
#pragma unroll
  for (int q = 0; q < NC; ++q) sm[q * ns + s] = u[q];
#pragma unroll
  for (int d = 0; d < DIM; ++d) sm[(NC + d) * ns + s] = v[d];
  sm[(NC + DIM) * ns + s] = p;
  sm[(NC + DIM + 1) * ns + s] = Ep;
}

// Stage the parts of the flux of the stage state sUs at gi as values at
// .. at + stage_vals - 1 of staged cell s.
template <typename T, int DIM>
__device__ __forceinline__ void stage_stage(const EqConsts<T>& e, const T* __restrict__ sUs,
                                            int64_t gi, int64_t n, T* sm, int ns, int s, int at) {
  constexpr int NC = DIM + 2;
  T u[NC], v[DIM], p, Ep;
  load_state(sUs, gi, n, u);
  flux_parts(e, u, v, p, Ep);
#pragma unroll
  for (int d = 0; d < DIM; ++d) {
    sm[(at + d) * ns + s] = u[1 + d];
    sm[(at + DIM + d) * ns + s] = v[d];
  }
  sm[(at + 2 * DIM) * ns + s] = p;
  sm[(at + 2 * DIM + 1) * ns + s] = Ep;
}

// The reach of the launch's lattice: the largest |offset| on any axis.
inline int lattice_reach(const Consts* c) {
  int reach = 0;
  for (int k = 0; k < c->K; ++k) {
    const int a[3] = {c->dz[k], c->dy[k], c->dx[k]};
    for (int v : a) reach = v > reach ? v : (-v > reach ? -v : reach);
  }
  return reach;
}

// Set a kernel's dynamic shared memory above the default 48 KB where its
// tile needs it.
template <typename F>
inline int allow_smem(F kernel, int smem) {
  if (smem <= 48 * 1024) return int(cudaSuccess);
  return int(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

}  // namespace ryujin
