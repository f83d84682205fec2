// Staged tiles, shared by the kernels that read a neighbour's state and
// flux in every slot (pk1_stream, pk2_stream, pk3_stream and the stacked
// pk1, pk2 and pk3).
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
// PK1 (pk1_stream and the stacked pk1): U and the parts of f(U), the rest
// of the Riemann precompute (a, 1/rho, 1/p, log2 p; its p is the flux's)
// and eta_j / rho_j
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

// Stage PK1's values of canvas cell gi as staged cell s: U, v, p and E + p
// as stage_state lays them out (p at value NC + DIM), then a, 1/rho, 1/p
// and log2 p at u_vals (the precompute's p and 1/rho are the flux's, the
// same expressions of the same operands) and eta_j / rho_j, the one IEEE
// division of the indicator, at u_vals + 4.
template <typename T, int DIM>
__device__ __forceinline__ void stage_pk1(const EqConsts<T>& e, const T* __restrict__ U,
                                          const T* __restrict__ prec, int64_t gi, int64_t n,
                                          T* sm, int ns, int s) {
  constexpr int NC = DIM + 2, PV = NC + DIM, AV = u_vals(DIM), QV = AV + 4;
  T u[NC], v[DIM], p, Ep, pa[5];
  load_state(U, gi, n, u);
  flux_parts(e, u, v, p, Ep);
  riemann_precompute(e, u, pa);
#pragma unroll
  for (int q = 0; q < NC; ++q) sm[q * ns + s] = u[q];
#pragma unroll
  for (int d = 0; d < DIM; ++d) sm[(NC + d) * ns + s] = v[d];
  sm[PV * ns + s] = p;
  sm[(PV + 1) * ns + s] = Ep;
#pragma unroll
  for (int r = 0; r < 4; ++r) sm[(AV + r) * ns + s] = pa[1 + r];
  sm[QV * ns + s] = prec[n + gi] / u[0];
}

// U of staged cell s, and its Riemann precompute (p, a, 1/rho, 1/p,
// log2 p) as stage_pk1 stages it.
template <typename T, int NC>
__device__ __forceinline__ void staged_u(const T* sm, int ns, int s, T (&u)[NC]) {
#pragma unroll
  for (int q = 0; q < NC; ++q) u[q] = sm[q * ns + s];
}

template <int DIM, typename T>
__device__ __forceinline__ void staged_pa(const T* sm, int ns, int s, T (&pa)[5]) {
  pa[0] = sm[(2 * DIM + 2) * ns + s];
#pragma unroll
  for (int r = 0; r < 4; ++r) pa[1 + r] = sm[(u_vals(DIM) + r) * ns + s];
}

// The indicator alpha of a cell from its sums over the slots, 0 where the
// node is not real (indicator_finalize; d_eta formed here, so that it
// holds no register through the slots).
template <typename T, int NC>
__device__ __forceinline__ T pk1_alpha(const EqConsts<T>& e, const T* __restrict__ node,
                                       int64_t i, int64_t n, const T (&ui)[NC], T eta_i,
                                       T rho_i_inv, T left, const T (&right)[NC]) {
  constexpr int DIM = NC - 2;
  T a = T(0);
  if (node[3 * n + i] > T(0)) {
    T d_eta[NC];
    const T rho_rho_e = ui[0] * ui[NC - 1] - T(0.5) * mdot(ui, ui);
    const T factor = e.inv_gp1 * pow(rho_rho_e, e.harten_deriv_exp);
    d_eta[0] = factor * ui[NC - 1] - eta_i * rho_i_inv;
#pragma unroll
    for (int d = 0; d < DIM; ++d) d_eta[1 + d] = -factor * ui[1 + d];
    d_eta[NC - 1] = factor * ui[0];
    T dot = T(0), dot_abs = T(0);
#pragma unroll
    for (int q = 0; q < NC; ++q) {
      dot += d_eta[q] * right[q];
      dot_abs += fabs(d_eta[q] * right[q]);
    }
    const T hd_i = node[i] * e.measure_inv;
    const T quotient = fabs(left - dot) / (fabs(left) + dot_abs + hd_i * fabs(eta_i));
    a = mn(T(1), e.evc_factor * quotient);
  }
  return a;
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
