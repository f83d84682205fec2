// PK2: low-order update U_low, high-order right-hand side F and the
// limiter bounds [rho_min, rho_max, s_min].
//
// Replaces: the Pallas kernel `pk2` of PallasStepper.step
// (ryujin_tpu/solver/pallas_step.py:2841-2871), which rebuilds d from the
// lambda window (_d_win_sym, :1500) and runs hyperbolic.phase_low_order
// per 8-row tile.
//
// Bound on an H100: memory traffic.  Per cell: c_ij (16 planes), mask (8),
// cmax (8), c_ii (2), node, U (4), prec (2), lambda (4), alpha and up to
// two stage states (4 each), with the neighbour reads of U, prec, lambda,
// alpha and the stages; writes U_low (4), F (4) and bounds (3).  The one
// transcendental per live edge (rho^gamma in the interpolated entropy)
// does not change that.
//
// Design: one thread per canvas cell, 128 threads along x.  d_k =
// cmax_k * lambda, where lambda is plane k at the cell for k < 4 and
// plane 7-k at neighbour k for k >= 4 (one Riemann solve per undirected
// edge).  tau is read from device memory (no host sync); the stage
// weights are static and come by value.  Masked slots are skipped, which
// equals the reference's multiplication by a zero mask on finite data.
//
// dG (DG = true; the TPU kernel takes it through phase_low_order,
// hyperbolic.py:924-928): the factor of d_H is max(1/2 (alpha_i +
// alpha_j), beta_ij), beta read from the K incidence planes `inc`.  The
// flag is a template parameter, so the cG instance reads no incidence
// plane and compiles as before.
#include "euler.cuh"

namespace ryujin {

template <typename T, bool DG>
__global__ void __launch_bounds__(128)
pk2_kernel(const T* __restrict__ cij, const T* __restrict__ mask, const T* __restrict__ inc,
           const T* __restrict__ cmax,
           const T* __restrict__ cii, const T* __restrict__ node, const T* __restrict__ U,
           const T* __restrict__ prec, const T* __restrict__ lam, const T* __restrict__ alpha,
           const T* __restrict__ sU, const T* __restrict__ tau_ptr, T* __restrict__ U_low,
           T* __restrict__ F_out, T* __restrict__ bounds, const EqConsts<T> e) {
  Cell c;
  if (!this_cell(e.H, e.W, c)) return;
  const int64_t i = c.i, n = c.n;
  const int S = e.n_stages;
  const T w_s[2] = {e.w0, e.w1};

  T ui[C];
  load_state(U, i, n, ui);
  const T s_i = prec[i];
  const T alpha_i = alpha[i];
  const T tau = *tau_ptr;

  T fi[C][2];
  flux(e, ui, fi);
  const T cii0 = cii[i], cii1 = cii[n + i];
  T flux_ii[C];
#pragma unroll
  for (int q = 0; q < C; ++q) flux_ii[q] = flux_div(fi, fi, q, cii0, cii1);

  T fs_i[2][C][2];
  T stage_F[2][C];
  for (int s = 0; s < S; ++s) {
    T us[C];
    load_state(sU + s * C * n, i, n, us);
    flux(e, us, fs_i[s]);
#pragma unroll
    for (int q = 0; q < C; ++q) stage_F[s][q] = T(0);
  }

  T low_acc[C] = {T(0), T(0), T(0), T(0)};
  T F_acc[C] = {T(0), T(0), T(0), T(0)};
  T rho_min = ui[0], rho_max = ui[0], s_min = s_i, s_interp_max = s_i;
  T relax_num = T(0), k_count = T(0);

#pragma unroll
  for (int k = 0; k < K; ++k) {
    const T mk = mask[k * n + i];
    if (!(mk > T(0))) continue;
    const int64_t j = nbr(c, k, e.H, e.W);
    const T lam_k = k < K2 ? lam[k * n + i] : lam[(K - 1 - k) * n + j];
    const T d = lam_k * cmax[k * n + i];
    const T c0 = cij[k * n + i], c1 = cij[(K + k) * n + i];
    T uj[C];
    load_state(U, j, n, uj);
    T fj[C][2];
    flux(e, uj, fj);
    T factor = T(0.5) * (alpha_i + alpha[j]);
    if constexpr (DG) factor = mx(factor, inc[k * n + i]);
    const T d_H = d * factor;
#pragma unroll
    for (int q = 0; q < C; ++q) {
      const T flux_ij = flux_div(fi, fj, q, c0, c1);
      const T dU = uj[q] - ui[q];
      low_acc[q] += flux_ij + d * dU;
      F_acc[q] += d_H * dU + e.weight * flux_ij;
    }
    for (int s = 0; s < S; ++s) {
      T usj[C], fsj[C][2];
      load_state(sU + s * C * n, j, n, usj);
      flux(e, usj, fsj);
#pragma unroll
      for (int q = 0; q < C; ++q) stage_F[s][q] += flux_div(fs_i[s], fsj, q, c0, c1);
    }

    // limiter bounds (euler/limiter.h:255-363)
    const T dr = mx(d, e.reg);
    const T sc0 = c0 / dr, sc1 = c1 / dr;
    const T rho_bar = T(0.5) * (ui[0] + uj[0] + ((ui[1] - uj[1]) * sc0 + (ui[2] - uj[2]) * sc1));
    rho_min = mn(rho_min, rho_bar);
    rho_max = mx(rho_max, rho_bar);
    s_min = mn(s_min, prec[j]);
    relax_num += (ui[0] + uj[0]) * mk;
    k_count += mk;
    T u_half[C];
#pragma unroll
    for (int q = 0; q < C; ++q) u_half[q] = T(0.5) * (ui[q] + uj[q]);
    s_interp_max = mx(s_interp_max, specific_entropy(e, u_half));
  }

  const T m_inv = node[n + i];
  T F[C];
#pragma unroll
  for (int q = 0; q < C; ++q) {
    U_low[q * n + i] = ui[q] + (tau * m_inv) * (low_acc[q] + flux_ii[q]);
    F[q] = F_acc[q] + e.weight * flux_ii[q];
  }
  if (S > 0) {
    T inc[C];
    for (int s = 0; s < S; ++s) {
      const T cs0 = cii0, cs1 = cii1;
#pragma unroll
      for (int q = 0; q < C; ++q) {
        const T v = w_s[s] * (stage_F[s][q] + flux_div(fs_i[s], fs_i[s], q, cs0, cs1));
        inc[q] = s == 0 ? v : inc[q] + v;
      }
    }
#pragma unroll
    for (int q = 0; q < C; ++q) F[q] = F[q] + inc[q];
  }
#pragma unroll
  for (int q = 0; q < C; ++q) F_out[q * n + i] = F[q];

  // relaxation (limiter.h:330-363)
  const T hd_i = node[i] * e.measure_inv;
  const T sq = sqrt(sqrt(hd_i));
  const T r_i = sq * sq * sq * e.relax_factor;
  const T rho_relaxation = fabs(relax_num + T(2) * ui[0]) / (fabs(k_count + T(1)) + e.eps);
  const T relaxation = e.two_relax_factor * rho_relaxation;
  rho_min = mx((T(1) - r_i) * rho_min, rho_min - relaxation);
  rho_max = mn((T(1) + r_i) * rho_max, rho_max + relaxation);
  const T entropy_relaxation = e.relax_factor * (s_interp_max - s_min);
  s_min = mx((T(1) - r_i) * s_min, s_min - entropy_relaxation);
  bounds[i] = rho_min;
  bounds[n + i] = rho_max;
  bounds[2 * n + i] = s_min;
}

template <typename T>
int launch_pk2(const T* cij, const T* mask, const T* inc, const T* cmax, const T* cii,
               const T* node, const T* U, const T* prec, const T* lam, const T* alpha,
               const T* sU, const T* tau, T* U_low, T* F, T* bounds, const Consts* consts,
               cudaStream_t stream) {
  const EqConsts<T> e = EqConsts<T>::make(*consts);
  const dim3 grid = canvas_grid(e.H, e.W), block = canvas_block();
  if (inc)
    pk2_kernel<T, true><<<grid, block, 0, stream>>>(
        cij, mask, inc, cmax, cii, node, U, prec, lam, alpha, sU, tau, U_low, F, bounds, e);
  else
    pk2_kernel<T, false><<<grid, block, 0, stream>>>(
        cij, mask, inc, cmax, cii, node, U, prec, lam, alpha, sU, tau, U_low, F, bounds, e);
  return int(cudaGetLastError());
}

}  // namespace ryujin

#define RYUJIN_PK2(SUFFIX, T)                                                                  \
  extern "C" int ryujin_pk2_##SUFFIX(const void* cij, const void* mask, const void* inc,       \
                                     const void* cmax, const void* cii, const void* node,       \
                                     const void* U, const void* prec, const void* lam,          \
                                     const void* alpha, const void* sU, const void* tau,        \
                                     void* U_low, void* F, void* bounds,                        \
                                     const ryujin::Consts* consts, void* stream) {             \
    return ryujin::launch_pk2<T>((const T*)cij, (const T*)mask, (const T*)inc, (const T*)cmax,  \
                                 (const T*)cii, (const T*)node, (const T*)U, (const T*)prec,    \
                                 (const T*)lam, (const T*)alpha, (const T*)sU, (const T*)tau,   \
                                 (T*)U_low, (T*)F, (T*)bounds, consts, (cudaStream_t)stream);   \
  }

RYUJIN_PK2(f32, float)
RYUJIN_PK2(f64, double)
