// PK2, slot-streaming form: low-order update U_low, high-order right-hand
// side F and the limiter bounds [rho_min, rho_max, s_min], for a canvas of
// any lattice reach, from the pre-scaled half-slot wavespeeds e of PK1.
//
// Replaces: the Pallas kernel `pk2_stream` of PallasStepper.step with
// prescale (ryujin_tpu/solver/pallas_step.py:2879-2980), which folds one
// lattice offset at a time into running sums and running bounds.
//
// Bound on an H100: memory traffic.  At K = 24: c_ij (48 planes), mask
// (24), c_ii (2), node, U (4), prec (2), e (12), alpha and up to two stage
// states (4 each), with the neighbour reads of U, prec, e, alpha and the
// stages; writes U_low (4), F (4) and bounds (3).  cmax is not read: the
// graph viscosity of slot k is e_k at the cell for k < K/2 and plane
// K-1-k of neighbour k otherwise.
//
// Design: one thread per canvas cell, 128 threads along x; K and the
// offsets come with the launch and the loop over k is not unrolled.  The
// thread carries only running accumulators: the low-order and F sums
// (2 x 4) and the six bound accumulators of limiter_bounds_accum, seeded
// with the diagonal terms.  Masked slots are skipped, which equals the
// reference's multiplication by a zero mask on finite data.  tau is read
// from device memory (no host sync).  Every sum runs over k = 0 .. K-1 in
// order and adds the diagonal last, as pk2_stream_reference does.
#include "euler.cuh"

namespace ryujin {

template <typename T>
__global__ void __launch_bounds__(128)
pk2_stream_kernel(const T* __restrict__ cij, const T* __restrict__ mask,
                  const T* __restrict__ cii, const T* __restrict__ node,
                  const T* __restrict__ U, const T* __restrict__ prec, const T* __restrict__ ed,
                  const T* __restrict__ alpha, const T* __restrict__ sU,
                  const T* __restrict__ tau_ptr, T* __restrict__ U_low, T* __restrict__ F_out,
                  T* __restrict__ bounds, const __grid_constant__ EqConsts<T> e) {
  Cell c;
  if (!this_cell(e.H, e.W, c)) return;
  const int64_t i = c.i, n = c.n;
  const int K = e.K, K2 = K / 2;
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

  T fs_i[2][C][2];
  for (int s = 0; s < S; ++s) {
    T us[C];
    load_state(sU + s * C * n, i, n, us);
    flux(e, us, fs_i[s]);
  }

  T low_acc[C] = {T(0), T(0), T(0), T(0)};
  T F_acc[C] = {T(0), T(0), T(0), T(0)};
  // limiter_bounds_init: the diagonal (j = i) contributions
  T rho_min = ui[0], rho_max = ui[0], s_min = s_i, s_interp_max = s_i;
  T relax_num = T(2) * ui[0], k_count = T(0);

#pragma unroll 1
  for (int k = 0; k < K; ++k) {
    const T mk = mask[k * n + i];
    if (!(mk > T(0))) continue;
    const int64_t j = nbr_at(c, e.dy[k], e.dx[k], e.H, e.W);
    const T d = k < K2 ? ed[k * n + i] : ed[(K - 1 - k) * n + j];
    const T c0 = cij[k * n + i], c1 = cij[(K + k) * n + i];
    T uj[C];
    load_state(U, j, n, uj);
    T fj[C][2];
    flux(e, uj, fj);
    const T d_H = d * (T(0.5) * (alpha_i + alpha[j]));
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
      for (int q = 0; q < C; ++q) F_acc[q] += w_s[s] * flux_div(fs_i[s], fsj, q, c0, c1);
    }

    // limiter_bounds_accum (euler/limiter.h:255-363)
    const T dr = mx(d, e.reg);
    const T sc0 = c0 / dr, sc1 = c1 / dr;
    const T rho_bar = T(0.5) * (ui[0] + uj[0] + ((ui[1] - uj[1]) * sc0 + (ui[2] - uj[2]) * sc1));
    rho_min = mn(rho_min, rho_bar);
    rho_max = mx(rho_max, rho_bar);
    s_min = mn(s_min, prec[j]);
    T u_half[C];
#pragma unroll
    for (int q = 0; q < C; ++q) u_half[q] = T(0.5) * (ui[q] + uj[q]);
    s_interp_max = mx(s_interp_max, specific_entropy(e, u_half));
    relax_num += (ui[0] + uj[0]) * mk;
    k_count += mk;
  }

  const T m_inv = node[n + i];
#pragma unroll
  for (int q = 0; q < C; ++q) {
    const T flux_ii = flux_div(fi, fi, q, cii0, cii1);
    U_low[q * n + i] = ui[q] + (tau * m_inv) * (low_acc[q] + flux_ii);
    T F = F_acc[q] + e.weight * flux_ii;
    for (int s = 0; s < S; ++s) F = F + w_s[s] * flux_div(fs_i[s], fs_i[s], q, cii0, cii1);
    F_out[q * n + i] = F;
  }

  // limiter_bounds_finalize (limiter.h:330-363)
  const T hd_i = node[i] * e.measure_inv;
  const T sq = sqrt(sqrt(hd_i));
  const T r_i = sq * sq * sq * e.relax_factor;
  const T rho_relaxation = fabs(relax_num) / (fabs(k_count + T(1)) + e.eps);
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
int launch_pk2_stream(const T* cij, const T* mask, const T* cii, const T* node, const T* U,
                      const T* prec, const T* ed, const T* alpha, const T* sU, const T* tau,
                      T* U_low, T* F, T* bounds, const Consts* consts, cudaStream_t stream) {
  if (consts->K < 2 || consts->K > MAX_K || consts->K % 2) return int(cudaErrorInvalidValue);
  const EqConsts<T> e = EqConsts<T>::make(*consts);
  pk2_stream_kernel<T><<<canvas_grid(e.H, e.W), canvas_block(), 0, stream>>>(
      cij, mask, cii, node, U, prec, ed, alpha, sU, tau, U_low, F, bounds, e);
  return int(cudaGetLastError());
}

}  // namespace ryujin

#define RYUJIN_PK2_STREAM(SUFFIX, T)                                                           \
  extern "C" int ryujin_pk2_stream_##SUFFIX(                                                   \
      const void* cij, const void* mask, const void* cii, const void* node, const void* U,     \
      const void* prec, const void* ed, const void* alpha, const void* sU, const void* tau,    \
      void* U_low, void* F, void* bounds, const ryujin::Consts* consts, void* stream) {        \
    return ryujin::launch_pk2_stream<T>(                                                       \
        (const T*)cij, (const T*)mask, (const T*)cii, (const T*)node, (const T*)U,             \
        (const T*)prec, (const T*)ed, (const T*)alpha, (const T*)sU, (const T*)tau,            \
        (T*)U_low, (T*)F, (T*)bounds, consts, (cudaStream_t)stream);                           \
  }

RYUJIN_PK2_STREAM(f32, float)
RYUJIN_PK2_STREAM(f64, double)
