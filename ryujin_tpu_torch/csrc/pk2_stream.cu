// PK2, slot-streaming form: low-order update U_low, high-order right-hand
// side F and the limiter bounds [rho_min, rho_max, s_min], for a canvas of
// any lattice reach, in 2D or 3D, from the wavespeeds e of PK1.
//
// Replaces: the Pallas kernel `pk2_stream` of PallasStepper.step with
// prescale (ryujin_tpu/solver/pallas_step.py:2879-2980) in 2D, and `pk2`
// of PallasStepper._step_slab (:2317-2384) in 3D; both fold one lattice
// offset at a time into running sums and running bounds.
//
// Bound on an H100: memory traffic.  At K = 26 in 3D: c_ij (78 planes),
// mask (26), c_ii (3), node, U (5), prec, e (13 or 26), alpha and up to
// two stage states (5 each), with the neighbour reads of U, prec, e,
// alpha and the stages; writes U_low (5), F (5) and bounds (3).  cmax is
// not read.
//
// The graph viscosity of slot k (_slot_d, :2056-2070), by route (HALF):
// half-slot, e_k at the cell for k < K/2 and plane K-1-k of neighbour k
// otherwise; two-direction, max(e_k at the cell, plane K-1-k of
// neighbour k).
//
// Design: one thread per canvas cell, 128 threads along x, the grid over
// (x-blocks, H, D); K and the offsets come with the launch and the loop
// over k is not unrolled.  The thread carries only running accumulators:
// the low-order and F sums (2 x C) and the six bound accumulators of
// limiter_bounds_accum, seeded with the diagonal terms.  Masked slots are
// skipped, which equals the reference's multiplication by a zero mask on
// finite data.  tau is read from device memory (no host sync).  Every sum
// runs over k = 0 .. K-1 in order and adds the diagonal last, as
// pk2_stream_reference does.  The bounds relax by r_i = (h^d_i)^(3/4) in
// 2D and (h^d_i)^(1/2) in 3D (euler/limiter.h:330-363).
//
// dG (DG = true; the TPU kernels take it at pallas_step.py:2942-2944 in
// `pk2_stream` and, in 3D, through the stacked launcher _tiled_call_3d,
// :597): the factor of d_H is max(1/2 (alpha_i + alpha_j), beta_ij), beta
// read from the K incidence planes `inc`.  The flag is a template
// parameter, so the cG instances read no incidence plane and compile as
// before.
//
// Statics (ST, statics.cuh): FullStatics reads the stored planes;
// SepStatics (3D cG only) synthesizes c_ij, the mask and c_ii from the
// separable factors g2 / fz, as `_SepTile` does in `_step_slab`'s pk2
// (:2276-2277, 2340): the 107 planes of c_ij, the mask and c_ii give way
// to the L2-resident factors, at 4 multiplies a slot and 3 a cell.  The
// factor pointers come after the constants, so the full-statics
// instances keep their parameter offsets.
#include "statics.cuh"

namespace ryujin {

template <typename T, int DIM, bool HALF, bool DG, class ST>
__global__ void __launch_bounds__(128)
pk2_stream_kernel(const T* __restrict__ cij, const T* __restrict__ mask,
                  const T* __restrict__ inc, const T* __restrict__ cii, const T* __restrict__ node,
                  const T* __restrict__ U, const T* __restrict__ prec, const T* __restrict__ ed,
                  const T* __restrict__ alpha, const T* __restrict__ sU,
                  const T* __restrict__ tau_ptr, T* __restrict__ U_low, T* __restrict__ F_out,
                  T* __restrict__ bounds, const __grid_constant__ EqConsts<T> e,
                  const T* __restrict__ g2, const T* __restrict__ fz) {
  static_assert(!ST::kSeparable || (DIM == 3 && !DG), "separable statics are 3D cG");
  constexpr int NC = DIM + 2;
  Cell c;
  if (!this_cell<DIM>(e, c)) return;
  const ST st(e, cij, nullptr, mask, nullptr, cii, g2, fz);
  const int64_t i = c.i, n = c.n;
  const int K = e.K, K2 = K / 2;
  const int S = e.n_stages;
  const T w_s[2] = {e.w0, e.w1};

  T ui[NC];
  load_state(U, i, n, ui);
  const T s_i = prec[i];
  const T alpha_i = alpha[i];
  const T tau = *tau_ptr;

  T fi[NC][DIM];
  flux(e, ui, fi);
  T cvi[DIM];
#pragma unroll
  for (int d = 0; d < DIM; ++d) cvi[d] = st.cii(c, e, d);

  T fs_i[2][NC][DIM];
  for (int s = 0; s < S; ++s) {
    T us[NC];
    load_state(sU + s * NC * n, i, n, us);
    flux(e, us, fs_i[s]);
  }

  T low_acc[NC], F_acc[NC];
#pragma unroll
  for (int q = 0; q < NC; ++q) low_acc[q] = F_acc[q] = T(0);
  // limiter_bounds_init: the diagonal (j = i) contributions
  T rho_min = ui[0], rho_max = ui[0], s_min = s_i, s_interp_max = s_i;
  T relax_num = T(2) * ui[0], k_count = T(0);

#pragma unroll 1
  for (int k = 0; k < K; ++k) {
    const T mk = st.mask(c, e, k);
    if (!(mk > T(0))) continue;
    const int64_t j = nbr_k<DIM>(c, e, k);
    const T d = HALF ? (k < K2 ? ed[k * n + i] : ed[(K - 1 - k) * n + j])
                     : mx(ed[k * n + i], ed[(K - 1 - k) * n + j]);
    T cv[DIM];
#pragma unroll
    for (int dd = 0; dd < DIM; ++dd) cv[dd] = st.cij(c, e, dd, k);
    T uj[NC];
    load_state(U, j, n, uj);
    T fj[NC][DIM];
    flux(e, uj, fj);
    T factor = T(0.5) * (alpha_i + alpha[j]);
    if constexpr (DG) factor = mx(factor, inc[k * n + i]);
    const T d_H = d * factor;
#pragma unroll
    for (int q = 0; q < NC; ++q) {
      const T flux_ij = flux_div(fi, fj, q, cv);
      const T dU = uj[q] - ui[q];
      low_acc[q] += flux_ij + d * dU;
      F_acc[q] += d_H * dU + e.weight * flux_ij;
    }
    for (int s = 0; s < S; ++s) {
      T usj[NC], fsj[NC][DIM];
      load_state(sU + s * NC * n, j, n, usj);
      flux(e, usj, fsj);
#pragma unroll
      for (int q = 0; q < NC; ++q) F_acc[q] += w_s[s] * flux_div(fs_i[s], fsj, q, cv);
    }

    // limiter_bounds_accum (euler/limiter.h:255-363)
    const T dr = mx(d, e.reg);
    T rho_bar = (ui[1] - uj[1]) * (cv[0] / dr);
#pragma unroll
    for (int dd = 1; dd < DIM; ++dd) rho_bar = rho_bar + (ui[1 + dd] - uj[1 + dd]) * (cv[dd] / dr);
    rho_bar = T(0.5) * (ui[0] + uj[0] + rho_bar);
    rho_min = mn(rho_min, rho_bar);
    rho_max = mx(rho_max, rho_bar);
    s_min = mn(s_min, prec[j]);
    T u_half[NC];
#pragma unroll
    for (int q = 0; q < NC; ++q) u_half[q] = T(0.5) * (ui[q] + uj[q]);
    s_interp_max = mx(s_interp_max, specific_entropy(e, u_half));
    relax_num += (ui[0] + uj[0]) * mk;
    k_count += mk;
  }

  const T m_inv = node[n + i];
#pragma unroll
  for (int q = 0; q < NC; ++q) {
    const T flux_ii = flux_div(fi, fi, q, cvi);
    U_low[q * n + i] = ui[q] + (tau * m_inv) * (low_acc[q] + flux_ii);
    T F = F_acc[q] + e.weight * flux_ii;
    for (int s = 0; s < S; ++s) F = F + w_s[s] * flux_div(fs_i[s], fs_i[s], q, cvi);
    F_out[q * n + i] = F;
  }

  // limiter_bounds_finalize (limiter.h:330-363)
  const T hd_i = node[i] * e.measure_inv;
  T r_i;
  if constexpr (DIM == 2) {
    const T sq = sqrt(sqrt(hd_i));
    r_i = sq * sq * sq * e.relax_factor;
  } else {
    r_i = sqrt(hd_i) * e.relax_factor;
  }
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

template <typename T, bool DG, class ST>
int launch_pk2_stream_route(const T* cij, const T* mask, const T* inc, const T* cii, const T* node,
                      const T* U, const T* prec, const T* ed, const T* alpha, const T* sU,
                      const T* tau, T* U_low, T* F, T* bounds, const T* g2, const T* fz,
                      const EqConsts<T>& e, const Consts* consts, cudaStream_t stream) {
  const dim3 grid = canvas_grid(e.D, e.H, e.W), block = canvas_block();
  if constexpr (!ST::kSeparable) {
    if (consts->dim == 2 && consts->half) {
      pk2_stream_kernel<T, 2, true, DG, ST><<<grid, block, 0, stream>>>(
          cij, mask, inc, cii, node, U, prec, ed, alpha, sU, tau, U_low, F, bounds, e, g2, fz);
      return int(cudaGetLastError());
    }
  }
  if (consts->dim == 3 && consts->half)
    pk2_stream_kernel<T, 3, true, DG, ST><<<grid, block, 0, stream>>>(
        cij, mask, inc, cii, node, U, prec, ed, alpha, sU, tau, U_low, F, bounds, e, g2, fz);
  else if (consts->dim == 3)
    pk2_stream_kernel<T, 3, false, DG, ST><<<grid, block, 0, stream>>>(
        cij, mask, inc, cii, node, U, prec, ed, alpha, sU, tau, U_low, F, bounds, e, g2, fz);
  else
    return int(cudaErrorInvalidValue);
  return int(cudaGetLastError());
}

// g2 and fz given: the SEP instances (3D cG, K = 26); both null: the full
// statics, cG or dG by `inc`.
template <typename T>
int launch_pk2_stream(const T* cij, const T* mask, const T* inc, const T* cii, const T* node,
                      const T* U, const T* prec, const T* ed, const T* alpha, const T* sU,
                      const T* tau, T* U_low, T* F, T* bounds, const T* g2, const T* fz,
                      const Consts* consts, cudaStream_t stream) {
  if (consts->K < 2 || consts->K > MAX_K || consts->K % 2) return int(cudaErrorInvalidValue);
  const EqConsts<T> e = EqConsts<T>::make(*consts);
  if (g2 || fz) {
    if (!g2 || !fz || inc || consts->dim != 3 || consts->K != 26)
      return int(cudaErrorInvalidValue);
    return launch_pk2_stream_route<T, false, SepStatics<T>>(
        cij, mask, inc, cii, node, U, prec, ed, alpha, sU, tau, U_low, F, bounds, g2, fz, e,
        consts, stream);
  }
  if (inc)
    return launch_pk2_stream_route<T, true, FullStatics<T>>(
        cij, mask, inc, cii, node, U, prec, ed, alpha, sU, tau, U_low, F, bounds, g2, fz, e,
        consts, stream);
  return launch_pk2_stream_route<T, false, FullStatics<T>>(
      cij, mask, inc, cii, node, U, prec, ed, alpha, sU, tau, U_low, F, bounds, g2, fz, e,
      consts, stream);
}

}  // namespace ryujin

#define RYUJIN_PK2_STREAM(SUFFIX, T)                                                           \
  extern "C" int ryujin_pk2_stream_##SUFFIX(                                                   \
      const void* cij, const void* mask, const void* inc, const void* cii, const void* node,   \
      const void* U, const void* prec, const void* ed, const void* alpha, const void* sU,      \
      const void* tau, void* U_low, void* F, void* bounds, const void* g2, const void* fz,     \
      const ryujin::Consts* consts, void* stream) {                                            \
    return ryujin::launch_pk2_stream<T>(                                                       \
        (const T*)cij, (const T*)mask, (const T*)inc, (const T*)cii, (const T*)node,           \
        (const T*)U, (const T*)prec, (const T*)ed, (const T*)alpha, (const T*)sU,              \
        (const T*)tau, (T*)U_low, (T*)F, (T*)bounds, (const T*)g2, (const T*)fz, consts,       \
        (cudaStream_t)stream);                                                                 \
  }

RYUJIN_PK2_STREAM(f32, float)
RYUJIN_PK2_STREAM(f64, double)
