// PK3, slot-streaming form: antidiffusive fluxes P_ij with the
// mass-matrix correction, the first limiter pass l_ij and the per-node
// success flag okp, for a canvas of any lattice reach, in 2D or 3D.
//
// Replaces: the Pallas kernel `pk3_stream` of PallasStepper.step with
// prescale (ryujin_tpu/solver/pallas_step.py:3093-3214) in 2D, and `pk3`
// of PallasStepper._step_slab (:2409-2502) in 3D; both compute one
// lattice offset at a time and store P_k and l_k as they go.
//
// Bound on an H100: memory traffic, dominated by the C * K planes of P it
// writes (96 at K = 24 in 2D, 130 at K = 26 in 3D: the largest array of
// the substep) and l (K), plus c_ij (dim * K), m_ij (K), the mask (K) and
// the neighbour reads of U, e, alpha, F, the lumped mass and the stages.
// The limiter's Newton iterations (one pow per evaluation) add branchy
// compute on the shocked cells only.
//
// Design: one thread per canvas cell, 128 threads along x, the grid over
// (x-blocks, H, D); K and the offsets come with the launch and the loop
// over k is not unrolled.  The thread keeps nothing per slot but `ok`:
// P_k and l_k go to device memory as soon as they are computed.  The edge
// mask is folded into the stored P (as _step_slab does at :2498), and
// masked slots write P = 0 and l = 0, so pk_up needs no guard on its
// transposed read of l.  The limiter returns per lane where psi(t_r) > 0
// (exact, see limiter_limit).  The graph viscosity of slot k is read by
// route (HALF) as in pk2_stream.cu; cmax is not read.
//
// dG (DG = true; the TPU kernels take it at pallas_step.py:3167-3171 in
// `pk3_stream` and, in 3D, through the stacked launcher _tiled_call_3d,
// :597): the factor of d_H is max(1/2 (alpha_i + alpha_j), beta_ij), beta
// read from the K incidence planes `inc`.  The flag is a template
// parameter, so the cG instances read no incidence plane and compile as
// before.
//
// Statics (ST, statics.cuh): FullStatics reads the stored planes;
// SepStatics (3D cG only) synthesizes c_ij, m_ij and the mask from the
// separable factors g2 / fz, as `_SepTile` does in `_step_slab`'s pk3
// (:2276-2277, 2471): the 130 planes of c_ij, m_ij and the mask give way
// to the L2-resident factors, at 5 multiplies a slot.  That is a quarter
// of what this kernel reads; P, which it writes, stays the larger stream.
// The factor pointers come after the constants, so the full-statics
// instances keep their parameter offsets.
#include "statics.cuh"

namespace ryujin {

template <typename T, int DIM, bool HALF, bool DG, class ST>
__global__ void __launch_bounds__(128)
pk3_stream_kernel(const T* __restrict__ cij, const T* __restrict__ mij,
                  const T* __restrict__ mask, const T* __restrict__ inc,
                  const T* __restrict__ node,
                  const T* __restrict__ U, const T* __restrict__ ed, const T* __restrict__ alpha,
                  const T* __restrict__ Fin, const T* __restrict__ U_low,
                  const T* __restrict__ bounds, const T* __restrict__ sU,
                  const T* __restrict__ tau_ptr, T* __restrict__ P_out, T* __restrict__ l_out,
                  T* __restrict__ okp, const __grid_constant__ EqConsts<T> e,
                  const T* __restrict__ g2, const T* __restrict__ fz) {
  static_assert(!ST::kSeparable || (DIM == 3 && !DG), "separable statics are 3D cG");
  constexpr int NC = DIM + 2;
  Cell c;
  if (!this_cell<DIM>(e, c)) return;
  const ST st(e, cij, nullptr, mask, mij, nullptr, g2, fz);
  const int64_t i = c.i, n = c.n;
  const int K = e.K, K2 = K / 2;
  const int S = e.n_stages;
  const T w_s[2] = {e.w0, e.w1};

  T ui[NC], fi_F[NC], ul[NC];
  load_state(U, i, n, ui);
  load_state(Fin, i, n, fi_F);
  load_state(U_low, i, n, ul);
  const T bnd[3] = {bounds[i], bounds[n + i], bounds[2 * n + i]};
  const T alpha_i = alpha[i];
  const T m_inv = node[n + i];
  const T tau = *tau_ptr;
  const T pfac = tau * m_inv * node[2 * n + i];
  const bool real = node[3 * n + i] > T(0);

  T fi[NC][DIM];
  flux(e, ui, fi);
  T fs_i[2][NC][DIM];
  for (int s = 0; s < S; ++s) {
    T us[NC];
    load_state(sU + s * NC * n, i, n, us);
    flux(e, us, fs_i[s]);
  }
  T psi0[4];
  limiter_psi0(e, bnd[2], ul, psi0);

  T ok = T(1);
#pragma unroll 1
  for (int k = 0; k < K; ++k) {
    const T mk = st.mask(c, e, k);
    if (!(mk > T(0))) {
#pragma unroll
      for (int q = 0; q < NC; ++q) P_out[(q * K + k) * n + i] = T(0);
      l_out[k * n + i] = T(0);
      continue;
    }
    const int64_t j = nbr_k<DIM>(c, e, k);
    const T d = HALF ? (k < K2 ? ed[k * n + i] : ed[(K - 1 - k) * n + j])
                     : mx(ed[k * n + i], ed[(K - 1 - k) * n + j]);
    T factor = T(0.5) * (alpha_i + alpha[j]);
    if constexpr (DG) factor = mx(factor, inc[k * n + i]);
    const T d_H = d * factor;
    T cv[DIM];
#pragma unroll
    for (int dd = 0; dd < DIM; ++dd) cv[dd] = st.cij(c, e, dd, k);
    T uj[NC], fj[NC][DIM];
    load_state(U, j, n, uj);
    flux(e, uj, fj);

    T P[NC];
#pragma unroll
    for (int q = 0; q < NC; ++q)
      P[q] = e.weight_m1 * flux_div(fi, fj, q, cv) + (d_H - d) * (uj[q] - ui[q]);
    for (int s = 0; s < S; ++s) {
      T usj[NC], fsj[NC][DIM];
      load_state(sU + s * NC * n, j, n, usj);
      flux(e, usj, fsj);
#pragma unroll
      for (int q = 0; q < NC; ++q) P[q] = P[q] + w_s[s] * flux_div(fs_i[s], fsj, q, cv);
    }
    const T m_ij = st.mij(c, e, k);
    const T b_ij = -m_ij / node[j];
    const T b_ji = -m_ij * m_inv;
#pragma unroll
    for (int q = 0; q < NC; ++q) {
      P[q] = (P[q] + b_ij * Fin[q * n + j] - b_ji * fi_F[q]) * pfac;
      P_out[(q * K + k) * n + i] = P[q];
    }
    bool success;
    l_out[k * n + i] = limiter_limit(e, bnd, ul, psi0, P, success);
    if (real && !success) ok = T(0);
  }
  okp[i] = ok;
}

template <typename T, bool DG, class ST>
int launch_pk3_stream_route(const T* cij, const T* mij, const T* mask, const T* inc,
                            const T* node, const T* U, const T* ed, const T* alpha, const T* F,
                            const T* U_low, const T* bounds, const T* sU, const T* tau, T* P,
                            T* l, T* okp, const T* g2, const T* fz, const EqConsts<T>& e,
                            const Consts* consts, cudaStream_t stream) {
  const dim3 grid = canvas_grid(e.D, e.H, e.W), block = canvas_block();
  if constexpr (!ST::kSeparable) {
    if (consts->dim == 2 && consts->half) {
      pk3_stream_kernel<T, 2, true, DG, ST><<<grid, block, 0, stream>>>(
          cij, mij, mask, inc, node, U, ed, alpha, F, U_low, bounds, sU, tau, P, l, okp, e, g2,
          fz);
      return int(cudaGetLastError());
    }
  }
  if (consts->dim == 3 && consts->half)
    pk3_stream_kernel<T, 3, true, DG, ST><<<grid, block, 0, stream>>>(
        cij, mij, mask, inc, node, U, ed, alpha, F, U_low, bounds, sU, tau, P, l, okp, e, g2,
        fz);
  else if (consts->dim == 3)
    pk3_stream_kernel<T, 3, false, DG, ST><<<grid, block, 0, stream>>>(
        cij, mij, mask, inc, node, U, ed, alpha, F, U_low, bounds, sU, tau, P, l, okp, e, g2,
        fz);
  else
    return int(cudaErrorInvalidValue);
  return int(cudaGetLastError());
}

// g2 and fz given: the SEP instances (3D cG, K = 26); both null: the full
// statics, cG or dG by `inc`.
template <typename T>
int launch_pk3_stream(const T* cij, const T* mij, const T* mask, const T* inc, const T* node,
                      const T* U, const T* ed, const T* alpha, const T* F, const T* U_low,
                      const T* bounds, const T* sU, const T* tau, T* P, T* l, T* okp,
                      const T* g2, const T* fz, const Consts* consts, cudaStream_t stream) {
  if (consts->K < 2 || consts->K > MAX_K || consts->K % 2) return int(cudaErrorInvalidValue);
  const EqConsts<T> e = EqConsts<T>::make(*consts);
  if (g2 || fz) {
    if (!g2 || !fz || inc || consts->dim != 3 || consts->K != 26)
      return int(cudaErrorInvalidValue);
    return launch_pk3_stream_route<T, false, SepStatics<T>>(
        cij, mij, mask, inc, node, U, ed, alpha, F, U_low, bounds, sU, tau, P, l, okp, g2, fz,
        e, consts, stream);
  }
  if (inc)
    return launch_pk3_stream_route<T, true, FullStatics<T>>(
        cij, mij, mask, inc, node, U, ed, alpha, F, U_low, bounds, sU, tau, P, l, okp, g2, fz,
        e, consts, stream);
  return launch_pk3_stream_route<T, false, FullStatics<T>>(
      cij, mij, mask, inc, node, U, ed, alpha, F, U_low, bounds, sU, tau, P, l, okp, g2, fz, e,
      consts, stream);
}

}  // namespace ryujin

#define RYUJIN_PK3_STREAM(SUFFIX, T)                                                           \
  extern "C" int ryujin_pk3_stream_##SUFFIX(                                                   \
      const void* cij, const void* mij, const void* mask, const void* inc, const void* node,   \
      const void* U, const void* ed, const void* alpha, const void* F, const void* U_low,      \
      const void* bounds, const void* sU, const void* tau, void* P, void* l, void* okp,        \
      const void* g2, const void* fz, const ryujin::Consts* consts, void* stream) {            \
    return ryujin::launch_pk3_stream<T>(                                                       \
        (const T*)cij, (const T*)mij, (const T*)mask, (const T*)inc, (const T*)node,           \
        (const T*)U, (const T*)ed, (const T*)alpha, (const T*)F, (const T*)U_low,              \
        (const T*)bounds, (const T*)sU, (const T*)tau, (T*)P, (T*)l, (T*)okp, (const T*)g2,    \
        (const T*)fz, consts, (cudaStream_t)stream);                                           \
  }

RYUJIN_PK3_STREAM(f32, float)
RYUJIN_PK3_STREAM(f64, double)
