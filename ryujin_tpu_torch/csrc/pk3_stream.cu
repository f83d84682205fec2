// PK3, slot-streaming form: antidiffusive fluxes P_ij with the
// mass-matrix correction, the first limiter pass l_ij and the per-node
// success flag okp, for a canvas of any lattice reach.
//
// Replaces: the Pallas kernel `pk3_stream` of PallasStepper.step with
// prescale (ryujin_tpu/solver/pallas_step.py:3093-3214), which computes
// one lattice offset at a time and stores P_k and l_k as it goes.
//
// Bound on an H100: memory traffic, dominated by the C * K = 96 planes of
// P it writes at K = 24 (the largest array of the substep) and l (24),
// plus c_ij (48), m_ij (24), the mask (24) and the neighbour reads of U,
// e, alpha, F, the lumped mass and the stages.  The limiter's Newton
// iterations (one pow per evaluation) add branchy compute on the shocked
// cells only.
//
// Design: one thread per canvas cell, 128 threads along x; K and the
// offsets come with the launch and the loop over k is not unrolled.  The
// thread keeps nothing per slot but `ok`: P_k and l_k go to device memory
// as soon as they are computed.  The edge mask is folded into the stored
// P, and masked slots write P = 0 and l = 0, so pk_up needs no guard on
// its transposed read of l.  The limiter returns per lane where
// psi(t_r) > 0 (exact, see limiter_limit).  The graph viscosity of slot k
// is e_k at the cell for k < K/2 and plane K-1-k of neighbour k otherwise;
// cmax is not read.
#include "euler.cuh"

namespace ryujin {

template <typename T>
__global__ void __launch_bounds__(128)
pk3_stream_kernel(const T* __restrict__ cij, const T* __restrict__ mij,
                  const T* __restrict__ mask, const T* __restrict__ node,
                  const T* __restrict__ U, const T* __restrict__ ed, const T* __restrict__ alpha,
                  const T* __restrict__ Fin, const T* __restrict__ U_low,
                  const T* __restrict__ bounds, const T* __restrict__ sU,
                  const T* __restrict__ tau_ptr, T* __restrict__ P_out, T* __restrict__ l_out,
                  T* __restrict__ okp, const __grid_constant__ EqConsts<T> e) {
  Cell c;
  if (!this_cell(e.H, e.W, c)) return;
  const int64_t i = c.i, n = c.n;
  const int K = e.K, K2 = K / 2;
  const int S = e.n_stages;
  const T w_s[2] = {e.w0, e.w1};

  T ui[C], fi_F[C], ul[C];
  load_state(U, i, n, ui);
  load_state(Fin, i, n, fi_F);
  load_state(U_low, i, n, ul);
  const T bnd[3] = {bounds[i], bounds[n + i], bounds[2 * n + i]};
  const T alpha_i = alpha[i];
  const T m_inv = node[n + i];
  const T tau = *tau_ptr;
  const T pfac = tau * m_inv * node[2 * n + i];
  const bool real = node[3 * n + i] > T(0);

  T fi[C][2];
  flux(e, ui, fi);
  T fs_i[2][C][2];
  for (int s = 0; s < S; ++s) {
    T us[C];
    load_state(sU + s * C * n, i, n, us);
    flux(e, us, fs_i[s]);
  }
  T psi0[4];
  limiter_psi0(e, bnd[2], ul, psi0);

  T ok = T(1);
#pragma unroll 1
  for (int k = 0; k < K; ++k) {
    const T mk = mask[k * n + i];
    if (!(mk > T(0))) {
#pragma unroll
      for (int q = 0; q < C; ++q) P_out[(q * K + k) * n + i] = T(0);
      l_out[k * n + i] = T(0);
      continue;
    }
    const int64_t j = nbr_at(c, e.dy[k], e.dx[k], e.H, e.W);
    const T d = k < K2 ? ed[k * n + i] : ed[(K - 1 - k) * n + j];
    const T d_H = d * (T(0.5) * (alpha_i + alpha[j]));
    const T c0 = cij[k * n + i], c1 = cij[(K + k) * n + i];
    T uj[C], fj[C][2];
    load_state(U, j, n, uj);
    flux(e, uj, fj);

    T P[C];
#pragma unroll
    for (int q = 0; q < C; ++q)
      P[q] = e.weight_m1 * flux_div(fi, fj, q, c0, c1) + (d_H - d) * (uj[q] - ui[q]);
    for (int s = 0; s < S; ++s) {
      T usj[C], fsj[C][2];
      load_state(sU + s * C * n, j, n, usj);
      flux(e, usj, fsj);
#pragma unroll
      for (int q = 0; q < C; ++q) P[q] = P[q] + w_s[s] * flux_div(fs_i[s], fsj, q, c0, c1);
    }
    const T m_ij = mij[k * n + i];
    const T b_ij = -m_ij / node[j];
    const T b_ji = -m_ij * m_inv;
#pragma unroll
    for (int q = 0; q < C; ++q) {
      P[q] = (P[q] + b_ij * Fin[q * n + j] - b_ji * fi_F[q]) * pfac;
      P_out[(q * K + k) * n + i] = P[q];
    }
    bool success;
    l_out[k * n + i] = limiter_limit(e, bnd, ul, psi0, P, success);
    if (real && !success) ok = T(0);
  }
  okp[i] = ok;
}

template <typename T>
int launch_pk3_stream(const T* cij, const T* mij, const T* mask, const T* node, const T* U,
                      const T* ed, const T* alpha, const T* F, const T* U_low, const T* bounds,
                      const T* sU, const T* tau, T* P, T* l, T* okp, const Consts* consts,
                      cudaStream_t stream) {
  if (consts->K < 2 || consts->K > MAX_K || consts->K % 2) return int(cudaErrorInvalidValue);
  const EqConsts<T> e = EqConsts<T>::make(*consts);
  pk3_stream_kernel<T><<<canvas_grid(e.H, e.W), canvas_block(), 0, stream>>>(
      cij, mij, mask, node, U, ed, alpha, F, U_low, bounds, sU, tau, P, l, okp, e);
  return int(cudaGetLastError());
}

}  // namespace ryujin

#define RYUJIN_PK3_STREAM(SUFFIX, T)                                                           \
  extern "C" int ryujin_pk3_stream_##SUFFIX(                                                   \
      const void* cij, const void* mij, const void* mask, const void* node, const void* U,     \
      const void* ed, const void* alpha, const void* F, const void* U_low,                     \
      const void* bounds, const void* sU, const void* tau, void* P, void* l, void* okp,        \
      const ryujin::Consts* consts, void* stream) {                                            \
    return ryujin::launch_pk3_stream<T>(                                                       \
        (const T*)cij, (const T*)mij, (const T*)mask, (const T*)node, (const T*)U,             \
        (const T*)ed, (const T*)alpha, (const T*)F, (const T*)U_low, (const T*)bounds,         \
        (const T*)sU, (const T*)tau, (T*)P, (T*)l, (T*)okp, consts, (cudaStream_t)stream);     \
  }

RYUJIN_PK3_STREAM(f32, float)
RYUJIN_PK3_STREAM(f64, double)
