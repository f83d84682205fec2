// PK3: antidiffusive fluxes P_ij with the mass-matrix correction, the
// first limiter pass l_ij and the per-node success flag okp.
//
// Replaces: the Pallas kernel `pk3` of PallasStepper.step
// (ryujin_tpu/solver/pallas_step.py:3044-3091), which runs
// hyperbolic.phase_p_l1 per 8-row tile.
//
// Bound on an H100: memory traffic, dominated by the 32-plane P it writes
// (C * K planes, the largest array of the substep), plus c_ij (16), mij
// (8), cmax (8), mask (8) and the neighbour reads of U, lambda, alpha, F,
// the lumped mass and the stages.  The limiter's Newton iterations (one
// pow per evaluation) add branchy compute on the shocked cells only.
//
// Design: one thread per canvas cell, 128 threads along x.  The limiter
// runs per slot and per thread: a lane with psi(t_r) > 0 returns at once,
// which is exact per lane (euler.py:755-762) and takes the place of the
// TPU kernel's all-lanes lax.cond.  Masked slots write P = 0 and l = 0,
// so every output is finite everywhere (no NaN * 0 hazard downstream).
//
// dG (DG = true; the TPU kernel takes it through phase_p_l1,
// hyperbolic.py:1006-1010): the factor of d_H is max(1/2 (alpha_i +
// alpha_j), beta_ij), beta read from the K incidence planes `inc`.  The
// flag is a template parameter, so the cG instance reads no incidence
// plane and compiles as before.
#include "euler.cuh"

namespace ryujin {

template <typename T, bool DG>
__global__ void __launch_bounds__(128)
pk3_kernel(const T* __restrict__ cij, const T* __restrict__ cmax, const T* __restrict__ mij,
           const T* __restrict__ mask, const T* __restrict__ inc, const T* __restrict__ node,
           const T* __restrict__ U,
           const T* __restrict__ lam, const T* __restrict__ alpha, const T* __restrict__ Fin,
           const T* __restrict__ U_low, const T* __restrict__ bounds, const T* __restrict__ sU,
           const T* __restrict__ tau_ptr, T* __restrict__ P_out, T* __restrict__ l_out,
           T* __restrict__ okp, const EqConsts<T> e) {
  Cell c;
  if (!this_cell(e.H, e.W, c)) return;
  const int64_t i = c.i, n = c.n;
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
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const T mk = mask[k * n + i];
    if (!(mk > T(0))) {
#pragma unroll
      for (int q = 0; q < C; ++q) P_out[(q * K + k) * n + i] = T(0);
      l_out[k * n + i] = T(0);
      continue;
    }
    const int64_t j = nbr(c, k, e.H, e.W);
    const T lam_k = k < K2 ? lam[k * n + i] : lam[(K - 1 - k) * n + j];
    const T d = lam_k * cmax[k * n + i];
    T factor = T(0.5) * (alpha_i + alpha[j]);
    if constexpr (DG) factor = mx(factor, inc[k * n + i]);
    const T d_H = d * factor;
    const T c0 = cij[k * n + i], c1 = cij[(K + k) * n + i];
    T uj[C], fj[C][2];
    load_state(U, j, n, uj);
    flux(e, uj, fj);

    T P[C];
#pragma unroll
    for (int q = 0; q < C; ++q) {
      const T flux_ij = flux_div(fi, fj, q, c0, c1);
      P[q] = -flux_ij + e.weight * flux_ij + (d_H - d) * (uj[q] - ui[q]);
    }
    if (S > 0) {
      T inc[C];
      for (int s = 0; s < S; ++s) {
        T usj[C], fsj[C][2];
        load_state(sU + s * C * n, j, n, usj);
        flux(e, usj, fsj);
#pragma unroll
        for (int q = 0; q < C; ++q) {
          const T v = w_s[s] * flux_div(fs_i[s], fsj, q, c0, c1);
          inc[q] = s == 0 ? v : inc[q] + v;
        }
      }
#pragma unroll
      for (int q = 0; q < C; ++q) P[q] = P[q] + inc[q];
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
int launch_pk3(const T* cij, const T* cmax, const T* mij, const T* mask, const T* inc,
               const T* node, const T* U, const T* lam, const T* alpha, const T* F,
               const T* U_low, const T* bounds, const T* sU, const T* tau, T* P, T* l, T* okp,
               const Consts* consts, cudaStream_t stream) {
  const EqConsts<T> e = EqConsts<T>::make(*consts);
  const dim3 grid = canvas_grid(e.H, e.W), block = canvas_block();
  if (inc)
    pk3_kernel<T, true><<<grid, block, 0, stream>>>(
        cij, cmax, mij, mask, inc, node, U, lam, alpha, F, U_low, bounds, sU, tau, P, l, okp, e);
  else
    pk3_kernel<T, false><<<grid, block, 0, stream>>>(
        cij, cmax, mij, mask, inc, node, U, lam, alpha, F, U_low, bounds, sU, tau, P, l, okp, e);
  return int(cudaGetLastError());
}

}  // namespace ryujin

#define RYUJIN_PK3(SUFFIX, T)                                                                  \
  extern "C" int ryujin_pk3_##SUFFIX(const void* cij, const void* cmax, const void* mij,       \
                                     const void* mask, const void* inc, const void* node,       \
                                     const void* U, const void* lam, const void* alpha,         \
                                     const void* F, const void* U_low, const void* bounds,      \
                                     const void* sU, const void* tau, void* P, void* l,         \
                                     void* okp, const ryujin::Consts* consts, void* stream) {   \
    return ryujin::launch_pk3<T>((const T*)cij, (const T*)cmax, (const T*)mij,                  \
                                 (const T*)mask, (const T*)inc, (const T*)node, (const T*)U,    \
                                 (const T*)lam, (const T*)alpha, (const T*)F,                   \
                                 (const T*)U_low, (const T*)bounds, (const T*)sU,               \
                                 (const T*)tau, (T*)P, (T*)l, (T*)okp, consts,                  \
                                 (cudaStream_t)stream);                                         \
  }

RYUJIN_PK3(f32, float)
RYUJIN_PK3(f64, double)
