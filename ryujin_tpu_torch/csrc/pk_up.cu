// pk_up: the symmetrized limited update, launched twice per substep (PK4
// and PK5).  Not the last pass (l_new given): also re-limits the remaining
// (1 - l_sym) P and writes l' = (1 - l_sym) l2.
//
// Replaces: the Pallas kernel `pk_up` of PallasStepper.step
// (ryujin_tpu/solver/pallas_step.py:3265-3285), which runs
// hyperbolic.phase_update per 8-row tile.
//
// Bound on an H100: memory traffic.  It reads the 32-plane P (the
// largest stream of the substep), l (8) at the cell and the transposed
// plane at each neighbour, the mask (8), U (4), 1/n_i and the bounds (3),
// and writes U (4) and l' (8).
//
// Design: one thread per canvas cell, 128 threads along x.  l_T is plane
// 7-k of neighbour k; l_sym stays in registers between the update and the
// re-limit, and P is read a second time (an L1/L2 hit) instead of being
// held.  No mask on the transposed read is needed: this is a single-block
// canvas and PK3 writes l = 0 on every masked slot.
#include "euler.cuh"

namespace ryujin {

template <typename T>
__global__ void __launch_bounds__(128)
pk_up_kernel(const T* __restrict__ inv_n, const T* __restrict__ mask, const T* __restrict__ U,
             const T* __restrict__ bounds, const T* __restrict__ P, const T* __restrict__ l,
             T* __restrict__ U_next, T* __restrict__ l_new, const EqConsts<T> e) {
  Cell c;
  if (!this_cell(e.H, e.W, c)) return;
  const int64_t i = c.i, n = c.n;

  T l_sym[K];
  T acc[C] = {T(0), T(0), T(0), T(0)};
#pragma unroll
  for (int k = 0; k < K; ++k) {
    l_sym[k] = T(0);
    if (!(mask[k * n + i] > T(0))) continue;
    const int64_t j = nbr(c, k, e.H, e.W);
    l_sym[k] = mn(l[k * n + i], l[(K - 1 - k) * n + j]);
#pragma unroll
    for (int q = 0; q < C; ++q) acc[q] += l_sym[k] * P[(q * K + k) * n + i];
  }
  T un[C];
  const T lam_i = inv_n[i];
#pragma unroll
  for (int q = 0; q < C; ++q) {
    un[q] = U[q * n + i] + lam_i * acc[q];
    U_next[q * n + i] = un[q];
  }
  if (l_new == nullptr) return;

  const T bnd[3] = {bounds[i], bounds[n + i], bounds[2 * n + i]};
  T psi0[4];
  limiter_psi0(e, bnd[2], un, psi0);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    T out = T(0);
    if (mask[k * n + i] > T(0)) {
      const T rest = T(1) - l_sym[k];
      T Pk[C];
#pragma unroll
      for (int q = 0; q < C; ++q) Pk[q] = rest * P[(q * K + k) * n + i];
      bool success;
      out = rest * limiter_limit(e, bnd, un, psi0, Pk, success);
    }
    l_new[k * n + i] = out;
  }
}

template <typename T>
int launch_pk_up(const T* inv_n, const T* mask, const T* U, const T* bounds, const T* P,
                 const T* l, T* U_next, T* l_new, const Consts* consts, cudaStream_t stream) {
  const EqConsts<T> e = EqConsts<T>::make(*consts);
  pk_up_kernel<T><<<canvas_grid(e.H, e.W), canvas_block(), 0, stream>>>(
      inv_n, mask, U, bounds, P, l, U_next, l_new, e);
  return int(cudaGetLastError());
}

}  // namespace ryujin

#define RYUJIN_PK_UP(SUFFIX, T)                                                                \
  extern "C" int ryujin_pk_up_##SUFFIX(const void* inv_n, const void* mask, const void* U,     \
                                       const void* bounds, const void* P, const void* l,        \
                                       void* U_next, void* l_new,                              \
                                       const ryujin::Consts* consts, void* stream) {           \
    return ryujin::launch_pk_up<T>((const T*)inv_n, (const T*)mask, (const T*)U,                \
                                   (const T*)bounds, (const T*)P, (const T*)l, (T*)U_next,      \
                                   (T*)l_new, consts, (cudaStream_t)stream);                   \
  }

RYUJIN_PK_UP(f32, float)
RYUJIN_PK_UP(f64, double)

// Message of a CUDA error code returned by an entry point.
extern "C" const char* ryujin_error_string(int code) {
  return cudaGetErrorString(cudaError_t(code));
}
