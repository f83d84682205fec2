// pk_up: the symmetrized limited update, launched twice per substep (PK4
// and PK5).  Not the last pass (l_new given): also re-limits the remaining
// (1 - l_sym) P and writes l' = (1 - l_sym) l2.
//
// Replaces: the Pallas kernel `pk_up` of PallasStepper.step
// (ryujin_tpu/solver/pallas_step.py:3265-3285), which runs
// hyperbolic.phase_update per 8-row tile, and `pk_up` of
// PallasStepper._step_slab (:2528-2563) on 3D z-slabs.
//
// Bound on an H100: memory traffic.  It reads the C * K planes of P (the
// largest stream of the substep: 32 at K = 8, 96 at K = 24, 130 at K = 26
// in 3D), l (K) at the cell and the transposed plane at each neighbour,
// the mask (K), U (C), 1/n_i and the bounds (3), and writes U (C) and
// l' (K).
//
// Design: one thread per canvas cell, 128 threads along x, the grid over
// (x-blocks, H, D).  l_T is plane K-1-k of neighbour k; l_sym = min(l,
// l_T) is read again in the re-limit loop, and so is P (L1/L2 hits),
// instead of being held.  The kernel is a template on DIM and K,
// instantiated for K = 8 and K = 24 in 2D (reach 1 and 2) and K = 26 in 3D
// (reach 1), so the update loop unrolls with the launch's offsets at
// compile-time indices.  The re-limit loop is not unrolled: K inlined
// limiter bodies (≈30,000 instructions at K = 24) thrashed the
// instruction cache, and rolled it is 16 % faster at K = 24, 3 times
// faster at K = 26 on a blast state and 2-3 % slower at K = 8 (H100 SXM,
// 700 W).  No mask on the transposed read is needed: this is a
// single-block canvas and PK3 writes l = 0 on every masked slot.
//
// Statics (ST, statics.cuh): the mask is the one static plane this kernel
// reads, K of them.  SepStatics (3D, K = 26) synthesizes it from the
// separable factors g2 / fz (`_SepTile.mask_k`, :1139), one multiply a
// slot in each loop; the TPU's pk_up reads no mask and relies on P
// carrying it, the port keeps its masked loops.  The factor pointers come
// after the constants, so the full-statics instances keep their
// parameter offsets.
#include "statics.cuh"

namespace ryujin {

template <typename T, int DIM, int K, class ST>
__global__ void __launch_bounds__(128)
pk_up_kernel(const T* __restrict__ inv_n, const T* __restrict__ mask, const T* __restrict__ U,
             const T* __restrict__ bounds, const T* __restrict__ P, const T* __restrict__ l,
             T* __restrict__ U_next, T* __restrict__ l_new,
             const __grid_constant__ EqConsts<T> e, const T* __restrict__ g2,
             const T* __restrict__ fz) {
  static_assert(!ST::kSeparable || (DIM == 3 && K == 26), "separable statics are 3D, K = 26");
  constexpr int NC = DIM + 2;
  Cell c;
  if (!this_cell<DIM>(e, c)) return;
  const ST st(e, nullptr, nullptr, mask, nullptr, nullptr, g2, fz);
  const int64_t i = c.i, n = c.n;
  T acc[NC];
#pragma unroll
  for (int q = 0; q < NC; ++q) acc[q] = T(0);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (!(st.mask(c, e, k) > T(0))) continue;
    const int64_t j = nbr_k<DIM>(c, e, k);
    const T ls = mn(l[k * n + i], l[(K - 1 - k) * n + j]);
#pragma unroll
    for (int q = 0; q < NC; ++q) acc[q] += ls * P[(q * K + k) * n + i];
  }
  T un[NC];
  const T lam_i = inv_n[i];
#pragma unroll
  for (int q = 0; q < NC; ++q) {
    un[q] = U[q * n + i] + lam_i * acc[q];
    U_next[q * n + i] = un[q];
  }
  if (l_new == nullptr) return;
  const T bnd[3] = {bounds[i], bounds[n + i], bounds[2 * n + i]};
  T psi0[4];
  limiter_psi0(e, bnd[2], un, psi0);
#pragma unroll 1
  for (int k = 0; k < K; ++k) {
    T out = T(0);
    if (st.mask(c, e, k) > T(0)) {
      const int64_t j = nbr_k<DIM>(c, e, k);
      const T rest = T(1) - mn(l[k * n + i], l[(K - 1 - k) * n + j]);
      T Pk[NC];
#pragma unroll
      for (int q = 0; q < NC; ++q) Pk[q] = rest * P[(q * K + k) * n + i];
      bool success;
      out = rest * limiter_limit(e, bnd, un, psi0, Pk, success);
    }
    l_new[k * n + i] = out;
  }
}

// g2 and fz given: the SEP instance (3D, K = 26); both null: the full
// statics.
template <typename T>
int launch_pk_up(const T* inv_n, const T* mask, const T* U, const T* bounds, const T* P,
                 const T* l, T* U_next, T* l_new, const T* g2, const T* fz,
                 const Consts* consts, cudaStream_t stream) {
  const EqConsts<T> e = EqConsts<T>::make(*consts);
  const dim3 grid = canvas_grid(e.D, e.H, e.W), block = canvas_block();
  if (g2 || fz) {
    if (!g2 || !fz || consts->dim != 3 || e.K != 26) return int(cudaErrorInvalidValue);
    pk_up_kernel<T, 3, 26, SepStatics<T>><<<grid, block, 0, stream>>>(
        inv_n, mask, U, bounds, P, l, U_next, l_new, e, g2, fz);
  } else if (consts->dim == 2 && e.K == 8) {
    pk_up_kernel<T, 2, 8, FullStatics<T>><<<grid, block, 0, stream>>>(
        inv_n, mask, U, bounds, P, l, U_next, l_new, e, g2, fz);
  } else if (consts->dim == 2 && e.K == 24) {
    pk_up_kernel<T, 2, 24, FullStatics<T>><<<grid, block, 0, stream>>>(
        inv_n, mask, U, bounds, P, l, U_next, l_new, e, g2, fz);
  } else if (consts->dim == 3 && e.K == 26) {
    pk_up_kernel<T, 3, 26, FullStatics<T>><<<grid, block, 0, stream>>>(
        inv_n, mask, U, bounds, P, l, U_next, l_new, e, g2, fz);
  } else {
    return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

}  // namespace ryujin

#define RYUJIN_PK_UP(SUFFIX, T)                                                                \
  extern "C" int ryujin_pk_up_##SUFFIX(const void* inv_n, const void* mask, const void* U,     \
                                       const void* bounds, const void* P, const void* l,        \
                                       void* U_next, void* l_new, const void* g2,              \
                                       const void* fz, const ryujin::Consts* consts,           \
                                       void* stream) {                                         \
    return ryujin::launch_pk_up<T>((const T*)inv_n, (const T*)mask, (const T*)U,                \
                                   (const T*)bounds, (const T*)P, (const T*)l, (T*)U_next,      \
                                   (T*)l_new, (const T*)g2, (const T*)fz, consts,              \
                                   (cudaStream_t)stream);                                      \
  }

RYUJIN_PK_UP(f32, float)
RYUJIN_PK_UP(f64, double)

// Message of a CUDA error code returned by an entry point.
extern "C" const char* ryujin_error_string(int code) {
  return cudaGetErrorString(cudaError_t(code));
}
