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
// l' (K).  PK5 reads no bounds and writes no l'.
//
// Design, PK4 at K = 24, 26 and 48 (pk_up_tile_kernel; at K = 48
// pk_up_tile_dyn_kernel, the same body on dynamic shared memory, since
// its arrays take 64,000 bytes in f64): a block owns TX = 32
// consecutive cells of one x row, one warp per component (block (32, C)),
// the grid over (x tiles, H, D); lanes are cells, so every plane is read
// and written in 32-cell rows.  It reads each slot's P, l and transposed l once, where
// the one-thread-per-cell form read P and l again in its re-limit loop
// (from device memory: 66 KB of P a 128-cell block between the reads):
//   1. stage: the C * K planes of P of the row into shared memory, and,
//      warp w taking slots k = w, w + C, ..., the mask and l_sym = min(l,
//      l_T) (l_T: plane K-1-k of neighbour k);
//   2. update: warp q sums l_sym P over k = 0 .. K-1 on live slots for
//      component q, in k order as before, and writes U;
//   3. re-limit: warp w again takes slots k = w, w + C, ..., each lane its
//      cell, with U' and psi0 of the cell from the update, P and l_sym
//      from shared memory: it reads no device memory but the bounds, and
//      writes l'.
// The shared arrays take 21 KB in 3D f32 (42 KB f64), so registers, not
// shared memory, set the resident warps (40 in f32).  On box3d PK4 takes
// 0.30 ms against 0.43 (H100 SXM, 700 W; PERF.md §6).  The re-limit
// loop is not unrolled: K inlined limiter bodies (≈30,000 instructions at
// K = 24) thrashed the instruction cache in the one-thread-per-cell form
// (rolled 16 % faster at K = 24, 3 times at K = 26 on a blast state).  No
// mask on the transposed read is needed: this is a single-block canvas
// and PK3 writes l = 0 on every masked slot.  The arithmetic per cell and
// slot is that of the plain twin (pk_up_reference), in its order, so U
// and l' are bit-equal.  PK4 at K = 8 keeps the one-thread-per-cell form
// (pk_up_kernel), and PK5 its single pass in a kernel of its own
// (pk_up_last_kernel): see there.
//
// Statics (ST, statics.cuh): the mask is the one static plane this kernel
// reads, K of them.  SepStatics (3D, K = 26) synthesizes it from the
// separable factors g2 / fz (`_SepTile.mask_k`, :1139), one multiply a
// slot; the TPU's pk_up reads no mask and relies on P carrying it, the
// port keeps its masked loops.  The factor pointers come after the
// constants, so the full-statics instances keep their parameter offsets.
#include "staged.cuh"

namespace ryujin {

constexpr int UP_TX = 32;  // cells a block owns; mirrored by kernels/pk_up.py tile()

// Shared bytes of the instance: P, l_sym, the live flags and U' (the
// dynamic layout of K = 48 puts the flags last).
template <typename T, int DIM, int K>
constexpr int pk_up_smem() {
  return (DIM + 2) * K * UP_TX * int(sizeof(T)) + K * UP_TX * int(sizeof(T)) + K * UP_TX +
         (DIM + 2) * UP_TX * int(sizeof(T));
}

// The staged PK4 on the row's shared arrays sP [C K][TX], sls [K][TX],
// slive [K][TX] and sU [C][TX]: static in the K = 24 and 26 instances,
// dynamic at K = 48, whose arrays pass the 48 KB of static shared memory
// in f64 (sP alone 49,152 bytes).
template <typename T, int DIM, int K, class ST>
__device__ __forceinline__ void pk_up_tile_body(
    const T* __restrict__ inv_n, const T* __restrict__ mask, const T* __restrict__ U,
    const T* __restrict__ bounds, const T* __restrict__ P, const T* __restrict__ l,
    T* __restrict__ U_next, T* __restrict__ l_new, const EqConsts<T>& e,
    const T* __restrict__ g2, const T* __restrict__ fz, T (&sP)[(DIM + 2) * K][UP_TX],
    T (&sls)[K][UP_TX], bool (&slive)[K][UP_TX], T (&sU)[DIM + 2][UP_TX]) {
  static_assert(!ST::kSeparable || (DIM == 3 && K == 26), "separable statics are 3D, K = 26");
  constexpr int NC = DIM + 2;
  const int lane = threadIdx.x, w = threadIdx.y;
  Cell c;
  // every thread of the block reaches the barriers; `in` marks a cell of
  // the canvas
  const bool in = this_cell<DIM>(e, c);
  const ST st(e, nullptr, nullptr, mask, nullptr, nullptr, g2, fz);
  const int64_t i = c.i, n = c.n;

  if (in) {
    // row kk NC + w of P, then slot kk NC + w: K and ceil(K / C) loads a
    // thread, all independent
#pragma unroll
    for (int kk = 0; kk < K; ++kk) sP[kk * NC + w][lane] = P[(kk * NC + w) * n + i];
#pragma unroll
    for (int kk = 0; kk < (K + NC - 1) / NC; ++kk) {
      const int k = kk * NC + w;
      if (k >= K) break;
      const bool live = st.mask(c, e, k) > T(0);
      slive[k][lane] = live;
      if (live) {
        const int64_t j = nbr_k<DIM>(c, e, k);
        sls[k][lane] = mn(l[k * n + i], l[(K - 1 - k) * n + j]);
      }
    }
  }
  __syncthreads();
  if (in) {
    T acc = T(0);
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (slive[k][lane]) acc += sls[k][lane] * sP[w * K + k][lane];
    const T un = U[w * n + i] + inv_n[i] * acc;
    U_next[w * n + i] = un;
    sU[w][lane] = un;
  }
  __syncthreads();
  if (!in) return;
  T un[NC];
#pragma unroll
  for (int q = 0; q < NC; ++q) un[q] = sU[q][lane];
  const T bnd[3] = {bounds[i], bounds[n + i], bounds[2 * n + i]};
  T psi0[4];
  limiter_psi0(e, bnd[2], un, psi0);
#pragma unroll 1
  for (int k = w; k < K; k += NC) {
    T out = T(0);
    if (slive[k][lane]) {
      const T rest = T(1) - sls[k][lane];
      T Pk[NC];
#pragma unroll
      for (int q = 0; q < NC; ++q) Pk[q] = rest * sP[q * K + k][lane];
      bool success;
      out = rest * limiter_limit(e, bnd, un, psi0, Pk, success);
    }
    l_new[k * n + i] = out;
  }
}

template <typename T, int DIM, int K, class ST>
__global__ void __launch_bounds__(UP_TX * (DIM + 2))
pk_up_tile_kernel(const T* __restrict__ inv_n, const T* __restrict__ mask, const T* __restrict__ U,
             const T* __restrict__ bounds, const T* __restrict__ P, const T* __restrict__ l,
             T* __restrict__ U_next, T* __restrict__ l_new,
             const __grid_constant__ EqConsts<T> e, const T* __restrict__ g2,
             const T* __restrict__ fz) {
  constexpr int NC = DIM + 2;
  __shared__ T sP[NC * K][UP_TX];
  __shared__ T sls[K][UP_TX];
  __shared__ bool slive[K][UP_TX];
  __shared__ T sU[NC][UP_TX];
  pk_up_tile_body<T, DIM, K, ST>(inv_n, mask, U, bounds, P, l, U_next, l_new, e, g2, fz, sP, sls,
                                 slive, sU);
}

// The same in dynamic shared memory, laid out sP, sls, sU, then the flags
// (pk_up_smem's bytes, the wrapper's tile()).
template <typename T, int DIM, int K, class ST>
__global__ void __launch_bounds__(UP_TX * (DIM + 2))
pk_up_tile_dyn_kernel(const T* __restrict__ inv_n, const T* __restrict__ mask,
                      const T* __restrict__ U, const T* __restrict__ bounds,
                      const T* __restrict__ P, const T* __restrict__ l, T* __restrict__ U_next,
                      T* __restrict__ l_new, const __grid_constant__ EqConsts<T> e,
                      const T* __restrict__ g2, const T* __restrict__ fz) {
  constexpr int NC = DIM + 2;
  extern __shared__ __align__(16) unsigned char up_smem[];
  T* base = reinterpret_cast<T*>(up_smem);
  auto& sP = *reinterpret_cast<T(*)[NC * K][UP_TX]>(base);
  auto& sls = *reinterpret_cast<T(*)[K][UP_TX]>(base + NC * K * UP_TX);
  auto& sU = *reinterpret_cast<T(*)[NC][UP_TX]>(base + (NC + 1) * K * UP_TX);
  auto& slive =
      *reinterpret_cast<bool(*)[K][UP_TX]>(base + (NC + 1) * K * UP_TX + NC * UP_TX);
  pk_up_tile_body<T, DIM, K, ST>(inv_n, mask, U, bounds, P, l, U_next, l_new, e, g2, fz, sP, sls,
                                 slive, sU);
}

// The one-thread-per-cell form, unchanged: PK4 at K = 8, where
// a 128-cell block's P (16 KB) stays in L1 for the re-limit loop's second
// read, and the staged form took 0.1867 ms on step2d against 0.1740.
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

// PK5 (the last pass: no re-limit) keeps the one-thread-per-cell form, a
// single pass over P: 128 threads along x, the grid over (x-blocks, H, D),
// the update loop unrolled over K, in a kernel of its own.  Staged as PK4
// is, it took 0.2090 ms on box3d against 0.191; alone, 0.1633 against
// 0.1877.  Its K = 24 and SEP f32 instances are held to 64 registers
// (eight blocks an SM): at 34 registers the K = 24 one took 0.2427 ms on
// q2step2d against 0.2157 held (H100 SXM, 700 W).
template <typename T, int DIM, int K, class ST>
__global__ void __launch_bounds__(128,
                                  (K == 24 || ST::kSeparable) && sizeof(T) == 4 ? 8 : 1)
pk_up_last_kernel(const T* __restrict__ inv_n, const T* __restrict__ mask,
                  const T* __restrict__ U, const T* __restrict__ P, const T* __restrict__ l,
                  T* __restrict__ U_next, const __grid_constant__ EqConsts<T> e,
                  const T* __restrict__ g2, const T* __restrict__ fz) {
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
  const T lam_i = inv_n[i];
#pragma unroll
  for (int q = 0; q < NC; ++q) U_next[q * n + i] = U[q * n + i] + lam_i * acc[q];
}

template <typename T, int DIM, int K, class ST>
int launch_pk_up_instance(const T* inv_n, const T* mask, const T* U, const T* bounds, const T* P,
                          const T* l, T* U_next, T* l_new, const T* g2, const T* fz,
                          const EqConsts<T>& e, const Consts* consts, cudaStream_t stream) {
  // the wrapper's tile (kernels/pk_up.py tile()) must be this pass's: one
  // thread a cell for PK5 and at K = 8, else the staged row
  const bool last = l_new == nullptr, cell = last || K == 8;
  const dim3 block(cell ? 128 : UP_TX, cell ? 1 : DIM + 2);
  const dim3 grid(consts->grid[0], consts->grid[1], consts->grid[2]);
  if (consts->block[0] != int(block.x) || consts->block[1] != int(block.y) ||
      consts->block[2] != 1 || consts->smem != (cell ? 0 : pk_up_smem<T, DIM, K>()) ||
      int64_t(grid.x) * block.x < e.W || int(grid.y) < e.H || int(grid.z) < e.D)
    return int(cudaErrorInvalidValue);
  if (last) {
    pk_up_last_kernel<T, DIM, K, ST><<<grid, block, 0, stream>>>(inv_n, mask, U, P, l, U_next, e,
                                                                 g2, fz);
  } else if constexpr (K == 8) {
    pk_up_kernel<T, DIM, K, ST><<<grid, block, 0, stream>>>(inv_n, mask, U, bounds, P, l, U_next,
                                                            l_new, e, g2, fz);
  } else if constexpr (K == 48) {
    constexpr int smem = pk_up_smem<T, DIM, K>();
    const int err = allow_smem(pk_up_tile_dyn_kernel<T, DIM, K, ST>, smem);
    if (err != int(cudaSuccess)) return err;
    pk_up_tile_dyn_kernel<T, DIM, K, ST><<<grid, block, smem, stream>>>(
        inv_n, mask, U, bounds, P, l, U_next, l_new, e, g2, fz);
  } else {
    pk_up_tile_kernel<T, DIM, K, ST><<<grid, block, 0, stream>>>(inv_n, mask, U, bounds, P, l,
                                                                 U_next, l_new, e, g2, fz);
  }
  return int(cudaGetLastError());
}

// g2 and fz given: the SEP instance (3D, K = 26); both null: the full
// statics.
template <typename T>
int launch_pk_up(const T* inv_n, const T* mask, const T* U, const T* bounds, const T* P,
                 const T* l, T* U_next, T* l_new, const T* g2, const T* fz,
                 const Consts* consts, cudaStream_t stream) {
  const EqConsts<T> e = EqConsts<T>::make(*consts);
  if (g2 || fz) {
    if (!g2 || !fz || consts->dim != 3 || e.K != 26) return int(cudaErrorInvalidValue);
    return launch_pk_up_instance<T, 3, 26, SepStatics<T>>(inv_n, mask, U, bounds, P, l, U_next,
                                                          l_new, g2, fz, e, consts, stream);
  }
  if (consts->dim == 2 && e.K == 8)
    return launch_pk_up_instance<T, 2, 8, FullStatics<T>>(inv_n, mask, U, bounds, P, l, U_next,
                                                          l_new, g2, fz, e, consts, stream);
  if (consts->dim == 2 && e.K == 24)
    return launch_pk_up_instance<T, 2, 24, FullStatics<T>>(inv_n, mask, U, bounds, P, l, U_next,
                                                           l_new, g2, fz, e, consts, stream);
  if (consts->dim == 2 && e.K == 48)
    return launch_pk_up_instance<T, 2, 48, FullStatics<T>>(inv_n, mask, U, bounds, P, l, U_next,
                                                           l_new, g2, fz, e, consts, stream);
  if (consts->dim == 3 && e.K == 26)
    return launch_pk_up_instance<T, 3, 26, FullStatics<T>>(inv_n, mask, U, bounds, P, l, U_next,
                                                           l_new, g2, fz, e, consts, stream);
  return int(cudaErrorInvalidValue);
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
