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
// four stage states (4 each), with the neighbour reads of U, prec, lambda,
// alpha and the stages; writes U_low (4), F (4) and bounds (3).  The one
// transcendental per live edge (rho^gamma in the interpolated entropy)
// does not change that.
//
// Design: a block (32, TY) owns a tile of TY rows of TILE_TX = 32 cells,
// one thread a cell, and first stages (staged.cuh), for the tile and its
// halo of one cell, what a slot reads at its neighbour j: U and the parts
// of f(U), alpha_j, s_j (prec plane 0), the parts of f(sU_s) of each
// stage and the K/2 half-slot lambda planes, pk2_stream's layout with the
// lambda planes after it (26 values a cell at two stages).  Each
// neighbour flux is so formed once per staged cell, not once per slot:
// at two stages 3 flux parts (a division each) for each of the (32 +
// 2)(TY + 2) staged cells, where one thread a cell made 24 flux
// evaluations a cell.  The slot loop reads its neighbour, its own cell
// and lambda from shared memory (plane k at the cell for k < 4, plane 7-k
// at neighbour k otherwise: one Riemann solve per undirected edge; read
// from device memory, the transposed lambda left the kernel 1.18x slower
// on step2d, PERF.md §6), and from device memory only the statics (c_ij,
// cmax, the mask, the dG `inc`), all of a slot at once and the next
// slot's while this one computes.  The stage sums are kept apart, one
// accumulator per stage in a loop unrolled over the MS stages an instance
// carries, and the stage fluxes are read from shared memory at the
// stage's index, so no instance has a stack frame.  MS is a template
// parameter: 2 for ERK33 and the shorter tableaux, whose instances keep
// their registers and code, MAX_STAGES (4) for ERK54's fourth and fifth
// substeps (3 and 4 slots), chosen at launch by n_stages.  Every slot keeps this
// kernel's own arithmetic and its order, which differs from pk2_stream's
// in three places: d = lambda * cmax from the half-slot lambda planes,
// the stage terms summed apart over the slots and added to F last, and
// the relaxation sum seeded with 0 and the diagonal added at the end; so
// U_low, F and the bounds keep their bits.  tau is read from device
// memory (no host sync); the stage weights are static and come by value.
// Masked slots are skipped, which equals the reference's multiplication
// by a zero mask on finite data.  The tile, its halo and the shared bytes
// come from kernels/pk2.py tile(); the launcher refuses a tile whose halo
// is not the lattice's one cell, whose grid misses the canvas or whose
// bytes are not this layout's.
//
// dG (DG = true; the TPU kernel takes it through phase_low_order,
// hyperbolic.py:924-928): the factor of d_H is max(1/2 (alpha_i +
// alpha_j), beta_ij), beta read from the K incidence planes `inc`.  The
// flag is a template parameter, so the cG instance reads no incidence
// plane.
#include "staged.cuh"

namespace ryujin {

template <typename T, bool DG, int MS>
__global__ void __launch_bounds__(256)
pk2_kernel(const T* __restrict__ cij, const T* __restrict__ mask, const T* __restrict__ inc,
           const T* __restrict__ cmax,
           const T* __restrict__ cii, const T* __restrict__ node, const T* __restrict__ U,
           const T* __restrict__ prec, const T* __restrict__ lam, const T* __restrict__ alpha,
           const T* __restrict__ sU, const T* __restrict__ tau_ptr, T* __restrict__ U_low,
           T* __restrict__ F_out, T* __restrict__ bounds, const __grid_constant__ EqConsts<T> e) {
  constexpr int DIM = 2, UV = u_vals(DIM), SV = stage_vals(DIM);
  constexpr int AV = UV, PV = UV + 1, SB = UV + 2;  // alpha_j, s_j, the stages
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sm = reinterpret_cast<T*>(smem_raw);

  const int S = e.n_stages;
  const int LB = SB + S * SV;  // the half-slot lambda planes, after the stages
  const int TY = blockDim.y;
  const int SX = TILE_TX + 2, SY = TY + 2, ns = SX * SY;
  const int lane = threadIdx.x, ty = threadIdx.y;
  const int x0 = blockIdx.x * TILE_TX, y0 = blockIdx.y * TY;
  const int64_t n = int64_t(e.H) * e.W;

  // ---- stage the tile and its halo -----------------------------------------
  for (int s = lane + TILE_TX * ty; s < ns; s += TILE_TX * TY) {  // s: a staged cell
    const int64_t gi = staged_cell<DIM>(e, x0, y0, 0, 1, SX, SY, s);
    stage_state<T, DIM>(e, U, gi, n, sm, ns, s);
    sm[AV * ns + s] = alpha[gi];
    sm[PV * ns + s] = prec[gi];
    for (int stage = 0; stage < S; ++stage)
      stage_stage<T, DIM>(e, sU + stage * C * n, gi, n, sm, ns, s, SB + stage * SV);
#pragma unroll
    for (int r = 0; r < K2; ++r) sm[(LB + r) * ns + s] = lam[r * n + gi];
  }
  __syncthreads();

  // ---- the slots of this thread's cell -------------------------------------
  Cell c;
  c.x = x0 + lane;
  c.y = y0 + ty;
  c.z = 0;
  c.n = n;
  c.i = int64_t(c.y) * e.W + c.x;
  if (c.x >= e.W || c.y >= e.H) return;
  const int64_t i = c.i;
  const int si = (1 + ty) * SX + 1 + lane;

  T ui[C], mi[DIM];
#pragma unroll
  for (int q = 0; q < C; ++q) ui[q] = sm[q * ns + si];
#pragma unroll
  for (int d = 0; d < DIM; ++d) mi[d] = ui[1 + d];
  const T s_i = sm[PV * ns + si];
  const T alpha_i = sm[AV * ns + si];
  const T tau = *tau_ptr;

  T fi[C][DIM];
  staged_flux(sm, ns, C, si, mi, fi);
  const T cii0 = cii[i], cii1 = cii[n + i];
  T flux_ii[C];
#pragma unroll
  for (int q = 0; q < C; ++q) flux_ii[q] = flux_div(fi, fi, q, cii0, cii1);

  T low_acc[C], F_acc[C], stage_F[MS][C];
#pragma unroll
  for (int q = 0; q < C; ++q) {
    low_acc[q] = F_acc[q] = T(0);
#pragma unroll
    for (int s = 0; s < MS; ++s) stage_F[s][q] = T(0);
  }
  T rho_min = ui[0], rho_max = ui[0], s_min = s_i, s_interp_max = s_i;
  T relax_num = T(0), k_count = T(0);

  // a slot's reads of device memory, issued together, the next slot's
  // while this one computes (a masked slot reads them too, unused)
  struct Slot {
    T mk, cmax, c0, c1, beta;
  };
  auto fetch = [&](int k, Slot& sl) {
    sl.mk = mask[k * n + i];
    sl.cmax = cmax[k * n + i];
    sl.c0 = cij[k * n + i];
    sl.c1 = cij[(K + k) * n + i];
    sl.beta = DG ? inc[k * n + i] : T(0);
  };
  Slot cur;
  fetch(0, cur);
#pragma unroll 1
  for (int k = 0; k < K; ++k) {
    Slot nxt;
    if (k + 1 < K) fetch(k + 1, nxt);
    if (cur.mk > T(0)) {
      const int sj = si + DY(k) * SX + DX(k);
      const T d = (k < K2 ? sm[(LB + k) * ns + si] : sm[(LB + K - 1 - k) * ns + sj]) * cur.cmax;
      T uj[C], mj[DIM];
#pragma unroll
      for (int q = 0; q < C; ++q) uj[q] = sm[q * ns + sj];
#pragma unroll
      for (int dd = 0; dd < DIM; ++dd) mj[dd] = uj[1 + dd];
      T factor = T(0.5) * (alpha_i + sm[AV * ns + sj]);
      if constexpr (DG) factor = mx(factor, cur.beta);
      const T d_H = d * factor;
      {
        T fj[C][DIM];
        staged_flux(sm, ns, C, sj, mj, fj);
#pragma unroll
        for (int q = 0; q < C; ++q) {
          const T flux_ij = flux_div(fi, fj, q, cur.c0, cur.c1);
          const T dU = uj[q] - ui[q];
          low_acc[q] += flux_ij + d * dU;
          F_acc[q] += d_H * dU + e.weight * flux_ij;
        }
      }
#pragma unroll
      for (int s = 0; s < MS; ++s) {
        if (s >= S) break;
        T fsi[C][DIM], fsj[C][DIM];
        staged_stage_flux(sm, ns, SB + s * SV, si, fsi);
        staged_stage_flux(sm, ns, SB + s * SV, sj, fsj);
#pragma unroll
        for (int q = 0; q < C; ++q) stage_F[s][q] += flux_div(fsi, fsj, q, cur.c0, cur.c1);
      }

      // limiter bounds (euler/limiter.h:255-363)
      const T dr = mx(d, e.reg);
      const T sc0 = cur.c0 / dr, sc1 = cur.c1 / dr;
      const T rho_bar =
          T(0.5) * (ui[0] + uj[0] + ((ui[1] - uj[1]) * sc0 + (ui[2] - uj[2]) * sc1));
      rho_min = mn(rho_min, rho_bar);
      rho_max = mx(rho_max, rho_bar);
      s_min = mn(s_min, sm[PV * ns + sj]);
      relax_num += (ui[0] + uj[0]) * cur.mk;
      k_count += cur.mk;
      T u_half[C];
#pragma unroll
      for (int q = 0; q < C; ++q) u_half[q] = T(0.5) * (ui[q] + uj[q]);
      s_interp_max = mx(s_interp_max, specific_entropy(e, u_half));
    }
    if (k + 1 < K) cur = nxt;
  }

  const T m_inv = node[n + i];
  T F[C];
#pragma unroll
  for (int q = 0; q < C; ++q) {
    U_low[q * n + i] = ui[q] + (tau * m_inv) * (low_acc[q] + flux_ii[q]);
    F[q] = F_acc[q] + e.weight * flux_ii[q];
  }
  if (S > 0) {
    T inc_F[C];
#pragma unroll
    for (int s = 0; s < MS; ++s) {
      if (s >= S) break;
      T fsi[C][DIM];
      staged_stage_flux(sm, ns, SB + s * SV, si, fsi);
      const T w_s = stage_weight<MS>(e, s);
#pragma unroll
      for (int q = 0; q < C; ++q) {
        const T v = w_s * (stage_F[s][q] + flux_div(fsi, fsi, q, cii0, cii1));
        inc_F[q] = s == 0 ? v : inc_F[q] + v;
      }
    }
#pragma unroll
    for (int q = 0; q < C; ++q) F[q] = F[q] + inc_F[q];
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

// Shared bytes of the tile (ty rows, halo 1) at `stages` stages:
// pk2_stream's values and the K2 half-slot lambda planes a staged cell.
template <typename T>
int64_t pk2_smem(int stages, int ty) {
  return (pk2_vals(2, stages) + K2) * int64_t(TILE_TX + 2) * (ty + 2) * int64_t(sizeof(T));
}

// The wrapper's tile (kernels/pk2.py tile()) must fit this layout: 32
// lanes, one z, at most 256 threads, the halo of the reach-1 lattice, a
// grid that covers the canvas, and the bytes pk2_smem gives.
template <typename T>
bool pk2_tile_ok(const Consts* c) {
  const int ty = c->block[1];
  return c->block[0] == TILE_TX && ty >= 1 && c->block[2] == 1 && TILE_TX * ty <= 256 &&
         c->halo == 1 && int64_t(c->grid[0]) * TILE_TX >= c->W &&
         int64_t(c->grid[1]) * ty >= c->H && c->grid[2] == 1 &&
         c->smem == pk2_smem<T>(c->n_stages, ty);
}

template <typename T, bool DG, int MS>
int launch_pk2_instance(const T* cij, const T* mask, const T* inc, const T* cmax, const T* cii,
                        const T* node, const T* U, const T* prec, const T* lam, const T* alpha,
                        const T* sU, const T* tau, T* U_low, T* F, T* bounds,
                        const EqConsts<T>& e, const Consts* consts, cudaStream_t stream) {
  auto kernel = pk2_kernel<T, DG, MS>;
  const int smem = consts->smem;
  const int rc = allow_smem(kernel, smem);
  if (rc != int(cudaSuccess)) return rc;
  const dim3 grid(consts->grid[0], consts->grid[1], consts->grid[2]);
  const dim3 block(consts->block[0], consts->block[1], consts->block[2]);
  kernel<<<grid, block, smem, stream>>>(cij, mask, inc, cmax, cii, node, U, prec, lam, alpha, sU,
                                        tau, U_low, F, bounds, e);
  return int(cudaGetLastError());
}

template <typename T>
int launch_pk2(const T* cij, const T* mask, const T* inc, const T* cmax, const T* cii,
               const T* node, const T* U, const T* prec, const T* lam, const T* alpha,
               const T* sU, const T* tau, T* U_low, T* F, T* bounds, const Consts* consts,
               cudaStream_t stream) {
  if (consts->dim != 2 || consts->K != K || !pk2_tile_ok<T>(consts))
    return int(cudaErrorInvalidValue);
  if (consts->n_stages < 0 || consts->n_stages > MAX_STAGES) return int(cudaErrorInvalidValue);
  const EqConsts<T> e = EqConsts<T>::make(*consts);
  const bool wide = consts->n_stages > 2;
  if (inc && wide)
    return launch_pk2_instance<T, true, MAX_STAGES>(cij, mask, inc, cmax, cii, node, U, prec, lam,
                                                    alpha, sU, tau, U_low, F, bounds, e, consts,
                                                    stream);
  if (inc)
    return launch_pk2_instance<T, true, 2>(cij, mask, inc, cmax, cii, node, U, prec, lam, alpha,
                                           sU, tau, U_low, F, bounds, e, consts, stream);
  if (wide)
    return launch_pk2_instance<T, false, MAX_STAGES>(cij, mask, inc, cmax, cii, node, U, prec,
                                                     lam, alpha, sU, tau, U_low, F, bounds, e,
                                                     consts, stream);
  return launch_pk2_instance<T, false, 2>(cij, mask, inc, cmax, cii, node, U, prec, lam, alpha,
                                          sU, tau, U_low, F, bounds, e, consts, stream);
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
