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
// Design: a block (32, TY) owns a tile of TY rows of TILE_TX = 32 cells,
// one thread a cell, and first stages (staged.cuh), for the tile and its
// halo of one cell, what a slot reads at its neighbour j: U, the parts of
// the fluxes f(U) and f(sU_s) of each stage, F, m_j and alpha_j, the
// layout of pk3_stream's tile.  Each neighbour flux is so formed once per
// staged cell, not once per slot: at two stages 3 flux parts (a division
// each) for each of the (32 + 2)(TY + 2) staged cells, where the
// one-thread-per-cell form made 24 flux evaluations a cell.  The slot loop
// reads its neighbour and its own cell from shared memory, and from device
// memory only the statics (c_ij, cmax, m_ij, the mask, the dG `inc`) and
// the half-slot lambda, all of a slot at once and the next slot's while
// this one computes; P and l are written one plane per slot, coalesced
// along x.  The stage loop reads shared memory at a runtime stage index
// and keeps no per-stage array, so no instance has a stack frame; the
// stage weight is a select on the stage index among the MS weights an
// instance takes (MS = 2, or MAX_STAGES for ERK54's 3 and 4 slots,
// chosen at launch by n_stages).  Every
// slot keeps this kernel's own arithmetic and its order, which differs
// from pk3_stream's in three places: d = lambda * cmax from the half-slot
// lambda planes, the first term of P as -flux_ij + weight * flux_ij, and
// the stage terms summed apart before they are added to P; so P, l and
// okp keep their bits.  The tile, its halo and the shared bytes come from
// kernels/pk3.py tile(); the launcher refuses a tile whose halo is not
// the lattice's one cell, whose grid misses the canvas or whose bytes are
// not this layout's, and sets the dynamic shared memory above 48 KB.
//
// The limiter runs per slot and per thread: a lane with psi(t_r) > 0
// returns at once, which is exact per lane (euler.py:755-762) and takes
// the place of the TPU kernel's all-lanes lax.cond.  Masked slots write
// P = 0 and l = 0, so every output is finite everywhere (no NaN * 0
// hazard downstream).
//
// dG (DG = true; the TPU kernel takes it through phase_p_l1,
// hyperbolic.py:1006-1010): the factor of d_H is max(1/2 (alpha_i +
// alpha_j), beta_ij), beta read from the K incidence planes `inc`.  The
// flag is a template parameter, so the cG instance reads no incidence
// plane.
#include "staged.cuh"

namespace ryujin {

// At most 256 threads a block; the cG f32 instance is held to 85
// registers (three such blocks an SM), as the 2D pk3_stream instances are
// (the dG one spilled under that cap).
template <typename T, bool DG, int MS>
__global__ void __launch_bounds__(256, sizeof(T) == 4 && !DG ? 3 : 1)
pk3_kernel(const T* __restrict__ cij, const T* __restrict__ cmax, const T* __restrict__ mij,
           const T* __restrict__ mask, const T* __restrict__ inc, const T* __restrict__ node,
           const T* __restrict__ U,
           const T* __restrict__ lam, const T* __restrict__ alpha, const T* __restrict__ Fin,
           const T* __restrict__ U_low, const T* __restrict__ bounds, const T* __restrict__ sU,
           const T* __restrict__ tau_ptr, T* __restrict__ P_out, T* __restrict__ l_out,
           T* __restrict__ okp, const __grid_constant__ EqConsts<T> e) {
  constexpr int DIM = 2, UV = u_vals(DIM), SV = stage_vals(DIM);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sm = reinterpret_cast<T*>(smem_raw);

  const int S = e.n_stages;
  const int TY = blockDim.y;
  const int SX = TILE_TX + 2, SY = TY + 2, ns = SX * SY;
  const int FB = UV + S * SV;  // F, then m_j, then alpha_j
  const int lane = threadIdx.x, ty = threadIdx.y;
  const int x0 = blockIdx.x * TILE_TX, y0 = blockIdx.y * TY;
  const int64_t n = int64_t(e.H) * e.W;

  // ---- stage the tile and its halo -----------------------------------------
  for (int s = lane + TILE_TX * ty; s < ns; s += TILE_TX * TY) {  // s: a staged cell
    const int64_t gi = staged_cell<DIM>(e, x0, y0, 0, 1, SX, SY, s);
    stage_state<T, DIM>(e, U, gi, n, sm, ns, s);
    for (int stage = 0; stage < S; ++stage)
      stage_stage<T, DIM>(e, sU + stage * C * n, gi, n, sm, ns, s, UV + stage * SV);
#pragma unroll
    for (int q = 0; q < C; ++q) sm[(FB + q) * ns + s] = Fin[q * n + gi];
    sm[(FB + C) * ns + s] = node[gi];
    sm[(FB + C + 1) * ns + s] = alpha[gi];
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

  T ui[C], fi_F[C], ul[C], mi[DIM];
#pragma unroll
  for (int q = 0; q < C; ++q) {
    ui[q] = sm[q * ns + si];
    fi_F[q] = sm[(FB + q) * ns + si];
  }
#pragma unroll
  for (int d = 0; d < DIM; ++d) mi[d] = ui[1 + d];
  load_state(U_low, i, n, ul);
  const T bnd[3] = {bounds[i], bounds[n + i], bounds[2 * n + i]};
  const T alpha_i = sm[(FB + C + 1) * ns + si];
  const T m_inv = node[n + i];
  const T tau = *tau_ptr;
  const T pfac = tau * m_inv * node[2 * n + i];
  const bool real = node[3 * n + i] > T(0);

  T fi[C][DIM];
  staged_flux(sm, ns, C, si, mi, fi);
  T psi0[4];
  limiter_psi0(e, bnd[2], ul, psi0);

  // a slot's reads of device memory, issued together, the next slot's
  // while this one computes (a masked slot reads them too, unused)
  struct Slot {
    T mk, lam, cmax, c0, c1, m_ij, beta;
  };
  auto fetch = [&](int k, Slot& sl) {
    sl.mk = mask[k * n + i];
    sl.lam = k < K2 ? lam[k * n + i] : lam[(K - 1 - k) * n + nbr(c, k, e.H, e.W)];
    sl.cmax = cmax[k * n + i];
    sl.c0 = cij[k * n + i];
    sl.c1 = cij[(K + k) * n + i];
    sl.m_ij = mij[k * n + i];
    sl.beta = DG ? inc[k * n + i] : T(0);
  };
  Slot cur;
  fetch(0, cur);
  T ok = T(1);
#pragma unroll 1
  for (int k = 0; k < K; ++k) {
    Slot nxt;
    if (k + 1 < K) fetch(k + 1, nxt);
    if (!(cur.mk > T(0))) {
#pragma unroll
      for (int q = 0; q < C; ++q) P_out[(q * K + k) * n + i] = T(0);
      l_out[k * n + i] = T(0);
    } else {
      const int sj = si + DY(k) * SX + DX(k);
      const T d = cur.lam * cur.cmax;
      T factor = T(0.5) * (alpha_i + sm[(FB + C + 1) * ns + sj]);
      if constexpr (DG) factor = mx(factor, cur.beta);
      const T d_H = d * factor;

      T P[C];
      {
        T uj[C], mj[DIM], fj[C][DIM];
#pragma unroll
        for (int q = 0; q < C; ++q) uj[q] = sm[q * ns + sj];
#pragma unroll
        for (int dd = 0; dd < DIM; ++dd) mj[dd] = uj[1 + dd];
        staged_flux(sm, ns, C, sj, mj, fj);
#pragma unroll
        for (int q = 0; q < C; ++q) {
          const T flux_ij = flux_div(fi, fj, q, cur.c0, cur.c1);
          P[q] = -flux_ij + e.weight * flux_ij + (d_H - d) * (uj[q] - ui[q]);
        }
      }
      if (S > 0) {
        T stage_sum[C];
        for (int s = 0; s < S; ++s) {
          T fsi[C][DIM], fsj[C][DIM];
          staged_stage_flux(sm, ns, UV + s * SV, si, fsi);
          staged_stage_flux(sm, ns, UV + s * SV, sj, fsj);
          const T w_s = stage_weight<MS>(e, s);
#pragma unroll
          for (int q = 0; q < C; ++q) {
            const T v = w_s * flux_div(fsi, fsj, q, cur.c0, cur.c1);
            stage_sum[q] = s == 0 ? v : stage_sum[q] + v;
          }
        }
#pragma unroll
        for (int q = 0; q < C; ++q) P[q] = P[q] + stage_sum[q];
      }
      const T b_ij = -cur.m_ij / sm[(FB + C) * ns + sj];
      const T b_ji = -cur.m_ij * m_inv;
#pragma unroll
      for (int q = 0; q < C; ++q) {
        P[q] = (P[q] + b_ij * sm[(FB + q) * ns + sj] - b_ji * fi_F[q]) * pfac;
        P_out[(q * K + k) * n + i] = P[q];
      }
      bool success;
      l_out[k * n + i] = limiter_limit(e, bnd, ul, psi0, P, success);
      if (real && !success) ok = T(0);
    }
    if (k + 1 < K) cur = nxt;
  }
  okp[i] = ok;
}

// Shared bytes of the tile (ty rows, halo 1) at `stages` stages.
template <typename T>
int64_t pk3_smem(int stages, int ty) {
  return pk3_vals(2, stages) * int64_t(TILE_TX + 2) * (ty + 2) * int64_t(sizeof(T));
}

// The wrapper's tile (kernels/pk3.py tile()) must fit this layout: 32
// lanes, one z, at most 256 threads, the halo of the reach-1 lattice, a
// grid that covers the canvas, and the bytes pk3_smem gives.
template <typename T>
bool pk3_tile_ok(const Consts* c) {
  const int ty = c->block[1];
  return c->block[0] == TILE_TX && ty >= 1 && c->block[2] == 1 && TILE_TX * ty <= 256 &&
         c->halo == 1 && int64_t(c->grid[0]) * TILE_TX >= c->W &&
         int64_t(c->grid[1]) * ty >= c->H && c->grid[2] == 1 &&
         c->smem == pk3_smem<T>(c->n_stages, ty);
}

template <typename T, bool DG, int MS>
int launch_pk3_instance(const T* cij, const T* cmax, const T* mij, const T* mask, const T* inc,
                        const T* node, const T* U, const T* lam, const T* alpha, const T* F,
                        const T* U_low, const T* bounds, const T* sU, const T* tau, T* P, T* l,
                        T* okp, const EqConsts<T>& e, const Consts* consts, cudaStream_t stream) {
  auto kernel = pk3_kernel<T, DG, MS>;
  const int smem = consts->smem;
  const int rc = allow_smem(kernel, smem);
  if (rc != int(cudaSuccess)) return rc;
  const dim3 grid(consts->grid[0], consts->grid[1], consts->grid[2]);
  const dim3 block(consts->block[0], consts->block[1], consts->block[2]);
  kernel<<<grid, block, smem, stream>>>(cij, cmax, mij, mask, inc, node, U, lam, alpha, F, U_low,
                                        bounds, sU, tau, P, l, okp, e);
  return int(cudaGetLastError());
}

template <typename T>
int launch_pk3(const T* cij, const T* cmax, const T* mij, const T* mask, const T* inc,
               const T* node, const T* U, const T* lam, const T* alpha, const T* F,
               const T* U_low, const T* bounds, const T* sU, const T* tau, T* P, T* l, T* okp,
               const Consts* consts, cudaStream_t stream) {
  if (consts->dim != 2 || consts->K != K || !pk3_tile_ok<T>(consts))
    return int(cudaErrorInvalidValue);
  if (consts->n_stages < 0 || consts->n_stages > MAX_STAGES) return int(cudaErrorInvalidValue);
  const EqConsts<T> e = EqConsts<T>::make(*consts);
  const bool wide = consts->n_stages > 2;
  if (inc && wide)
    return launch_pk3_instance<T, true, MAX_STAGES>(cij, cmax, mij, mask, inc, node, U, lam, alpha,
                                                    F, U_low, bounds, sU, tau, P, l, okp, e,
                                                    consts, stream);
  if (inc)
    return launch_pk3_instance<T, true, 2>(cij, cmax, mij, mask, inc, node, U, lam, alpha, F,
                                           U_low, bounds, sU, tau, P, l, okp, e, consts, stream);
  if (wide)
    return launch_pk3_instance<T, false, MAX_STAGES>(cij, cmax, mij, mask, inc, node, U, lam,
                                                     alpha, F, U_low, bounds, sU, tau, P, l, okp,
                                                     e, consts, stream);
  return launch_pk3_instance<T, false, 2>(cij, cmax, mij, mask, inc, node, U, lam, alpha, F,
                                          U_low, bounds, sU, tau, P, l, okp, e, consts, stream);
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
