// PK1: half-slot Riemann wavespeeds and the EVC indicator alpha.
//
// Replaces: the Pallas kernel `pk1` of PallasStepper.step
// (ryujin_tpu/solver/pallas_step.py:2676-2707), which runs
// hyperbolic.phase_e_alpha(half=True) per 8-row tile.
//
// Bound on an H100: memory traffic.  Per cell it reads c_ij (16 planes),
// the mask (8), the node plane, U (4) and prec (1: eta) and writes lambda
// (4) and alpha (1); the arithmetic (4 Riemann solves, 8 flux
// divergences, one pow per node) is small next to the ~30 plane reads.
//
// Design: a block (32, TY) owns a tile of TY rows of TILE_TX = 32 cells,
// one thread a cell, and first stages (staged.cuh, stage_pk1), for the
// tile and its halo of one cell, what a slot reads at its neighbour j:
// U and the parts of f(U) (v = m (1/rho), p, E + p), the rest of
// riemann_precompute(U_j) (a, 1/rho, 1/p, log2 p) and eta_j / rho_j, 13
// values a cell, pk1_stream's 2D layout, each formed by the operations
// that formed it in every slot before (the precompute's p and 1/rho are
// the flux's, eta_j / rho_j stays a division).  So a staged cell costs
// one flux, one quotient and one precompute, where the one-thread-a-cell
// form made 8 fluxes, 8 quotients and 4 precomputes a cell and gathered
// U_j and prec in every slot from device memory.  The slot loop reads
// its neighbour and its own cell from shared memory, and from device
// memory only the statics of the slot (c_ij, the mask), all at once and
// the next slot's while this one computes; lambda is written one plane a
// half slot, coalesced along x.  What stays per slot is what depends on
// i: the normalisation c / nn, lambda_max itself and the indicator's
// products.  Each slot keeps this kernel's own arithmetic and order,
// which differs from pk1_stream's tile only in lambda: raw on the K / 2
// = 4 half slots (no cmax), with (c0 / nn, c1 / nn) passed to the 2D
// lambda_max.  Masked slots write lambda = 0 and add nothing; alpha is 0
// where the node is not real; left and right sum over k = 0 .. 7 in
// order, right as (fj0 - fi0) c0 + (fj1 - fi1) c1; so lambda and alpha
// keep the bits of the one-thread-a-cell form.  The exact mask is read,
// not the TPU kernel's derived one (a bandwidth trick,
// pallas_step.py:1543-1558).  The tile, its halo and the shared bytes
// come from kernels/pk1.py tile(); the launcher refuses a tile whose
// halo is not the lattice's one cell, whose grid misses the canvas or
// whose bytes are not this layout's.
//
// Forms tried on step2d's canvas (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md
// §6, tile_sweep): this one, the slot loop rolled (f32 62 registers, 0 B
// of stack), 0.1446 ms over two calls; the loop unrolled, all 8 slots'
// statics issued ahead, 0.1427 but spilling 8 B at 64 registers in f32;
// unrolled for the indicator with the 4 Riemann solves in a loop of their
// own, 0.1483; the earlier one-thread-a-cell form, 0.1596-0.1671.  Tiles
// of TY 1 / 2 / 4 / 8 rows: 0.1729 / 0.1529 / 0.1458 / 0.1493.
#include "staged.cuh"

namespace ryujin {

template <typename T>
__global__ void __launch_bounds__(256)
pk1_kernel(const T* __restrict__ cij, const T* __restrict__ mask, const T* __restrict__ node,
           const T* __restrict__ U, const T* __restrict__ prec, T* __restrict__ lam,
           T* __restrict__ alpha, const __grid_constant__ EqConsts<T> e) {
  constexpr int DIM = 2, QV = u_vals(DIM) + 4;  // eta_j / rho_j of a staged cell
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sm = reinterpret_cast<T*>(smem_raw);

  const int TY = blockDim.y;
  const int SX = TILE_TX + 2, SY = TY + 2, ns = SX * SY;
  const int lane = threadIdx.x, ty = threadIdx.y;
  const int x0 = blockIdx.x * TILE_TX, y0 = blockIdx.y * TY;
  const int64_t n = int64_t(e.H) * e.W;

  // ---- stage the tile and its halo -----------------------------------------
  for (int s = lane + TILE_TX * ty; s < ns; s += TILE_TX * TY) {  // s: a staged cell
    const int64_t gi = staged_cell<DIM>(e, x0, y0, 0, 1, SX, SY, s);
    stage_pk1<T, DIM>(e, U, prec, gi, n, sm, ns, s);
  }
  __syncthreads();

  // ---- the slots of this thread's cell -------------------------------------
  const int x = x0 + lane, y = y0 + ty;
  if (x >= e.W || y >= e.H) return;
  const int64_t i = int64_t(y) * e.W + x;
  const int si = (1 + ty) * SX + 1 + lane;

  T ui[C], pa_i[5];
  staged_u(sm, ns, si, ui);
  staged_pa<DIM>(sm, ns, si, pa_i);
  const T eta_i = prec[n + i];
  const T rho_i_inv = pa_i[2];
  T fi[C][DIM];
  {
    const T mi[DIM] = {ui[1], ui[2]};
    staged_flux(sm, ns, C, si, mi, fi);
  }
  T left = T(0), right[C] = {T(0), T(0), T(0), T(0)};

  // a slot's reads of device memory, issued together, the next slot's
  // while this one computes (a masked slot reads them too, unused)
  struct Slot {
    T mk, c0, c1;
  };
  auto fetch = [&](int k, Slot& sl) {
    sl.mk = mask[k * n + i];
    sl.c0 = cij[k * n + i];
    sl.c1 = cij[(K + k) * n + i];
  };
  Slot cur;
  fetch(0, cur);
#pragma unroll 1
  for (int k = 0; k < K; ++k) {
    Slot nxt;
    if (k + 1 < K) fetch(k + 1, nxt);
    const T mk = cur.mk, c0 = cur.c0, c1 = cur.c1;
    T lam_k = T(0);
    if (mk > T(0)) {
      const int sj = si + DY(k) * SX + DX(k);
      T uj[C];
      staged_u(sm, ns, sj, uj);
      left += (sm[QV * ns + sj] - eta_i * rho_i_inv) * (uj[1] * c0 + uj[2] * c1);
      T fj[C][DIM];
      {
        const T mj[DIM] = {uj[1], uj[2]};
        staged_flux(sm, ns, C, sj, mj, fj);
      }
#pragma unroll
      for (int q = 0; q < C; ++q)
        right[q] += (fj[q][0] - fi[q][0]) * c0 + (fj[q][1] - fi[q][1]) * c1;

      if (k < K2) {
        const T norm = sqrt(c0 * c0 + c1 * c1);
        const T nn = mx(norm, e.tiny);
        T pa_j[5];
        staged_pa<DIM>(sm, ns, sj, pa_j);
        lam_k = lambda_max(e, ui, pa_i, uj, pa_j, c0 / nn, c1 / nn);
      }
    }
    if (k < K2) lam[k * n + i] = lam_k;
    if (k + 1 < K) cur = nxt;
  }
  alpha[i] = pk1_alpha(e, node, i, n, ui, eta_i, rho_i_inv, left, right);
}

// Shared bytes of the tile (ty rows, halo 1): pk1_vals values a staged
// cell.
template <typename T>
int64_t pk1_smem(int ty) {
  return pk1_vals(2) * int64_t(TILE_TX + 2) * (ty + 2) * int64_t(sizeof(T));
}

// The wrapper's tile (kernels/pk1.py tile()) must fit this layout: 32
// lanes, one z, at most 256 threads, the halo of the reach-1 lattice, a
// grid that covers the canvas, and the bytes pk1_smem gives.
template <typename T>
bool pk1_tile_ok(const Consts* c) {
  const int ty = c->block[1];
  return c->block[0] == TILE_TX && ty >= 1 && c->block[2] == 1 && TILE_TX * ty <= 256 &&
         c->halo == 1 && int64_t(c->grid[0]) * TILE_TX >= c->W &&
         int64_t(c->grid[1]) * ty >= c->H && c->grid[2] == 1 && c->smem == pk1_smem<T>(ty);
}

template <typename T>
int launch_pk1(const T* cij, const T* mask, const T* node, const T* U, const T* prec, T* lam,
               T* alpha, const Consts* consts, cudaStream_t stream) {
  if (consts->dim != 2 || consts->K != K || !pk1_tile_ok<T>(consts))
    return int(cudaErrorInvalidValue);
  const EqConsts<T> e = EqConsts<T>::make(*consts);
  auto kernel = pk1_kernel<T>;
  const int smem = consts->smem;
  const int rc = allow_smem(kernel, smem);
  if (rc != int(cudaSuccess)) return rc;
  const dim3 grid(consts->grid[0], consts->grid[1], consts->grid[2]);
  const dim3 block(consts->block[0], consts->block[1], consts->block[2]);
  kernel<<<grid, block, smem, stream>>>(cij, mask, node, U, prec, lam, alpha, e);
  return int(cudaGetLastError());
}

}  // namespace ryujin

#define RYUJIN_PK1(SUFFIX, T)                                                                 \
  extern "C" int ryujin_pk1_##SUFFIX(const void* cij, const void* mask, const void* node,     \
                                     const void* U, const void* prec, void* lam, void* alpha,  \
                                     const ryujin::Consts* consts, void* stream) {             \
    return ryujin::launch_pk1<T>((const T*)cij, (const T*)mask, (const T*)node, (const T*)U,   \
                                 (const T*)prec, (T*)lam, (T*)alpha, consts,                   \
                                 (cudaStream_t)stream);                                        \
  }

RYUJIN_PK1(f32, float)
RYUJIN_PK1(f64, double)
