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
// four stage states (5 each), with the neighbour reads of U, prec, e,
// alpha and the stages; writes U_low (5), F (5) and bounds (3).  cmax is
// not read.
//
// The graph viscosity of slot k (_slot_d, :2056-2070), by route (HALF):
// half-slot, e_k at the cell for k < K/2 and plane K-1-k of neighbour k
// otherwise; two-direction, max(e_k at the cell, plane K-1-k of
// neighbour k).
//
// Design, full statics (pk2_stream_tile_kernel): a block (32, TY, TZ) owns
// a tile of TY rows of TILE_TX = 32 cells, in 3D at TZ consecutive z, one thread a cell; the grid covers the
// canvas in such tiles.  The block first stages (staged.cuh), for the tile
// and its halo of the lattice reach h (in 3D the z neighbours too), what a
// slot reads at its neighbour j: U and the parts of f(U), alpha_j, s_j
// (prec plane 0), and the parts of f(sU_s) of each stage, one shared array
// per value.  Each neighbour flux is so formed once per staged cell: in 3D
// at two stages, 3 flux parts (a division each) for each staged cell,
// where the one-thread-per-cell form made 78 flux evaluations a cell and
// gathered ~470 neighbour values from device memory.  The slot loop reads
// its neighbour and its own cell from shared memory, and from device
// memory only the statics (c_ij, the mask, the dG `inc`) and the
// transposed e, all of a slot at once and the next slot's while this one
// computes.  The stage loop reads shared memory at a runtime stage index
// and keeps no per-stage array, so no instance has a stack frame (the
// stage weight is a select on the stage index among the MS weights of the
// instance: MS = 2, or MAX_STAGES for ERK54's 3 and 4 slots, chosen at
// launch by n_stages; the SEP instances keep MS stage fluxes of the
// cell).  On
// box3d this form takes 0.45 ms against 0.63 at two stages (H100 SXM,
// 700 W; PERF.md §6).  The thread carries only running accumulators: the low-order and F sums
// (2 x C) and the six bound accumulators of limiter_bounds_accum, seeded
// with the diagonal terms.  Masked slots are skipped, which equals the
// reference's multiplication by a zero mask on finite data.  tau is read
// from device memory (no host sync).  Every sum runs over k = 0 .. K-1 in
// order and adds the diagonal last, as pk2_stream_reference does, and
// each slot does the arithmetic of the one-thread-per-cell form in its
// order (the per-slot entropy's division and pow, rho_bar's DIM
// divisions stay), so U_low, F and the bounds keep their bits.  The
// bounds relax by r_i = (h^d_i)^(3/4) in 2D and (h^d_i)^(1/2) in 3D
// (euler/limiter.h:330-363).  The tile (TY, TZ), the halo and the shared
// bytes come from kernels/pk2_stream.py tile(); the launcher refuses a
// tile whose halo is short of the reach, whose grid misses the canvas or
// whose bytes are not this layout's, and sets the instance's dynamic
// shared memory above 48 KB.
//
// dG (DG = true; the TPU kernels take it at pallas_step.py:2942-2944 in
// `pk2_stream` and, in 3D, through the stacked launcher _tiled_call_3d,
// :597): the factor of d_H is max(1/2 (alpha_i + alpha_j), beta_ij), beta
// read from the K incidence planes `inc`.  The flag is a template
// parameter, so the cG instances read no incidence plane and compile as
// before.
//
// Statics (statics.cuh): the staged tile reads the stored planes
// (FullStatics).  The SEP instances (SepStatics, 3D cG only: c_ij, the
// mask and c_ii synthesized from the separable factors g2 / fz, as
// `_SepTile` does in `_step_slab`'s pk2, :2276-2277, 2340, at 4 multiplies
// a slot and 3 a cell in place of 107 planes) keep the one-thread-per-cell
// form (pk2_stream_kernel, one thread a cell, 128 along x, the loop over k
// not unrolled, the stage fluxes of the cell in a per-thread array): the
// staged tile was faster there at two stages only, and slower by 8 %
// over the three stage counts of an ERK33 step on cylinder3d (0.70 against
// 0.65 ms; PERF.md §6).  The factor pointers come after the constants.
#include "staged.cuh"

namespace ryujin {

// ---- one thread a cell: the SEP instances ---------------------------------
template <typename T, int DIM, bool HALF, bool DG, class ST, int MS>
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
  T w_s[MS];
#pragma unroll
  for (int s = 0; s < MS; ++s) w_s[s] = stage_weight<MS>(e, s);

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

  T fs_i[MS][NC][DIM];
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

// ---- a staged tile: the full-statics instances ----------------------------

template <typename T, int DIM, bool HALF, bool DG, int MS>
__global__ void __launch_bounds__(256)
pk2_stream_tile_kernel(const T* __restrict__ cij, const T* __restrict__ mask,
                       const T* __restrict__ inc, const T* __restrict__ cii,
                       const T* __restrict__ node, const T* __restrict__ U,
                       const T* __restrict__ prec, const T* __restrict__ ed,
                       const T* __restrict__ alpha, const T* __restrict__ sU,
                       const T* __restrict__ tau_ptr, T* __restrict__ U_low,
                       T* __restrict__ F_out, T* __restrict__ bounds,
                       const __grid_constant__ EqConsts<T> e, const int h) {
  constexpr int NC = DIM + 2;
  constexpr int UV = u_vals(DIM), SV = stage_vals(DIM);
  constexpr int AV = UV, PV = UV + 1, SB = UV + 2;  // alpha_j, s_j, the stages
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sm = reinterpret_cast<T*>(smem_raw);

  const int S = e.n_stages, K = e.K, K2 = K / 2;
  const int TY = blockDim.y, TZ = blockDim.z;
  const int SX = TILE_TX + 2 * h, SY = TY + 2 * h, SZ = DIM == 3 ? TZ + 2 * h : 1;
  const int ns = SX * SY * SZ;
  const int lane = threadIdx.x, ty = threadIdx.y, tz = DIM == 3 ? threadIdx.z : 0;
  const int tid = lane + TILE_TX * (ty + TY * threadIdx.z);
  const int x0 = blockIdx.x * TILE_TX, y0 = blockIdx.y * TY, z0 = DIM == 3 ? blockIdx.z * TZ : 0;
  const int64_t n = int64_t(e.D) * e.H * e.W;

  // ---- stage the tile and its halo -----------------------------------------
  for (int s = tid; s < ns; s += TILE_TX * TY * TZ) {  // s: a staged cell
    const int64_t gi = staged_cell<DIM>(e, x0, y0, z0, h, SX, SY, s);
    stage_state<T, DIM>(e, U, gi, n, sm, ns, s);
    sm[AV * ns + s] = alpha[gi];
    sm[PV * ns + s] = prec[gi];
    for (int stage = 0; stage < S; ++stage)
      stage_stage<T, DIM>(e, sU + stage * NC * n, gi, n, sm, ns, s, SB + stage * SV);
  }
  __syncthreads();

  // ---- the slots of this thread's cell -------------------------------------
  Cell c;
  c.x = x0 + lane;
  c.y = y0 + ty;
  c.z = z0 + tz;
  c.n = n;
  c.i = (int64_t(c.z) * e.H + c.y) * e.W + c.x;
  if (c.x >= e.W || c.y >= e.H || c.z >= e.D) return;
  const FullStatics<T> st(e, cij, nullptr, mask, nullptr, cii, nullptr, nullptr);
  const int64_t i = c.i;
  const int si = ((DIM == 3 ? h + tz : 0) * SY + h + ty) * SX + h + lane;

  T ui[NC], mi[DIM];
#pragma unroll
  for (int q = 0; q < NC; ++q) ui[q] = sm[q * ns + si];
#pragma unroll
  for (int d = 0; d < DIM; ++d) mi[d] = ui[1 + d];
  const T s_i = sm[PV * ns + si];
  const T alpha_i = sm[AV * ns + si];
  const T tau = *tau_ptr;

  T fi[NC][DIM];
  staged_flux(sm, ns, NC, si, mi, fi);
  T cvi[DIM];
#pragma unroll
  for (int d = 0; d < DIM; ++d) cvi[d] = st.cii(c, e, d);

  T low_acc[NC], F_acc[NC];
#pragma unroll
  for (int q = 0; q < NC; ++q) low_acc[q] = F_acc[q] = T(0);
  // limiter_bounds_init: the diagonal (j = i) contributions
  T rho_min = ui[0], rho_max = ui[0], s_min = s_i, s_interp_max = s_i;
  T relax_num = T(2) * ui[0], k_count = T(0);

  // a slot's reads of device memory, issued together, the next slot's
  // while this one computes (a masked slot reads them too, unused)
  struct Slot {
    T mk, e0, e1, cv[DIM], beta;
  };
  auto fetch = [&](int k, Slot& sl) {
    sl.mk = st.mask(c, e, k);
    const int64_t j = nbr_k<DIM>(c, e, k);
    sl.e0 = HALF && k >= K2 ? ed[(K - 1 - k) * n + j] : ed[k * n + i];
    sl.e1 = HALF ? T(0) : ed[(K - 1 - k) * n + j];
#pragma unroll
    for (int dd = 0; dd < DIM; ++dd) sl.cv[dd] = st.cij(c, e, dd, k);
    sl.beta = DG ? inc[k * n + i] : T(0);
  };
  Slot cur;
  fetch(0, cur);
#pragma unroll 1
  for (int k = 0; k < K; ++k) {
    Slot nxt;
    if (k + 1 < K) fetch(k + 1, nxt);
    if (cur.mk > T(0)) {
      const int sj = si + ((DIM == 3 ? e.dz[k] : 0) * SY + e.dy[k]) * SX + e.dx[k];
      const T d = HALF ? cur.e0 : mx(cur.e0, cur.e1);
      T uj[NC], mj[DIM];
#pragma unroll
      for (int q = 0; q < NC; ++q) uj[q] = sm[q * ns + sj];
#pragma unroll
      for (int dd = 0; dd < DIM; ++dd) mj[dd] = uj[1 + dd];
      T factor = T(0.5) * (alpha_i + sm[AV * ns + sj]);
      if constexpr (DG) factor = mx(factor, cur.beta);
      const T d_H = d * factor;
      {
        T fj[NC][DIM];
        staged_flux(sm, ns, NC, sj, mj, fj);
#pragma unroll
        for (int q = 0; q < NC; ++q) {
          const T flux_ij = flux_div(fi, fj, q, cur.cv);
          const T dU = uj[q] - ui[q];
          low_acc[q] += flux_ij + d * dU;
          F_acc[q] += d_H * dU + e.weight * flux_ij;
        }
      }
      for (int s = 0; s < S; ++s) {
        T fsi[NC][DIM], fsj[NC][DIM];
        staged_stage_flux(sm, ns, SB + s * SV, si, fsi);
        staged_stage_flux(sm, ns, SB + s * SV, sj, fsj);
        const T w_s = stage_weight<MS>(e, s);
#pragma unroll
        for (int q = 0; q < NC; ++q) F_acc[q] += w_s * flux_div(fsi, fsj, q, cur.cv);
      }

      // limiter_bounds_accum (euler/limiter.h:255-363)
      const T dr = mx(d, e.reg);
      T rho_bar = (ui[1] - uj[1]) * (cur.cv[0] / dr);
#pragma unroll
      for (int dd = 1; dd < DIM; ++dd)
        rho_bar = rho_bar + (ui[1 + dd] - uj[1 + dd]) * (cur.cv[dd] / dr);
      rho_bar = T(0.5) * (ui[0] + uj[0] + rho_bar);
      rho_min = mn(rho_min, rho_bar);
      rho_max = mx(rho_max, rho_bar);
      s_min = mn(s_min, sm[PV * ns + sj]);
      T u_half[NC];
#pragma unroll
      for (int q = 0; q < NC; ++q) u_half[q] = T(0.5) * (ui[q] + uj[q]);
      s_interp_max = mx(s_interp_max, specific_entropy(e, u_half));
      relax_num += (ui[0] + uj[0]) * cur.mk;
      k_count += cur.mk;
    }
    if (k + 1 < K) cur = nxt;
  }

  const T m_inv = node[n + i];
  T F[NC];
#pragma unroll
  for (int q = 0; q < NC; ++q) {
    const T flux_ii = flux_div(fi, fi, q, cvi);
    U_low[q * n + i] = ui[q] + (tau * m_inv) * (low_acc[q] + flux_ii);
    F[q] = F_acc[q] + e.weight * flux_ii;
  }
  for (int s = 0; s < S; ++s) {
    T fsi[NC][DIM];
    staged_stage_flux(sm, ns, SB + s * SV, si, fsi);
    const T w_s = stage_weight<MS>(e, s);
#pragma unroll
    for (int q = 0; q < NC; ++q) F[q] = F[q] + w_s * flux_div(fsi, fsi, q, cvi);
  }
#pragma unroll
  for (int q = 0; q < NC; ++q) F_out[q * n + i] = F[q];

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

// Shared bytes of the tile (ty rows at tz z, halo h) at `stages` stages.
template <typename T>
int64_t pk2_stream_smem(int dim, int stages, int ty, int tz, int h) {
  const int64_t ns =
      int64_t(TILE_TX + 2 * h) * (ty + 2 * h) * (dim == 3 ? tz + 2 * h : 1);
  return pk2_vals(dim, stages) * ns * int64_t(sizeof(T));
}

// The wrapper's tile (kernels/pk2_stream.py tile()) must fit this layout:
// 32 lanes, at most 256 threads, one z in 2D, a halo no shorter than the
// lattice reach, a grid that covers the canvas, and the bytes
// pk2_stream_smem gives.
template <typename T>
bool pk2_stream_tile_ok(const Consts* c) {
  const int ty = c->block[1], tz = c->block[2];
  const bool cover_z = c->dim == 3 ? int64_t(c->grid[2]) * tz >= c->D : c->grid[2] == 1 && tz == 1;
  return c->block[0] == TILE_TX && ty >= 1 && tz >= 1 && TILE_TX * ty * tz <= 256 &&
         c->halo >= lattice_reach(c) && int64_t(c->grid[0]) * TILE_TX >= c->W &&
         int64_t(c->grid[1]) * ty >= c->H && cover_z &&
         c->smem == pk2_stream_smem<T>(c->dim, c->n_stages, ty, tz, c->halo);
}

template <typename T, int DIM, bool HALF, bool DG, int MS>
int launch_pk2_stream_tile(const T* cij, const T* mask, const T* inc, const T* cii,
                           const T* node, const T* U, const T* prec, const T* ed,
                           const T* alpha, const T* sU, const T* tau, T* U_low, T* F, T* bounds,
                           const EqConsts<T>& e, const Consts* consts, cudaStream_t stream) {
  auto kernel = pk2_stream_tile_kernel<T, DIM, HALF, DG, MS>;
  const int smem = consts->smem;
  const int rc = allow_smem(kernel, smem);
  if (rc != int(cudaSuccess)) return rc;
  const dim3 grid(consts->grid[0], consts->grid[1], consts->grid[2]);
  const dim3 block(consts->block[0], consts->block[1], consts->block[2]);
  kernel<<<grid, block, smem, stream>>>(cij, mask, inc, cii, node, U, prec, ed, alpha, sU, tau,
                                        U_low, F, bounds, e, consts->halo);
  return int(cudaGetLastError());
}

template <typename T, bool DG, int MS>
int launch_pk2_stream_route(const T* cij, const T* mask, const T* inc, const T* cii, const T* node,
                            const T* U, const T* prec, const T* ed, const T* alpha, const T* sU,
                            const T* tau, T* U_low, T* F, T* bounds, const EqConsts<T>& e,
                            const Consts* consts, cudaStream_t stream) {
  if (consts->dim == 2 && consts->half)
    return launch_pk2_stream_tile<T, 2, true, DG, MS>(cij, mask, inc, cii, node, U, prec, ed, alpha,
                                                  sU, tau, U_low, F, bounds, e, consts, stream);
  if (consts->dim == 3 && consts->half)
    return launch_pk2_stream_tile<T, 3, true, DG, MS>(cij, mask, inc, cii, node, U, prec, ed, alpha,
                                                  sU, tau, U_low, F, bounds, e, consts, stream);
  if (consts->dim == 3)
    return launch_pk2_stream_tile<T, 3, false, DG, MS>(cij, mask, inc, cii, node, U, prec, ed, alpha,
                                                   sU, tau, U_low, F, bounds, e, consts, stream);
  return int(cudaErrorInvalidValue);
}

// The SEP instances of a route at most MS stages.
template <typename T, int MS>
int launch_pk2_stream_sep(const T* cij, const T* mask, const T* inc, const T* cii, const T* node,
                          const T* U, const T* prec, const T* ed, const T* alpha, const T* sU,
                          const T* tau, T* U_low, T* F, T* bounds, const T* g2, const T* fz,
                          const EqConsts<T>& e, const Consts* consts, cudaStream_t stream) {
  const dim3 grid = canvas_grid(e.D, e.H, e.W), block = canvas_block();
  if (consts->half)
    pk2_stream_kernel<T, 3, true, false, SepStatics<T>, MS><<<grid, block, 0, stream>>>(
        cij, mask, inc, cii, node, U, prec, ed, alpha, sU, tau, U_low, F, bounds, e, g2, fz);
  else
    pk2_stream_kernel<T, 3, false, false, SepStatics<T>, MS><<<grid, block, 0, stream>>>(
        cij, mask, inc, cii, node, U, prec, ed, alpha, sU, tau, U_low, F, bounds, e, g2, fz);
  return int(cudaGetLastError());
}

// g2 and fz given: the SEP instances (3D cG, K = 26), one thread a cell;
// both null: the full statics, cG or dG by `inc`, on the wrapper's tile.
// Each takes its instance of at most 2 stages, or of MAX_STAGES above 2.
template <typename T>
int launch_pk2_stream(const T* cij, const T* mask, const T* inc, const T* cii, const T* node,
                      const T* U, const T* prec, const T* ed, const T* alpha, const T* sU,
                      const T* tau, T* U_low, T* F, T* bounds, const T* g2, const T* fz,
                      const Consts* consts, cudaStream_t stream) {
  if (consts->K < 2 || consts->K > MAX_K || consts->K % 2) return int(cudaErrorInvalidValue);
  if (consts->n_stages < 0 || consts->n_stages > MAX_STAGES) return int(cudaErrorInvalidValue);
  const EqConsts<T> e = EqConsts<T>::make(*consts);
  const bool wide = consts->n_stages > 2;
  if (g2 || fz) {
    if (!g2 || !fz || inc || consts->dim != 3 || consts->K != 26)
      return int(cudaErrorInvalidValue);
    if (wide)
      return launch_pk2_stream_sep<T, MAX_STAGES>(cij, mask, inc, cii, node, U, prec, ed, alpha,
                                                  sU, tau, U_low, F, bounds, g2, fz, e, consts,
                                                  stream);
    return launch_pk2_stream_sep<T, 2>(cij, mask, inc, cii, node, U, prec, ed, alpha, sU, tau,
                                       U_low, F, bounds, g2, fz, e, consts, stream);
  }
  if (!pk2_stream_tile_ok<T>(consts)) return int(cudaErrorInvalidValue);
  if (inc && wide)
    return launch_pk2_stream_route<T, true, MAX_STAGES>(cij, mask, inc, cii, node, U, prec, ed,
                                                        alpha, sU, tau, U_low, F, bounds, e,
                                                        consts, stream);
  if (inc)
    return launch_pk2_stream_route<T, true, 2>(cij, mask, inc, cii, node, U, prec, ed, alpha, sU,
                                               tau, U_low, F, bounds, e, consts, stream);
  if (wide)
    return launch_pk2_stream_route<T, false, MAX_STAGES>(cij, mask, inc, cii, node, U, prec, ed,
                                                         alpha, sU, tau, U_low, F, bounds, e,
                                                         consts, stream);
  return launch_pk2_stream_route<T, false, 2>(cij, mask, inc, cii, node, U, prec, ed, alpha, sU,
                                              tau, U_low, F, bounds, e, consts, stream);
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
