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
// the transposed e.  The limiter's Newton iterations (one pow per
// evaluation) add branchy compute on the shocked cells only.
//
// Design: a block owns a tile of TY rows of TX = 32 cells (in 3D at one
// z), block (32, TY, G): lanes are cells along x, and the G threads of a
// cell take its slots k = g, g + G, ...  The block first stages, for the
// tile and its halo of the lattice reach h (in 3D the z neighbours too),
// what a slot reads at its neighbour j: U, the parts of the fluxes f(U)
// and f(sU_s) of each stage (1/rho times m, p and E + p, the operands
// `flux` forms every entry from, so f_j is rebuilt bit for bit with 12
// multiplies and no division), F, m_j and alpha_j, one shared array per
// value, cells along x (staged.cuh, which pk2_stream and the stacked pk3
// share).  Each flux is so formed once per staged cell, not once per
// slot: with the 3D tile (4, 2), 3 x 4.8 flux parts (a division
// each) a cell at two stages, where the one-thread-per-cell form made 81
// flux evaluations and gathered ~600 values.  The slot loop reads its
// neighbour and its own cell from shared memory, and from device memory
// only the statics (c_ij, m_ij, the mask, the dG `inc`) and the
// transposed e, all of a slot at once and the next slot's while this one
// computes; P and l are still written one plane per slot, coalesced along
// x.  The stage loop reads shared memory at a runtime stage index and
// keeps no per-stage array, so no instance has a stack frame; the stage
// weight is a select on that index among the MS weights of the instance
// (MS = 2, or MAX_STAGES for ERK54's 3 and 4 slots, chosen at launch by
// n_stages).  Staged
// cells wrap on every axis as nbr_k does (a ragged or narrow tile wraps
// further, and only cells no output reads lie past a single wrap).  The
// tile (TY, G), the halo and the shared bytes come from
// kernels/pk3_stream.py tile(): (4, 2) in 3D (81 KB in f32 at two stages,
// two blocks and 16 warps an SM), (4, 1) in 2D; the launcher refuses a
// tile whose halo is short of the reach, whose grid misses the canvas or
// whose bytes are not this layout's, and sets the instance's dynamic
// shared memory above 48 KB.  On box3d this form takes 0.64 ms against
// the one-thread-per-cell form's 0.93 (H100 SXM, 700 W; PERF.md §6).
//
// The edge mask is folded into the stored P (as _step_slab does at
// :2498), and masked slots write P = 0 and l = 0, so pk_up needs no guard
// on its transposed read of l.  The limiter returns per lane where
// psi(t_r) > 0 (exact, see limiter_limit).  The graph viscosity of slot k
// is read by route (HALF) as in pk2_stream.cu; cmax is not read.  Every
// slot does the arithmetic of the plain twin (pk3_stream_reference) in its
// order, so P, l and okp are bit-equal to it.
//
// dG (DG = true; the TPU kernels take it at pallas_step.py:3167-3171 in
// `pk3_stream` and, in 3D, through the stacked launcher _tiled_call_3d,
// :597): the factor of d_H is max(1/2 (alpha_i + alpha_j), beta_ij), beta
// read from the K incidence planes `inc`.  The flag is a template
// parameter, so the cG instances read no incidence plane.
//
// Statics (ST, statics.cuh): FullStatics reads the stored planes;
// SepStatics (3D cG only) synthesizes c_ij, m_ij and the mask from the
// separable factors g2 / fz, as `_SepTile` does in `_step_slab`'s pk3
// (:2276-2277, 2471): the 130 planes of c_ij, m_ij and the mask give way
// to the L2-resident factors, at 5 multiplies a slot.  The factor pointers
// come after the constants.
#include "staged.cuh"

namespace ryujin {

// At most 256 threads a block; the 2D f32 instances are held to 85
// registers (three such blocks an SM): 0.6636 against 0.7303 ms on
// q2step2d with the (4, 1) tile, where the 3D instances lost 6-10 % under
// any cap (H100 SXM, 700 W).
template <typename T, int DIM, bool HALF, bool DG, class ST, int MS>
__global__ void __launch_bounds__(256, DIM == 2 && sizeof(T) == 4 ? 3 : 1)
pk3_stream_kernel(const T* __restrict__ cij, const T* __restrict__ mij,
                  const T* __restrict__ mask, const T* __restrict__ inc,
                  const T* __restrict__ node,
                  const T* __restrict__ U, const T* __restrict__ ed, const T* __restrict__ alpha,
                  const T* __restrict__ Fin, const T* __restrict__ U_low,
                  const T* __restrict__ bounds, const T* __restrict__ sU,
                  const T* __restrict__ tau_ptr, T* __restrict__ P_out, T* __restrict__ l_out,
                  T* __restrict__ okp, const __grid_constant__ EqConsts<T> e,
                  const T* __restrict__ g2, const T* __restrict__ fz, const int h) {
  static_assert(!ST::kSeparable || (DIM == 3 && !DG), "separable statics are 3D cG");
  constexpr int NC = DIM + 2;
  constexpr int UV = u_vals(DIM), SV = stage_vals(DIM);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sm = reinterpret_cast<T*>(smem_raw);

  const int S = e.n_stages, K = e.K, K2 = K / 2;
  const int TY = blockDim.y, G = blockDim.z;
  const int SX = TILE_TX + 2 * h, SY = TY + 2 * h, SZ = DIM == 3 ? 1 + 2 * h : 1;
  const int ns = SX * SY * SZ;
  const int FB = UV + S * SV;  // F, then m_j, then alpha_j
  int* const okc = reinterpret_cast<int*>(sm + (FB + NC + 2) * ns);
  const int lane = threadIdx.x, ty = threadIdx.y, g = threadIdx.z;
  const int tid = lane + TILE_TX * (ty + TY * g);
  const int x0 = blockIdx.x * TILE_TX, y0 = blockIdx.y * TY, z0 = DIM == 3 ? blockIdx.z : 0;
  const int64_t n = int64_t(e.D) * e.H * e.W;

  // ---- stage the tile and its halo -----------------------------------------
  for (int s = tid; s < ns; s += TILE_TX * TY * G) {  // s: a staged cell
    const int sx = s % SX, sy = (s / SX) % SY, sz = s / (SX * SY);
    const int xg = wrap_any(x0 - h + sx, e.W), yg = wrap_any(y0 - h + sy, e.H);
    const int zg = DIM == 3 ? wrap_any(z0 - h + sz, e.D) : 0;
    const int64_t gi = (int64_t(zg) * e.H + yg) * e.W + xg;
    T u[NC], v[DIM], p, Ep;
    load_state(U, gi, n, u);
    flux_parts(e, u, v, p, Ep);
#pragma unroll
    for (int q = 0; q < NC; ++q) sm[q * ns + s] = u[q];
#pragma unroll
    for (int d = 0; d < DIM; ++d) sm[(NC + d) * ns + s] = v[d];
    sm[(NC + DIM) * ns + s] = p;
    sm[(NC + DIM + 1) * ns + s] = Ep;
    for (int stage = 0; stage < S; ++stage) {
      load_state(sU + stage * NC * n, gi, n, u);
      flux_parts(e, u, v, p, Ep);
      const int at = UV + stage * SV;
#pragma unroll
      for (int d = 0; d < DIM; ++d) {
        sm[(at + d) * ns + s] = u[1 + d];
        sm[(at + DIM + d) * ns + s] = v[d];
      }
      sm[(at + 2 * DIM) * ns + s] = p;
      sm[(at + 2 * DIM + 1) * ns + s] = Ep;
    }
#pragma unroll
    for (int q = 0; q < NC; ++q) sm[(FB + q) * ns + s] = Fin[q * n + gi];
    sm[(FB + NC) * ns + s] = node[gi];
    sm[(FB + NC + 1) * ns + s] = alpha[gi];
  }
  if (g == 0) okc[ty * TILE_TX + lane] = 1;
  __syncthreads();

  // ---- the slots of this thread's cell -------------------------------------
  Cell c;
  c.x = x0 + lane;
  c.y = y0 + ty;
  c.z = z0;
  c.n = n;
  c.i = (int64_t(c.z) * e.H + c.y) * e.W + c.x;
  if (c.x < e.W && c.y < e.H) {
    const ST st(e, cij, nullptr, mask, mij, nullptr, g2, fz);
    const int64_t i = c.i;
    const int si = ((DIM == 3 ? h : 0) * SY + h + ty) * SX + h + lane;

    T ui[NC], fi_F[NC], ul[NC], mi[DIM];
#pragma unroll
    for (int q = 0; q < NC; ++q) {
      ui[q] = sm[q * ns + si];
      fi_F[q] = sm[(FB + q) * ns + si];
    }
#pragma unroll
    for (int d = 0; d < DIM; ++d) mi[d] = ui[1 + d];
    load_state(U_low, i, n, ul);
    const T bnd[3] = {bounds[i], bounds[n + i], bounds[2 * n + i]};
    const T alpha_i = sm[(FB + NC + 1) * ns + si];
    const T m_inv = node[n + i];
    const T tau = *tau_ptr;
    const T pfac = tau * m_inv * node[2 * n + i];
    const bool real = node[3 * n + i] > T(0);
    T psi0[4];
    limiter_psi0(e, bnd[2], ul, psi0);

    // a slot's reads of device memory, issued together, the next slot's
    // while this one computes (a masked slot reads them too, unused)
    struct Slot {
      T mk, e0, e1, cv[DIM], m_ij, beta;
      int64_t j;
    };
    auto fetch = [&](int k, Slot& sl) {
      sl.mk = st.mask(c, e, k);
      sl.j = nbr_k<DIM>(c, e, k);
      sl.e0 = HALF && k >= K2 ? ed[(K - 1 - k) * n + sl.j] : ed[k * n + i];
      sl.e1 = HALF ? T(0) : ed[(K - 1 - k) * n + sl.j];
#pragma unroll
      for (int dd = 0; dd < DIM; ++dd) sl.cv[dd] = st.cij(c, e, dd, k);
      sl.m_ij = st.mij(c, e, k);
      sl.beta = DG ? inc[k * n + i] : T(0);
    };
    Slot cur;
    if (g < K) fetch(g, cur);
    bool ok = true;
#pragma unroll 1
    for (int k = g; k < K; k += G) {
      Slot nxt;
      if (k + G < K) fetch(k + G, nxt);
      if (!(cur.mk > T(0))) {
#pragma unroll
        for (int q = 0; q < NC; ++q) P_out[(q * K + k) * n + i] = T(0);
        l_out[k * n + i] = T(0);
      } else {
        const int sj = si + ((DIM == 3 ? e.dz[k] : 0) * SY + e.dy[k]) * SX + e.dx[k];
        const T d = HALF ? cur.e0 : mx(cur.e0, cur.e1);
        T factor = T(0.5) * (alpha_i + sm[(FB + NC + 1) * ns + sj]);
        if constexpr (DG) factor = mx(factor, cur.beta);
        const T d_H = d * factor;

        T P[NC];
        {
          T uj[NC], mj[DIM], fi[NC][DIM], fj[NC][DIM];
#pragma unroll
          for (int q = 0; q < NC; ++q) uj[q] = sm[q * ns + sj];
#pragma unroll
          for (int d = 0; d < DIM; ++d) mj[d] = uj[1 + d];
          staged_flux(sm, ns, NC, si, mi, fi);
          staged_flux(sm, ns, NC, sj, mj, fj);
#pragma unroll
          for (int q = 0; q < NC; ++q)
            P[q] = e.weight_m1 * flux_div(fi, fj, q, cur.cv) + (d_H - d) * (uj[q] - ui[q]);
        }
        for (int s = 0; s < S; ++s) {
          T fsi[NC][DIM], fsj[NC][DIM];
          staged_stage_flux(sm, ns, UV + s * SV, si, fsi);
          staged_stage_flux(sm, ns, UV + s * SV, sj, fsj);
          const T w_s = stage_weight<MS>(e, s);
#pragma unroll
          for (int q = 0; q < NC; ++q) P[q] = P[q] + w_s * flux_div(fsi, fsj, q, cur.cv);
        }
        const T b_ij = -cur.m_ij / sm[(FB + NC) * ns + sj];
        const T b_ji = -cur.m_ij * m_inv;
#pragma unroll
        for (int q = 0; q < NC; ++q) {
          P[q] = (P[q] + b_ij * sm[(FB + q) * ns + sj] - b_ji * fi_F[q]) * pfac;
          P_out[(q * K + k) * n + i] = P[q];
        }
        bool success;
        l_out[k * n + i] = limiter_limit(e, bnd, ul, psi0, P, success);
        if (real && !success) ok = false;
      }
      if (k + G < K) cur = nxt;
    }
    if (!ok) okc[ty * TILE_TX + lane] = 0;
  }
  __syncthreads();
  if (g == 0 && c.x < e.W && c.y < e.H) okp[c.i] = okc[ty * TILE_TX + lane] ? T(1) : T(0);
}

// Shared bytes of the tile (ty rows, halo h) at `stages` stages.
template <typename T>
int64_t pk3_stream_smem(int dim, int stages, int ty, int h) {
  const int64_t ns =
      int64_t(TILE_TX + 2 * h) * (ty + 2 * h) * (dim == 3 ? 1 + 2 * h : 1);
  return pk3_vals(dim, stages) * ns * int64_t(sizeof(T)) + int64_t(ty) * TILE_TX * 4;
}

template <typename T, int DIM, bool HALF, bool DG, class ST, int MS>
int launch_pk3_stream_instance(const T* cij, const T* mij, const T* mask, const T* inc,
                               const T* node, const T* U, const T* ed, const T* alpha,
                               const T* F, const T* U_low, const T* bounds, const T* sU,
                               const T* tau, T* P, T* l, T* okp, const T* g2, const T* fz,
                               const EqConsts<T>& e, const Consts* consts, cudaStream_t stream) {
  auto kernel = pk3_stream_kernel<T, DIM, HALF, DG, ST, MS>;
  const int smem = consts->smem;
  const int rc = allow_smem(kernel, smem);
  if (rc != int(cudaSuccess)) return rc;
  const dim3 grid(consts->grid[0], consts->grid[1], consts->grid[2]);
  const dim3 block(consts->block[0], consts->block[1], consts->block[2]);
  kernel<<<grid, block, smem, stream>>>(cij, mij, mask, inc, node, U, ed, alpha, F, U_low, bounds,
                                        sU, tau, P, l, okp, e, g2, fz, consts->halo);
  return int(cudaGetLastError());
}

template <typename T, bool DG, class ST, int MS>
int launch_pk3_stream_route(const T* cij, const T* mij, const T* mask, const T* inc,
                            const T* node, const T* U, const T* ed, const T* alpha, const T* F,
                            const T* U_low, const T* bounds, const T* sU, const T* tau, T* P,
                            T* l, T* okp, const T* g2, const T* fz, const EqConsts<T>& e,
                            const Consts* consts, cudaStream_t stream) {
  if constexpr (!ST::kSeparable) {
    if (consts->dim == 2 && consts->half)
      return launch_pk3_stream_instance<T, 2, true, DG, ST, MS>(cij, mij, mask, inc, node, U, ed,
                                                            alpha, F, U_low, bounds, sU, tau, P,
                                                            l, okp, g2, fz, e, consts, stream);
  }
  if (consts->dim == 3 && consts->half)
    return launch_pk3_stream_instance<T, 3, true, DG, ST, MS>(cij, mij, mask, inc, node, U, ed, alpha,
                                                          F, U_low, bounds, sU, tau, P, l, okp,
                                                          g2, fz, e, consts, stream);
  if (consts->dim == 3)
    return launch_pk3_stream_instance<T, 3, false, DG, ST, MS>(cij, mij, mask, inc, node, U, ed,
                                                           alpha, F, U_low, bounds, sU, tau, P, l,
                                                           okp, g2, fz, e, consts, stream);
  return int(cudaErrorInvalidValue);
}

// The wrapper's tile (kernels/pk3_stream.py tile()) must fit this layout:
// 32 lanes, a halo no shorter than the lattice reach, a grid that covers
// the canvas, and the bytes pk3_stream_smem gives.
template <typename T>
bool pk3_stream_tile_ok(const Consts* c) {
  const int reach = lattice_reach(c);
  const int ty = c->block[1], G = c->block[2];
  return c->block[0] == TILE_TX && ty >= 1 && G >= 1 && TILE_TX * ty * G <= 256 &&
         c->halo >= reach && int64_t(c->grid[0]) * TILE_TX >= c->W &&
         int64_t(c->grid[1]) * ty >= c->H && c->grid[2] == (c->dim == 3 ? c->D : 1) &&
         c->smem == pk3_stream_smem<T>(c->dim, c->n_stages, ty, c->halo);
}

// The instances of at most MS stages: g2 and fz given, the SEP instances
// (3D cG, K = 26); both null, the full statics, cG or dG by `inc`.
template <typename T, int MS>
int launch_pk3_stream_stages(const T* cij, const T* mij, const T* mask, const T* inc,
                             const T* node, const T* U, const T* ed, const T* alpha, const T* F,
                             const T* U_low, const T* bounds, const T* sU, const T* tau, T* P,
                             T* l, T* okp, const T* g2, const T* fz, const EqConsts<T>& e,
                             const Consts* consts, cudaStream_t stream) {
  if (g2 || fz) {
    if (!g2 || !fz || inc || consts->dim != 3 || consts->K != 26)
      return int(cudaErrorInvalidValue);
    return launch_pk3_stream_route<T, false, SepStatics<T>, MS>(
        cij, mij, mask, inc, node, U, ed, alpha, F, U_low, bounds, sU, tau, P, l, okp, g2, fz,
        e, consts, stream);
  }
  if (inc)
    return launch_pk3_stream_route<T, true, FullStatics<T>, MS>(
        cij, mij, mask, inc, node, U, ed, alpha, F, U_low, bounds, sU, tau, P, l, okp, g2, fz,
        e, consts, stream);
  return launch_pk3_stream_route<T, false, FullStatics<T>, MS>(
      cij, mij, mask, inc, node, U, ed, alpha, F, U_low, bounds, sU, tau, P, l, okp, g2, fz, e,
      consts, stream);
}

// The instances of at most 2 stages, or of MAX_STAGES above 2.
template <typename T>
int launch_pk3_stream(const T* cij, const T* mij, const T* mask, const T* inc, const T* node,
                      const T* U, const T* ed, const T* alpha, const T* F, const T* U_low,
                      const T* bounds, const T* sU, const T* tau, T* P, T* l, T* okp,
                      const T* g2, const T* fz, const Consts* consts, cudaStream_t stream) {
  if (consts->K < 2 || consts->K > MAX_K || consts->K % 2 || !pk3_stream_tile_ok<T>(consts))
    return int(cudaErrorInvalidValue);
  if (consts->n_stages < 0 || consts->n_stages > MAX_STAGES) return int(cudaErrorInvalidValue);
  const EqConsts<T> e = EqConsts<T>::make(*consts);
  if (consts->n_stages > 2)
    return launch_pk3_stream_stages<T, MAX_STAGES>(cij, mij, mask, inc, node, U, ed, alpha, F,
                                                   U_low, bounds, sU, tau, P, l, okp, g2, fz, e,
                                                   consts, stream);
  return launch_pk3_stream_stages<T, 2>(cij, mij, mask, inc, node, U, ed, alpha, F, U_low, bounds,
                                        sU, tau, P, l, okp, g2, fz, e, consts, stream);
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
