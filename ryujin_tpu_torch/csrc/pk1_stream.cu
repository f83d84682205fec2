// PK1, slot-streaming form: the wavespeeds e and the EVC indicator alpha,
// for a canvas of any lattice reach, in 2D or 3D.
//
// Replaces: PallasStepper._pk1_stream (ryujin_tpu/solver/pallas_step.py:
// 1904-2018), which walks the lattice offsets one at a time with running
// indicator sums: the 2D stream path with prescale, and the 3D z-slab
// path (_step_slab, :2164-2175) with prescale = sym.
//
// Two routes, a template argument each (HALF), as `sym` picks them in
// _step_slab (:2092-2098):
// - half-slot (HALF): e = lambda * cmax on the slots k < K/2 only.
//   cmax_k(i) == cmax_{K-1-k}(j), so the transposed read of e in PK2/PK3
//   is the graph viscosity d itself and neither reads cmax.
// - two-direction (!HALF): e = |c_ij| lambda_max(U_i, U_j, n_ij) on all K
//   slots; PK2/PK3 read d = max(e_k, e_T).  cmax is not read.  The
//   hyperbolic module takes this route when the coupling-boundary-pair set
//   is too large for the half-slot fixup (a 3D box's whole surface).
//
// In 2D the two-direction route is that of a multi-block canvas
// (offline/multiblock.py), whose rotated block frames break the k <->
// K-1-k slot pairing at interfaces: the TPU runs the stacked pk1 / pk2 /
// pk3 there with sym off (pallas_step.py:2709-2735, 2796-2810, 2925,
// 3152); the port's stacked kernels are built around the K/2 half-slot
// lambda planes, so that route takes this template's DIM = 2, HALF =
// false instance instead, reading e across an interface after the
// reader-frame refresh (gmap_edge) as it reads it on one block.
//
// Bound on an H100: memory traffic.  At K = 26 in 3D it reads c_ij (78
// planes), the mask (26), the node planes, U (5) and prec, and writes e
// (13 or 26) and alpha (1).
//
// Design: a block (32, TY, TZ) owns a tile of TY rows of TILE_TX = 32
// cells, in 3D at TZ consecutive z, one thread a cell; the grid covers the
// canvas in such tiles.  The block first stages (staged.cuh), for the tile
// and its halo of the lattice reach h, what a slot reads at its neighbour
// j: U and the parts of f(U) (v = m (1/rho), p, E + p), the rest of
// riemann_precompute(U_j) (a, 1/rho, 1/p, log2 p) and eta_j / rho_j,
// pk1_vals values a cell (13 in 2D, 15 in 3D), each formed by the
// operations that formed it in every slot before: the precompute's p and
// 1/rho are the flux's, the same expressions of the same operands, and
// eta_j / rho_j is the one IEEE division the indicator made.  So a
// staged cell costs one precompute, one flux and one quotient, where the
// one-thread-per-cell form made them once per live slot (26 a cell in 3D
// on the two-direction route) and gathered U_j and prec at every slot from
// device memory.  The slot loop reads its neighbour and its own cell from
// shared memory, and from device memory only the statics of the slot
// (c_ij, the mask, on the half-slot route cmax), all at once and the next
// slot's while this one computes; e is written one plane a slot,
// coalesced along x.  What stays per slot is what depends on i: the
// normalisation cv / nn, lambda_max itself and the indicator's products.
// Every slot solves its own Riemann problem: lambda_max(U_i, U_j, n) and
// lambda_max(U_j, U_i, -n) differ in the last ulp, so the two sides of an
// edge share no solve.  The thread holds only the running sums (left,
// right[C]) and the loop over k is not unrolled, so nothing of size K
// lives in registers.  Masked slots write e = 0 and add nothing; alpha is
// 0 where the node is not real.  The exact edge mask is read, not the TPU
// kernel's derived one.  The sums run over k = 0 .. K-1 in order, as
// pk1_stream_reference does, and each slot does the arithmetic of the
// one-thread-per-cell form in its order, so e and alpha keep their bits.
// The tile (TY, TZ), the halo and the shared bytes come from
// kernels/pk1_stream.py tile(); the launcher refuses a tile whose halo is
// short of the reach, whose grid misses the canvas or whose bytes are not
// this layout's, and sets the instance's dynamic shared memory above 48
// KB.
//
// Statics (statics.cuh): the staged tile reads the stored planes
// (FullStatics).  The SEP instances (SepStatics, 3D only: c_ij, the mask
// and cmax synthesized from the separable factors g2 / fz, as `_SepTile`
// does in `_pk1_stream`, :1915-1917, 1974, 2003; on the two-direction
// route that replaces the 104 planes of c_ij and the mask, and on the
// half-slot route the 13 of cmax, by the L2-resident factors, at 4
// multiplies a slot, 19 more for cmax) keep the one-thread-per-cell form
// (pk1_stream_kernel: one thread a cell, 128 along x, the loop over k not
// unrolled, U_j and prec gathered and the precompute, the flux and the
// quotient formed in every slot): the staged tile took 0.187 against
// 0.179 ms on cylinder3d and 0.321 against 0.318 on box3d (H100 SXM, 700
// W; PERF.md §6).  The factor pointers come after the constants.
#include "staged.cuh"

namespace ryujin {

// ---- one thread a cell: the SEP instances ---------------------------------
template <typename T, int DIM, bool HALF, class ST>
__global__ void __launch_bounds__(128)
pk1_stream_kernel(const T* __restrict__ cij, const T* __restrict__ cmax,
                  const T* __restrict__ mask, const T* __restrict__ node,
                  const T* __restrict__ U, const T* __restrict__ prec, T* __restrict__ e_out,
                  T* __restrict__ alpha, const __grid_constant__ EqConsts<T> e,
                  const T* __restrict__ g2, const T* __restrict__ fz) {
  static_assert(!ST::kSeparable || DIM == 3, "separable statics are 3D");
  constexpr int NC = DIM + 2;
  Cell c;
  if (!this_cell<DIM>(e, c)) return;
  const ST st(e, cij, cmax, mask, nullptr, nullptr, g2, fz);
  const int64_t i = c.i, n = c.n;
  const int K = e.K, K_e = HALF ? K / 2 : K;

  T ui[NC];
  load_state(U, i, n, ui);
  T pa_i[5];
  riemann_precompute(e, ui, pa_i);

  // indicator_init
  const T eta_i = prec[n + i];
  const T rho_i_inv = T(1) / ui[0];
  T d_eta[NC];
  {
    const T rho_rho_e = ui[0] * ui[NC - 1] - T(0.5) * mdot(ui, ui);
    const T factor = e.inv_gp1 * pow(rho_rho_e, e.harten_deriv_exp);
    d_eta[0] = factor * ui[NC - 1] - eta_i * rho_i_inv;
#pragma unroll
    for (int d = 0; d < DIM; ++d) d_eta[1 + d] = -factor * ui[1 + d];
    d_eta[NC - 1] = factor * ui[0];
  }
  T fi[NC][DIM];
  flux(e, ui, fi);
  T left = T(0), right[NC];
#pragma unroll
  for (int q = 0; q < NC; ++q) right[q] = T(0);

#pragma unroll 1
  for (int k = 0; k < K; ++k) {
    T e_k = T(0);
    if (st.mask(c, e, k) > T(0)) {
      const int64_t j = nbr_k<DIM>(c, e, k);
      T uj[NC];
      load_state(U, j, n, uj);
      T cv[DIM];
#pragma unroll
      for (int d = 0; d < DIM; ++d) cv[d] = st.cij(c, e, d, k);

      if (k < K_e) {
        const T norm = sqrt(vdot(cv, cv));
        const T nn = mx(norm, e.tiny);
        T nv[DIM];
#pragma unroll
        for (int d = 0; d < DIM; ++d) nv[d] = cv[d] / nn;
        T pa_j[5];
        riemann_precompute(e, uj, pa_j);
        const T lam = lambda_max(e, ui, pa_i, uj, pa_j, nv);
        e_k = HALF ? lam * st.cmax(c, e, k) : norm * lam;
      }

      // indicator_accum
      const T eta_j = prec[n + j];
      left += (eta_j / uj[0] - eta_i * rho_i_inv) * mproj(uj, cv);
      T fj[NC][DIM];
      flux(e, uj, fj);
#pragma unroll
      for (int q = 0; q < NC; ++q) {
        T r = (fj[q][0] - fi[q][0]) * cv[0];
#pragma unroll
        for (int d = 1; d < DIM; ++d) r = r + (fj[q][d] - fi[q][d]) * cv[d];
        right[q] += r;
      }
    }
    if (k < K_e) e_out[k * n + i] = e_k;
  }

  // indicator_finalize
  T a = T(0);
  if (node[3 * n + i] > T(0)) {
    T dot = T(0), dot_abs = T(0);
#pragma unroll
    for (int q = 0; q < NC; ++q) {
      dot += d_eta[q] * right[q];
      dot_abs += fabs(d_eta[q] * right[q]);
    }
    const T hd_i = node[i] * e.measure_inv;
    const T quotient = fabs(left - dot) / (fabs(left) + dot_abs + hd_i * fabs(eta_i));
    a = mn(T(1), e.evc_factor * quotient);
  }
  alpha[i] = a;
}

// ---- a staged tile: the full-statics instances ----------------------------
template <typename T, int DIM, bool HALF>
__global__ void __launch_bounds__(256)
pk1_stream_tile_kernel(const T* __restrict__ cij, const T* __restrict__ cmax,
                       const T* __restrict__ mask, const T* __restrict__ node,
                       const T* __restrict__ U, const T* __restrict__ prec,
                       T* __restrict__ e_out, T* __restrict__ alpha,
                       const __grid_constant__ EqConsts<T> e, const int h) {
  constexpr int NC = DIM + 2;
  constexpr int QV = u_vals(DIM) + 4;  // eta_j / rho_j of a staged cell (stage_pk1)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sm = reinterpret_cast<T*>(smem_raw);

  const int K = e.K, K_e = HALF ? K / 2 : K;
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
    stage_pk1<T, DIM>(e, U, prec, gi, n, sm, ns, s);
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
  const FullStatics<T> st(e, cij, cmax, mask, nullptr, nullptr, nullptr, nullptr);
  const int64_t i = c.i;
  const int si = ((DIM == 3 ? h + tz : 0) * SY + h + ty) * SX + h + lane;

  // the flux of staged cell s
  auto staged_f = [&](int s, const T(&u)[NC], T(&f)[NC][DIM]) {
    T m[DIM];
#pragma unroll
    for (int d = 0; d < DIM; ++d) m[d] = u[1 + d];
    staged_flux(sm, ns, NC, s, m, f);
  };

  T ui[NC], pa_i[5];
  staged_u(sm, ns, si, ui);
  staged_pa<DIM>(sm, ns, si, pa_i);

  // indicator_init (d_eta after the slots: it holds no register through them)
  const T eta_i = prec[n + i];
  const T rho_i_inv = pa_i[2];
  T fi[NC][DIM];
  staged_f(si, ui, fi);
  T left = T(0), right[NC];
#pragma unroll
  for (int q = 0; q < NC; ++q) right[q] = T(0);

  // a slot's reads of device memory, issued together, the next slot's
  // while this one computes (a masked slot reads them too, unused)
  struct Slot {
    T mk, cv[DIM], cmax;
  };
  auto fetch = [&](int k, Slot& sl) {
    sl.mk = st.mask(c, e, k);
#pragma unroll
    for (int d = 0; d < DIM; ++d) sl.cv[d] = st.cij(c, e, d, k);
    sl.cmax = HALF && k < K_e ? st.cmax(c, e, k) : T(0);
  };
  Slot cur;
  fetch(0, cur);
#pragma unroll 1
  for (int k = 0; k < K; ++k) {
    Slot nxt;
    if (k + 1 < K) fetch(k + 1, nxt);
    T e_k = T(0);
    if (cur.mk > T(0)) {
      const int sj = si + ((DIM == 3 ? e.dz[k] : 0) * SY + e.dy[k]) * SX + e.dx[k];
      T uj[NC];
      staged_u(sm, ns, sj, uj);

      if (k < K_e) {
        const T norm = sqrt(vdot(cur.cv, cur.cv));
        const T nn = mx(norm, e.tiny);
        T nv[DIM];
#pragma unroll
        for (int d = 0; d < DIM; ++d) nv[d] = cur.cv[d] / nn;
        T pa_j[5];
        staged_pa<DIM>(sm, ns, sj, pa_j);
        const T lam = lambda_max(e, ui, pa_i, uj, pa_j, nv);
        e_k = HALF ? lam * cur.cmax : norm * lam;
      }

      // indicator_accum
      left += (sm[QV * ns + sj] - eta_i * rho_i_inv) * mproj(uj, cur.cv);
      T fj[NC][DIM];
      staged_f(sj, uj, fj);
#pragma unroll
      for (int q = 0; q < NC; ++q) {
        T r = (fj[q][0] - fi[q][0]) * cur.cv[0];
#pragma unroll
        for (int d = 1; d < DIM; ++d) r = r + (fj[q][d] - fi[q][d]) * cur.cv[d];
        right[q] += r;
      }
    }
    if (k < K_e) e_out[k * n + i] = e_k;
    if (k + 1 < K) cur = nxt;
  }
  alpha[i] = pk1_alpha(e, node, i, n, ui, eta_i, rho_i_inv, left, right);
}

// Shared bytes of the tile (ty rows at tz z, halo h).
template <typename T>
int64_t pk1_stream_smem(int dim, int ty, int tz, int h) {
  const int64_t ns =
      int64_t(TILE_TX + 2 * h) * (ty + 2 * h) * (dim == 3 ? tz + 2 * h : 1);
  return pk1_vals(dim) * ns * int64_t(sizeof(T));
}

// The wrapper's tile (kernels/pk1_stream.py tile()) must fit this layout:
// 32 lanes, at most 256 threads, one z in 2D, a halo no shorter than the
// lattice reach, a grid that covers the canvas, and the bytes
// pk1_stream_smem gives.
template <typename T>
bool pk1_stream_tile_ok(const Consts* c) {
  const int ty = c->block[1], tz = c->block[2];
  const bool cover_z = c->dim == 3 ? int64_t(c->grid[2]) * tz >= c->D : c->grid[2] == 1 && tz == 1;
  return c->block[0] == TILE_TX && ty >= 1 && tz >= 1 && TILE_TX * ty * tz <= 256 &&
         c->halo >= lattice_reach(c) && int64_t(c->grid[0]) * TILE_TX >= c->W &&
         int64_t(c->grid[1]) * ty >= c->H && cover_z &&
         c->smem == pk1_stream_smem<T>(c->dim, ty, tz, c->halo);
}

template <typename T, int DIM, bool HALF>
int launch_pk1_stream_tile(const T* cij, const T* cmax, const T* mask, const T* node, const T* U,
                           const T* prec, T* e_out, T* alpha, const EqConsts<T>& e,
                           const Consts* consts, cudaStream_t stream) {
  auto kernel = pk1_stream_tile_kernel<T, DIM, HALF>;
  const int smem = consts->smem;
  const int rc = allow_smem(kernel, smem);
  if (rc != int(cudaSuccess)) return rc;
  const dim3 grid(consts->grid[0], consts->grid[1], consts->grid[2]);
  const dim3 block(consts->block[0], consts->block[1], consts->block[2]);
  kernel<<<grid, block, smem, stream>>>(cij, cmax, mask, node, U, prec, e_out, alpha, e,
                                        consts->halo);
  return int(cudaGetLastError());
}

// g2 and fz given: the SEP instances (3D, K = 26), one thread a cell;
// both null: the full statics on the wrapper's tile.
template <typename T>
int launch_pk1_stream(const T* cij, const T* cmax, const T* mask, const T* node, const T* U,
                      const T* prec, T* e_out, T* alpha, const T* g2, const T* fz,
                      const Consts* consts, cudaStream_t stream) {
  if (consts->K < 2 || consts->K > MAX_K || consts->K % 2) return int(cudaErrorInvalidValue);
  const EqConsts<T> e = EqConsts<T>::make(*consts);
  if (g2 || fz) {
    if (!g2 || !fz || consts->dim != 3 || consts->K != 26) return int(cudaErrorInvalidValue);
    const dim3 grid = canvas_grid(e.D, e.H, e.W), block = canvas_block();
    if (consts->half)
      pk1_stream_kernel<T, 3, true, SepStatics<T>><<<grid, block, 0, stream>>>(
          cij, cmax, mask, node, U, prec, e_out, alpha, e, g2, fz);
    else
      pk1_stream_kernel<T, 3, false, SepStatics<T>><<<grid, block, 0, stream>>>(
          cij, cmax, mask, node, U, prec, e_out, alpha, e, g2, fz);
    return int(cudaGetLastError());
  }
  if (!pk1_stream_tile_ok<T>(consts)) return int(cudaErrorInvalidValue);
  if (consts->dim == 2 && consts->half)
    return launch_pk1_stream_tile<T, 2, true>(cij, cmax, mask, node, U, prec, e_out, alpha, e,
                                              consts, stream);
  if (consts->dim == 2)
    return launch_pk1_stream_tile<T, 2, false>(cij, cmax, mask, node, U, prec, e_out, alpha, e,
                                               consts, stream);
  if (consts->dim == 3 && consts->half)
    return launch_pk1_stream_tile<T, 3, true>(cij, cmax, mask, node, U, prec, e_out, alpha, e,
                                              consts, stream);
  if (consts->dim == 3)
    return launch_pk1_stream_tile<T, 3, false>(cij, cmax, mask, node, U, prec, e_out, alpha, e,
                                               consts, stream);
  return int(cudaErrorInvalidValue);
}

}  // namespace ryujin

#define RYUJIN_PK1_STREAM(SUFFIX, T)                                                          \
  extern "C" int ryujin_pk1_stream_##SUFFIX(                                                  \
      const void* cij, const void* cmax, const void* mask, const void* node, const void* U,   \
      const void* prec, void* e_out, void* alpha, const void* g2, const void* fz,             \
      const ryujin::Consts* consts, void* stream) {                                           \
    return ryujin::launch_pk1_stream<T>((const T*)cij, (const T*)cmax, (const T*)mask,        \
                                        (const T*)node, (const T*)U, (const T*)prec,          \
                                        (T*)e_out, (T*)alpha, (const T*)g2, (const T*)fz,     \
                                        consts, (cudaStream_t)stream);                        \
  }

RYUJIN_PK1_STREAM(f32, float)
RYUJIN_PK1_STREAM(f64, double)
