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
// Bound on an H100: memory traffic.  At K = 26 in 3D it reads c_ij (78
// planes), the mask (26), the node planes, U (5) and prec, and writes e
// (13 or 26) and alpha (1).  The neighbour reads of U and prec span the
// planes z-1 .. z+1 and hit L1/L2.
//
// Design: one thread per canvas cell, 128 threads along x, the grid over
// (x-blocks, H, D).  K and the offsets come with the launch; the loop over
// k is not unrolled and the thread holds only the running sums (left,
// right[C]), so nothing of size K lives in registers.  Masked slots
// write e = 0 and add nothing; alpha is 0 where the node is not real.
// The exact edge mask is read, not the TPU kernel's derived one.  The
// sums run over k = 0 .. K-1 in order, as pk1_stream_reference does.
//
// Statics (ST, statics.cuh): FullStatics reads the stored planes;
// SepStatics (3D only) synthesizes c_ij, the mask and cmax from the
// separable factors g2 / fz, as `_SepTile` does in `_pk1_stream`
// (:1915-1917, 1974, 2003).  On the two-direction route that replaces the
// 104 planes of c_ij and the mask (and on the half-slot route the 13 of
// cmax) by the L2-resident factors, at 4 multiplies a slot (19 more for
// cmax); the factor pointers come after the constants, so the
// full-statics instances keep their parameter offsets.
#include "statics.cuh"

namespace ryujin {

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

template <typename T, class ST>
int launch_pk1_stream_st(const T* cij, const T* cmax, const T* mask, const T* node,
                         const T* U, const T* prec, T* e_out, T* alpha, const T* g2,
                         const T* fz, const EqConsts<T>& e, const Consts* consts,
                         cudaStream_t stream) {
  const dim3 grid = canvas_grid(e.D, e.H, e.W), block = canvas_block();
  if constexpr (!ST::kSeparable) {
    if (consts->dim == 2 && consts->half) {
      pk1_stream_kernel<T, 2, true, ST><<<grid, block, 0, stream>>>(
          cij, cmax, mask, node, U, prec, e_out, alpha, e, g2, fz);
      return int(cudaGetLastError());
    }
  }
  if (consts->dim == 3 && consts->half)
    pk1_stream_kernel<T, 3, true, ST><<<grid, block, 0, stream>>>(
        cij, cmax, mask, node, U, prec, e_out, alpha, e, g2, fz);
  else if (consts->dim == 3)
    pk1_stream_kernel<T, 3, false, ST><<<grid, block, 0, stream>>>(
        cij, cmax, mask, node, U, prec, e_out, alpha, e, g2, fz);
  else
    return int(cudaErrorInvalidValue);
  return int(cudaGetLastError());
}

// g2 and fz given: the SEP instances (3D, K = 26); both null: the full
// statics.
template <typename T>
int launch_pk1_stream(const T* cij, const T* cmax, const T* mask, const T* node, const T* U,
                      const T* prec, T* e_out, T* alpha, const T* g2, const T* fz,
                      const Consts* consts, cudaStream_t stream) {
  if (consts->K < 2 || consts->K > MAX_K || consts->K % 2) return int(cudaErrorInvalidValue);
  const EqConsts<T> e = EqConsts<T>::make(*consts);
  if (g2 || fz) {
    if (!g2 || !fz || consts->dim != 3 || consts->K != 26) return int(cudaErrorInvalidValue);
    return launch_pk1_stream_st<T, SepStatics<T>>(cij, cmax, mask, node, U, prec, e_out,
                                                  alpha, g2, fz, e, consts, stream);
  }
  return launch_pk1_stream_st<T, FullStatics<T>>(cij, cmax, mask, node, U, prec, e_out,
                                                 alpha, g2, fz, e, consts, stream);
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
