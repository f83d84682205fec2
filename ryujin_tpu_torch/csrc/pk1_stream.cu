// PK1, slot-streaming form: pre-scaled half-slot wavespeeds e = lambda *
// cmax and the EVC indicator alpha, for a canvas of any lattice reach.
//
// Replaces: PallasStepper._pk1_stream with prescale
// (ryujin_tpu/solver/pallas_step.py:1904-2018), which walks the lattice
// offsets one at a time with running indicator sums.
//
// Bound on an H100: memory traffic.  At K = 24 it reads c_ij (48 planes),
// the mask (24), cmax (12), the node plane, U (4) and prec (2), and writes
// e (12) and alpha (1); the 12 Riemann solves and 24 flux tensors per cell
// are small next to ~100 plane reads.  The neighbour reads of U and prec
// span rows y-2 .. y+2 and hit L1/L2.
//
// Design: one thread per canvas cell, 128 threads along x.  K and the
// offsets come with the launch; the loop over k is not unrolled and the
// thread holds only the running sums (left, right[4]), so nothing of size
// K lives in registers.  e = lambda * cmax is written on the slots
// k < K/2: cmax_k(i) == cmax_{K-1-k}(j), so the transposed read of e in
// PK2/PK3 is the graph viscosity d itself and neither reads cmax.  Masked
// slots write e = 0 and add nothing; alpha is 0 where the node is not
// real.  The exact edge mask is read, not the TPU kernel's derived one.
// The sums run over k = 0 .. K-1 in order, as pk1_stream_reference does.
#include "euler.cuh"

namespace ryujin {

template <typename T>
__global__ void __launch_bounds__(128)
pk1_stream_kernel(const T* __restrict__ cij, const T* __restrict__ cmax,
                  const T* __restrict__ mask, const T* __restrict__ node,
                  const T* __restrict__ U, const T* __restrict__ prec, T* __restrict__ e_out,
                  T* __restrict__ alpha, const __grid_constant__ EqConsts<T> e) {
  Cell c;
  if (!this_cell(e.H, e.W, c)) return;
  const int64_t i = c.i, n = c.n;
  const int K = e.K, K2 = K / 2;

  T ui[C];
  load_state(U, i, n, ui);
  T pa_i[5];
  riemann_precompute(e, ui, pa_i);

  // indicator_init
  const T eta_i = prec[n + i];
  const T rho_i_inv = T(1) / ui[0];
  T d_eta[C];
  {
    const T rho_rho_e = ui[0] * ui[3] - T(0.5) * (ui[1] * ui[1] + ui[2] * ui[2]);
    const T factor = e.inv_gp1 * pow(rho_rho_e, e.harten_deriv_exp);
    d_eta[0] = factor * ui[3] - eta_i * rho_i_inv;
    d_eta[1] = -factor * ui[1];
    d_eta[2] = -factor * ui[2];
    d_eta[3] = factor * ui[0];
  }
  T fi[C][2];
  flux(e, ui, fi);
  T left = T(0), right[C] = {T(0), T(0), T(0), T(0)};

#pragma unroll 1
  for (int k = 0; k < K; ++k) {
    T e_k = T(0);
    if (mask[k * n + i] > T(0)) {
      const int64_t j = nbr_at(c, e.dy[k], e.dx[k], e.H, e.W);
      T uj[C];
      load_state(U, j, n, uj);
      const T c0 = cij[k * n + i], c1 = cij[(K + k) * n + i];

      if (k < K2) {
        const T norm = sqrt(c0 * c0 + c1 * c1);
        const T nn = mx(norm, e.tiny);
        T pa_j[5];
        riemann_precompute(e, uj, pa_j);
        e_k = lambda_max(e, ui, pa_i, uj, pa_j, c0 / nn, c1 / nn) * cmax[k * n + i];
      }

      // indicator_accum
      const T eta_j = prec[n + j];
      left += (eta_j / uj[0] - eta_i * rho_i_inv) * (uj[1] * c0 + uj[2] * c1);
      T fj[C][2];
      flux(e, uj, fj);
#pragma unroll
      for (int q = 0; q < C; ++q)
        right[q] += (fj[q][0] - fi[q][0]) * c0 + (fj[q][1] - fi[q][1]) * c1;
    }
    if (k < K2) e_out[k * n + i] = e_k;
  }

  // indicator_finalize
  T a = T(0);
  if (node[3 * n + i] > T(0)) {
    T dot = T(0), dot_abs = T(0);
#pragma unroll
    for (int q = 0; q < C; ++q) {
      dot += d_eta[q] * right[q];
      dot_abs += fabs(d_eta[q] * right[q]);
    }
    const T hd_i = node[i] * e.measure_inv;
    const T quotient = fabs(left - dot) / (fabs(left) + dot_abs + hd_i * fabs(eta_i));
    a = mn(T(1), e.evc_factor * quotient);
  }
  alpha[i] = a;
}

template <typename T>
int launch_pk1_stream(const T* cij, const T* cmax, const T* mask, const T* node, const T* U,
                      const T* prec, T* e_out, T* alpha, const Consts* consts,
                      cudaStream_t stream) {
  if (consts->K < 2 || consts->K > MAX_K || consts->K % 2) return int(cudaErrorInvalidValue);
  const EqConsts<T> e = EqConsts<T>::make(*consts);
  pk1_stream_kernel<T><<<canvas_grid(e.H, e.W), canvas_block(), 0, stream>>>(
      cij, cmax, mask, node, U, prec, e_out, alpha, e);
  return int(cudaGetLastError());
}

}  // namespace ryujin

#define RYUJIN_PK1_STREAM(SUFFIX, T)                                                          \
  extern "C" int ryujin_pk1_stream_##SUFFIX(                                                  \
      const void* cij, const void* cmax, const void* mask, const void* node, const void* U,   \
      const void* prec, void* e_out, void* alpha, const ryujin::Consts* consts,               \
      void* stream) {                                                                         \
    return ryujin::launch_pk1_stream<T>((const T*)cij, (const T*)cmax, (const T*)mask,        \
                                        (const T*)node, (const T*)U, (const T*)prec,          \
                                        (T*)e_out, (T*)alpha, consts, (cudaStream_t)stream);  \
  }

RYUJIN_PK1_STREAM(f32, float)
RYUJIN_PK1_STREAM(f64, double)
