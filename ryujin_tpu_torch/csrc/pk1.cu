// PK1: half-slot Riemann wavespeeds and the EVC indicator alpha.
//
// Replaces: the Pallas kernel `pk1` of PallasStepper.step
// (ryujin_tpu/solver/pallas_step.py:2676-2707), which runs
// hyperbolic.phase_e_alpha(half=True) per 8-row tile.
//
// Bound on an H100: memory traffic.  Per cell it reads c_ij (16 planes),
// the mask (8), the node plane, U (4) and prec (2) at the cell and the 8
// neighbours, and writes lambda (4) and alpha (1); the arithmetic (4
// Riemann solves, 8 flux tensors, one pow per node) is small next to the
// ~30 plane reads.  Neighbour reads of U/prec hit L1/L2 because the rows
// y-1, y, y+1 of a block are read by three neighbouring blocks.
//
// Design: one thread per canvas cell, 128 threads along x, so each plane
// read is one coalesced row segment.  Slots whose edge is masked are
// skipped (their lambda is written as 0); alpha is written as 0 where the
// node is not real.  The derived edge mask of the TPU kernel (a bandwidth
// trick, pallas_step.py:1543-1558) is not carried over: the exact mask is
// read.
#include "euler.cuh"

namespace ryujin {

template <typename T>
__global__ void __launch_bounds__(128)
pk1_kernel(const T* __restrict__ cij, const T* __restrict__ mask, const T* __restrict__ node,
           const T* __restrict__ U, const T* __restrict__ prec, T* __restrict__ lam,
           T* __restrict__ alpha, const EqConsts<T> e) {
  Cell c;
  if (!this_cell(e.H, e.W, c)) return;
  const int64_t i = c.i, n = c.n;

  T ui[C];
  load_state(U, i, n, ui);
  T pa_i[5];
  riemann_precompute(e, ui, pa_i);

  // indicator_alpha, node-local part
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

#pragma unroll
  for (int k = 0; k < K; ++k) {
    T lam_k = T(0);
    if (mask[k * n + i] > T(0)) {
      const int64_t j = nbr(c, k, e.H, e.W);
      T uj[C];
      load_state(U, j, n, uj);
      const T c0 = cij[k * n + i], c1 = cij[(K + k) * n + i];

      const T eta_j = prec[n + j];
      left += (eta_j / uj[0] - eta_i * rho_i_inv) * (uj[1] * c0 + uj[2] * c1);
      T fj[C][2];
      flux(e, uj, fj);
#pragma unroll
      for (int q = 0; q < C; ++q)
        right[q] += (fj[q][0] - fi[q][0]) * c0 + (fj[q][1] - fi[q][1]) * c1;

      if (k < K2) {
        const T norm = sqrt(c0 * c0 + c1 * c1);
        const T nn = mx(norm, e.tiny);
        T pa_j[5];
        riemann_precompute(e, uj, pa_j);
        lam_k = lambda_max(e, ui, pa_i, uj, pa_j, c0 / nn, c1 / nn);
      }
    }
    if (k < K2) lam[k * n + i] = lam_k;
  }

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
int launch_pk1(const T* cij, const T* mask, const T* node, const T* U, const T* prec, T* lam,
               T* alpha, const Consts* consts, cudaStream_t stream) {
  const EqConsts<T> e = EqConsts<T>::make(*consts);
  pk1_kernel<T><<<canvas_grid(e.H, e.W), canvas_block(), 0, stream>>>(cij, mask, node, U, prec,
                                                                        lam, alpha, e);
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
