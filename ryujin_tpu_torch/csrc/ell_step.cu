// The substep on the padded-ELL stencil: four kernels, one thread a row.
//
// Replaces: no TPU kernel.  The JAX package runs this path in XLA: the
// gather stencil (Stencil, _stencil_from_ell, ryujin_tpu/solver/
// hyperbolic.py:65-130) under the phase functions (:411-1104).  Each
// kernel here computes one phase of the port's plain substep on that
// stencil (ryujin_tpu_torch/solver/hyperbolic.py) and is held against it:
//
//   ell_pk1    e_ij = |c_ij| lambda_max(U_i, U_j, n_ij) on every live slot
//              (the two-direction route) and the EVC indicator alpha_i
//              (phase_e_alpha, half=False);
//   ell_pk2    U_low, the high-order right-hand side F and the limiter
//              bounds from the graph viscosity d (phase_low_order);
//   ell_pk3    the antidiffusive P_ij, the first limiter pass l and the
//              per-row success flag okp (phase_p_l1);
//   ell_pk_up  the symmetrized limited update with l_ji = l[trans]; PK4
//              re-limits, PK5 (l_new null) is the last (phase_update).
//
// Layout: node axis last, n rows (the padded node count; the launch puts
// n in Consts W, with D = H = 1).  Neighbour j of slot k is cols[k * n +
// i] (int64); the transposed edge of slot k at row i is the flat index
// trans[k * n + i] into the [K, n] edge arrays.  Statics: c_ij [DIM, K,
// n], m_ij [K, n], the mask [K, n] (1 live, 0 padding), c_ii [DIM, n],
// the dG incidence [K, n] (null for a continuous ansatz) and the node
// planes [4, n]: m_i, 1/m_i, n_nbrs, node_mask.  K is the launch's
// (Consts K): the mesh's largest row, 2 in 1D Q1, more at the irregular
// vertices of an unstructured mesh.
//
// Design: one thread a row, 128 threads a block, the loop over k not
// unrolled, U_j and the other neighbour values gathered from device
// memory at every live slot: the one-thread-a-cell form of the canvas
// kernels' first ports (pk1_stream.cu, pk2_stream.cu, `_kernel`).  Each
// kernel is a template on DIM (1, 2, 3; C = DIM + 2 components), PK2 and
// PK3 also on the dG flag (the incidence raises the high-order viscosity
// factor to beta_ij) and on MS, the most stage slots an instance takes (2,
// or MAX_STAGES for ERK54's 3 and 4), chosen at launch by n_stages.
//
// Arithmetic: each per-edge value (e, P, l, l') is formed by the
// operations of the plain phase function in their order (FMA contraction
// is off, kernels/build.py), so it keeps its bits given the same inputs;
// the sums over the slots run k = 0 .. K-1 in order, where torch.sum may
// group them otherwise (alpha, U_low, F and the bounds differ from their
// plain versions by summation order only; PERF.md section 2 holds them at
// relative 1e-5 in f32, 1e-11 in f64).  The update sums l_sym P in slot
// order, as its plain version (kernels/ell.py) does.  Every output entry
// is written: 0 on masked slots, alpha 0 on padded rows.
#include "euler.cuh"

namespace ryujin {

namespace {

__device__ __forceinline__ bool this_row(int64_t n, int64_t& i) {
  i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  return i < n;
}

// The relaxation r_i = (h^d_i)^(3 / (2 DIM)) of the limiter bounds
// (euler/limiter.h:330-363; the port's Euler._relax_bounds).
template <int DIM, typename T>
__device__ __forceinline__ T relax_radius(T hd_i) {
  if constexpr (DIM == 2) {
    const T sq = sqrt(sqrt(hd_i));
    return sq * sq * sq;
  } else if constexpr (DIM == 1) {
    const T sq = sqrt(hd_i);
    return sq * sq * sq;
  } else {
    return sqrt(hd_i);
  }
}

}  // namespace

// ---- ell_pk1: e on every slot and alpha --------------------------------------
template <typename T, int DIM>
__global__ void __launch_bounds__(128)
ell_pk1_kernel(const int64_t* __restrict__ cols, const T* __restrict__ cij,
               const T* __restrict__ mask, const T* __restrict__ node, const T* __restrict__ U,
               const T* __restrict__ prec, T* __restrict__ e_out, T* __restrict__ alpha,
               const __grid_constant__ EqConsts<T> e) {
  constexpr int NC = DIM + 2;
  const int64_t n = int64_t(e.D) * e.H * e.W;
  int64_t i;
  if (!this_row(n, i)) return;
  const int K = e.K;

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
    if (mask[k * n + i] > T(0)) {
      const int64_t j = cols[k * n + i];
      T uj[NC];
      load_state(U, j, n, uj);
      T cv[DIM];
#pragma unroll
      for (int d = 0; d < DIM; ++d) cv[d] = cij[(int64_t(d) * K + k) * n + i];
      const T norm = sqrt(vdot(cv, cv));
      const T nn = mx(norm, e.tiny);
      T nv[DIM];
#pragma unroll
      for (int d = 0; d < DIM; ++d) nv[d] = cv[d] / nn;
      T pa_j[5];
      riemann_precompute(e, uj, pa_j);
      e_k = norm * lambda_max(e, ui, pa_i, uj, pa_j, nv);

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
    e_out[k * n + i] = e_k;
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

// ---- ell_pk2: U_low, F and the limiter bounds -----------------------------------
template <typename T, int DIM, bool DG, int MS>
__global__ void __launch_bounds__(128)
ell_pk2_kernel(const int64_t* __restrict__ cols, const T* __restrict__ cij,
               const T* __restrict__ mask, const T* __restrict__ inc, const T* __restrict__ cii,
               const T* __restrict__ node, const T* __restrict__ U, const T* __restrict__ prec,
               const T* __restrict__ d_in, const T* __restrict__ alpha,
               const T* __restrict__ sU, const T* __restrict__ tau_ptr, T* __restrict__ U_low,
               T* __restrict__ F_out, T* __restrict__ bounds,
               const __grid_constant__ EqConsts<T> e) {
  constexpr int NC = DIM + 2;
  const int64_t n = int64_t(e.D) * e.H * e.W;
  int64_t i;
  if (!this_row(n, i)) return;
  const int K = e.K;
  const int S = e.n_stages;

  T ui[NC];
  load_state(U, i, n, ui);
  const T s_i = prec[i];
  const T alpha_i = alpha[i];
  const T tau = *tau_ptr;

  T fi[NC][DIM];
  flux(e, ui, fi);
  T cvi[DIM];
#pragma unroll
  for (int d = 0; d < DIM; ++d) cvi[d] = cii[int64_t(d) * n + i];

  T fs_i[MS][NC][DIM];
  for (int s = 0; s < S; ++s) {
    T us[NC];
    load_state(sU + int64_t(s) * NC * n, i, n, us);
    flux(e, us, fs_i[s]);
  }

  // the running sums over the slots: the low-order and F terms, and per
  // stage its flux divergences; the bounds' accumulators
  T low_acc[NC], F_acc[NC], Fs_acc[MS][NC];
#pragma unroll
  for (int q = 0; q < NC; ++q) low_acc[q] = F_acc[q] = T(0);
#pragma unroll
  for (int s = 0; s < MS; ++s)
#pragma unroll
    for (int q = 0; q < NC; ++q) Fs_acc[s][q] = T(0);
  T rho_min = ui[0], rho_max = ui[0], s_min = s_i, s_interp_max = s_i;
  T relax_sum = T(0), k_count = T(0);

#pragma unroll 1
  for (int k = 0; k < K; ++k) {
    const T mk = mask[k * n + i];
    if (!(mk > T(0))) continue;
    const int64_t j = cols[k * n + i];
    const T d = d_in[k * n + i];
    T cv[DIM];
#pragma unroll
    for (int dd = 0; dd < DIM; ++dd) cv[dd] = cij[(int64_t(dd) * K + k) * n + i];
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
      load_state(sU + int64_t(s) * NC * n, j, n, usj);
      flux(e, usj, fsj);
#pragma unroll
      for (int q = 0; q < NC; ++q) Fs_acc[s][q] += flux_div(fs_i[s], fsj, q, cv);
    }

    // limiter_bounds (euler/limiter.h:255-363)
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
    relax_sum += (ui[0] + uj[0]) * mk;
    k_count += mk;
  }

  const T m_inv = node[n + i];
#pragma unroll
  for (int q = 0; q < NC; ++q) {
    const T flux_ii = flux_div(fi, fi, q, cvi);
    U_low[q * n + i] = ui[q] + (tau * m_inv) * (low_acc[q] + flux_ii);
    T F = F_acc[q] + e.weight * flux_ii;
    // the stage increments sum_s w_s (sum_k hof_s + hof_s_ii), summed
    // over the stages apart and added last, as _stage_terms does; a zero
    // weight adds nothing there
    T F_inc = T(0);
    bool have = false;
    for (int s = 0; s < S; ++s) {
      const T w_s = stage_weight<MS>(e, s);
      if (w_s == T(0)) continue;
      const T inc_s = w_s * (Fs_acc[s][q] + flux_div(fs_i[s], fs_i[s], q, cvi));
      F_inc = have ? F_inc + inc_s : inc_s;
      have = true;
    }
    F_out[q * n + i] = have ? F + F_inc : F;
  }

  const T hd_i = node[i] * e.measure_inv;
  const T r_i = relax_radius<DIM>(hd_i) * e.relax_factor;
  const T relax_num = relax_sum + T(2) * ui[0];
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

// ---- ell_pk3: P, the first limiter pass and okp --------------------------------
template <typename T, int DIM, bool DG, int MS>
__global__ void __launch_bounds__(128)
ell_pk3_kernel(const int64_t* __restrict__ cols, const T* __restrict__ cij,
               const T* __restrict__ mij, const T* __restrict__ mask, const T* __restrict__ inc,
               const T* __restrict__ node, const T* __restrict__ U, const T* __restrict__ d_in,
               const T* __restrict__ alpha, const T* __restrict__ F, const T* __restrict__ U_low,
               const T* __restrict__ bounds, const T* __restrict__ sU,
               const T* __restrict__ tau_ptr, T* __restrict__ P_out, T* __restrict__ l_out,
               T* __restrict__ okp, const __grid_constant__ EqConsts<T> e) {
  constexpr int NC = DIM + 2;
  const int64_t n = int64_t(e.D) * e.H * e.W;
  int64_t i;
  if (!this_row(n, i)) return;
  const int K = e.K;
  const int S = e.n_stages;

  T ui[NC], ul[NC], Fi[NC];
  load_state(U, i, n, ui);
  load_state(U_low, i, n, ul);
  load_state(F, i, n, Fi);
  const T bnd[3] = {bounds[i], bounds[n + i], bounds[2 * n + i]};
  const T alpha_i = alpha[i];
  const T m_inv = node[n + i];
  const T tau = *tau_ptr;
  const T pfac = tau * m_inv * node[2 * n + i];
  const bool real = node[3 * n + i] > T(0);
  T psi0[4];
  limiter_psi0(e, bnd[2], ul, psi0);
  T fi[NC][DIM];
  flux(e, ui, fi);
  T fs_i[MS][NC][DIM];
  for (int s = 0; s < S; ++s) {
    T us[NC];
    load_state(sU + int64_t(s) * NC * n, i, n, us);
    flux(e, us, fs_i[s]);
  }

  bool ok = true;
#pragma unroll 1
  for (int k = 0; k < K; ++k) {
    if (!(mask[k * n + i] > T(0))) {
#pragma unroll
      for (int q = 0; q < NC; ++q) P_out[(int64_t(q) * K + k) * n + i] = T(0);
      l_out[k * n + i] = T(0);
      continue;
    }
    const int64_t j = cols[k * n + i];
    const T d = d_in[k * n + i];
    T cv[DIM];
#pragma unroll
    for (int dd = 0; dd < DIM; ++dd) cv[dd] = cij[(int64_t(dd) * K + k) * n + i];
    T factor = T(0.5) * (alpha_i + alpha[j]);
    if constexpr (DG) factor = mx(factor, inc[k * n + i]);
    const T d_H = d * factor;
    T uj[NC];
    load_state(U, j, n, uj);
    T P[NC];
    {
      T fj[NC][DIM];
      flux(e, uj, fj);
#pragma unroll
      for (int q = 0; q < NC; ++q) {
        const T flux_ij = flux_div(fi, fj, q, cv);
        P[q] = -flux_ij + e.weight * flux_ij + (d_H - d) * (uj[q] - ui[q]);
      }
    }
    // sum_s w_s hof_s over the stages of nonzero weight, added at once
    T P_inc[NC];
    bool have = false;
    for (int s = 0; s < S; ++s) {
      const T w_s = stage_weight<MS>(e, s);
      if (w_s == T(0)) continue;
      T usj[NC], fsj[NC][DIM];
      load_state(sU + int64_t(s) * NC * n, j, n, usj);
      flux(e, usj, fsj);
#pragma unroll
      for (int q = 0; q < NC; ++q) {
        const T term = w_s * flux_div(fs_i[s], fsj, q, cv);
        P_inc[q] = have ? P_inc[q] + term : term;
      }
      have = true;
    }
    const T m_ij = mij[k * n + i];
    const T b_ij = -m_ij / node[j];
    const T b_ji = -m_ij * m_inv;
#pragma unroll
    for (int q = 0; q < NC; ++q) {
      T p = have ? P[q] + P_inc[q] : P[q];
      p = p + b_ij * F[q * n + j] - b_ji * Fi[q];
      P[q] = p * pfac;
      P_out[(int64_t(q) * K + k) * n + i] = P[q];
    }
    bool success;
    l_out[k * n + i] = limiter_limit(e, bnd, ul, psi0, P, success);
    if (real && !success) ok = false;
  }
  okp[i] = ok ? T(1) : T(0);
}

// ---- ell_pk_up: PK4 (l_new given) and PK5 (l_new null) -------------------------
template <typename T, int DIM>
__global__ void __launch_bounds__(128)
ell_pk_up_kernel(const int64_t* __restrict__ trans, const T* __restrict__ mask,
                 const T* __restrict__ node, const T* __restrict__ U,
                 const T* __restrict__ bounds, const T* __restrict__ P,
                 const T* __restrict__ l, T* __restrict__ U_next, T* __restrict__ l_new,
                 const __grid_constant__ EqConsts<T> e) {
  constexpr int NC = DIM + 2;
  const int64_t n = int64_t(e.D) * e.H * e.W;
  int64_t i;
  if (!this_row(n, i)) return;
  const int K = e.K;

  T acc[NC];
#pragma unroll
  for (int q = 0; q < NC; ++q) acc[q] = T(0);
#pragma unroll 1
  for (int k = 0; k < K; ++k) {
    if (!(mask[k * n + i] > T(0))) continue;
    const T l_sym = mn(l[k * n + i], l[trans[k * n + i]]);
#pragma unroll
    for (int q = 0; q < NC; ++q) acc[q] = acc[q] + l_sym * P[(int64_t(q) * K + k) * n + i];
  }
  const T lam_i = T(1) / node[2 * n + i];
  T un[NC];
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
    if (mask[k * n + i] > T(0)) {
      const T l_sym = mn(l[k * n + i], l[trans[k * n + i]]);
      const T rest = T(1) - l_sym;
      T Pr[NC];
#pragma unroll
      for (int q = 0; q < NC; ++q) Pr[q] = rest * P[(int64_t(q) * K + k) * n + i];
      bool success;
      out = rest * limiter_limit(e, bnd, un, psi0, Pr, success);
    }
    l_new[k * n + i] = out;
  }
}

// ---- launchers ---------------------------------------------------------------

namespace {

bool ell_ok(const Consts* c) {
  return c->dim >= 1 && c->dim <= 3 && c->K >= 1 && c->D == 1 && c->H == 1 && c->W >= 0 &&
         c->n_stages >= 0 && c->n_stages <= MAX_STAGES;
}

inline dim3 row_grid(const Consts* c) { return dim3((unsigned(c->W) + 127) / 128); }

}  // namespace

template <typename T>
int launch_ell_pk1(const int64_t* cols, const T* cij, const T* mask, const T* node, const T* U,
                   const T* prec, T* e_out, T* alpha, const Consts* c, cudaStream_t stream) {
  if (!ell_ok(c)) return int(cudaErrorInvalidValue);
  if (c->W == 0) return int(cudaSuccess);
  const EqConsts<T> e = EqConsts<T>::make(*c);
  const dim3 grid = row_grid(c), block(128);
  if (c->dim == 1)
    ell_pk1_kernel<T, 1><<<grid, block, 0, stream>>>(cols, cij, mask, node, U, prec, e_out, alpha, e);
  else if (c->dim == 2)
    ell_pk1_kernel<T, 2><<<grid, block, 0, stream>>>(cols, cij, mask, node, U, prec, e_out, alpha, e);
  else
    ell_pk1_kernel<T, 3><<<grid, block, 0, stream>>>(cols, cij, mask, node, U, prec, e_out, alpha, e);
  return int(cudaGetLastError());
}

template <typename T, bool DG, int MS>
int launch_ell_pk2_instance(const int64_t* cols, const T* cij, const T* mask, const T* inc,
                            const T* cii, const T* node, const T* U, const T* prec, const T* d,
                            const T* alpha, const T* sU, const T* tau, T* U_low, T* F, T* bounds,
                            const EqConsts<T>& e, const Consts* c, cudaStream_t stream) {
  const dim3 grid = row_grid(c), block(128);
  if (c->dim == 1)
    ell_pk2_kernel<T, 1, DG, MS><<<grid, block, 0, stream>>>(
        cols, cij, mask, inc, cii, node, U, prec, d, alpha, sU, tau, U_low, F, bounds, e);
  else if (c->dim == 2)
    ell_pk2_kernel<T, 2, DG, MS><<<grid, block, 0, stream>>>(
        cols, cij, mask, inc, cii, node, U, prec, d, alpha, sU, tau, U_low, F, bounds, e);
  else
    ell_pk2_kernel<T, 3, DG, MS><<<grid, block, 0, stream>>>(
        cols, cij, mask, inc, cii, node, U, prec, d, alpha, sU, tau, U_low, F, bounds, e);
  return int(cudaGetLastError());
}

// `inc` given: the dG instances; each takes its instance of at most 2
// stages, or of MAX_STAGES above 2.
template <typename T>
int launch_ell_pk2(const int64_t* cols, const T* cij, const T* mask, const T* inc, const T* cii,
                   const T* node, const T* U, const T* prec, const T* d, const T* alpha,
                   const T* sU, const T* tau, T* U_low, T* F, T* bounds, const Consts* c,
                   cudaStream_t stream) {
  if (!ell_ok(c)) return int(cudaErrorInvalidValue);
  if (c->W == 0) return int(cudaSuccess);
  const EqConsts<T> e = EqConsts<T>::make(*c);
  const bool wide = c->n_stages > 2;
  if (inc && wide)
    return launch_ell_pk2_instance<T, true, MAX_STAGES>(cols, cij, mask, inc, cii, node, U, prec, d,
                                                        alpha, sU, tau, U_low, F, bounds, e, c,
                                                        stream);
  if (inc)
    return launch_ell_pk2_instance<T, true, 2>(cols, cij, mask, inc, cii, node, U, prec, d, alpha,
                                               sU, tau, U_low, F, bounds, e, c, stream);
  if (wide)
    return launch_ell_pk2_instance<T, false, MAX_STAGES>(cols, cij, mask, inc, cii, node, U, prec,
                                                         d, alpha, sU, tau, U_low, F, bounds, e, c,
                                                         stream);
  return launch_ell_pk2_instance<T, false, 2>(cols, cij, mask, inc, cii, node, U, prec, d, alpha,
                                              sU, tau, U_low, F, bounds, e, c, stream);
}

template <typename T, bool DG, int MS>
int launch_ell_pk3_instance(const int64_t* cols, const T* cij, const T* mij, const T* mask,
                            const T* inc, const T* node, const T* U, const T* d, const T* alpha,
                            const T* F, const T* U_low, const T* bounds, const T* sU,
                            const T* tau, T* P, T* l, T* okp, const EqConsts<T>& e,
                            const Consts* c, cudaStream_t stream) {
  const dim3 grid = row_grid(c), block(128);
  if (c->dim == 1)
    ell_pk3_kernel<T, 1, DG, MS><<<grid, block, 0, stream>>>(
        cols, cij, mij, mask, inc, node, U, d, alpha, F, U_low, bounds, sU, tau, P, l, okp, e);
  else if (c->dim == 2)
    ell_pk3_kernel<T, 2, DG, MS><<<grid, block, 0, stream>>>(
        cols, cij, mij, mask, inc, node, U, d, alpha, F, U_low, bounds, sU, tau, P, l, okp, e);
  else
    ell_pk3_kernel<T, 3, DG, MS><<<grid, block, 0, stream>>>(
        cols, cij, mij, mask, inc, node, U, d, alpha, F, U_low, bounds, sU, tau, P, l, okp, e);
  return int(cudaGetLastError());
}

template <typename T>
int launch_ell_pk3(const int64_t* cols, const T* cij, const T* mij, const T* mask, const T* inc,
                   const T* node, const T* U, const T* d, const T* alpha, const T* F,
                   const T* U_low, const T* bounds, const T* sU, const T* tau, T* P, T* l, T* okp,
                   const Consts* c, cudaStream_t stream) {
  if (!ell_ok(c)) return int(cudaErrorInvalidValue);
  if (c->W == 0) return int(cudaSuccess);
  const EqConsts<T> e = EqConsts<T>::make(*c);
  const bool wide = c->n_stages > 2;
  if (inc && wide)
    return launch_ell_pk3_instance<T, true, MAX_STAGES>(cols, cij, mij, mask, inc, node, U, d,
                                                        alpha, F, U_low, bounds, sU, tau, P, l,
                                                        okp, e, c, stream);
  if (inc)
    return launch_ell_pk3_instance<T, true, 2>(cols, cij, mij, mask, inc, node, U, d, alpha, F,
                                               U_low, bounds, sU, tau, P, l, okp, e, c, stream);
  if (wide)
    return launch_ell_pk3_instance<T, false, MAX_STAGES>(cols, cij, mij, mask, inc, node, U, d,
                                                         alpha, F, U_low, bounds, sU, tau, P, l,
                                                         okp, e, c, stream);
  return launch_ell_pk3_instance<T, false, 2>(cols, cij, mij, mask, inc, node, U, d, alpha, F,
                                              U_low, bounds, sU, tau, P, l, okp, e, c, stream);
}

template <typename T>
int launch_ell_pk_up(const int64_t* trans, const T* mask, const T* node, const T* U,
                     const T* bounds, const T* P, const T* l, T* U_next, T* l_new,
                     const Consts* c, cudaStream_t stream) {
  if (!ell_ok(c)) return int(cudaErrorInvalidValue);
  if (c->W == 0) return int(cudaSuccess);
  const EqConsts<T> e = EqConsts<T>::make(*c);
  const dim3 grid = row_grid(c), block(128);
  if (c->dim == 1)
    ell_pk_up_kernel<T, 1><<<grid, block, 0, stream>>>(trans, mask, node, U, bounds, P, l, U_next,
                                                       l_new, e);
  else if (c->dim == 2)
    ell_pk_up_kernel<T, 2><<<grid, block, 0, stream>>>(trans, mask, node, U, bounds, P, l, U_next,
                                                       l_new, e);
  else
    ell_pk_up_kernel<T, 3><<<grid, block, 0, stream>>>(trans, mask, node, U, bounds, P, l, U_next,
                                                       l_new, e);
  return int(cudaGetLastError());
}

}  // namespace ryujin

#define RYUJIN_ELL(SUFFIX, T)                                                                  \
  extern "C" int ryujin_ell_pk1_##SUFFIX(const void* cols, const void* cij, const void* mask,  \
                                         const void* node, const void* U, const void* prec,    \
                                         void* e_out, void* alpha,                             \
                                         const ryujin::Consts* consts, void* stream) {         \
    return ryujin::launch_ell_pk1<T>((const int64_t*)cols, (const T*)cij, (const T*)mask,      \
                                     (const T*)node, (const T*)U, (const T*)prec, (T*)e_out,   \
                                     (T*)alpha, consts, (cudaStream_t)stream);                 \
  }                                                                                            \
  extern "C" int ryujin_ell_pk2_##SUFFIX(                                                      \
      const void* cols, const void* cij, const void* mask, const void* inc, const void* cii,   \
      const void* node, const void* U, const void* prec, const void* d, const void* alpha,     \
      const void* sU, const void* tau, void* U_low, void* F, void* bounds,                     \
      const ryujin::Consts* consts, void* stream) {                                            \
    return ryujin::launch_ell_pk2<T>((const int64_t*)cols, (const T*)cij, (const T*)mask,      \
                                     (const T*)inc, (const T*)cii, (const T*)node, (const T*)U, \
                                     (const T*)prec, (const T*)d, (const T*)alpha,             \
                                     (const T*)sU, (const T*)tau, (T*)U_low, (T*)F,             \
                                     (T*)bounds, consts, (cudaStream_t)stream);                \
  }                                                                                            \
  extern "C" int ryujin_ell_pk3_##SUFFIX(                                                      \
      const void* cols, const void* cij, const void* mij, const void* mask, const void* inc,   \
      const void* node, const void* U, const void* d, const void* alpha, const void* F,        \
      const void* U_low, const void* bounds, const void* sU, const void* tau, void* P,         \
      void* l, void* okp, const ryujin::Consts* consts, void* stream) {                        \
    return ryujin::launch_ell_pk3<T>((const int64_t*)cols, (const T*)cij, (const T*)mij,       \
                                     (const T*)mask, (const T*)inc, (const T*)node,            \
                                     (const T*)U, (const T*)d, (const T*)alpha, (const T*)F,   \
                                     (const T*)U_low, (const T*)bounds, (const T*)sU,          \
                                     (const T*)tau, (T*)P, (T*)l, (T*)okp, consts,             \
                                     (cudaStream_t)stream);                                    \
  }                                                                                            \
  extern "C" int ryujin_ell_pk_up_##SUFFIX(                                                    \
      const void* trans, const void* mask, const void* node, const void* U,                    \
      const void* bounds, const void* P, const void* l, void* U_next, void* l_new,             \
      const ryujin::Consts* consts, void* stream) {                                            \
    return ryujin::launch_ell_pk_up<T>((const int64_t*)trans, (const T*)mask, (const T*)node,  \
                                       (const T*)U, (const T*)bounds, (const T*)P,             \
                                       (const T*)l, (T*)U_next, (T*)l_new, consts,             \
                                       (cudaStream_t)stream);                                  \
  }

RYUJIN_ELL(f32, float)
RYUJIN_ELL(f64, double)
