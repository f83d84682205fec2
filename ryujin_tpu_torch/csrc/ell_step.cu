// The substep on the padded-ELL stencil: four kernels.
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
// i] (int64 for ell_pk1, int32 for ell_pk2 and ell_pk3: n < 2^31); the
// transposed edge of slot k at row i is the flat index trans[k * n + i]
// into the [K, n] edge arrays.  Statics: c_ij [DIM, K,
// n], m_ij [K, n], the mask [K, n] (1 live, 0 padding), c_ii [DIM, n],
// the dG incidence [K, n] (null for a continuous ansatz) and the node
// planes [4, n]: m_i, 1/m_i, n_nbrs, node_mask.  K is the launch's
// (Consts K): the mesh's largest row, 2 in 1D Q1, more at the irregular
// vertices of an unstructured mesh.
//
// Design: ell_pk1 and ell_pk_up one thread a row, 128 threads a block,
// the loop over k not unrolled, U_j and the other neighbour values
// gathered from device memory at every live slot: the one-thread-a-cell
// form of the canvas kernels' first ports.  ell_pk2 and ell_pk3 (see "the
// launch of ell_pk2 and ell_pk3" below) stage each block's row values in
// shared memory, so their registers hold no row state the slots only read
// and their stacks nothing; ell_pk3 spreads a row's slots over threads.
// The neighbour values are gathered at every live slot: a block's columns
// span 1,000-6,500 rows on the meshes at size, more than shared memory
// holds (PERF.md section 6).  What bounds them on the H100: not
// their bytes (24-34 % of that bound in the one-thread-a-row form) nor the
// gathers, but the latency of each slot's chain of gathers, divisions,
// pows and the limiter's Newton steps, which the warps an SM holds hide
// only in part.  Each kernel is a template on DIM (1, 2, 3; C = DIM + 2
// components), PK2 and PK3 also on the dG flag (the incidence raises the
// high-order viscosity factor to beta_ij) and on MS, the most stage slots
// an instance takes (2, or MAX_STAGES for ERK54's 3 and 4), chosen at
// launch by n_stages.
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
#include "staged.cuh"

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

// ---- the launch of ell_pk2 and ell_pk3 -----------------------------------------
//
// A block (B, KY) owns B = block.x consecutive rows and stages in shared
// memory, as arrays of B rows, the values that depend on the row alone,
// each formed once: U and the parts of its flux, each stage state's flux
// parts, and the kernel's other row values.  A slot rebuilds the row's flux
// from its parts (staged.cuh: the multiplies flux() forms it with, so bit
// for bit), reads the other row values where it needs them, and forms its
// neighbour's flux from the state it gathers; the stage loops run over the
// instance's MS, so no array is indexed at run time and nothing goes to the
// stack.  ell_pk3 spreads the slots over KY threads a row: thread (m, ky)
// takes the edges (k, i0 + m) of the slots k = ky, ky + KY, ... < K, and a
// warp covers consecutive rows of one slot, so the per-edge planes (cols,
// c_ij, m_ij, d, the mask, the incidence) are read, and P and l written,
// coalesced.  ell_pk2 sums over the slots in order and keeps one thread a
// row (KY = 1; spreading its slots lost, PERF.md section 6).
// ell_step_shape() (kernels/ell.py) mirrors the layout; the launchers refuse
// any other.
constexpr int ELL_THREADS = 128;  // the most threads a block; mirrored by ELL_THREADS in kernels/ell.py
// The launch bound of the f32 instances in 1D and 2D: the blocks of
// ELL_THREADS an SM must hold, so at most 72 registers a thread for
// ell_pk2, 48 for ell_pk3 of at most two stage slots and 56 for its
// MAX_STAGES instance (more warps resident, with no stack; fewer spill;
// the other instances are left to the compiler)
constexpr int ELL_PK2_BLOCKS = 7, ELL_PK3_BLOCKS = 10, ELL_PK3_WIDE_BLOCKS = 9;
template <typename T, int DIM>
__host__ __device__ constexpr int ell_min_blocks(int blocks) {
  return sizeof(T) == 4 && DIM <= 2 ? blocks : 1;
}

// Row values of ell_pk3: U and its flux parts, U_low, F, the bounds, psi0,
// alpha_i, 1/m_i, pfac and the node mask, then each stage state's flux parts;
// of ell_pk2 staged.cuh's pk2_vals (U and its flux parts, s_i, alpha_i, the
// stages' flux parts), then the row's sums of each stage's flux
// divergences, which its thread alone reads and writes.
__host__ __device__ constexpr int ell_pk3_row_vals(int dim, int stages) {
  return 4 * dim + 19 + stages * stage_vals(dim);
}

inline int64_t ell_step_smem(bool pk3, int dim, int stages, int rows, int size) {
  const int vals = pk3 ? ell_pk3_row_vals(dim, stages) : pk2_vals(dim, stages) + stages * (dim + 2);
  return int64_t(vals) * rows * size;
}

namespace {

// The parts of a state's flux, m, v = m (1/rho), p and E + p (staged.cuh):
// flux_div over them forms each flux entry where it is summed, with the
// multiplies flux() forms it with, so no flux tensor is held.
template <typename T, int DIM>
struct Parts {
  T m[DIM], v[DIM], p, Ep;
};

template <typename T, int NC>
__device__ __forceinline__ Parts<T, NC - 2> state_parts(const EqConsts<T>& e, const T (&u)[NC]) {
  Parts<T, NC - 2> f;
#pragma unroll
  for (int d = 0; d < NC - 2; ++d) f.m[d] = u[1 + d];
  flux_parts(e, u, f.v, f.p, f.Ep);
  return f;
}

// The parts staged for row r: m at values am .., v at av .., p and E + p
// after v (U's: am = 1, av = NC; a stage state's: av = am + DIM).
template <typename T, int DIM>
__device__ __forceinline__ Parts<T, DIM> staged_parts(const T* sm, int ns, int r, int am, int av) {
  Parts<T, DIM> f;
#pragma unroll
  for (int d = 0; d < DIM; ++d) {
    f.m[d] = sm[(am + d) * ns + r];
    f.v[d] = sm[(av + d) * ns + r];
  }
  f.p = sm[(av + DIM) * ns + r];
  f.Ep = sm[(av + DIM + 1) * ns + r];
  return f;
}

// Entry d of row q of the flux tensor of parts f (flux_from_parts').
template <typename T, int DIM>
__device__ __forceinline__ T flux_entry(const Parts<T, DIM>& f, int q, int d) {
  if (q == 0) return f.m[d];
  if (q == DIM + 1) return f.v[d] * f.Ep;
  return q - 1 == d ? f.m[q - 1] * f.v[d] + f.p : f.m[q - 1] * f.v[d];
}

// -(f_a + f_b) . c for component q, as flux_div forms it.
template <typename T, int DIM>
__device__ __forceinline__ T flux_div(const Parts<T, DIM>& a, const Parts<T, DIM>& b, int q,
                                      const T (&cv)[DIM]) {
  T s = (flux_entry(a, q, 0) + flux_entry(b, q, 0)) * cv[0];
#pragma unroll
  for (int d = 1; d < DIM; ++d) s = s + (flux_entry(a, q, d) + flux_entry(b, q, d)) * cv[d];
  return -s;
}

}  // namespace

// ---- ell_pk2: U_low, F and the limiter bounds -----------------------------------
//
// One thread a row, its slots in order k = 0 .. K-1 as the one-thread-a-row
// form sums them; the row's values (U and its flux parts, s_i, alpha_i, each
// stage state's flux parts) and its sums of the stages' flux divergences in
// shared memory, for the thread alone (no barrier), so that the thread fits
// the launch bound's registers with nothing on the stack.
template <typename T, int DIM, bool DG, int MS>
__global__ void __launch_bounds__(ELL_THREADS, ell_min_blocks<T, DIM>(ELL_PK2_BLOCKS))
ell_pk2_kernel(const int32_t* __restrict__ cols, const T* __restrict__ cij,
               const T* __restrict__ mask, const T* __restrict__ inc, const T* __restrict__ cii,
               const T* __restrict__ node, const T* __restrict__ U, const T* __restrict__ prec,
               const T* __restrict__ d_in, const T* __restrict__ alpha,
               const T* __restrict__ sU, const T* __restrict__ tau_ptr, T* __restrict__ U_low,
               T* __restrict__ F_out, T* __restrict__ bounds,
               const __grid_constant__ EqConsts<T> e) {
  constexpr int NC = DIM + 2, SV = stage_vals(DIM);
  constexpr int SI = u_vals(DIM), AL = SI + 1, SG = SI + 2;  // s_i, alpha_i, stages
  extern __shared__ __align__(16) unsigned char ell_smem[];
  T* const rv = reinterpret_cast<T*>(ell_smem);
  const int B = blockDim.x, m = threadIdx.x;
  const int64_t n = e.W;
  const int K = e.K, S = e.n_stages;
  const int64_t i = int64_t(blockIdx.x) * B + m;
  if (i >= n) return;

  stage_state<T, DIM>(e, U, i, n, rv, B, m);
  rv[SI * B + m] = prec[i];
  rv[AL * B + m] = alpha[i];
#pragma unroll
  for (int s = 0; s < MS; ++s)
    if (s < S) stage_stage<T, DIM>(e, sU + int64_t(s) * NC * n, i, n, rv, B, m, SG + s * SV);

  T low_acc[NC], F_acc[NC];
  T* const Fs_acc = rv + (SG + S * SV) * B + m;  // the stage sums, value s NC + q
#pragma unroll
  for (int q = 0; q < NC; ++q) low_acc[q] = F_acc[q] = T(0);
#pragma unroll
  for (int s = 0; s < MS; ++s)
#pragma unroll
    for (int q = 0; q < NC; ++q)
      if (s < S) Fs_acc[(s * NC + q) * B] = T(0);
  const T u0 = rv[m], s_i = rv[SI * B + m];
  T rho_min = u0, rho_max = u0, s_min = s_i, s_interp_max = s_i;
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
    T ui[NC], uj[NC];
    staged_u(rv, B, m, ui);
    load_state(U, j, n, uj);
    T factor = T(0.5) * (rv[AL * B + m] + alpha[j]);
    if constexpr (DG) factor = mx(factor, inc[k * n + i]);
    const T d_H = d * factor;
    {
      const Parts<T, DIM> fi = staged_parts<T, DIM>(rv, B, m, 1, NC), fj = state_parts(e, uj);
#pragma unroll
      for (int q = 0; q < NC; ++q) {
        const T flux_ij = flux_div(fi, fj, q, cv);
        const T dU = uj[q] - ui[q];
        low_acc[q] += flux_ij + d * dU;
        F_acc[q] += d_H * dU + e.weight * flux_ij;
      }
    }
#pragma unroll
    for (int s = 0; s < MS; ++s) {
      if (s < S) {
        T usj[NC];
        load_state(sU + int64_t(s) * NC * n, j, n, usj);
        const Parts<T, DIM> fsi = staged_parts<T, DIM>(rv, B, m, SG + s * SV, SG + s * SV + DIM);
        const Parts<T, DIM> fsj = state_parts(e, usj);
#pragma unroll
        for (int q = 0; q < NC; ++q) Fs_acc[(s * NC + q) * B] += flux_div(fsi, fsj, q, cv);
      }
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
  const T tau = *tau_ptr;
  T cvi[DIM];
#pragma unroll
  for (int d = 0; d < DIM; ++d) cvi[d] = cii[int64_t(d) * n + i];
  const Parts<T, DIM> fi = staged_parts<T, DIM>(rv, B, m, 1, NC);
#pragma unroll
  for (int q = 0; q < NC; ++q) {
    const T flux_ii = flux_div(fi, fi, q, cvi);
    U_low[q * n + i] = rv[q * B + m] + (tau * m_inv) * (low_acc[q] + flux_ii);
    T F = F_acc[q] + e.weight * flux_ii;
    // the stage increments sum_s w_s (sum_k hof_s + hof_s_ii), summed
    // over the stages apart and added last, as _stage_terms does; a zero
    // weight adds nothing there
    T F_inc = T(0);
    bool have = false;
#pragma unroll
    for (int s = 0; s < MS; ++s) {
      if (s < S) {
        const T w_s = stage_weight<MS>(e, s);
        if (w_s == T(0)) continue;
        const Parts<T, DIM> fsi = staged_parts<T, DIM>(rv, B, m, SG + s * SV, SG + s * SV + DIM);
        const T inc_s = w_s * (Fs_acc[(s * NC + q) * B] + flux_div(fsi, fsi, q, cvi));
        F_inc = have ? F_inc + inc_s : inc_s;
        have = true;
      }
    }
    F_out[q * n + i] = have ? F + F_inc : F;
  }

  const T hd_i = node[i] * e.measure_inv;
  const T r_i = relax_radius<DIM>(hd_i) * e.relax_factor;
  const T relax_num = relax_sum + T(2) * u0;
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
//
// Each edge writes its P and l; the row's task writes okp = 1 before the
// barrier, and an edge of a real row that fails the limiter writes 0 after
// it (every writer the same value).
template <typename T, int DIM, bool DG, int MS>
__global__ void __launch_bounds__(ELL_THREADS, ell_min_blocks<T, DIM>(MS == 2 ? ELL_PK3_BLOCKS
                                                                     : ELL_PK3_WIDE_BLOCKS))
ell_pk3_kernel(const int32_t* __restrict__ cols, const T* __restrict__ cij,
               const T* __restrict__ mij, const T* __restrict__ mask, const T* __restrict__ inc,
               const T* __restrict__ node, const T* __restrict__ U, const T* __restrict__ d_in,
               const T* __restrict__ alpha, const T* __restrict__ F, const T* __restrict__ U_low,
               const T* __restrict__ bounds, const T* __restrict__ sU,
               const T* __restrict__ tau_ptr, T* __restrict__ P_out, T* __restrict__ l_out,
               T* __restrict__ okp, const __grid_constant__ EqConsts<T> e) {
  constexpr int NC = DIM + 2, SV = stage_vals(DIM);
  // U_low, F_i, the bounds, psi0, alpha_i, 1/m_i, pfac, node mask, stages
  constexpr int UL = u_vals(DIM), FI = UL + NC, BN = FI + NC, PS = BN + 3, AL = PS + 4,
                MI = AL + 1, PF = AL + 2, RE = AL + 3, SG = AL + 4;
  extern __shared__ __align__(16) unsigned char ell_smem[];
  T* const rv = reinterpret_cast<T*>(ell_smem);
  const int B = blockDim.x, KY = blockDim.y, m = threadIdx.x, ky = threadIdx.y;
  const int64_t n = e.W;
  const int K = e.K, S = e.n_stages;
  const int64_t i = int64_t(blockIdx.x) * B + m;

  // the row values, a task a thread: 0 U and its flux parts; 1 U_low, the
  // bounds and psi0, and okp = 1; 2 F_i, alpha_i, 1/m_i, pfac and the node
  // mask; 3 + s stage s
  if (i < n) {
    for (int t = ky; t < 3 + S; t += KY) {
      if (t == 0) {
        stage_state<T, DIM>(e, U, i, n, rv, B, m);
      } else if (t == 1) {
        T ul[NC], psi0[4];
        load_state(U_low, i, n, ul);
        const T bnd[3] = {bounds[i], bounds[n + i], bounds[2 * n + i]};
        limiter_psi0(e, bnd[2], ul, psi0);
#pragma unroll
        for (int q = 0; q < NC; ++q) rv[(UL + q) * B + m] = ul[q];
#pragma unroll
        for (int b = 0; b < 3; ++b) rv[(BN + b) * B + m] = bnd[b];
#pragma unroll
        for (int b = 0; b < 4; ++b) rv[(PS + b) * B + m] = psi0[b];
        okp[i] = T(1);
      } else if (t == 2) {
#pragma unroll
        for (int q = 0; q < NC; ++q) rv[(FI + q) * B + m] = F[q * n + i];
        const T m_inv = node[n + i];
        rv[AL * B + m] = alpha[i];
        rv[MI * B + m] = m_inv;
        rv[PF * B + m] = *tau_ptr * m_inv * node[2 * n + i];
        rv[RE * B + m] = node[3 * n + i];
      } else {
        stage_stage<T, DIM>(e, sU + int64_t(t - 3) * NC * n, i, n, rv, B, m, SG + (t - 3) * SV);
      }
    }
  }
  __syncthreads();

  if (i < n) {
    for (int k = ky; k < K; k += KY) {
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
      T factor = T(0.5) * (rv[AL * B + m] + alpha[j]);
      if constexpr (DG) factor = mx(factor, inc[k * n + i]);
      const T d_H = d * factor;
      T ui[NC], uj[NC];
      staged_u(rv, B, m, ui);
      load_state(U, j, n, uj);
      T P[NC];
      {
        const Parts<T, DIM> fi = staged_parts<T, DIM>(rv, B, m, 1, NC), fj = state_parts(e, uj);
#pragma unroll
        for (int q = 0; q < NC; ++q) {
          const T flux_ij = flux_div(fi, fj, q, cv);
          P[q] = -flux_ij + e.weight * flux_ij + (d_H - d) * (uj[q] - ui[q]);
        }
      }
      // sum_s w_s hof_s over the stages of nonzero weight, added at once
      T P_inc[NC];
      bool have = false;
#pragma unroll
      for (int s = 0; s < MS; ++s) {
        if (s < S) {
          const T w_s = stage_weight<MS>(e, s);
          if (w_s == T(0)) continue;
          T usj[NC];
          load_state(sU + int64_t(s) * NC * n, j, n, usj);
          const Parts<T, DIM> fsi = staged_parts<T, DIM>(rv, B, m, SG + s * SV, SG + s * SV + DIM);
          const Parts<T, DIM> fsj = state_parts(e, usj);
#pragma unroll
          for (int q = 0; q < NC; ++q) {
            const T term = w_s * flux_div(fsi, fsj, q, cv);
            P_inc[q] = have ? P_inc[q] + term : term;
          }
          have = true;
        }
      }
      const T m_ij = mij[k * n + i];
      const T b_ij = -m_ij / node[j];
      const T b_ji = -m_ij * rv[MI * B + m];
      const T pfac = rv[PF * B + m];
#pragma unroll
      for (int q = 0; q < NC; ++q) {
        T p = have ? P[q] + P_inc[q] : P[q];
        p = p + b_ij * F[q * n + j] - b_ji * rv[(FI + q) * B + m];
        P[q] = p * pfac;
        P_out[(int64_t(q) * K + k) * n + i] = P[q];
      }
      T ul[NC], bnd[3], psi0[4];
#pragma unroll
      for (int q = 0; q < NC; ++q) ul[q] = rv[(UL + q) * B + m];
#pragma unroll
      for (int b = 0; b < 3; ++b) bnd[b] = rv[(BN + b) * B + m];
#pragma unroll
      for (int b = 0; b < 4; ++b) psi0[b] = rv[(PS + b) * B + m];
      bool success;
      l_out[k * n + i] = limiter_limit(e, bnd, ul, psi0, P, success);
      if (rv[RE * B + m] > T(0) && !success) okp[i] = T(0);
    }
  }
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

// The launch ell_step_shape() gives ell_pk2 (pk3 false) or ell_pk3: a block
// (B, KY, 1) of at most ELL_THREADS threads with KY <= K (KY = 1 for
// ell_pk2), ceil(n / B) blocks, and the shared bytes of the layout.
template <typename T>
bool ell_step_launch_ok(const Consts* c, bool pk3) {
  const int B = c->block[0], KY = c->block[1];
  if (B < 1 || KY < 1 || KY > c->K || c->block[2] != 1 || B * KY > ELL_THREADS) return false;
  if (!pk3 && KY != 1) return false;
  if (c->grid[0] != (int64_t(c->W) + B - 1) / B || c->grid[1] != 1 || c->grid[2] != 1) return false;
  return c->smem == ell_step_smem(pk3, c->dim, c->n_stages, B, int(sizeof(T)));
}

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
int launch_ell_pk2_instance(const int32_t* cols, const T* cij, const T* mask, const T* inc,
                            const T* cii, const T* node, const T* U, const T* prec, const T* d,
                            const T* alpha, const T* sU, const T* tau, T* U_low, T* F, T* bounds,
                            const EqConsts<T>& e, const Consts* c, cudaStream_t stream) {
  const dim3 grid(c->grid[0]), block(c->block[0], c->block[1]);
  const int smem = c->smem;
  if (c->dim == 1) {
    auto* kernel = ell_pk2_kernel<T, 1, DG, MS>;
    if (const int rc = allow_smem(kernel, smem)) return rc;
    kernel<<<grid, block, smem, stream>>>(cols, cij, mask, inc, cii, node, U, prec, d, alpha, sU,
                                          tau, U_low, F, bounds, e);
  } else if (c->dim == 2) {
    auto* kernel = ell_pk2_kernel<T, 2, DG, MS>;
    if (const int rc = allow_smem(kernel, smem)) return rc;
    kernel<<<grid, block, smem, stream>>>(cols, cij, mask, inc, cii, node, U, prec, d, alpha, sU,
                                          tau, U_low, F, bounds, e);
  } else {
    auto* kernel = ell_pk2_kernel<T, 3, DG, MS>;
    if (const int rc = allow_smem(kernel, smem)) return rc;
    kernel<<<grid, block, smem, stream>>>(cols, cij, mask, inc, cii, node, U, prec, d, alpha, sU,
                                          tau, U_low, F, bounds, e);
  }
  return int(cudaGetLastError());
}

// `inc` given: the dG instances; each takes its instance of at most 2
// stages, or of MAX_STAGES above 2.
template <typename T>
int launch_ell_pk2(const int32_t* cols, const T* cij, const T* mask, const T* inc, const T* cii,
                   const T* node, const T* U, const T* prec, const T* d, const T* alpha,
                   const T* sU, const T* tau, T* U_low, T* F, T* bounds, const Consts* c,
                   cudaStream_t stream) {
  if (!ell_ok(c) || !ell_step_launch_ok<T>(c, false)) return int(cudaErrorInvalidValue);
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
int launch_ell_pk3_instance(const int32_t* cols, const T* cij, const T* mij, const T* mask,
                            const T* inc, const T* node, const T* U, const T* d, const T* alpha,
                            const T* F, const T* U_low, const T* bounds, const T* sU,
                            const T* tau, T* P, T* l, T* okp, const EqConsts<T>& e,
                            const Consts* c, cudaStream_t stream) {
  const dim3 grid(c->grid[0]), block(c->block[0], c->block[1]);
  const int smem = c->smem;
  if (c->dim == 1) {
    auto* kernel = ell_pk3_kernel<T, 1, DG, MS>;
    if (const int rc = allow_smem(kernel, smem)) return rc;
    kernel<<<grid, block, smem, stream>>>(cols, cij, mij, mask, inc, node, U, d, alpha, F, U_low,
                                          bounds, sU, tau, P, l, okp, e);
  } else if (c->dim == 2) {
    auto* kernel = ell_pk3_kernel<T, 2, DG, MS>;
    if (const int rc = allow_smem(kernel, smem)) return rc;
    kernel<<<grid, block, smem, stream>>>(cols, cij, mij, mask, inc, node, U, d, alpha, F, U_low,
                                          bounds, sU, tau, P, l, okp, e);
  } else {
    auto* kernel = ell_pk3_kernel<T, 3, DG, MS>;
    if (const int rc = allow_smem(kernel, smem)) return rc;
    kernel<<<grid, block, smem, stream>>>(cols, cij, mij, mask, inc, node, U, d, alpha, F, U_low,
                                          bounds, sU, tau, P, l, okp, e);
  }
  return int(cudaGetLastError());
}

template <typename T>
int launch_ell_pk3(const int32_t* cols, const T* cij, const T* mij, const T* mask, const T* inc,
                   const T* node, const T* U, const T* d, const T* alpha, const T* F,
                   const T* U_low, const T* bounds, const T* sU, const T* tau, T* P, T* l, T* okp,
                   const Consts* c, cudaStream_t stream) {
  if (!ell_ok(c) || !ell_step_launch_ok<T>(c, true)) return int(cudaErrorInvalidValue);
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
    return ryujin::launch_ell_pk2<T>((const int32_t*)cols, (const T*)cij, (const T*)mask,      \
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
    return ryujin::launch_ell_pk3<T>((const int32_t*)cols, (const T*)cij, (const T*)mij,       \
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
