// Device functions of the 2D Euler equations for the canvas kernels.
//
// Each function follows its PyTorch counterpart in
// ryujin_tpu_torch/equations/euler.py (itself a port of
// ryujin_tpu/equations/euler.py) operation by operation, so a kernel and
// its plain-torch reference do the same arithmetic.  Constants that the
// Python code forms from Python floats are formed here in double and
// rounded to T once (EqConsts), as Python scalars meet a tensor of T.
//
// Canvas layout: every array is planes-first [planes, H, W], row-major,
// n = H * W.  Lattice offset k is (DY[k], DX[k]) in (y, x), ordered as
// ryujin_tpu.offline.structured.lattice_offsets(2, 1); the transposed
// slot of k is K-1-k.  A neighbour is read at ((y+dy) mod H, (x+dx) mod W),
// the wrap of torch.roll; wrapped reads only ever feed masked edges.
#pragma once

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace ryujin {

constexpr int K = 8;
constexpr int K2 = K / 2;
constexpr int C = 4;  // rho, m_1, m_2, E

__host__ __device__ constexpr int DY(int k) { return k < 3 ? -1 : (k < 5 ? 0 : 1); }
__host__ __device__ constexpr int DX(int k) {
  return k < 3 ? k - 1 : (k < 5 ? (k == 3 ? -1 : 1) : k - 6);
}

// Scalars of one launch; mirrors ryujin_tpu_torch.kernels.build.Consts.
struct Consts {
  double gamma, reference_density, vacuum_small, vacuum_large;
  double evc_factor, relaxation_factor, newton_tol, measure_inv;
  double weight, w0, w1;  // 1 - sum(stage weights), stage weights
  int newton_iterations, pow_n, n_stages, H, W;
};

template <typename T> struct Limits;
template <> struct Limits<float> {
  static constexpr double eps = FLT_EPSILON, tiny = FLT_MIN, max = FLT_MAX;
};
template <> struct Limits<double> {
  static constexpr double eps = DBL_EPSILON, tiny = DBL_MIN, max = DBL_MAX;
};

__device__ __forceinline__ float rsqrt_(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_(double x) { return rsqrt(x); }

// Constants in T, each formed in double first.
template <typename T>
struct EqConsts {
  T g, gm1, gp1, inv_gp1, harten_deriv_exp, rf_factor, rf_ratio_exp;
  T sqrt2, lambda_fac, relax_small, relax, one_minus_relax, vacuum_cutoff;
  T eps, tiny, big, reg, evc_factor, relax_factor, two_relax_factor;
  T newton_tol, measure_inv, weight, w0, w1;
  double gamma_d, pow_e;
  int pow_n, newton_iterations, n_stages, H, W;

  static EqConsts make(const Consts& c) {
    EqConsts e;
    const double g = c.gamma, eps = Limits<T>::eps;
    e.g = T(g);
    e.gm1 = T(g - 1.0);
    e.gp1 = T(g + 1.0);
    e.inv_gp1 = T(1.0 / (g + 1.0));
    e.harten_deriv_exp = T(-g / (g + 1.0));
    const double factor = (g - 1.0) * 0.5;
    e.rf_factor = T(factor);
    e.rf_ratio_exp = T(-factor / g);
    e.sqrt2 = T(1.4142135623730951);
    e.lambda_fac = T((g + 1.0) * 0.5 / g);
    const double relax = 1.0 + c.vacuum_large * eps;
    e.relax_small = T(1.0 + c.vacuum_small * eps);
    e.relax = T(relax);
    e.one_minus_relax = T(1.0 - relax);
    e.vacuum_cutoff = T(c.reference_density * c.vacuum_large * eps);
    e.eps = T(eps);
    e.tiny = T(Limits<T>::tiny);
    e.big = T(Limits<T>::max);
    e.reg = T(100.0 * Limits<T>::tiny);
    e.evc_factor = T(c.evc_factor);
    e.relax_factor = T(c.relaxation_factor);
    e.two_relax_factor = T(2.0 * c.relaxation_factor);
    e.newton_tol = T(c.newton_tol);
    e.measure_inv = T(c.measure_inv);
    e.weight = T(c.weight);
    e.w0 = T(c.w0);
    e.w1 = T(c.w1);
    e.gamma_d = g;
    e.pow_e = 2.0 * g / (g - 1.0);
    e.pow_n = c.pow_n;
    e.newton_iterations = c.newton_iterations;
    e.n_stages = c.n_stages;
    e.H = c.H;
    e.W = c.W;
    return e;
  }
};

// ---- canvas addressing ---------------------------------------------------

struct Cell {
  int64_t i, n;  // flat index, plane size
  int y, x;
};

// The cell of this thread, or false past the canvas edge.  Launch with
// block (128, 1) and grid (ceil(W / 128), H): threads of a warp read
// neighbouring addresses of every plane.
__device__ __forceinline__ bool this_cell(int H, int W, Cell& c) {
  c.x = blockIdx.x * blockDim.x + threadIdx.x;
  c.y = blockIdx.y;
  c.n = int64_t(H) * W;
  c.i = int64_t(c.y) * W + c.x;
  return c.x < W && c.y < H;
}

__device__ __forceinline__ int64_t nbr(const Cell& c, int k, int H, int W) {
  int yj = c.y + DY(k), xj = c.x + DX(k);
  yj = yj < 0 ? yj + H : (yj >= H ? yj - H : yj);
  xj = xj < 0 ? xj + W : (xj >= W ? xj - W : xj);
  return int64_t(yj) * W + xj;
}

template <typename T>
__device__ __forceinline__ void load_state(const T* U, int64_t i, int64_t n, T u[C]) {
#pragma unroll
  for (int c = 0; c < C; ++c) u[c] = U[c * n + i];
}

// ---- elementwise helpers with the NaN-propagating semantics of torch -----

template <typename T> __device__ __forceinline__ T pos(T x) { return x > T(0) ? x : T(0); }
template <typename T> __device__ __forceinline__ T neg(T x) { return -x > T(0) ? -x : T(0); }
template <typename T> __device__ __forceinline__ T mn(T a, T b) { return a < b ? a : b; }
template <typename T> __device__ __forceinline__ T mx(T a, T b) { return a > b ? a : b; }

// x^e with a (near-)integer exponent strength-reduced to multiplies, as
// euler._pow; pow_n == 0 means a general exponent.
template <typename T>
__device__ __forceinline__ T pow_int(T x, int er, double e) {
  if (er == 0) return pow(x, T(e));
  int n = er < 0 ? -er : er;
  T acc = T(0);
  bool have = false;
  T base = x;
  while (n) {
    if (n & 1) {
      acc = have ? acc * base : base;
      have = true;
    }
    n >>= 1;
    if (n) base = base * base;
  }
  return er > 0 ? acc : T(1) / acc;
}

// ---- state algebra ---------------------------------------------------------

template <typename T>
__device__ __forceinline__ T internal_energy(const T u[C]) {
  const T rho_inv = T(1) / u[0];
  return u[3] - T(0.5) * (u[1] * u[1] + u[2] * u[2]) * rho_inv;
}

template <typename T>
__device__ __forceinline__ T specific_entropy(const EqConsts<T>& e, const T u[C]) {
  const T rho_inv = T(1) / u[0];
  return internal_energy(u) * pow(rho_inv, e.g);
}

// Flux tensor f[c][d].
template <typename T>
__device__ __forceinline__ void flux(const EqConsts<T>& e, const T u[C], T f[C][2]) {
  const T rho_inv = T(1) / u[0];
  const T p = e.gm1 * internal_energy(u);
  const T v0 = u[1] * rho_inv, v1 = u[2] * rho_inv;
  f[0][0] = u[1];
  f[0][1] = u[2];
  f[1][0] = u[1] * v0 + p;
  f[1][1] = u[1] * v1;
  f[2][0] = u[2] * v0;
  f[2][1] = u[2] * v1 + p;
  f[3][0] = v0 * (u[3] + p);
  f[3][1] = v1 * (u[3] + p);
}

// -(f_i + f_j) . c for component c.
template <typename T>
__device__ __forceinline__ T flux_div(const T fi[C][2], const T fj[C][2], int c, T c0, T c1) {
  return -((fi[c][0] + fj[c][0]) * c0 + (fi[c][1] + fj[c][1]) * c1);
}

// ---- Riemann solver --------------------------------------------------------

// (p, a, 1/rho, 1/p, log2 p)
template <typename T>
__device__ __forceinline__ void riemann_precompute(const EqConsts<T>& e, const T u[C], T pa[5]) {
  const T rho_inv = T(1) / u[0];
  const T rho_e = u[3] - T(0.5) * (u[1] * u[1] + u[2] * u[2]) * rho_inv;
  const T p = e.gm1 * rho_e;
  pa[0] = p;
  pa[1] = sqrt(e.g * p * rho_inv);
  pa[2] = rho_inv;
  pa[3] = T(1) / p;
  pa[4] = log2(p);
}

// Two-rarefaction bound on the maximal wavespeed along (n0, n1), without
// Newton refinement (riemann_solver.template.h:406-582).
template <typename T>
__device__ __forceinline__ T lambda_max(const EqConsts<T>& e, const T ui[C], const T pi_[5],
                                        const T uj[C], const T pj_[5], T n0, T n1) {
  const T rho_i = ui[0], rho_j = uj[0];
  const T u_i = (n0 * ui[1] + n1 * ui[2]) * pi_[2];
  const T u_j = (n0 * uj[1] + n1 * uj[2]) * pj_[2];
  const T p_i = pi_[0], a_i = pi_[1], p_inv_i = pi_[3], lp_i = pi_[4];
  const T p_j = pj_[0], a_j = pj_[1], p_inv_j = pj_[3], lp_j = pj_[4];

  const T p_max = mx(p_i, p_j);
  const T num = pos(a_i + a_j - e.rf_factor * (u_j - u_i));
  const T ratio_pow = exp2(e.rf_ratio_exp * (lp_i - lp_j));
  const T den = a_i * ratio_pow + a_j;
  const T p_rarefaction = p_j * pow_int(num / den, e.pow_n, e.pow_e);

  const T sqrt_2pmax = sqrt(T(2) * p_max);
  const T ri = rho_i * (e.gp1 * p_max + e.gm1 * p_i);
  const T rj = rho_j * (e.gp1 * p_max + e.gm1 * p_j);
  const T ri_rsqrt = rsqrt_(ri), rj_rsqrt = rsqrt_(rj);
  const T x_i = sqrt_2pmax * ri_rsqrt, x_j = sqrt_2pmax * rj_rsqrt;
  const T a_q = x_i + x_j;
  const T b_q = u_j - u_i;
  const T c_q = -p_i * x_i - p_j * x_j;
  const T base = (-b_q + sqrt(b_q * b_q - T(4) * a_q * c_q)) / (T(2) * a_q);
  const T p_failsafe = base * base;
  const T p_star_tilde = mn(p_rarefaction, p_failsafe);

  const T vi = (p_max - p_i) * (e.sqrt2 * ri_rsqrt);
  const T vj = (p_max - p_j) * (e.sqrt2 * rj_rsqrt);
  const T phi_p_max = vi + vj + u_j - u_i;
  const T p_2 = phi_p_max < T(0) ? p_star_tilde : mn(p_max, p_star_tilde);

  const T nu_11 = u_i - a_i * sqrt(T(1) + e.lambda_fac * pos((p_2 - p_i) * p_inv_i));
  const T nu_32 = u_j + a_j * sqrt(T(1) + e.lambda_fac * pos((p_2 - p_j) * p_inv_j));
  return mx(pos(nu_32), neg(nu_11));
}

// ---- limiter ---------------------------------------------------------------

// (rho, rho^gamma, rho * rho_e, psi) of U at t = 0 (euler.limiter_psi0).
template <typename T>
__device__ __forceinline__ void limiter_psi0(const EqConsts<T>& e, T s_min, const T u[C], T psi0[4]) {
  const T rho = u[0];
  const T rho_gamma = pow(rho, e.g);
  const T ae = rho * u[3] - T(0.5) * (u[1] * u[1] + u[2] * u[2]);
  psi0[0] = rho;
  psi0[1] = rho_gamma;
  psi0[2] = ae;
  psi0[3] = e.relax_small * ae - s_min * rho_gamma * rho;
}

template <typename T>
__device__ __forceinline__ T filter_vacuum(const EqConsts<T>& e, T rho) {
  return fabs(rho) < e.vacuum_cutoff ? T(0) : rho;
}

// One step of the two-sided quadratic Newton method (newton.h:37-101).
template <typename T>
__device__ __forceinline__ void quadratic_newton_step(const EqConsts<T>& e, T p_1, T p_2, T phi_1,
                                                      T phi_2, T dphi_1, T dphi_2, T sign,
                                                      T& new_1, T& new_2) {
  const T scaling = T(1) / (p_2 - p_1 + e.eps);
  const T dd_11 = dphi_1;
  const T dd_12 = (phi_2 - phi_1) * scaling;
  const T dd_22 = dphi_2;
  const T dd_112 = (dd_12 - dd_11) * scaling;
  const T dd_122 = (dd_22 - dd_12) * scaling;
  const T disc_1 = fabs(dphi_1 * dphi_1 - T(4) * phi_1 * dd_112);
  const T disc_2 = fabs(dphi_2 * dphi_2 - T(4) * phi_2 * dd_122);
  const T den_1 = dphi_1 + sign * sqrt(disc_1);
  const T den_2 = dphi_2 + sign * sqrt(disc_2);
  T t_1 = p_1 - (fabs(den_1) < e.eps ? T(0) : T(2) * phi_1 / den_1);
  T t_2 = p_2 - (fabs(den_2) < e.eps ? T(0) : T(2) * phi_2 / den_2);
  t_1 = mn(mx(t_1, p_1), p_2);
  t_2 = mn(mx(t_2, p_1), p_2);
  new_1 = mn(t_1, t_2);
  new_2 = mx(t_1, t_2);
}

// Convex limiter along U + t P, t in [0, 1] (euler/limiter.template.h:
// 15-327): density bounds, then the specific-entropy minimum principle by
// quadratic Newton.  Returns l; `success` as the JAX limiter reports it.
// Where psi(t_r) > 0 the Newton loop would leave t_l = t_r exactly, so the
// lane returns at once: the per-lane form of the all-lanes early exit.
template <typename T>
__device__ __forceinline__ T limiter_limit(const EqConsts<T>& e, const T bnd[3], const T u[C],
                                           const T psi0[4], const T P[C], bool& success) {
  const T rho_min = bnd[0], rho_max = bnd[1], s_min = bnd[2];
  const T rho_U = u[0], rho_P = P[0];

  const T test_min = filter_vacuum(e, pos(rho_U - e.relax * rho_max));
  const T test_max = filter_vacuum(e, pos(rho_min - e.relax * rho_U));
  success = (test_min == T(0)) && (test_max == T(0));

  T t_r = T(1);
  const T denominator = T(1) / (fabs(rho_P) + e.eps * rho_max);
  if (rho_max < rho_U + t_r * rho_P) t_r = (rho_max - rho_U) * denominator;
  if (rho_U + t_r * rho_P < rho_min) t_r = (rho_U - rho_min) * denominator;
  t_r = mn(mx(t_r, T(0)), T(1));

  const T ae = psi0[2];
  const T be = rho_U * P[3] + rho_P * u[3] - (u[1] * P[1] + u[2] * P[2]);
  const T ce = rho_P * P[3] - T(0.5) * (P[1] * P[1] + P[2] * P[2]);

  auto psi_eval = [&](T t, T& rho_t, T& rho_g) {
    rho_t = rho_U + t * rho_P;
    rho_g = pow(rho_t, e.g);
    return e.relax_small * (ae + t * (be + t * ce)) - s_min * rho_g * rho_t;
  };
  auto dpsi_eval = [&](T t, T rho_g) {
    return (be + T(2) * ce * t) - e.gp1 * s_min * rho_g * rho_P;
  };

  if (e.newton_iterations == 0) return T(0);
  T rho_r, rho_r_gamma;
  T psi_r = psi_eval(t_r, rho_r, rho_r_gamma);
  if (psi_r > T(0)) {
    const T lower_bound = e.one_minus_relax * s_min * rho_r * rho_r_gamma;
    success = success && (psi_r - lower_bound >= T(0));
    return t_r;
  }
  T t_l = T(0);
  for (int it = 0; it < e.newton_iterations; ++it) {
    if (it > 0) psi_r = psi_eval(t_r, rho_r, rho_r_gamma);
    const bool pr_pos = psi_r > T(0);
    if (pr_pos) t_l = t_r;
    T rho_l, rho_l_gamma, psi_l;
    if (it == 0) {
      rho_l = pr_pos ? rho_r : psi0[0];
      rho_l_gamma = pr_pos ? rho_r_gamma : psi0[1];
      psi_l = pr_pos ? psi_r : psi0[3];
      const T lower_bound = e.one_minus_relax * s_min * rho_l * rho_l_gamma;
      success = success && (psi_l - lower_bound >= T(0));
    } else {
      psi_l = psi_eval(t_l, rho_l, rho_l_gamma);
    }
    const T dpsi_l = dpsi_eval(t_l, rho_l_gamma);
    const T dpsi_r = dpsi_eval(t_r, rho_r_gamma);
    T nl, nr;
    quadratic_newton_step(e, t_l, t_r, psi_l, psi_r, dpsi_l, dpsi_r, T(-1), nl, nr);
    if (t_r - t_l > e.newton_tol) {
      t_l = nl;
      t_r = nr;
    }
  }
  return t_l;
}

// ---- launch helper -----------------------------------------------------------

inline dim3 canvas_grid(int H, int W) { return dim3((W + 127) / 128, H); }
inline dim3 canvas_block() { return dim3(128, 1); }

}  // namespace ryujin
