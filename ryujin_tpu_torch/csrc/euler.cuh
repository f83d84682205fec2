// Device functions of the Euler equations for the canvas kernels, in 2D
// (C = 4 components) and 3D (C = 5).
//
// Each function follows its PyTorch counterpart in
// ryujin_tpu_torch/equations/euler.py (itself a port of
// ryujin_tpu/equations/euler.py) operation by operation, so a kernel and
// its plain-torch reference do the same arithmetic.  Constants that the
// Python code forms from Python floats are formed here in double and
// rounded to T once (EqConsts), as Python scalars meet a tensor of T.
//
// Canvas layout: every array is planes-first [planes, H, W] in 2D and
// [planes, D, H, W] in 3D, row-major, n = D * H * W (D = 1 in 2D).
// Lattice offset k is (dz[k], dy[k], dx[k]) in (z, y, x) (dz = 0 in 2D),
// ordered as offline.structured.lattice_offsets(dim, reach); the
// transposed slot of k is K-1-k for every reach.  A neighbour is read at
// ((z+dz) mod D, (y+dy) mod H, (x+dx) mod W), the wrap of torch.roll;
// wrapped reads only ever feed masked edges.  The reach-1 2D kernels
// (pk1, pk2, pk3) have K = 8 and the offsets DY/DX at compile time; the
// stream kernels and pk_up take K and the offset list of the launch from
// Consts, and are templates on DIM.
//
// The state algebra takes arrays by reference and reads the dimension
// from their extent: a state u[NC] has NC = DIM + 2 components (rho,
// m_1 .. m_DIM, E), a flux tensor f[NC][DIM].  Sums over the momentum or
// space components run from the first to the last, left to right, as
// torch.sum over a component axis does.
#pragma once

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace ryujin {

constexpr int K = 8;
constexpr int K2 = K / 2;
constexpr int C = 4;  // rho, m_1, m_2, E of the 2D reach-1 kernels
constexpr int MAX_K = 48;  // offsets a launch can carry (reach 3)
// Stage slots a launch can carry (ERK54's last substep passes 4).  PK2 and
// PK3 are templates on the most stages an instance takes (MS): 2, the
// instances of ERK33 and the shorter tableaux, whose per-stage arrays keep
// their size, or MAX_STAGES; the launcher picks by the launch's n_stages.
constexpr int MAX_STAGES = 4;

__host__ __device__ constexpr int DY(int k) { return k < 3 ? -1 : (k < 5 ? 0 : 1); }
__host__ __device__ constexpr int DX(int k) {
  return k < 3 ? k - 1 : (k < 5 ? (k == 3 ? -1 : 1) : k - 6);
}

// Scalars of one launch; mirrors ryujin_tpu_torch.kernels.build.Consts.
struct Consts {
  double gamma, reference_density, vacuum_small, vacuum_large;
  double evc_factor, relaxation_factor, newton_tol, measure_inv;
  double weight, w0, w1;  // 1 - sum(stage weights), stage weights 0 and 1
  int newton_iterations, pow_n, n_stages, D, H, W;
  int dim, half;  // space dimension; 1: half-slot pre-scaled e, 0: two-direction e
  int K, dz[MAX_K], dy[MAX_K], dx[MAX_K];  // lattice offsets of the canvas
  // launch shape of the tiled kernels (pk1_stream, pk2_stream, pk3_stream,
  // pk1, pk2, pk3, pk_up), from the wrapper's tile(): block, grid, shared
  // bytes, halo
  int block[3], grid[3], smem, halo;
  // stage weights 2 and 3 (ERK54's), last: the fields before keep the
  // offsets the instances of at most 2 stages were compiled against
  double w2, w3;
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
  T newton_tol, measure_inv, weight, weight_m1, w0, w1;
  double gamma_d, pow_e;
  int pow_n, newton_iterations, n_stages, D, H, W;
  int K, dz[MAX_K], dy[MAX_K], dx[MAX_K];
  T w2, w3;  // last, as in Consts

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
    e.weight_m1 = T(c.weight - 1.0);
    e.w0 = T(c.w0);
    e.w1 = T(c.w1);
    e.w2 = T(c.w2);
    e.w3 = T(c.w3);
    e.gamma_d = g;
    e.pow_e = 2.0 * g / (g - 1.0);
    e.pow_n = c.pow_n;
    e.newton_iterations = c.newton_iterations;
    e.n_stages = c.n_stages;
    e.D = c.D;
    e.H = c.H;
    e.W = c.W;
    e.K = c.K;
    for (int k = 0; k < MAX_K; ++k) {
      e.dz[k] = c.dz[k];
      e.dy[k] = c.dy[k];
      e.dx[k] = c.dx[k];
    }
    return e;
  }
};

// ---- canvas addressing ---------------------------------------------------

struct Cell {
  int64_t i, n;  // flat index, plane size
  int z, y, x;
};

// The cell of this thread, or false past the canvas edge.  Launch with
// block (128, 1) and grid (ceil(W / 128), H): threads of a warp read
// neighbouring addresses of every plane.
__device__ __forceinline__ bool this_cell(int H, int W, Cell& c) {
  c.x = blockIdx.x * blockDim.x + threadIdx.x;
  c.y = blockIdx.y;
  c.z = 0;
  c.n = int64_t(H) * W;
  c.i = int64_t(c.y) * W + c.x;
  return c.x < W && c.y < H;
}

// The same on a DIM-dimensional canvas: grid (ceil(W / 128), H, D) in 3D.
template <int DIM, typename T>
__device__ __forceinline__ bool this_cell(const EqConsts<T>& e, Cell& c) {
  if constexpr (DIM == 2) {
    return this_cell(e.H, e.W, c);
  } else {
    c.x = blockIdx.x * blockDim.x + threadIdx.x;
    c.y = blockIdx.y;
    c.z = blockIdx.z;
    c.n = int64_t(e.D) * e.H * e.W;
    c.i = (int64_t(c.z) * e.H + c.y) * e.W + c.x;
    return c.x < e.W && c.y < e.H && c.z < e.D;
  }
}

// Flat index of the cell at offset (dy, dx), |dy| <= H and |dx| <= W.
__device__ __forceinline__ int64_t nbr_at(const Cell& c, int dy, int dx, int H, int W) {
  int yj = c.y + dy, xj = c.x + dx;
  yj = yj < 0 ? yj + H : (yj >= H ? yj - H : yj);
  xj = xj < 0 ? xj + W : (xj >= W ? xj - W : xj);
  return int64_t(yj) * W + xj;
}

__device__ __forceinline__ int64_t nbr(const Cell& c, int k, int H, int W) {
  return nbr_at(c, DY(k), DX(k), H, W);
}

// Flat index of the cell at lattice offset k of the launch.
template <int DIM, typename T>
__device__ __forceinline__ int64_t nbr_k(const Cell& c, const EqConsts<T>& e, int k) {
  if constexpr (DIM == 2) {
    return nbr_at(c, e.dy[k], e.dx[k], e.H, e.W);
  } else {
    int zj = c.z + e.dz[k], yj = c.y + e.dy[k], xj = c.x + e.dx[k];
    zj = zj < 0 ? zj + e.D : (zj >= e.D ? zj - e.D : zj);
    yj = yj < 0 ? yj + e.H : (yj >= e.H ? yj - e.H : yj);
    xj = xj < 0 ? xj + e.W : (xj >= e.W ? xj - e.W : xj);
    return (int64_t(zj) * e.H + yj) * e.W + xj;
  }
}

template <typename T, int NC>
__device__ __forceinline__ void load_state(const T* U, int64_t i, int64_t n, T (&u)[NC]) {
#pragma unroll
  for (int c = 0; c < NC; ++c) u[c] = U[c * n + i];
}

// ---- elementwise helpers with the NaN-propagating semantics of torch -----

template <typename T> __device__ __forceinline__ T pos(T x) { return x > T(0) ? x : T(0); }
template <typename T> __device__ __forceinline__ T neg(T x) { return -x > T(0) ? -x : T(0); }
template <typename T> __device__ __forceinline__ T mn(T a, T b) { return a < b ? a : b; }
template <typename T> __device__ __forceinline__ T mx(T a, T b) { return a > b ? a : b; }

// The weight of stage slot s of an instance that takes at most MS slots:
// a chain of selects on the slot index, no indexed read of the kernel's
// parameters; at MS = 2 the two-slot instances' own expression.
template <int MS, typename T>
__device__ __forceinline__ T stage_weight(const EqConsts<T>& e, int s) {
  static_assert(MS == 2 || MS == MAX_STAGES, "an instance takes 2 or MAX_STAGES slots");
  if constexpr (MS == 2)
    return s == 0 ? e.w0 : e.w1;
  else
    return s == 0 ? e.w0 : (s == 1 ? e.w1 : (s == 2 ? e.w2 : e.w3));
}

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

// sum over d of a[1 + d] * b[1 + d]: the momentum dot product of two states
template <typename T, int NC>
__device__ __forceinline__ T mdot(const T (&a)[NC], const T (&b)[NC]) {
  T s = a[1] * b[1];
#pragma unroll
  for (int d = 2; d < NC - 1; ++d) s = s + a[d] * b[d];
  return s;
}

// sum over d of a[d] * b[d] for two vectors of DIM components
template <typename T, int DIM>
__device__ __forceinline__ T vdot(const T (&a)[DIM], const T (&b)[DIM]) {
  T s = a[0] * b[0];
#pragma unroll
  for (int d = 1; d < DIM; ++d) s = s + a[d] * b[d];
  return s;
}

// sum over d of m_d * c_d, the momentum of a state against a vector
template <typename T, int NC>
__device__ __forceinline__ T mproj(const T (&u)[NC], const T (&c)[NC - 2]) {
  T s = u[1] * c[0];
#pragma unroll
  for (int d = 1; d < NC - 2; ++d) s = s + u[1 + d] * c[d];
  return s;
}

template <typename T, int NC>
__device__ __forceinline__ T internal_energy(const T (&u)[NC]) {
  const T rho_inv = T(1) / u[0];
  return u[NC - 1] - T(0.5) * mdot(u, u) * rho_inv;
}

template <typename T, int NC>
__device__ __forceinline__ T specific_entropy(const EqConsts<T>& e, const T (&u)[NC]) {
  const T rho_inv = T(1) / u[0];
  return internal_energy(u) * pow(rho_inv, e.g);
}

// Flux tensor f[c][d].
template <typename T, int NC>
__device__ __forceinline__ void flux(const EqConsts<T>& e, const T (&u)[NC], T (&f)[NC][NC - 2]) {
  constexpr int DIM = NC - 2;
  const T rho_inv = T(1) / u[0];
  const T p = e.gm1 * internal_energy(u);
  T v[DIM];
#pragma unroll
  for (int d = 0; d < DIM; ++d) v[d] = u[1 + d] * rho_inv;
#pragma unroll
  for (int d = 0; d < DIM; ++d) f[0][d] = u[1 + d];
#pragma unroll
  for (int a = 0; a < DIM; ++a) {
#pragma unroll
    for (int b = 0; b < DIM; ++b) f[1 + a][b] = a == b ? u[1 + a] * v[b] + p : u[1 + a] * v[b];
  }
#pragma unroll
  for (int d = 0; d < DIM; ++d) f[NC - 1][d] = v[d] * (u[NC - 1] + p);
}

// -(f_i + f_j) . c for component c.
template <typename T, int NC, int DIM>
__device__ __forceinline__ T flux_div(const T (&fi)[NC][DIM], const T (&fj)[NC][DIM], int c,
                                      const T (&cv)[DIM]) {
  T s = (fi[c][0] + fj[c][0]) * cv[0];
#pragma unroll
  for (int d = 1; d < DIM; ++d) s = s + (fi[c][d] + fj[c][d]) * cv[d];
  return -s;
}

// The 2D form with the two components of c given apart.
template <typename T>
__device__ __forceinline__ T flux_div(const T (&fi)[4][2], const T (&fj)[4][2], int c, T c0, T c1) {
  const T cv[2] = {c0, c1};
  return flux_div(fi, fj, c, cv);
}

// ---- Riemann solver --------------------------------------------------------

// (p, a, 1/rho, 1/p, log2 p)
template <typename T, int NC>
__device__ __forceinline__ void riemann_precompute(const EqConsts<T>& e, const T (&u)[NC], T pa[5]) {
  const T rho_inv = T(1) / u[0];
  const T rho_e = u[NC - 1] - T(0.5) * mdot(u, u) * rho_inv;
  const T p = e.gm1 * rho_e;
  pa[0] = p;
  pa[1] = sqrt(e.g * p * rho_inv);
  pa[2] = rho_inv;
  pa[3] = T(1) / p;
  pa[4] = log2(p);
}

// Two-rarefaction bound on the maximal wavespeed along the unit vector nv,
// without Newton refinement (riemann_solver.template.h:406-582).
template <typename T, int NC>
__device__ __forceinline__ T lambda_max(const EqConsts<T>& e, const T (&ui)[NC], const T pi_[5],
                                        const T (&uj)[NC], const T pj_[5],
                                        const T (&nv)[NC - 2]) {
  const T rho_i = ui[0], rho_j = uj[0];
  const T u_i = mproj(ui, nv) * pi_[2];
  const T u_j = mproj(uj, nv) * pj_[2];
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

// The 2D form along (n0, n1).
template <typename T>
__device__ __forceinline__ T lambda_max(const EqConsts<T>& e, const T (&ui)[4], const T pi_[5],
                                        const T (&uj)[4], const T pj_[5], T n0, T n1) {
  const T nv[2] = {n0, n1};
  return lambda_max(e, ui, pi_, uj, pj_, nv);
}

// ---- limiter ---------------------------------------------------------------

// (rho, rho^gamma, rho * rho_e, psi) of U at t = 0 (euler.limiter_psi0).
template <typename T, int NC>
__device__ __forceinline__ void limiter_psi0(const EqConsts<T>& e, T s_min, const T (&u)[NC],
                                             T psi0[4]) {
  const T rho = u[0];
  const T rho_gamma = pow(rho, e.g);
  const T ae = rho * u[NC - 1] - T(0.5) * mdot(u, u);
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
template <typename T, int NC>
__device__ __forceinline__ T limiter_limit(const EqConsts<T>& e, const T bnd[3], const T (&u)[NC],
                                           const T psi0[4], const T (&P)[NC], bool& success) {
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
  const T be = rho_U * P[NC - 1] + rho_P * u[NC - 1] - mdot(u, P);
  const T ce = rho_P * P[NC - 1] - T(0.5) * mdot(P, P);

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
inline dim3 canvas_grid(int D, int H, int W) { return dim3((W + 127) / 128, H, D); }
inline dim3 canvas_block() { return dim3(128, 1); }

}  // namespace ryujin
