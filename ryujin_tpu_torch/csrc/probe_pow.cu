// Pow microbenchmark: out = sum_{r < R} f(x + s_r) for six forms of f.
//
// Replaces: rows 11 and 12 of the kernel table, the Pallas kernels of
// scripts/bench_pow.py (`make_kernel` / `run`, :58-71: R = 40 shifts
// f32(0.01 r), b = 1.4, f32 512 x 1024) and scripts/bench_pow_tpu.py
// (`make_kernel`, :50-70: R = 16 shifts f32(1e-3 r), f32 64 x 2048,
// launched 64 times in a row, each on x + 1e-9 * the previous output).
//
// The forms (PowForm): powf; exp2f(b log2f x); the bit-twiddled fast pow of
// bench_pow.py (fast_log2 / fast_exp2, :20-55); the Blinn seed and two
// Newton steps on z^5 = x^2 of bench_pow_tpu.py (pow_newton, :35-47,
// x^1.4 whatever b is); and the baselines x b and sqrtf(x).  The fast and
// Newton forms repeat the scripts' constants and operation order, so they
// carry the scripts' error (the fast pow is up to 12 % off powf, its
// fast_log2 up to 0.12 off log2 as m -> 2): built with -fmad=false they are
// bit-equal to their plain-torch versions.  Constants are double literals
// rounded to float, as jnp.float32(python float) rounds them.
//
// Bound on an H100: operations for the summed form (R evaluations of f per
// element against 8 or 12 bytes), the launch for the pointwise one (8 bytes
// an element, a few microseconds at the scripts' sizes).  The forms differ
// in their FP32-pipe, MUFU (16 a clock per SM) and conversion instructions,
// which python -m ryujin_tpu_torch.probes.pow counts from the SASS.
//
// Design.  Two kernels, each a template on the form; the launch shape of
// both comes from kernels/probe_pow.py pow_shape(), and the entry point
// refuses any other (threads, items, unroll, vector width, blocks).
// - Pointwise, f(x) once (the scripts' pointwise error): each thread loads
//   ITEMS float4 vectors (16-byte accesses, consecutive threads on
//   consecutive vectors, all loads in flight before the first evaluation),
//   evaluates and stores them; the n mod 4 elements past the last vector
//   go to the first threads of the grid as scalars.  A base pointer of x
//   or out that is not 16-byte aligned (a view such as x[1:]) takes the
//   scalar instance, VEC = 1, ITEMS = 1: one element a thread, the body of
//   the earlier kernel.  That instance is also the one evaluation whose
//   SASS probes.pow reads (pow_mix).
// - Summed: the R shifts are staged once a block in shared memory; each
//   thread takes ELEMS elements (strided by the block, so loads stay
//   coalesced) and walks the terms UNROLL at a time: the UNROLL x ELEMS
//   evaluations of a step are independent and in flight together, then
//   added to each element's sum one by one in r order, acc = acc + f(v +
//   s_r) from 0, so the sums keep the bits of the rolled loop (nothing
//   reassociates a float add, and -fmad=false keeps every product and sum
//   rounded on its own).  A step of 4 or 8 terms reads its shifts with
//   16-byte shared loads.  The R mod UNROLL last terms take a rolled loop.
// Defaults (kernels/probe_pow.py POW_DEFAULTS, POW_ITEMS_OF; tile_sweep
// pow): 256 threads; float4 from 270,336 elements on, two vectors a thread
// for x b; unroll 8, two elements a thread for x b, sqrt, exp2 log2 and
// fast from 270,336 on.  Chained (100 calls in one CUDA graph; NVIDIA H100
// 80GB HBM3, 700.00 W; PERF.md §6 rows 11-12, turns P C C P), against the
// earlier one-thread-an-element rolled kernel: row 11 summed x b 0.00923 ->
// 0.00424 ms, sqrt 0.01576 -> 0.01133, exp2 log2 0.03158 -> 0.02556, powf
// 0.06154 -> 0.05822; row 12 chain powf 0.00803 -> 0.00782; pointwise x b
// and sqrt 0.00214 / 0.00229 -> 0.00185 / 0.00196, at or below torch.mul /
// torch.sqrt (0.00186 / 0.00198).  What holds the summed forms is issue
// slots: powf issues about 64 instructions a term for the 41 FMA-pipe ones
// its bound counts.
// Indices are 32-bit (n is at most POW_MAX_N) but for the scalar instance:
// 64-bit ones cost the float4 and summed kernels branches and wider index
// math (x b 3 % slower), while 32-bit ones put an LDC of the base pointers
// on the scalar instance's path to its load (2-3 % slower than the
// earlier kernel, whose body it keeps).
#include <cuda_runtime.h>

#include <cstdint>

namespace ryujin {

enum PowForm { POWF = 0, EXP2_LOG2 = 1, FAST = 2, NEWTON = 3, MULT = 4, SQRT = 5 };

// mirrored by kernels/probe_pow.py: the largest n, the shifts a block
// stages, and the largest block of each kernel
constexpr int64_t POW_MAX_N = int64_t(1) << 30;
constexpr int POW_MAX_TERMS = 256;
constexpr int POW_POINTWISE_THREADS = 512;
constexpr int POW_SUMMED_THREADS = 256;

__device__ __forceinline__ float fast_log2(float x) {
  const int bits = __float_as_int(x);
  const float e = float(bits >> 23) - 127.0f;
  const float m = __int_as_float((bits & 0x007FFFFF) | 0x3F800000);
  const float t = m - 1.0f;
  float p = float(-0.034436006);
  p = p * t + float(0.18216566);
  p = p * t + float(-0.46565442);
  p = p * t + float(0.71517086);
  p = p * t + float(-0.71975631);
  p = p * t + float(1.44269504);
  return e + t * p;
}

__device__ __forceinline__ float fast_exp2(float x) {
  const float i = rintf(x);  // jnp.round: half to even
  const float f = x - i;
  float p = float(1.8775767e-3);
  p = p * f + float(8.9893397e-3);
  p = p * f + float(5.5826318e-2);
  p = p * f + float(2.4015361e-1);
  p = p * f + float(6.9315308e-1);
  p = p * f + float(9.9999994e-1);
  return p * __int_as_float((int(i) + 127) << 23);
}

__device__ __forceinline__ float newton_pow14(float x) {
  const float seed = float(0.4) * __int2float_rn(__float_as_int(x)) + float(0.6 * 1064866805.0);
  float z = __int_as_float(__float2int_rz(seed));
  const float x2 = x * x;
#pragma unroll
  for (int it = 0; it < 2; ++it) {
    const float z2 = z * z;
    const float z4 = z2 * z2;
    z = z * (float(0.8) + (float(0.2) * x2) / (z4 * z));
  }
  return x * z;
}

template <int FORM>
__device__ __forceinline__ float pow_form(float x, float b) {
  if (FORM == POWF) return powf(x, b);
  if (FORM == EXP2_LOG2) return exp2f(b * log2f(x));
  if (FORM == FAST) return fast_exp2(b * fast_log2(x));
  if (FORM == NEWTON) return newton_pow14(x);
  if (FORM == MULT) return x * b;
  return sqrtf(x);
}

// out[j] = f(x[j]) over nv vectors of VEC floats, then (VEC = 4) the tail
// elements 4 nv .. 4 nv + tail - 1, one a thread from the grid's first.
template <int FORM, int VEC, int ITEMS>
__global__ void __launch_bounds__(POW_POINTWISE_THREADS)
probe_pow_pointwise_kernel(const float* __restrict__ x, float b, float* __restrict__ out,
                           int64_t nv, int tail) {
  if (VEC == 1) {
    const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i >= nv) return;
    out[i] = pow_form<FORM>(x[i], b);
    return;
  }
  const int t = int(threadIdx.x), T = int(blockDim.x), nv32 = int(nv);
  const int base = int(blockIdx.x) * ITEMS * T + t;
  const float4* xv = reinterpret_cast<const float4*>(x);
  float4* ov = reinterpret_cast<float4*>(out);
  float4 v[ITEMS];
#pragma unroll
  for (int k = 0; k < ITEMS; ++k)
    if (base + k * T < nv32) v[k] = xv[base + k * T];
#pragma unroll
  for (int k = 0; k < ITEMS; ++k)
    if (base + k * T < nv32) {
      float4 o;
      o.x = pow_form<FORM>(v[k].x, b);
      o.y = pow_form<FORM>(v[k].y, b);
      o.z = pow_form<FORM>(v[k].z, b);
      o.w = pow_form<FORM>(v[k].w, b);
      ov[base + k * T] = o;
    }
  // the tail last, so that the vectors' loads go out first
  const int g = int(blockIdx.x) * T + t;
  if (g < tail) out[4 * nv32 + g] = pow_form<FORM>(x[4 * nv32 + g], b);
}

// out[j] = sum_{r < R} f(v_j + s_r), v_j = x[j] (+ 1e-9 carry[j]), summed
// from 0 in r order; ELEMS elements a thread, UNROLL terms a step.
template <int FORM, int ELEMS, int UNROLL>
__global__ void __launch_bounds__(POW_SUMMED_THREADS)
probe_pow_summed_kernel(const float* __restrict__ x, const float* __restrict__ carry,
                        const float* __restrict__ shifts, int R, float b,
                        float* __restrict__ out, int n) {
  __shared__ __align__(16) float s[POW_MAX_TERMS];
  const int t = int(threadIdx.x), T = int(blockDim.x);
  // rolled: an unrolled copy costs every thread a division for its trip
  // count, more than the terms of x b
#pragma unroll 1
  for (int r = t; r < R; r += T) s[r] = shifts[r];
  __syncthreads();
  const int base = int(blockIdx.x) * ELEMS * T + t;
  if (base >= n) return;
  float v[ELEMS], acc[ELEMS];
#pragma unroll
  for (int e = 0; e < ELEMS; ++e) {
    const int j = base + e * T;
    v[e] = 1.0f;  // past n: evaluated, never stored
    if (j < n) {
      v[e] = x[j];
      if (carry != nullptr) v[e] = v[e] + float(1e-9) * carry[j];
    }
    acc[e] = 0.0f;
  }
  int r = 0;
#pragma unroll 1
  for (; r + UNROLL <= R; r += UNROLL) {
    float sh[UNROLL], f[UNROLL][ELEMS];
    if (UNROLL % 4 == 0) {  // r is a multiple of 4: 16-byte shared loads
#pragma unroll
      for (int k = 0; k < UNROLL; k += 4) {
        const float4 q = *reinterpret_cast<const float4*>(s + r + k);
        sh[k] = q.x;
        sh[k + 1] = q.y;
        sh[k + 2] = q.z;
        sh[k + 3] = q.w;
      }
    } else {
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) sh[k] = s[r + k];
    }
#pragma unroll
    for (int k = 0; k < UNROLL; ++k)
#pragma unroll
      for (int e = 0; e < ELEMS; ++e) f[k][e] = pow_form<FORM>(v[e] + sh[k], b);
#pragma unroll
    for (int k = 0; k < UNROLL; ++k)
#pragma unroll
      for (int e = 0; e < ELEMS; ++e) acc[e] = acc[e] + f[k][e];
  }
#pragma unroll 1
  for (; r < R; ++r)
#pragma unroll
    for (int e = 0; e < ELEMS; ++e) acc[e] = acc[e] + pow_form<FORM>(v[e] + s[r], b);
#pragma unroll
  for (int e = 0; e < ELEMS; ++e)
    if (base + e * T < n) out[base + e * T] = acc[e];
}

template <int FORM>
cudaError_t launch_pointwise(const float* x, float b, float* out, int nv, int tail, int threads,
                             int items, int vec, int blocks, cudaStream_t s) {
  if (vec == 1)
    probe_pow_pointwise_kernel<FORM, 1, 1><<<blocks, threads, 0, s>>>(x, b, out, nv, 0);
  else if (items == 1)
    probe_pow_pointwise_kernel<FORM, 4, 1><<<blocks, threads, 0, s>>>(x, b, out, nv, tail);
  else if (items == 2)
    probe_pow_pointwise_kernel<FORM, 4, 2><<<blocks, threads, 0, s>>>(x, b, out, nv, tail);
  else
    probe_pow_pointwise_kernel<FORM, 4, 4><<<blocks, threads, 0, s>>>(x, b, out, nv, tail);
  return cudaGetLastError();
}

template <int FORM, int ELEMS>
cudaError_t launch_summed_e(const float* x, const float* carry, const float* shifts, int R,
                            float b, float* out, int n, int threads, int unroll, int blocks,
                            cudaStream_t s) {
  if (unroll == 1)
    probe_pow_summed_kernel<FORM, ELEMS, 1><<<blocks, threads, 0, s>>>(x, carry, shifts, R, b,
                                                                       out, n);
  else if (unroll == 2)
    probe_pow_summed_kernel<FORM, ELEMS, 2><<<blocks, threads, 0, s>>>(x, carry, shifts, R, b,
                                                                       out, n);
  else if (unroll == 4)
    probe_pow_summed_kernel<FORM, ELEMS, 4><<<blocks, threads, 0, s>>>(x, carry, shifts, R, b,
                                                                       out, n);
  else
    probe_pow_summed_kernel<FORM, ELEMS, 8><<<blocks, threads, 0, s>>>(x, carry, shifts, R, b,
                                                                       out, n);
  return cudaGetLastError();
}

template <int FORM>
cudaError_t launch_pow(int summed, const float* x, const float* carry, const float* shifts,
                       int R, float b, float* out, int n, int threads, int items, int unroll,
                       int vec, int blocks, cudaStream_t s) {
  if (!summed)
    return launch_pointwise<FORM>(x, b, out, n / vec, n % vec, threads, items, vec, blocks, s);
  if (items == 1)
    return launch_summed_e<FORM, 1>(x, carry, shifts, R, b, out, n, threads, unroll, blocks, s);
  return launch_summed_e<FORM, 2>(x, carry, shifts, R, b, out, n, threads, unroll, blocks, s);
}

// Whether (threads, items, unroll, vec, blocks) is pow_shape()'s layout for
// n elements: whole warps up to the kernel's largest block; pointwise:
// items 1, 2 or 4 float4 vectors a thread (vec 4, x and out 16-byte
// aligned) or one float (vec 1, items 1), unroll 1; summed: 1 or 2
// elements a thread, unroll 1, 2, 4 or 8, vec 1, 1 <= R <= POW_MAX_TERMS;
// and as many blocks as cover the vectors (at least one), none wholly past
// them.
bool pow_layout(int summed, const void* x, const void* out, int R, int64_t n, int threads,
                int items, int unroll, int vec, int blocks) {
  if (threads < 32 || threads % 32 != 0 || blocks < 1) return false;
  if (summed) {
    if (threads > POW_SUMMED_THREADS || (items != 1 && items != 2) || vec != 1 ||
        (unroll != 1 && unroll != 2 && unroll != 4 && unroll != 8) || R < 1 ||
        R > POW_MAX_TERMS)
      return false;
  } else {
    const bool aligned = ((uintptr_t(x) | uintptr_t(out)) & 15) == 0;
    if (threads > POW_POINTWISE_THREADS || unroll != 1 ||
        !(vec == 1 ? items == 1 : vec == 4 && aligned && (items == 1 || items == 2 || items == 4)))
      return false;
  }
  const int64_t units = n / vec, chunk = int64_t(threads) * items;
  return blocks == (units > chunk ? (units + chunk - 1) / chunk : 1);
}

}  // namespace ryujin

// form: a ryujin::PowForm; summed == 0: f(x) once (R, shifts and carry
// unused); carry: null, or the previous output, added to x as 1e-9 carry;
// the launch shape of kernels/probe_pow.py pow_shape(), refused unless it
// is that layout's (pow_layout).
extern "C" int ryujin_probe_pow(int form, int summed, const void* x, const void* carry,
                                const void* shifts, int R, float b, void* out, long long n,
                                int threads, int items, int unroll, int vec, int blocks,
                                void* stream) {
  using namespace ryujin;
  if (n <= 0) return int(cudaSuccess);
  if (n > POW_MAX_N ||
      !pow_layout(summed, x, out, R, n, threads, items, unroll, vec, blocks))
    return int(cudaErrorInvalidValue);
  const float* xs = static_cast<const float*>(x);
  const float* cs = static_cast<const float*>(carry);
  const float* ss = static_cast<const float*>(shifts);
  float* o = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = int(n);
  switch (form) {
    case POWF:
      return int(launch_pow<POWF>(summed, xs, cs, ss, R, b, o, m, threads, items, unroll, vec,
                                  blocks, s));
    case EXP2_LOG2:
      return int(launch_pow<EXP2_LOG2>(summed, xs, cs, ss, R, b, o, m, threads, items, unroll,
                                       vec, blocks, s));
    case FAST:
      return int(launch_pow<FAST>(summed, xs, cs, ss, R, b, o, m, threads, items, unroll, vec,
                                  blocks, s));
    case NEWTON:
      return int(launch_pow<NEWTON>(summed, xs, cs, ss, R, b, o, m, threads, items, unroll, vec,
                                    blocks, s));
    case MULT:
      return int(launch_pow<MULT>(summed, xs, cs, ss, R, b, o, m, threads, items, unroll, vec,
                                  blocks, s));
    case SQRT:
      return int(launch_pow<SQRT>(summed, xs, cs, ss, R, b, o, m, threads, items, unroll, vec,
                                  blocks, s));
    default: return int(cudaErrorInvalidValue);
  }
}
