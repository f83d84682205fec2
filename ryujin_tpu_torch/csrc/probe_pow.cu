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
// Bound on an H100: operations.  Each element reads 4 bytes (8 with the
// carry) and writes 4, against R evaluations of f; the forms differ in
// their FP32-pipe, MUFU (16 a clock per SM) and conversion instructions,
// which python -m ryujin_tpu_torch.probes.pow counts from the SASS.
//
// Design: one thread per element; the R-term loop is kept rolled
// (#pragma unroll 1) so that no term is folded away and every form runs
// the same loop skeleton.  The ONE instances evaluate f once without shift
// or sum (the scripts' pointwise error, reps = 1); probes.pow reads their
// SASS as the instruction mix of one evaluation.
#include <cuda_runtime.h>

#include <cstdint>

namespace ryujin {

enum PowForm { POWF = 0, EXP2_LOG2 = 1, FAST = 2, NEWTON = 3, MULT = 4, SQRT = 5 };

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

template <int FORM, bool ONE>
__global__ void __launch_bounds__(256)
probe_pow_kernel(const float* __restrict__ x, const float* __restrict__ carry,
                 const float* __restrict__ shifts, int R, float b, float* __restrict__ out,
                 int64_t n) {
  const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (ONE) {
    out[i] = pow_form<FORM>(x[i], b);
    return;
  }
  float xi = x[i];
  if (carry != nullptr) xi = xi + float(1e-9) * carry[i];
  float acc = 0.0f;
#pragma unroll 1
  for (int r = 0; r < R; ++r) acc = acc + pow_form<FORM>(xi + shifts[r], b);
  out[i] = acc;
}

template <int FORM>
cudaError_t launch_pow(bool one, const float* x, const float* carry, const float* shifts, int R,
                       float b, float* out, int64_t n, cudaStream_t stream) {
  const dim3 block(256), grid(unsigned((n + 255) / 256));
  if (one)
    probe_pow_kernel<FORM, true><<<grid, block, 0, stream>>>(x, carry, shifts, R, b, out, n);
  else
    probe_pow_kernel<FORM, false><<<grid, block, 0, stream>>>(x, carry, shifts, R, b, out, n);
  return cudaGetLastError();
}

}  // namespace ryujin

// form: a ryujin::PowForm; one != 0: f(x) once, without shifts or carry (R,
// shifts and carry unused); carry: null, or the previous output, added to x
// as 1e-9 carry.
extern "C" int ryujin_probe_pow(int form, int one, const void* x, const void* carry,
                                const void* shifts, int R, float b, void* out, long long n,
                                void* stream) {
  using namespace ryujin;
  if (n <= 0) return int(cudaSuccess);
  const float* xs = static_cast<const float*>(x);
  const float* cs = static_cast<const float*>(carry);
  const float* ss = static_cast<const float*>(shifts);
  float* o = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (form) {
    case POWF: return int(launch_pow<POWF>(one, xs, cs, ss, R, b, o, n, s));
    case EXP2_LOG2: return int(launch_pow<EXP2_LOG2>(one, xs, cs, ss, R, b, o, n, s));
    case FAST: return int(launch_pow<FAST>(one, xs, cs, ss, R, b, o, n, s));
    case NEWTON: return int(launch_pow<NEWTON>(one, xs, cs, ss, R, b, o, n, s));
    case MULT: return int(launch_pow<MULT>(one, xs, cs, ss, R, b, o, n, s));
    case SQRT: return int(launch_pow<SQRT>(one, xs, cs, ss, R, b, o, n, s));
    default: return int(cudaErrorInvalidValue);
  }
}
