// Gather probe: gathers from a shared-memory window, and the ELL gather-sum
// from device memory.
//
// Replaces: row 13 of the kernel table, scripts/probe_gather.py:
//   probe_lane_gather (:41, pallas_call :50): out[p, w] = x[p, idx[p, w]],
//     x f32 [P, W], idx int32; on the TPU, whether a kernel gathers across
//     its whole VMEM window.  Here the window is shared memory: one block a
//     row stages x[p, :] and gathers from it.
//   probe_sublane_gather (:60, pallas_call :69): out[s, l] = x[idx[s, l], l],
//     x f32 [S, L].  One block per tile of TL = 32 columns stages x[:, tile]
//     (S x 32 floats, 128 KB at S = 1024: the whole 512 KB array does not
//     fit in the 227 KB a block can have) and gathers from it; a row of the
//     tile is 32 consecutive floats, so the 32 lanes of a warp read 32
//     banks whatever rows they pick.
//   bench_xla_ell_gather (:78; XLA on the TPU, no pallas_call): out[c, i] =
//     sum_{k < K} X[c, cols[k, i]], X f32 [C, n], cols int32 [K, n]; the
//     throughput half of the row, and the access pattern of the padded-ELL
//     stencil.  One thread per node reads its K columns once and gathers
//     the C components from device memory, summing k = 0 .. K-1 from 0.
//
// Bound on an H100: bytes.  The window gathers move at most 1 MB and are
// launch-bound; the ELL gather-sum reads X and cols once and writes out
// (138.4 MB at C = 12, K = 9, n = 2^20) if its banded columns hit in L2.
//
// An index out of range gives NaN (the plain versions raise on it).
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace ryujin {

constexpr int GATHER_THREADS = 256;
constexpr int SUBLANE_TILE = 32;      // columns a block stages in the sublane gather
constexpr int SUBLANE_THREADS = 1024;  // few blocks (L / 32): as many loads in flight
constexpr int ELL_MAX_K = 16;     // slots the ELL gather-sum keeps in registers

__global__ void __launch_bounds__(GATHER_THREADS)
lane_gather_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                   float* __restrict__ out, int W) {
  extern __shared__ float row[];
  const int64_t base = int64_t(blockIdx.x) * W;
  for (int w = threadIdx.x; w < W; w += blockDim.x) row[w] = x[base + w];
  __syncthreads();
  for (int w = threadIdx.x; w < W; w += blockDim.x) {
    const int j = idx[base + w];
    out[base + w] = unsigned(j) < unsigned(W) ? row[j] : NAN;
  }
}

__global__ void __launch_bounds__(SUBLANE_THREADS)
sublane_gather_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                      float* __restrict__ out, int S, int L) {
  extern __shared__ float tile[];  // [S][SUBLANE_TILE]
  const int j = threadIdx.x % SUBLANE_TILE;
  const int l = blockIdx.x * SUBLANE_TILE + j;
  const int rows = blockDim.x / SUBLANE_TILE;
  if (l < L)
    for (int s = threadIdx.x / SUBLANE_TILE; s < S; s += rows)
      tile[s * SUBLANE_TILE + j] = x[int64_t(s) * L + l];
  __syncthreads();
  if (l >= L) return;
  for (int s = threadIdx.x / SUBLANE_TILE; s < S; s += rows) {
    const int r = idx[int64_t(s) * L + l];
    out[int64_t(s) * L + l] = unsigned(r) < unsigned(S) ? tile[r * SUBLANE_TILE + j] : NAN;
  }
}

__global__ void __launch_bounds__(GATHER_THREADS)
ell_gather_sum_kernel(const float* __restrict__ X, const int* __restrict__ cols,
                      float* __restrict__ out, int C, int K, int64_t n) {
  const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int j[ELL_MAX_K];
#pragma unroll
  for (int k = 0; k < ELL_MAX_K; ++k) j[k] = k < K ? cols[k * n + i] : 0;
  for (int c = 0; c < C; ++c) {
    const float* Xc = X + c * n;
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < ELL_MAX_K; ++k)
      if (k < K) acc = acc + (uint64_t(j[k]) < uint64_t(n) ? Xc[j[k]] : NAN);
    out[c * n + i] = acc;
  }
}

}  // namespace ryujin

extern "C" int ryujin_probe_lane_gather(const void* x, const void* idx, void* out, int P, int W,
                                        void* stream) {
  using namespace ryujin;
  if (P <= 0 || W <= 0) return int(cudaSuccess);
  const size_t smem = size_t(W) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      lane_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  lane_gather_kernel<<<P, GATHER_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(idx), static_cast<float*>(out), W);
  return int(cudaGetLastError());
}

extern "C" int ryujin_probe_sublane_gather(const void* x, const void* idx, void* out, int S,
                                           int L, void* stream) {
  using namespace ryujin;
  if (S <= 0 || L <= 0) return int(cudaSuccess);
  const size_t smem = size_t(S) * SUBLANE_TILE * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      sublane_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const unsigned blocks = unsigned((L + SUBLANE_TILE - 1) / SUBLANE_TILE);
  sublane_gather_kernel<<<blocks, SUBLANE_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(idx), static_cast<float*>(out), S, L);
  return int(cudaGetLastError());
}

extern "C" int ryujin_probe_ell_gather_sum(const void* X, const void* cols, void* out, int C,
                                           int K, long long n, void* stream) {
  using namespace ryujin;
  if (K > ELL_MAX_K || K < 0) return int(cudaErrorInvalidValue);
  if (n <= 0 || C <= 0) return int(cudaSuccess);
  const unsigned blocks = unsigned((n + GATHER_THREADS - 1) / GATHER_THREADS);
  ell_gather_sum_kernel<<<blocks, GATHER_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(X), static_cast<const int*>(cols), static_cast<float*>(out), C,
      K, int64_t(n));
  return int(cudaGetLastError());
}
