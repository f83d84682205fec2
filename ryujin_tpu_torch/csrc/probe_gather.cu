// Gather probe: gathers from a shared-memory window, and the ELL gather-sum
// from device memory.
//
// Replaces: row 13 of the kernel table, scripts/probe_gather.py:
//   probe_lane_gather (:41, pallas_call :50): out[p, w] = x[p, idx[p, w]],
//     x f32 [P, W], idx int32; on the TPU, whether a kernel gathers across
//     its whole VMEM window.  Here the window is shared memory: one block a
//     row stages x[p, :] and gathers from it.
//   probe_sublane_gather (:60, pallas_call :69): out[s, l] = x[idx[s, l], l],
//     x f32 [S, L]; on the TPU, whether a kernel gathers across the rows of
//     its whole window.  Design: a block stages the window of a tile of TL
//     = 32 columns, x[:, tile] (S x 32 floats, 128 KB at S = 1024: the
//     whole 512 KB array does not fit in the 227 KB a block can have), and
//     gathers from it one group of output rows; the grid is column tiles x
//     row groups (kernels/probe_gather.py sublane_shape), so at S = 1024, L
//     = 128 it spreads over more SMs than the 4 tiles, each group's window
//     coming again from L2.  The window is staged with cp.async in 16-byte
//     pieces (4 bytes where L is not a multiple of 4, as x's rows then
//     start unaligned), every piece of a thread in flight at once.  A row
//     of the window is 32 consecutive floats, so the 32 lanes of a warp,
//     one column each, read 32 banks whatever rows they pick: a narrower
//     tile would stage less a block but would put lanes of one column on
//     one bank.  The shared-memory attribute is set once a size, not at
//     every launch.  At S = 1024, L = 128 (NVIDIA H100 80GB HBM3, 700.00
//     W; PERF.md §6 row 13): 1 / 2 / 4 / 8 / 16 / 32 groups took 0.0098 /
//     0.0060 / 0.0039 / 0.0032 / 0.0027 / 0.0026 ms a call in a CUDA graph
//     of 100 calls, torch.gather 0.0050; 32 groups (128 blocks) kept.  The
//     earlier form, one block a tile (4 blocks of 1024 threads staging
//     4-byte words, the attribute set at every launch), took 0.0145 ms
//     there and 0.0322 as a single launch after an L2 flush, where this
//     one took 0.0068 and torch.gather 0.0121.
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
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace ryujin {

constexpr int GATHER_THREADS = 256;
// the sublane gather's window: columns a block stages, and its threads;
// mirrored by kernels/probe_gather.py sublane_shape()
constexpr int SUBLANE_TILE = 32;
constexpr int SUBLANE_THREADS = 256;
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

// Block (tile, group): stage x[:, 32 tile ..] whole, then gather the output
// rows rows * group .. rows * (group + 1) - 1 of those columns.
__global__ void __launch_bounds__(SUBLANE_THREADS)
sublane_gather_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                      float* __restrict__ out, int S, int L, int rows) {
  extern __shared__ __align__(16) float win[];  // [S][SUBLANE_TILE]
  const int l0 = blockIdx.x * SUBLANE_TILE;
  const int cols = min(SUBLANE_TILE, L - l0);
  const int t = threadIdx.x;
  if (L % 4 == 0) {  // cols is a multiple of 4: 8 pieces of 16 bytes a full row
    constexpr int PIECES = SUBLANE_TILE / 4, STEP = SUBLANE_THREADS / PIECES;
    const int q = t % PIECES;
    if (4 * q < cols)
      for (int s = t / PIECES; s < S; s += STEP)
        __pipeline_memcpy_async(win + s * SUBLANE_TILE + 4 * q, x + int64_t(s) * L + l0 + 4 * q,
                                16);
  } else {
    constexpr int STEP = SUBLANE_THREADS / SUBLANE_TILE;
    const int j = t % SUBLANE_TILE;
    if (j < cols)
      for (int s = t / SUBLANE_TILE; s < S; s += STEP)
        __pipeline_memcpy_async(win + s * SUBLANE_TILE + j, x + int64_t(s) * L + l0 + j, 4);
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  const int j = t % SUBLANE_TILE, l = l0 + j;
  if (j >= cols) return;
  const int s0 = int(blockIdx.y) * rows, s1 = min(S, s0 + rows);
  for (int s = s0 + t / SUBLANE_TILE; s < s1;
       s += SUBLANE_THREADS / SUBLANE_TILE) {
    const int r = idx[int64_t(s) * L + l];
    out[int64_t(s) * L + l] = unsigned(r) < unsigned(S) ? win[r * SUBLANE_TILE + j] : NAN;
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

// The launch shape (grid tiles x groups, rows a group, threads, shared
// bytes) comes from kernels/probe_gather.py sublane_shape(); refused unless
// it is this layout's: 32-column tiles that cover L, groups of `rows` that
// cover S, no block wholly past either, the whole window's bytes.
extern "C" int ryujin_probe_sublane_gather(const void* x, const void* idx, void* out, int S,
                                           int L, int tiles, int groups, int rows, int threads,
                                           int smem, void* stream) {
  using namespace ryujin;
  if (S <= 0 || L <= 0) return int(cudaSuccess);
  if (threads != SUBLANE_THREADS || rows < 1 ||
      int64_t(smem) != int64_t(S) * SUBLANE_TILE * int64_t(sizeof(float)) ||
      int64_t(tiles) * SUBLANE_TILE < L || (tiles - 1) * SUBLANE_TILE >= L ||
      int64_t(groups) * rows < S || int64_t(groups - 1) * rows >= S)
    return int(cudaErrorInvalidValue);
  static int allowed = 48 * 1024;  // dynamic shared bytes the kernel may take
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        sublane_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return int(err);
    allowed = smem;
  }
  sublane_gather_kernel<<<dim3(tiles, groups), SUBLANE_THREADS, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(idx), static_cast<float*>(out), S, L,
      rows);
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
