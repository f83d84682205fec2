// Gather probe: gathers from a shared-memory window, and the ELL gather-sum
// from device memory.
//
// Replaces: row 13 of the kernel table, scripts/probe_gather.py:
//   probe_lane_gather (:41, pallas_call :50): out[p, w] = x[p, idx[p, w]],
//     x f32 [P, W], idx int32; on the TPU, whether a kernel gathers across
//     its whole VMEM window.  Here the window is shared memory.  Design:
//     the grid is rows x groups of output columns (kernels/probe_gather.py
//     lane_shape), so at P = 8 it spreads over more SMs than the 8 rows;
//     each block stages its whole row x[p, :] (8 KB at W = 2048, again from
//     L2 for every group) with cp.async, 16-byte pieces where W % 4 == 0
//     and x, idx and out are 16-byte aligned (else 4 bytes), loads its
//     group's indices into registers while the row lands (int4 on the
//     16-byte path), and gathers; out is written in float4 on that path.
//     The shared-memory attribute is set once a size, not at every launch.
//     The earlier form, one block a row (8 blocks of 256 threads staging
//     4-byte words, the indices loaded only after the row had landed, the
//     attribute set at every launch), took 0.0040 ms a call in a CUDA graph
//     of 100 calls at P = 8, W = 2048, where this one, 4 groups of 128
//     threads, took 0.0016 and torch.gather 0.0045 (NVIDIA H100 80GB HBM3,
//     700.00 W; PERF.md §6 row 13).
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
//     stencil.  Its columns are banded (i + jitter, |jitter| <= 1500).
//     One thread a node reading X from device memory (the earlier form)
//     took 0.2140 ms chained, the same launch reading X[c, i + k]
//     coalesced 0.1286, with no X at all 0.0334 (NVIDIA H100 80GB HBM3,
//     700.00 W; PERF.md §6 row 13).
//     Design: a block owns `nodes` consecutive nodes.  One thread stages
//     the block's K x nodes columns in shared memory with a bulk copy a
//     slot (so a block waits one round trip for them, not one a load);
//     the block reduces their least and greatest in-range value to a band
//     [lo, hi] (warp reductions, a shared word a warp) and stages
//     X[c, lo .. hi] one component at a time through a ring of `stages`
//     buffers, component c + 1 in flight while c is gathered: one 1D bulk
//     copy issued by one thread and counted on an mbarrier, or, where n, X
//     or cols is not 16-byte aligned, 4-byte cp.async by every thread
//     arriving on the same kind of barrier.  (16-byte cp.async by every
//     thread took 4-16 % longer than the bulk copy at every launch tried.)
//     Each thread turns its staged columns, in place, into byte offsets
//     into a buffer, a column outside [0, n) into the offset of the
//     buffer's last float, a NaN: a slot of the sum is then one shared
//     load of its offset, one of its value (32 random words a warp, some
//     3.5 bank wavefronts, where device memory served some 27 lines) and
//     one add.  A block whose band does not fit its buffer gathers from
//     device memory, one node a thread, as the earlier form did; so does
//     a block with no column in range.  Either way the sum runs k = 0 ..
//     K - 1 from 0, so every output is bit-equal to the plain version.
//     The launch shape (nodes, threads, stages, bulk, band, blocks, shared
//     bytes) is kernels/probe_gather.py ell_shape()'s; the C side
//     refuses any other.
//
// Bound on an H100: bytes.  The window gathers move at most 1 MB and are
// launch-bound; the ELL gather-sum reads X and cols once and writes out
// (138.4 MB at C = 12, K = 9, n = 2^20).
//
// An index out of range gives NaN (the plain versions of the window
// gathers raise on it; the ELL gather-sum's gives NaN too).
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "tma.cuh"

namespace ryujin {

// the lane gather's layout, mirrored by kernels/probe_gather.py
// lane_shape(): index vectors a thread holds, and the most threads a block
constexpr int LANE_ITEMS = 4;
constexpr int LANE_MAX_THREADS = 1024;
// the sublane gather's window: columns a block stages, and its threads;
// mirrored by kernels/probe_gather.py sublane_shape()
constexpr int SUBLANE_TILE = 32;
constexpr int SUBLANE_THREADS = 256;
// the ELL gather-sum's layout, mirrored by kernels/probe_gather.py
// ell_shape(): slots a node, threads a block, stages of the ring, and the
// shared bytes ahead of the offsets (a barrier a stage, then the band
// reduction's words, two a warp)
constexpr int ELL_MAX_K = 16;
constexpr int ELL_MAX_THREADS = 512;
constexpr int ELL_MAX_STAGES = 8;
constexpr int ELL_HEADER_BYTES = 256;

// The lane gather's vectors: VEC (1 or 4) indices, floats.
template <int VEC>
struct LaneVec;
template <>
struct LaneVec<1> {
  using Idx = int;
  using Val = float;
  __device__ static float pick(const float* row, int j, int W) {
    return unsigned(j) < unsigned(W) ? row[j] : NAN;
  }
};
template <>
struct LaneVec<4> {
  using Idx = int4;
  using Val = float4;
  __device__ static float4 pick(const float* row, int4 j, int W) {
    return make_float4(LaneVec<1>::pick(row, j.x, W), LaneVec<1>::pick(row, j.y, W),
                       LaneVec<1>::pick(row, j.z, W), LaneVec<1>::pick(row, j.w, W));
  }
};

// Block (row, group): stage x[row, :] whole, load the group's vectors
// [span group, span group + span) of VEC indices (at most LANE_ITEMS a
// thread) into registers while it lands, then gather them.  VEC divides W.
template <int VEC>
__global__ void __launch_bounds__(LANE_MAX_THREADS)
lane_gather_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                   float* __restrict__ out, int W, int span) {
  using V = LaneVec<VEC>;
  extern __shared__ __align__(16) float row[];
  const int64_t base = int64_t(blockIdx.x) * W;
  const int t = threadIdx.x, T = blockDim.x, nvec = W / VEC;
  for (int v = t; v < nvec; v += T)
    __pipeline_memcpy_async(row + v * VEC, x + base + v * VEC, VEC * sizeof(float));
  __pipeline_commit();
  const int v0 = int(blockIdx.y) * span + t, v1 = min(nvec, int(blockIdx.y) * span + span);
  const typename V::Idx* iv = reinterpret_cast<const typename V::Idx*>(idx + base);
  typename V::Val* ov = reinterpret_cast<typename V::Val*>(out + base);
  typename V::Idx j[LANE_ITEMS];
#pragma unroll
  for (int i = 0; i < LANE_ITEMS; ++i)
    if (v0 + i * T < v1) j[i] = iv[v0 + i * T];
  __pipeline_wait_prior(0);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < LANE_ITEMS; ++i)
    if (v0 + i * T < v1) ov[v0 + i * T] = V::pick(row, j[i], W);
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

// The ELL gather-sum.  Block b owns nodes [b nodes, b nodes + nodes) of
// n, thread t the nodes t, t + threads, ... of those (every load and
// store coalesced).  Shared memory: the header (a barrier a stage, the
// columns' barrier, the band words), then the block's columns [K][nodes],
// then the ring of `stages` bands of `band` floats, each band's last float
// a NaN that out-of-range columns read.  staged: null, or a counter the
// block adds 1 to when it stages.
__global__ void __launch_bounds__(ELL_MAX_THREADS)
ell_gather_sum_kernel(const float* __restrict__ X, const int* __restrict__ cols,
                      float* __restrict__ out, int* __restrict__ staged, int C, int K, int64_t n,
                      int nodes, int stages, int bulk, int band) {
  extern __shared__ __align__(128) unsigned char ell_smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(ell_smem);
  uint64_t* cols_bar = bar + ELL_MAX_STAGES;
  int* warp_lo = reinterpret_cast<int*>(cols_bar + 1);
  int* warp_hi = warp_lo + ELL_MAX_THREADS / 32;
  int* cs = reinterpret_cast<int*>(ell_smem + ELL_HEADER_BYTES);
  float* ring = reinterpret_cast<float*>(cs + size_t(K) * nodes);
  const int t = threadIdx.x, T = blockDim.x;
  const int64_t i0 = int64_t(blockIdx.x) * nodes;
  const int m_end = int(min(int64_t(nodes), n - i0));

  if (t == 0) {
    for (int s = 0; s < stages; ++s) bar_init(bar + s, bulk ? 1 : T);
    bar_init(cols_bar, bulk ? 1 : T);
  }
  __syncthreads();
  // the block's columns, row k at cs + k nodes
  if (bulk) {
    if (t == 0) {
      bar_expect(cols_bar, unsigned(K) * unsigned(m_end) * unsigned(sizeof(int)));
      for (int k = 0; k < K; ++k)
        bulk_copy_1d(cs + k * nodes, cols + k * n + i0, unsigned(m_end) * unsigned(sizeof(int)),
                     cols_bar);
    }
  } else {
    for (int k = 0; k < K; ++k)
      for (int v = t; v < m_end; v += T)
        __pipeline_memcpy_async(cs + k * nodes + v, cols + k * n + i0 + v, 4);
    cp_async_arrive(cols_bar);
  }
  bar_wait(cols_bar, 0);

  // the band: the least and greatest column in [0, n) of the block's
  int lo = INT_MAX, hi = -1;
  for (int k = 0; k < K; ++k)
    for (int m = t; m < m_end; m += T) {
      const int j = cs[k * nodes + m];
      if (uint64_t(j) < uint64_t(n)) {
        lo = min(lo, j);
        hi = max(hi, j);
      }
    }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  if (t % 32 == 0) {
    warp_lo[t / 32] = lo;
    warp_hi[t / 32] = hi;
  }
  if (t < stages) ring[t * band + band - 1] = NAN;
  __syncthreads();
  for (int w = 0; w < T / 32; ++w) {
    lo = min(lo, warp_lo[w]);
    hi = max(hi, warp_hi[w]);
  }
  // the band's ends rounded out to 16 bytes, within the row
  const int64_t lo_a = lo & ~3, hi_a = min(n, (int64_t(hi) | 3) + 1);

  if (hi < 0 || hi_a - lo_a > band - 4) {  // gather from device memory
    for (int m = t; m < m_end; m += T) {
      int j[ELL_MAX_K];
#pragma unroll
      for (int k = 0; k < ELL_MAX_K; ++k) j[k] = k < K ? cs[k * nodes + m] : 0;
      for (int c = 0; c < C; ++c) {
        const float* Xc = X + c * n;
        float acc = 0.0f;
#pragma unroll
        for (int k = 0; k < ELL_MAX_K; ++k)
          if (k < K) acc = acc + (uint64_t(j[k]) < uint64_t(n) ? Xc[j[k]] : NAN);
        out[c * n + i0 + m] = acc;
      }
    }
    return;
  }
  if (t == 0 && staged != nullptr) atomicAdd(staged, 1);
  const int width = int(hi_a - lo_a);
  auto issue = [&](int c) {  // component c's band into slot c % stages
    float* dst = ring + (c % stages) * band;
    const float* src = X + c * n + lo_a;
    uint64_t* b = bar + c % stages;
    if (bulk) {
      if (t == 0) {
        bar_expect(b, unsigned(width) * unsigned(sizeof(float)));
        bulk_copy_1d(dst, src, unsigned(width) * unsigned(sizeof(float)), b);
      }
    } else {
      for (int v = t; v < width; v += T) __pipeline_memcpy_async(dst + v, src + v, 4);
      cp_async_arrive(b);
    }
  };
  for (int c = 0; c < stages && c < C; ++c) issue(c);

  // each column as a byte offset into a ring slot, the NaN cell where it
  // lies outside [0, n); a thread reads back only its own nodes' columns
  for (int k = 0; k < K; ++k)
    for (int m = t; m < m_end; m += T) {
      const int j = cs[k * nodes + m];
      cs[k * nodes + m] = int(uint64_t(j) < uint64_t(n) ? j - lo_a : band - 1) * int(sizeof(float));
    }

  for (int c = 0; c < C; ++c) {
    const int s = c % stages;
    bar_wait(bar + s, unsigned(c / stages) & 1u);
    const char* w = reinterpret_cast<const char*>(ring + s * band);
    for (int m = t; m < m_end; m += T) {
      float acc = 0.0f;
#pragma unroll 4
      for (int k = 0; k < K; ++k)
        acc = acc + *reinterpret_cast<const float*>(w + cs[k * nodes + m]);
      out[c * n + i0 + m] = acc;
    }
    __syncthreads();
    if (c + stages < C) issue(c + stages);
  }
}

}  // namespace ryujin

// The launch shape (groups, span: vectors a group, threads, vec: 4 for
// 16-byte pieces, 1 for 4-byte ones, shared bytes) comes from
// kernels/probe_gather.py lane_shape(); refused unless it is this
// layout's: whole warps up to LANE_MAX_THREADS, at most LANE_ITEMS vectors
// a thread, groups that cover the row's vectors with none wholly past
// them, 16-byte pieces only where W % 4 == 0 and x, idx and out are
// 16-byte aligned, the row's bytes.
extern "C" int ryujin_probe_lane_gather(const void* x, const void* idx, void* out, int P, int W,
                                        int groups, int span, int threads, int vec, int smem,
                                        void* stream) {
  using namespace ryujin;
  if (P <= 0 || W <= 0) return int(cudaSuccess);
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(idx) |
                         reinterpret_cast<uintptr_t>(out)) & 15) == 0 && W % 4 == 0;
  const int64_t nvec = vec == 4 ? W / 4 : W;
  if ((vec != 1 && vec != 4) || (vec == 4 && !aligned) || threads < 32 || threads % 32 != 0 ||
      threads > LANE_MAX_THREADS || span < 1 || span > LANE_ITEMS * threads ||
      int64_t(groups) * span < nvec || int64_t(groups - 1) * span >= nvec || groups > 65535 ||
      int64_t(smem) != int64_t(W) * int64_t(sizeof(float)))
    return int(cudaErrorInvalidValue);
  static int allowed[2] = {48 * 1024, 48 * 1024};  // dynamic shared bytes each instance may take
  void (*kernel)(const float*, const int*, float*, int, int) =
      vec == 4 ? lane_gather_kernel<4> : lane_gather_kernel<1>;
  if (smem > allowed[vec == 4]) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return int(err);
    allowed[vec == 4] = smem;
  }
  kernel<<<dim3(P, groups), threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(idx), static_cast<float*>(out), W,
      span);
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

// The launch shape (nodes a block, threads, stages, bulk: 1 bulk copies,
// 0 4-byte cp.async; band: floats a ring buffer holds; blocks; shared
// bytes) comes from kernels/probe_gather.py ell_shape(); refused unless it
// is this layout's: whole warps up to ELL_MAX_THREADS, nodes a multiple of
// the threads, blocks that cover n, bulk copies only on 16-byte aligned X
// and cols with n % 4 == 0, the header, the columns and the ring's bytes.  staged: null or an int on the card.
extern "C" int ryujin_probe_ell_gather_sum(const void* X, const void* cols, void* out,
                                           void* staged, int C, int K, long long n, int nodes,
                                           int threads, int stages, int bulk, int band,
                                           int blocks, int smem, void* stream) {
  using namespace ryujin;
  if (K > ELL_MAX_K || K < 0 || C < 0 || n < 0) return int(cudaErrorInvalidValue);
  if (n == 0 || C == 0) return int(cudaSuccess);
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(X) | reinterpret_cast<uintptr_t>(cols)) & 15) == 0 &&
      n % 4 == 0;
  const int64_t offs = int64_t(K) * nodes * int64_t(sizeof(int));
  if (threads < 32 || threads % 32 != 0 || threads > ELL_MAX_THREADS || nodes < threads ||
      nodes % threads != 0 || stages < 1 || stages > ELL_MAX_STAGES || (bulk != 0 && bulk != 1) ||
      (bulk && !aligned) || band < 8 ||
      band % 4 != 0 || int64_t(blocks) != (n + nodes - 1) / nodes ||
      int64_t(smem) != ELL_HEADER_BYTES + offs + int64_t(stages) * band * int64_t(sizeof(float)))
    return int(cudaErrorInvalidValue);
  static int allowed = 48 * 1024;  // dynamic shared bytes the kernel may take
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        ell_gather_sum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return int(err);
    allowed = smem;
  }
  ell_gather_sum_kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(X), static_cast<const int*>(cols), static_cast<float*>(out),
      static_cast<int*>(staged), C, K, int64_t(n), nodes, stages, bulk, band);
  return int(cudaGetLastError());
}
