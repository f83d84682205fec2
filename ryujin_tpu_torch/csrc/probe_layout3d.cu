// 3D layout probe: a (TD + 2)-deep z window of planes over an (D, H, W)
// canvas, staged in shared memory and reduced.
//
// Replaces: row 14 of the kernel table, scripts/probe_dma3d.py:
//   main (:30): plane-major (pallas_call :83, src [P, D, H, W]), z-major
//     (:117, src [D, P, H, W]) and z-major-slide (:168): out[z] =
//     sum_{p < P} h[p, z + 1] for z < gz TD, gz = D / TD - 2;
//   pk1_shape (:207, pallas_call :290): PK1's transfer set without its
//     compute: out[z, o] = sum_i h_i[z + 1, 0] + c[z, 0] for o < OUTPL, the
//     centre c [D, CENPL, H, W] in TD-row blocks, the windows h_i
//     [D, p_i, H, W], p_i in (5, 4, 2)[:NWIN];
//   moveaxis_cost (:321, pallas_call :373): out[z] = h[z + 1, 0] of a
//     z-major h [D, P, H, W], with (MOV = 1) or without the in-kernel
//     relayout of the window to plane-major.
// Rows z >= gz TD, which the TPU leaves unwritten, are written as 0.
//
// The TPU moves each z tile's window with explicit DMA, double-buffered,
// the grid running in order on one core.  Here a block owns tiles of TILE
// consecutive cells of the (H, W) plane and marches along z.
//
// The three layouts (window_full_kernel, window_slide_kernel) move each z
// row of a tile, TILE cells of all P planes, with one TMA copy of a box of
// a tensor map (tma.cuh) issued by one thread and counted on an mbarrier,
// so that no thread computes a copy's addresses, and keep many rows in
// flight: their bound is the device memory's rate, which needs some 30 KB
// or more in flight on every SM.  (A 1D bulk copy a (z, p) row, issued by
// the lanes of a warp, took about 45 ns a copy a warp on an H100: slower
// than 16-byte cp.async.)  The full-window kernel stages each z tile's
// whole window, wz = TD + 2 rows of all P planes, in a ring of `stages`
// windows, and
// z-major-slide stages only the TD new rows of each next z tile after a
// first window, in a ring of wz + stages TD rows (row z in slot z % slots),
// `stages` groups of TD rows in flight.  Both split the gz z tiles of each
// x tile into `segments` runs, a block each: the blocks of one segment
// march their z tiles in step, reading neighbouring tiles of the same rows
// at about the same time; a full window's rows shared with the z tile
// before, read moments before by the same block, come from L2; each
// further segment of the slide re-reads the wz - TD rows of its first
// window that the segment before also read.  The sum reads the staged
// rows, one thread per (row of the z tile, cell).  (A persistent grid
// walking (x tile, z tile) items lost to this by 6-20 % on the card.)
//
// moveaxis (moveaxis_kernel) marches as the full-window kernel does but
// stages each z tile's whole window with ONE TMA box of a tensor map whose
// box spans the window: for MOV = 0 a map of dimensions (cell, plane, z),
// the window as it lies, [wz][P][TILE]; for MOV = 1 a map over the same
// z-major canvas with its dimensions in the order (cell, z, plane), whose
// box lands plane-major, [P][wz][TILE]: the copy engine does the
// relayout, with no pass over shared memory.  pk1_shape
// (pk1_shape_kernel) marches the same way and stages each z tile with one
// TMA box a part, all counted on the stage's barrier: the centre's TD rows
// of its CENPL planes and each window's wz rows of its p_i planes, through
// maps of dimensions (cell, plane, z), landing [z][plane][cell] part after
// part.  At the script's sizes the fastest launch gives a block one z
// tile and puts 4 blocks on an SM: 0.0909 ms a call chained, 87 % of the
// bound, its staging alone 0.0734 (3.05 TB/s), where the earlier form,
// 16-byte cp.async by every thread (25 copies a thread a z tile) double-
// buffered over 4 z tiles a block, took 0.1591, its staging alone 0.0940
// (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md §6 row 14).  Both read
// one plane but stage every plane of the TPU kernel's transfer set.  So
// that their result depends on every staged value, these two also write a
// checksum, check[z] (z < gz TD, 0 past): the XOR of the bit patterns that
// thread (z, cell) reads back of its z tile's staged (for MOV = 1:
// plane-major) set, every plane of the window rows z % TD, z % TD + TD,
// ... (pk1_shape's centre: row z % TD).  XOR is associative, so the reads
// may run in any order and overlap, and pk1_shape splits them over groups
// of threads whose partial XORs meet in shared memory; the probe's time
// includes them.
//
// Bound on an H100: bytes, the transfer set read once: P planes of the
// gz TD + 2 rows the windows cover (pk1_shape: the centre's gz TD rows of
// CENPL planes and the windows' rows) and the outputs written once.  Sums
// run p = 0 .. P-1 (pk1_shape: window 0 .. NWIN-1, then the centre) from 0,
// as the plain versions do, so the results are bit-equal.
#include <cuda_runtime.h>

#include <cstdint>

#include "tma.cuh"

namespace ryujin {

constexpr int VEC = 4;  // H W a multiple of 4: 16-byte rows for the TMA
// the three layouts, moveaxis and pk1_shape: the shared bytes of barriers
// ahead of the staged rows, and the most stages they serve (the slide
// takes stages + 1 barriers); mirrored by kernels/probe_layout3d.py
constexpr int LAYOUT_BARRIER_BYTES = 128;
constexpr int LAYOUT_MAX_STAGES = LAYOUT_BARRIER_BYTES / 8 - 1;

enum WindowMode {
  PLANE_MAJOR = 0,
  Z_MAJOR = 1,
  Z_MAJOR_SLIDE = 2,
  MOVEAXIS = 3,
  NO_MOVEAXIS = 4
};

// XOR of the bit patterns of rows zo, zo + TD, ... < depth of planes
// [0, np) of a staged window, element (zl, p) at w[zl * zs + p * ps + q]:
// four independent accumulators, so the loads overlap.
__device__ __forceinline__ unsigned staged_xor(const float* w, int depth, int np, int zs, int ps,
                                               int zo, int TD, int q) {
  unsigned b0 = 0u, b1 = 0u, b2 = 0u, b3 = 0u;
  for (int zl = zo; zl < depth; zl += TD) {
    const float* row = w + zl * zs + q;
    int p = 0;
    for (; p + 4 <= np; p += 4) {
      b0 ^= __float_as_uint(row[p * ps]);
      b1 ^= __float_as_uint(row[(p + 1) * ps]);
      b2 ^= __float_as_uint(row[(p + 2) * ps]);
      b3 ^= __float_as_uint(row[(p + 3) * ps]);
    }
    for (; p < np; ++p) b0 ^= __float_as_uint(row[p * ps]);
  }
  return (b0 ^ b1) ^ (b2 ^ b3);
}

// As staged_xor, over the planes p0, p0 + step, ... < np only.
__device__ __forceinline__ unsigned planes_xor(const float* w, int depth, int np, int zs, int ps,
                                               int zo, int TD, int q, int p0, int step) {
  unsigned b0 = 0u, b1 = 0u, b2 = 0u, b3 = 0u;
  for (int zl = zo; zl < depth; zl += TD) {
    const float* row = w + zl * zs + q;
    int p = p0;
    for (; p + 3 * step < np; p += 4 * step) {
      b0 ^= __float_as_uint(row[p * ps]);
      b1 ^= __float_as_uint(row[(p + step) * ps]);
      b2 ^= __float_as_uint(row[(p + 2 * step) * ps]);
      b3 ^= __float_as_uint(row[(p + 3 * step) * ps]);
    }
    for (; p < np; p += step) b0 ^= __float_as_uint(row[p * ps]);
  }
  return (b0 ^ b1) ^ (b2 ^ b3);
}

// The three layouts' helpers.  Rows [gz TD, D) of out: zeros, spread over
// every thread of the grid (HW % 4 == 0, so both ends are 16-byte aligned).
__device__ __forceinline__ void zero_tail(float* out, int64_t from, int64_t to) {
  const int64_t block = int64_t(blockIdx.y) * gridDim.x + blockIdx.x;
  const int64_t stride = int64_t(gridDim.x) * gridDim.y * blockDim.x;
  for (int64_t v = from / 4 + block * blockDim.x + threadIdx.x; v < to / 4; v += stride)
    reinterpret_cast<float4*>(out)[v] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// Thread 0: rows [z0, z0 + nz) of the tile at q0, each the box (TILE
// cells, one z row, P planes) of `map` there, zeros past the plane's end,
// into buf, row z in slot z % slots, [slot][P][TILE]; counted on bar.  map:
// src [D, P, H, W] (ZM) with the box's coordinates (q0, p, z), else
// [P, D, H, W] with (q0, z, p).
template <bool ZM, int TILE>
__device__ __forceinline__ void stage_rows(float* buf, int slots, const CUtensorMap* map, int z0,
                                           int nz, int P, int q0, uint64_t* bar) {
  bar_expect(bar, unsigned(nz * P * TILE) * unsigned(sizeof(float)));
  for (int z = z0; z < z0 + nz; ++z)
    tma_copy_3d(buf + (z % slots) * P * TILE, map, q0, ZM ? 0 : z, ZM ? z : 0, bar);
}

// out rows [t TD, t TD + TD) of the tile at q0: out[z] = sum_p of staged
// row z + 1, summed from 0 in p order; one thread per (row, cell).
template <int TILE>
__device__ __forceinline__ void sum_rows(const float* buf, int slots, float* out, int t, int TD,
                                         int P, int64_t HW, int64_t q0) {
  for (int e = threadIdx.x; e < TD * TILE; e += blockDim.x) {
    const int zo = e / TILE, c = e % TILE;
    if (q0 + c >= HW) continue;
    const int z = t * TD + zo;
    const float* row = buf + ((z + 1) % slots) * P * TILE + c;
    float acc = 0.0f;
    for (int p = 0; p < P; ++p) acc = acc + row[p * TILE];
    out[int64_t(z) * HW + q0 + c] = acc;
  }
}

// Plane-major (ZM false, src [P, D, H, W]) and z-major (src [D, P, H, W]):
// block (x, segment) marches the tile at x TILE over z tiles [t0, t0 + n),
// t0 = gz segment / S, S segments; its z tile t0 + k stages its whole
// window into buffer k % stages, [wz][P][TILE], on barrier k % stages.
template <bool ZM, int TILE>
__global__ void __launch_bounds__(1024)
window_full_kernel(const __grid_constant__ CUtensorMap map, float* __restrict__ out, int P,
                   int D, int64_t HW, int TD, int gz, int stages) {
  extern __shared__ __align__(128) unsigned char layout_smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(layout_smem);
  float* buf = reinterpret_cast<float*>(layout_smem + LAYOUT_BARRIER_BYTES);
  const int wz = TD + 2, window = wz * P * TILE;
  const int q0 = int(blockIdx.x) * TILE;
  const int t0 = gz * int(blockIdx.y) / int(gridDim.y);
  const int n = gz * int(blockIdx.y + 1) / int(gridDim.y) - t0;
  zero_tail(out, int64_t(gz) * TD * HW, int64_t(D) * HW);
  if (threadIdx.x == 0)
    for (int s = 0; s < stages; ++s) bar_init(bar + s, 1);
  __syncthreads();

  auto issue = [&](int k) {  // thread 0: z tile t0 + k
    stage_rows<ZM, TILE>(buf + k % stages * window, wz, &map, (t0 + k) * TD, wz, P, q0,
                         bar + k % stages);
  };
  if (threadIdx.x == 0)
    for (int k = 0; k < stages && k < n; ++k) issue(k);
  for (int k = 0; k < n; ++k) {
    const int s = k % stages;
    bar_wait(bar + s, unsigned(k / stages) & 1u);
    sum_rows<TILE>(buf + s * window, wz, out, t0 + k, TD, P, HW, q0);
    __syncthreads();
    if (threadIdx.x == 0 && k + stages < n) issue(k + stages);
  }
}

// z-major-slide (src [D, P, H, W]): block (x, segment) marches the tile at
// x TILE over z tiles [t0, t0 + n), t0 = gz segment / S, S segments.  Group
// 0 stages the first window, group g >= 1 tile t0 + g's TD new rows, on
// barrier g % (stages + 1); after tile t0 + g is summed its first TD rows'
// slots take group g + stages + 1.
template <int TILE>
__global__ void __launch_bounds__(1024)
window_slide_kernel(const __grid_constant__ CUtensorMap map, float* __restrict__ out, int P,
                    int D, int64_t HW, int TD, int gz, int stages) {
  extern __shared__ __align__(128) unsigned char layout_smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(layout_smem);
  float* ring = reinterpret_cast<float*>(layout_smem + LAYOUT_BARRIER_BYTES);
  const int wz = TD + 2, slots = wz + stages * TD, nbar = stages + 1;
  const int q0 = int(blockIdx.x) * TILE;
  const int t0 = gz * int(blockIdx.y) / int(gridDim.y);
  const int n = gz * int(blockIdx.y + 1) / int(gridDim.y) - t0;
  zero_tail(out, int64_t(gz) * TD * HW, int64_t(D) * HW);
  if (threadIdx.x == 0)
    for (int s = 0; s < nbar; ++s) bar_init(bar + s, 1);
  __syncthreads();

  auto issue = [&](int g) {  // thread 0: group g
    const int z0 = g == 0 ? t0 * TD : (t0 + g) * TD + wz - TD;
    stage_rows<true, TILE>(ring, slots, &map, z0, g == 0 ? wz : TD, P, q0, bar + g % nbar);
  };
  if (threadIdx.x == 0)
    for (int g = 0; g <= stages && g < n; ++g) issue(g);
  for (int g = 0; g < n; ++g) {
    bar_wait(bar + g % nbar, unsigned(g / nbar) & 1u);
    sum_rows<TILE>(ring, slots, out, t0 + g, TD, P, HW, q0);
    __syncthreads();
    if (threadIdx.x == 0 && g + nbar < n) issue(g + nbar);
  }
}

// moveaxis (src [D, P, H, W]): block (x, segment) marches the tile at x
// TILE over z tiles [t0, t0 + n), as window_full_kernel does, and stages
// z tile t0 + k's whole window with ONE box of `map` into buffer k %
// stages on barrier k % stages.  MOVEAXIS: map's dimensions are (cell, z,
// plane), so the box lands plane-major, [P][wz][TILE], the window moved
// by the copy engine; NO_MOVEAXIS: (cell, plane, z), the window as it
// lies, [wz][P][TILE].  out[z] = 0 + row z + 1 of plane 0; check[z] the
// XOR of the staged rows zo, zo + TD, ... of every plane.  (Staging as
// NO_MOVEAXIS and moving each thread's rows into a plane-major copy in
// shared memory took 0.0384 ms a call chained at the script's sizes, the
// map's box 0.0262, on an NVIDIA H100 80GB HBM3 at 700.00 W: PERF.md §6
// row 14.)
template <int MODE, int TILE>
__global__ void __launch_bounds__(1024)
moveaxis_kernel(const __grid_constant__ CUtensorMap map, float* __restrict__ out,
                unsigned* __restrict__ check, int P, int D, int64_t HW, int TD, int gz,
                int stages) {
  extern __shared__ __align__(128) unsigned char layout_smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(layout_smem);
  float* buf = reinterpret_cast<float*>(layout_smem + LAYOUT_BARRIER_BYTES);
  constexpr bool PM = MODE == MOVEAXIS;  // reads a plane-major window
  const int wz = TD + 2, window = wz * P * TILE;
  const int q0 = int(blockIdx.x) * TILE;
  const int t0 = gz * int(blockIdx.y) / int(gridDim.y);
  const int n = gz * int(blockIdx.y + 1) / int(gridDim.y) - t0;
  zero_tail(out, int64_t(gz) * TD * HW, int64_t(D) * HW);
  zero_tail(reinterpret_cast<float*>(check), int64_t(gz) * TD * HW, int64_t(D) * HW);
  if (threadIdx.x == 0)
    for (int s = 0; s < stages; ++s) bar_init(bar + s, 1);
  __syncthreads();

  auto issue = [&](int k) {  // thread 0: z tile t0 + k
    uint64_t* b = bar + k % stages;
    const int z0 = (t0 + k) * TD;
    bar_expect(b, unsigned(window) * unsigned(sizeof(float)));
    tma_copy_3d(buf + k % stages * window, &map, q0, MODE == MOVEAXIS ? z0 : 0,
                MODE == MOVEAXIS ? 0 : z0, b);
  };
  if (threadIdx.x == 0)
    for (int k = 0; k < stages && k < n; ++k) issue(k);
  for (int k = 0; k < n; ++k) {
    const int s = k % stages;
    bar_wait(bar + s, unsigned(k / stages) & 1u);
    const float* win = buf + s * window;
    for (int e = threadIdx.x; e < TD * TILE; e += blockDim.x) {
      const int zo = e / TILE, c = e % TILE;
      if (q0 + c >= HW) continue;
      const int64_t z = int64_t(t0 + k) * TD + zo;
      float acc = 0.0f;
      acc = acc + win[(zo + 1) * (PM ? 1 : P) * TILE + c];
      out[z * HW + q0 + c] = acc;
      check[z * HW + q0 + c] = PM ? staged_xor(win, wz, P, TILE, wz * TILE, zo, TD, c)
                                  : staged_xor(win, wz, P, P * TILE, TILE, zo, TD, c);
    }
    __syncthreads();
    if (threadIdx.x == 0 && k + stages < n) issue(k + stages);
  }
}

// pk1_shape: the plane counts of the parts of a z tile, the centre's
// (0: none) and the windows'; out [D, out_pl, H, W].
struct Pk1Shape {
  int np[3];
  int nwin, cen_pl, out_pl;
};

// pk1_shape (the centre cen [D, CENPL, H W] and the windows h_i [D, p_i,
// H W], each read through its map, box (TILE, all planes, TD rows for
// the centre, wz for a window)): block (x, segment) marches the tile at x
// TILE over z tiles [t0, t0 + n), as window_full_kernel does; z tile
// t0 + k lands in buffer k % stages, the centre [TD][CENPL][TILE] then
// each window [wz][p_i][TILE], on barrier k % stages.  Thread (g, zo, c)
// of G = blockDim.x / (TD TILE) groups: every group sums window 0 ..
// NWIN-1 then the centre, from 0, for (row zo, cell c) and writes output
// planes g, g + G, ...; group g XORs planes g, g + G, ... of every part,
// groups 1 .. G-1 leave their XOR in shared memory ([2][G - 1][TD TILE],
// by the parity of k), and group 0 writes check.
template <int TILE>
__global__ void __launch_bounds__(1024)
pk1_shape_kernel(const __grid_constant__ CUtensorMap cen_map,
                 const __grid_constant__ CUtensorMap win0, const __grid_constant__ CUtensorMap win1,
                 const __grid_constant__ CUtensorMap win2, Pk1Shape a, float* __restrict__ out,
                 unsigned* __restrict__ check, int D, int64_t HW, int TD, int gz, int stages) {
  extern __shared__ __align__(128) unsigned char layout_smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(layout_smem);
  float* ring = reinterpret_cast<float*>(layout_smem + LAYOUT_BARRIER_BYTES);
  const int wz = TD + 2, rows = TD * TILE, G = int(blockDim.x) / rows;
  const int cen_floats = TD * a.cen_pl * TILE;
  int stage_floats = cen_floats;
#pragma unroll
  for (int i = 0; i < 3; ++i)
    if (i < a.nwin) stage_floats += wz * a.np[i] * TILE;
  unsigned* part = reinterpret_cast<unsigned*>(ring + stages * stage_floats);
  const int g = int(threadIdx.x) / rows, e = int(threadIdx.x) % rows;
  const int zo = e / TILE, c = e % TILE;
  const int q0 = int(blockIdx.x) * TILE;
  const int t0 = gz * int(blockIdx.y) / int(gridDim.y);
  const int n = gz * int(blockIdx.y + 1) / int(gridDim.y) - t0;
  zero_tail(out, int64_t(gz) * TD * a.out_pl * HW, int64_t(D) * a.out_pl * HW);
  zero_tail(reinterpret_cast<float*>(check), int64_t(gz) * TD * HW, int64_t(D) * HW);
  if (threadIdx.x == 0)
    for (int s = 0; s < stages; ++s) bar_init(bar + s, 1);
  __syncthreads();

  auto issue = [&](int k) {  // thread 0: z tile t0 + k, a box a part
    float* buf = ring + k % stages * stage_floats;
    uint64_t* b = bar + k % stages;
    const int z0 = (t0 + k) * TD;
    bar_expect(b, unsigned(stage_floats) * unsigned(sizeof(float)));
    if (a.cen_pl) tma_copy_3d(buf, &cen_map, q0, 0, z0, b);
    float* w = buf + cen_floats;
    if (a.nwin > 0) tma_copy_3d(w, &win0, q0, 0, z0, b);
    if (a.nwin > 1) tma_copy_3d(w += wz * a.np[0] * TILE, &win1, q0, 0, z0, b);
    if (a.nwin > 2) tma_copy_3d(w + wz * a.np[1] * TILE, &win2, q0, 0, z0, b);
  };
  if (threadIdx.x == 0)
    for (int k = 0; k < stages && k < n; ++k) issue(k);
  const bool live = q0 + c < HW;
  for (int k = 0; k < n; ++k) {
    const int s = k % stages;
    bar_wait(bar + s, unsigned(k / stages) & 1u);
    const float* buf = ring + s * stage_floats;
    const int64_t z = int64_t(t0 + k) * TD + zo;
    float acc = 0.0f;
    const float* w = buf + cen_floats;
#pragma unroll
    for (int i = 0; i < 3; ++i)
      if (i < a.nwin) {
        acc = acc + w[(zo + 1) * a.np[i] * TILE + c];
        w += wz * a.np[i] * TILE;
      }
    if (a.cen_pl) acc = acc + buf[zo * a.cen_pl * TILE + c];
    if (live)
      for (int o = g; o < a.out_pl; o += G) out[(z * a.out_pl + o) * HW + q0 + c] = acc;
    unsigned bits =
        a.cen_pl ? planes_xor(buf, TD, a.cen_pl, a.cen_pl * TILE, TILE, zo, TD, c, g, G) : 0u;
    w = buf + cen_floats;
#pragma unroll
    for (int i = 0; i < 3; ++i)
      if (i < a.nwin) {
        bits ^= planes_xor(w, wz, a.np[i], a.np[i] * TILE, TILE, zo, TD, c, g, G);
        w += wz * a.np[i] * TILE;
      }
    unsigned* parts = part + (k & 1) * (G - 1) * rows;
    if (g > 0) parts[(g - 1) * rows + e] = bits;
    __syncthreads();
    if (threadIdx.x == 0 && k + stages < n) issue(k + stages);
    if (g == 0) {
      for (int h = 1; h < G; ++h) bits ^= parts[(h - 1) * rows + e];
      if (live) check[z * HW + q0 + c] = bits;
    }
  }
}

// A 3D tensor map of f32 src for the TMA: dimensions dims (innermost
// first), byte strides of the outer two, box box, zeros past the ends.
// cuTensorMapEncodeTiled lies in libcuda, which the library does not
// link: it is looked up at run time.
inline cudaError_t encode_3d(CUtensorMap* map, const float* src, const cuuint64_t dims[3],
                             const cuuint64_t strides[2], const cuuint32_t box[3]) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorNotSupported;
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(src),
                              dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The tensor map of the rows of src: z-major [D, P, HW] or plane-major
// [P, D, HW], its box one z row of all P planes, TILE cells wide.
inline cudaError_t encode_rows(CUtensorMap* map, const float* src, bool zm, int P, int D,
                               int64_t HW, int tile) {
  const cuuint64_t dims[3] = {cuuint64_t(HW), cuuint64_t(zm ? P : D), cuuint64_t(zm ? D : P)};
  const cuuint64_t strides[2] = {cuuint64_t(HW) * sizeof(float),
                                 cuuint64_t(zm ? P : D) * HW * sizeof(float)};
  const cuuint32_t box[3] = {cuuint32_t(tile), cuuint32_t(zm ? P : 1), cuuint32_t(zm ? 1 : P)};
  return encode_3d(map, src, dims, strides, box);
}

// The tensor map of moveaxis's windows of a z-major src [D, P, HW], its
// box a whole window of wz rows, all P planes, TILE cells: with `moved`
// the dimensions (cell, z, plane), strides P HW and HW floats, so that a
// box lands plane-major; else (cell, plane, z).
inline cudaError_t encode_windows(CUtensorMap* map, const float* src, bool moved, int P, int D,
                                  int64_t HW, int wz, int tile) {
  const cuuint64_t plane = cuuint64_t(HW) * sizeof(float), row = cuuint64_t(P) * plane;
  const cuuint64_t dims[3] = {cuuint64_t(HW), cuuint64_t(moved ? D : P),
                              cuuint64_t(moved ? P : D)};
  const cuuint64_t strides[2] = {moved ? row : plane, moved ? plane : row};
  const cuuint32_t box[3] = {cuuint32_t(tile), cuuint32_t(moved ? wz : P),
                             cuuint32_t(moved ? P : wz)};
  return encode_3d(map, src, dims, strides, box);
}

// The three layouts' launch.  One allowed shared-memory size a kernel
// instance, raised once as a size first needs it; the tensor map of the
// last source kept for the next launch on it.
template <int TILE>
cudaError_t launch_layout(int layout, const float* src, float* out, int P, int D, int64_t HW,
                          int TD, int gz, int stages, int blocks, int segments, int threads,
                          int smem, cudaStream_t stream) {
  static int allowed[3] = {48 * 1024, 48 * 1024, 48 * 1024};
  static CUtensorMap map[2];
  static int64_t key[2][4] = {};
  const bool zm = layout != PLANE_MAJOR;
  const int64_t k[4] = {int64_t(reinterpret_cast<uintptr_t>(src)), P, D, HW};
  if (k[0] != key[zm][0] || k[1] != key[zm][1] || k[2] != key[zm][2] || k[3] != key[zm][3]) {
    const cudaError_t err = encode_rows(&map[zm], src, zm, P, D, HW, TILE);
    if (err != cudaSuccess) return err;
    for (int i = 0; i < 4; ++i) key[zm][i] = k[i];
  }
  void (*kernel)(const CUtensorMap, float*, int, int, int64_t, int, int, int) =
      layout == PLANE_MAJOR ? window_full_kernel<false, TILE>
      : layout == Z_MAJOR   ? window_full_kernel<true, TILE>
                            : window_slide_kernel<TILE>;
  if (smem > allowed[layout]) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    allowed[layout] = smem;
  }
  kernel<<<dim3(blocks / segments, segments), threads, smem, stream>>>(map[zm], out, P, D, HW,
                                                                      TD, gz, stages);
  return cudaGetLastError();
}

// moveaxis's launch, as launch_layout's: one allowed shared-memory size
// an instance, the tensor map of the last (source, shape) of each mode
// kept for the next launch on it.
template <int TILE>
cudaError_t launch_moveaxis(int mode, const float* src, float* out, unsigned* check, int P,
                            int D, int64_t HW, int TD, int gz, int stages, int blocks,
                            int segments, int threads, int smem, cudaStream_t stream) {
  static int allowed[2] = {48 * 1024, 48 * 1024};
  static CUtensorMap map[2];
  static int64_t key[2][5] = {};
  const int m = mode == MOVEAXIS;
  const int64_t k[5] = {int64_t(reinterpret_cast<uintptr_t>(src)), P, D, HW, TD};
  bool same = true;
  for (int i = 0; i < 5; ++i) same = same && k[i] == key[m][i];
  if (!same) {
    const cudaError_t err =
        encode_windows(&map[m], src, mode == MOVEAXIS, P, D, HW, TD + 2, TILE);
    if (err != cudaSuccess) return err;
    for (int i = 0; i < 5; ++i) key[m][i] = k[i];
  }
  void (*kernel)(const CUtensorMap, float*, unsigned*, int, int, int64_t, int, int, int) =
      mode == MOVEAXIS ? moveaxis_kernel<MOVEAXIS, TILE> : moveaxis_kernel<NO_MOVEAXIS, TILE>;
  if (smem > allowed[m]) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    allowed[m] = smem;
  }
  kernel<<<dim3(blocks / segments, segments), threads, smem, stream>>>(map[m], out, check, P, D,
                                                                      HW, TD, gz, stages);
  return cudaGetLastError();
}

// pk1_shape's launch, as launch_layout's: one allowed shared-memory size
// an instance, the tensor map of each part's last (source, shape) kept for
// the next launch on it.  src[0] the centre or null, src[1 + i] window i
// or null; planes[j] its planes.
template <int TILE>
cudaError_t launch_pk1_shape(const float* const src[4], const int planes[4], const Pk1Shape& a,
                             float* out, unsigned* check, int D, int64_t HW, int TD, int gz,
                             int stages, int blocks, int segments, int threads, int smem,
                             cudaStream_t stream) {
  static int allowed = 48 * 1024;
  static CUtensorMap map[4];
  static int64_t key[4][5] = {};
  for (int j = 0; j < 4; ++j) {
    if (src[j] == nullptr) continue;
    const int depth = j == 0 ? TD : TD + 2;
    const int64_t k[5] = {int64_t(reinterpret_cast<uintptr_t>(src[j])), planes[j], D, HW, depth};
    bool same = true;
    for (int i = 0; i < 5; ++i) same = same && k[i] == key[j][i];
    if (same) continue;
    const cudaError_t err = encode_windows(&map[j], src[j], false, planes[j], D, HW, depth, TILE);
    if (err != cudaSuccess) return err;
    for (int i = 0; i < 5; ++i) key[j][i] = k[i];
  }
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        pk1_shape_kernel<TILE>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  pk1_shape_kernel<TILE><<<dim3(blocks / segments, segments), threads, smem, stream>>>(
      map[0], map[1], map[2], map[3], a, out, check, D, HW, TD, gz, stages);
  return cudaGetLastError();
}

}  // namespace ryujin

// layout: PLANE_MAJOR (src [P, D, H, W]), Z_MAJOR or Z_MAJOR_SLIDE (src
// [D, P, H, W]); out [D, H, W].  The launch shape is layout_shape()'s
// (kernels/probe_layout3d.py): tile (64 or 128 cells), stages, blocks (x
// tiles x segments), segments, threads, smem; one that does not fit the
// layout is refused.  HW % 4 == 0, P <= 256 (a box's extent).
extern "C" int ryujin_probe_layout(int layout, const void* src, void* out, int P, int D,
                                   long long HW, int TD, int tile, int stages, int blocks,
                                   int segments, int threads, int smem, void* stream) {
  using namespace ryujin;
  const int gz = TD >= 1 ? D / TD - 2 : 0, wz = TD + 2;
  if (layout < PLANE_MAJOR || layout > Z_MAJOR_SLIDE || P < 1 || P > 256 || gz < 1 ||
      HW % VEC != 0 || HW > INT32_MAX ||
      (tile != 64 && tile != 128) || stages < 1 || stages > LAYOUT_MAX_STAGES ||
      threads != (TD * tile < 1024 ? TD * tile : 1024))
    return int(cudaErrorInvalidValue);
  const bool slide = layout == Z_MAJOR_SLIDE;
  const int64_t tiles = (HW + tile - 1) / tile;
  const int64_t rows = slide ? wz + int64_t(stages) * TD : int64_t(stages) * wz;
  if (int64_t(smem) != LAYOUT_BARRIER_BYTES + rows * P * tile * int64_t(sizeof(float)) ||
      segments < 1 || segments > gz || blocks != tiles * segments)
    return int(cudaErrorInvalidValue);
  const float* s = static_cast<const float*>(src);
  float* o = static_cast<float*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return int(tile == 64 ? launch_layout<64>(layout, s, o, P, D, HW, TD, gz, stages, blocks,
                                            segments, threads, smem, st)
                        : launch_layout<128>(layout, s, o, P, D, HW, TD, gz, stages, blocks,
                                             segments, threads, smem, st));
}

// mode: MOVEAXIS or NO_MOVEAXIS; src [D, P, H, W]; out, check [D, H, W]
// (check 32-bit).  The launch shape is layout_shape()'s for "moveaxis"
// (kernels/probe_layout3d.py): tile (64 or 128 cells), stages, blocks (x
// tiles x segments), segments, threads, smem (the barriers and `stages`
// windows); one that does not fit is refused.  HW % 4 == 0, P <= 256 and TD <= 16 (a box's
// extents).
extern "C" int ryujin_probe_window(int mode, const void* src, void* out, void* check, int P,
                                   int D, long long HW, int TD, int tile, int stages, int blocks,
                                   int segments, int threads, int smem, void* stream) {
  using namespace ryujin;
  const int gz = TD >= 1 ? D / TD - 2 : 0, wz = TD + 2;
  if (mode < MOVEAXIS || mode > NO_MOVEAXIS || P < 1 || P > 256 || TD > 16 || gz < 1 ||
      HW % VEC != 0 || HW > INT32_MAX || check == nullptr || (tile != 64 && tile != 128) ||
      stages < 1 || stages > LAYOUT_MAX_STAGES ||
      threads != (TD * tile < 1024 ? TD * tile : 1024))
    return int(cudaErrorInvalidValue);
  const int64_t tiles = (HW + tile - 1) / tile;
  const int64_t rows = int64_t(stages) * wz;
  if (int64_t(smem) != LAYOUT_BARRIER_BYTES + rows * P * tile * int64_t(sizeof(float)) ||
      segments < 1 || segments > gz || blocks != tiles * segments)
    return int(cudaErrorInvalidValue);
  const float* s = static_cast<const float*>(src);
  float* o = static_cast<float*>(out);
  unsigned* c = static_cast<unsigned*>(check);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return int(tile == 64 ? launch_moveaxis<64>(mode, s, o, c, P, D, HW, TD, gz, stages, blocks,
                                              segments, threads, smem, st)
                        : launch_moveaxis<128>(mode, s, o, c, P, D, HW, TD, gz, stages, blocks,
                                               segments, threads, smem, st));
}

// cen [D, cen_pl, H, W] or null; h0..h2 [D, p_i, H, W], the first nwin used;
// out [D, out_pl, H, W]; check [D, H, W] (32-bit); every pointer 16-byte
// aligned.  The launch shape is pk1_shape_shape()'s
// (kernels/probe_layout3d.py): tile (64 or 128 cells), stages, blocks (x
// tiles x segments), segments, threads (groups of TD tile), smem (the
// barriers, `stages` z tiles of every part and the groups' XORs); one
// that does not fit is refused.  HW % 4 == 0; CENPL, p_i and TD + 2 at
// most 256 (a box's extents).
extern "C" int ryujin_probe_pk1_shape(const void* cen, const void* h0, const void* h1,
                                      const void* h2, void* out, void* check, int nwin, int p0,
                                      int p1, int p2, int cen_pl, int out_pl, int D,
                                      long long HW, int TD, int tile, int stages, int blocks,
                                      int segments, int threads, int smem, void* stream) {
  using namespace ryujin;
  const int gz = TD >= 1 ? D / TD - 2 : 0, wz = TD + 2;
  const void* given[4] = {cen, h0, h1, h2};
  const float* src[4] = {};
  int planes[4] = {cen ? cen_pl : 0, p0, p1, p2};
  uintptr_t bases = reinterpret_cast<uintptr_t>(out) | reinterpret_cast<uintptr_t>(check);
  bool fits = nwin >= 0 && nwin <= 3 && (cen != nullptr || nwin > 0) && out_pl >= 0 &&
              gz >= 1 && wz <= 256 && HW % VEC == 0 && HW <= INT32_MAX && check != nullptr;
  for (int j = 0; j < 4; ++j) {
    if (j > nwin || (j == 0 && cen == nullptr)) {
      planes[j] = 0;
      continue;
    }
    src[j] = static_cast<const float*>(given[j]);
    fits = fits && src[j] != nullptr && planes[j] >= 1 && planes[j] <= 256;
    bases |= reinterpret_cast<uintptr_t>(src[j]);
  }
  if (!fits || (bases & 15) != 0 || (tile != 64 && tile != 128) || stages < 1 ||
      stages > LAYOUT_MAX_STAGES || threads > 1024 || threads < TD * tile ||
      threads % (TD * tile) != 0)
    return int(cudaErrorInvalidValue);
  const int64_t groups = threads / (TD * tile), tiles = (HW + tile - 1) / tile;
  const int64_t stage = (int64_t(TD) * planes[0] + int64_t(wz) * (planes[1] + planes[2] +
                         planes[3])) * tile * int64_t(sizeof(float));
  if (int64_t(smem) != LAYOUT_BARRIER_BYTES + stages * stage +
                           2 * (groups - 1) * TD * tile * int64_t(sizeof(unsigned)) ||
      segments < 1 || segments > gz || blocks != tiles * segments)
    return int(cudaErrorInvalidValue);
  const Pk1Shape a{{planes[1], planes[2], planes[3]}, nwin, planes[0], out_pl};
  float* o = static_cast<float*>(out);
  unsigned* c = static_cast<unsigned*>(check);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return int(tile == 64 ? launch_pk1_shape<64>(src, planes, a, o, c, D, HW, TD, gz, stages,
                                               blocks, segments, threads, smem, st)
                        : launch_pk1_shape<128>(src, planes, a, o, c, D, HW, TD, gz, stages,
                                                blocks, segments, threads, smem, st));
}
