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
// the grid running in order on one core.  Here a block owns a tile of TILE
// consecutive cells of the (H, W) plane and marches along z: it stages its
// window with cp.async (__pipeline_memcpy_async, 16 bytes a copy),
// double-buffered, and reduces from shared memory, one thread per (row of
// the tile, cell).  The full-window kernels (the three layouts, pk1_shape,
// moveaxis) march over ZCHUNK z tiles a block, so that the grid also runs
// along z; z-major-slide marches over all gz tiles, keeps the wz-deep window
// in a ring of wz + TD rows and loads only the TD new rows a step (the
// z-marching kernel of the 3D stencils' shared-memory lever), the (H, W)
// tiles giving the parallelism.  pk1_shape and moveaxis read one plane but
// stage every plane of the TPU kernel's transfer set; moveaxis with MOV = 1
// transposes the staged [wz, P, TILE] window to [P, wz, TILE] in shared
// memory before reading it.  So that their result depends on every staged
// value, these two also write a checksum, check[z] (z < gz TD, 0 past): the
// XOR of the bit patterns that thread (z, cell) reads back of its z tile's
// staged (for MOV = 1: transposed) set, every plane of the window rows
// z % TD, z % TD + TD, ... (pk1_shape's centre: row z % TD).  XOR is
// associative, so the reads may run in any order and overlap; the probe's
// time includes them.
//
// Bound on an H100: bytes, the transfer set read once: P planes of the
// gz TD + 2 rows the windows cover (pk1_shape: the centre's gz TD rows of
// CENPL planes and the windows' rows) and the outputs written once.  Sums
// run p = 0 .. P-1 (pk1_shape: window 0 .. NWIN-1, then the centre) from 0,
// as the plain versions do, so the results are bit-equal.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace ryujin {

constexpr int TILE = 64;   // cells of the (H, W) plane a block owns
constexpr int ZCHUNK = 4;  // z tiles a full-window block marches over
constexpr int VEC = 4;     // floats a cp.async moves

enum WindowMode { PLANE_MAJOR = 0, Z_MAJOR = 1, Z_MAJOR_SLIDE = 2, MOVEAXIS = 3, NO_MOVEAXIS = 4 };

// Copy rows [0, nz) of planes [0, np) of the tile at q0 from src (row
// stride zs, plane stride ps in floats) to dst (row stride dzs, plane stride
// dps); vectors past the plane's end (q >= HW) are skipped.
__device__ __forceinline__ void stage(float* dst, const float* src, int nz, int np, int64_t zs,
                                      int64_t ps, int dzs, int dps, int64_t q0, int64_t HW) {
  constexpr int per_row = TILE / VEC;
  const int nvec = nz * np * per_row;
  for (int v = threadIdx.x; v < nvec; v += blockDim.x) {
    const int vq = v % per_row, r = v / per_row;
    const int p = r % np, zl = r / np;
    const int64_t q = q0 + int64_t(vq) * VEC;
    if (q < HW)
      __pipeline_memcpy_async(dst + zl * dzs + p * dps + vq * VEC, src + zl * zs + p * ps + q,
                              VEC * sizeof(float));
  }
}

// out rows [z0, D) of the block's tile (zeros past the last z tile); `planes`
// output planes a row.
template <typename T>
__device__ __forceinline__ void zero_rows(T* out, int z0, int D, int planes, int TD, int64_t HW,
                                          int64_t q0) {
  const int zo = threadIdx.x / TILE, q = threadIdx.x % TILE;
  if (q0 + q >= HW) return;
  for (int z = z0 + zo; z < D; z += TD)
    for (int o = 0; o < planes; ++o) out[(int64_t(z) * planes + o) * HW + q0 + q] = T(0);
}

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

// The three layouts and moveaxis: each z tile's whole window, double-buffered.
// check: the staged window's checksum (MOVEAXIS and NO_MOVEAXIS only).
template <int MODE>
__global__ void __launch_bounds__(1024)
window_kernel(const float* __restrict__ src, float* __restrict__ out,
              unsigned* __restrict__ check, int P, int D, int64_t HW, int TD, int gz) {
  extern __shared__ __align__(16) float smem[];
  constexpr bool ZM = MODE != PLANE_MAJOR;
  constexpr bool CHECK = MODE == MOVEAXIS || MODE == NO_MOVEAXIS;
  const int wz = TD + 2;
  const int64_t q0 = int64_t(blockIdx.x) * TILE;
  const int64_t zs = ZM ? P * HW : HW, ps = ZM ? HW : int64_t(D) * HW;
  const int dzs = ZM ? P * TILE : TILE, dps = ZM ? TILE : wz * TILE;
  const int window = P * wz * TILE;
  float* moved = smem + 2 * window;  // [P][wz][TILE], MOVEAXIS only
  const int zo = threadIdx.x / TILE, q = threadIdx.x % TILE;
  if (blockIdx.y == 0) {
    zero_rows(out, gz * TD, D, 1, TD, HW, q0);
    if (CHECK) zero_rows(check, gz * TD, D, 1, TD, HW, q0);
  }
  const int t0 = blockIdx.y * ZCHUNK, t1 = min(gz, t0 + ZCHUNK);
  if (t0 >= t1) return;

  stage(smem, src + int64_t(t0) * TD * zs, wz, P, zs, ps, dzs, dps, q0, HW);
  __pipeline_commit();
  for (int tz = t0; tz < t1; ++tz) {
    const float* win = smem + ((tz - t0) & 1) * window;
    if (tz + 1 < t1) {
      stage(smem + ((tz - t0 + 1) & 1) * window, src + int64_t(tz + 1) * TD * zs, wz, P, zs, ps,
            dzs, dps, q0, HW);
      __pipeline_commit();
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    if (MODE == MOVEAXIS) {
      for (int e = threadIdx.x; e < window; e += blockDim.x) {
        const int c = e % TILE, r = e / TILE;
        const int zl = r % wz, p = r / wz;
        moved[e] = win[zl * dzs + p * dps + c];
      }
      __syncthreads();
    }
    if (q0 + q < HW) {
      float acc = 0.0f;
      if (MODE == MOVEAXIS) {
        acc = acc + moved[(zo + 1) * TILE + q];
      } else if (MODE == NO_MOVEAXIS) {
        acc = acc + win[(zo + 1) * dzs + q];
      } else {
        for (int p = 0; p < P; ++p) acc = acc + win[(zo + 1) * dzs + p * dps + q];
      }
      out[(int64_t(tz) * TD + zo) * HW + q0 + q] = acc;
      if (CHECK) {
        // MOVEAXIS reads the transposed copy, [P][wz][TILE]
        const unsigned bits = MODE == MOVEAXIS
                                  ? staged_xor(moved, wz, P, TILE, wz * TILE, zo, TD, q)
                                  : staged_xor(win, wz, P, dzs, dps, zo, TD, q);
        check[(int64_t(tz) * TD + zo) * HW + q0 + q] = bits;
      }
    }
    __syncthreads();
  }
}

// z-major-slide: one block marches its tile over every z tile; row z of the
// window lives in ring slot z % (wz + TD), [slot][P][TILE].
__global__ void __launch_bounds__(1024)
window_slide_kernel(const float* __restrict__ src, float* __restrict__ out, int P, int D,
                    int64_t HW, int TD, int gz) {
  extern __shared__ __align__(16) float ring[];
  const int wz = TD + 2, slots = wz + TD;
  const int64_t q0 = int64_t(blockIdx.x) * TILE;
  const int64_t zs = P * HW;
  const int slot = P * TILE;
  const int zo = threadIdx.x / TILE, q = threadIdx.x % TILE;
  zero_rows(out, gz * TD, D, 1, TD, HW, q0);

  // rows [z0, z0 + nz) into their slots (a run of rows may wrap the ring)
  auto load_rows = [&](int z0, int nz) {
    for (int z = z0; z < z0 + nz; ++z)
      stage(ring + (z % slots) * slot, src + int64_t(z) * zs, 1, P, zs, HW, 0, TILE, q0, HW);
    __pipeline_commit();
  };
  load_rows(0, wz);
  if (gz > 1) load_rows(wz, TD);
  for (int tz = 0; tz < gz; ++tz) {
    if (tz + 1 < gz)
      __pipeline_wait_prior(1);
    else
      __pipeline_wait_prior(0);
    __syncthreads();
    const int z = tz * TD + zo;
    if (q0 + q < HW) {
      const float* row = ring + ((z + 1) % slots) * slot;
      float acc = 0.0f;
      for (int p = 0; p < P; ++p) acc = acc + row[p * TILE + q];
      out[int64_t(z) * HW + q0 + q] = acc;
    }
    __syncthreads();
    if (tz + 2 < gz) load_rows((tz + 1) * TD + wz, TD);
  }
}

// pk1_shape: per z tile the centre's TD rows of cen_pl planes and each
// window's wz rows, double-buffered; out [D, out_pl, H, W].
struct Pk1Shape {
  const float* cen;
  const float* h[3];
  int np[3];
  int nwin, cen_pl, out_pl;
};

__global__ void __launch_bounds__(1024)
pk1_shape_kernel(Pk1Shape a, float* __restrict__ out, unsigned* __restrict__ check, int D,
                 int64_t HW, int TD, int gz) {
  extern __shared__ __align__(16) float smem[];
  const int wz = TD + 2;
  const int64_t q0 = int64_t(blockIdx.x) * TILE;
  const int cen_floats = a.cen ? TD * a.cen_pl * TILE : 0;
  int stage_floats = cen_floats;
  for (int i = 0; i < a.nwin; ++i) stage_floats += wz * a.np[i] * TILE;
  const int zo = threadIdx.x / TILE, q = threadIdx.x % TILE;
  if (blockIdx.y == 0) {
    zero_rows(out, gz * TD, D, a.out_pl, TD, HW, q0);
    zero_rows(check, gz * TD, D, 1, TD, HW, q0);
  }
  const int t0 = blockIdx.y * ZCHUNK, t1 = min(gz, t0 + ZCHUNK);
  if (t0 >= t1) return;

  auto load_tile = [&](int tz, float* buf) {
    if (a.cen)
      stage(buf, a.cen + int64_t(tz) * TD * a.cen_pl * HW, TD, a.cen_pl, a.cen_pl * HW, HW,
            a.cen_pl * TILE, TILE, q0, HW);
    float* w = buf + cen_floats;
    for (int i = 0; i < a.nwin; ++i) {
      stage(w, a.h[i] + int64_t(tz) * TD * a.np[i] * HW, wz, a.np[i], a.np[i] * HW, HW,
            a.np[i] * TILE, TILE, q0, HW);
      w += wz * a.np[i] * TILE;
    }
    __pipeline_commit();
  };
  load_tile(t0, smem);
  for (int tz = t0; tz < t1; ++tz) {
    const float* buf = smem + ((tz - t0) & 1) * stage_floats;
    if (tz + 1 < t1) {
      load_tile(tz + 1, smem + ((tz - t0 + 1) & 1) * stage_floats);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    if (q0 + q < HW) {
      float acc = 0.0f;
      const float* w = buf + cen_floats;
      for (int i = 0; i < a.nwin; ++i) {
        acc = acc + w[(zo + 1) * a.np[i] * TILE + q];
        w += wz * a.np[i] * TILE;
      }
      if (a.cen) acc = acc + buf[zo * a.cen_pl * TILE + q];
      const int64_t z = int64_t(tz) * TD + zo;
      for (int o = 0; o < a.out_pl; ++o) out[(z * a.out_pl + o) * HW + q0 + q] = acc;
      unsigned bits =
          a.cen ? staged_xor(buf, TD, a.cen_pl, a.cen_pl * TILE, TILE, zo, TD, q) : 0u;
      w = buf + cen_floats;
      for (int i = 0; i < a.nwin; ++i) {
        bits ^= staged_xor(w, wz, a.np[i], a.np[i] * TILE, TILE, zo, TD, q);
        w += wz * a.np[i] * TILE;
      }
      check[z * HW + q0 + q] = bits;
    }
    __syncthreads();
  }
}

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, dim3 grid, int TD, size_t smem, cudaStream_t stream,
                   Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, TILE * TD, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace ryujin

// mode: a ryujin::WindowMode; src [P, D, H, W] for PLANE_MAJOR, else
// [D, P, H, W]; out [D, H, W]; check [D, H, W] (32-bit) for MOVEAXIS and
// NO_MOVEAXIS, unused (may be null) for the three layouts.  HW % 4 == 0 and
// TD <= 16.
extern "C" int ryujin_probe_window(int mode, const void* src, void* out, void* check, int P,
                                   int D, long long HW, int TD, void* stream) {
  using namespace ryujin;
  const int gz = D / TD - 2, wz = TD + 2;
  if (TD < 1 || TILE * TD > 1024 || HW % VEC != 0 || P < 1 || gz < 1 ||
      ((mode == MOVEAXIS || mode == NO_MOVEAXIS) && check == nullptr))
    return int(cudaErrorInvalidValue);
  const unsigned tiles = unsigned((HW + TILE - 1) / TILE);
  const unsigned chunks = unsigned((gz + ZCHUNK - 1) / ZCHUNK);
  const size_t window = size_t(P) * wz * TILE * sizeof(float);
  const float* s = static_cast<const float*>(src);
  float* o = static_cast<float*>(out);
  unsigned* c = static_cast<unsigned*>(check);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(tiles, chunks);
  switch (mode) {
    case PLANE_MAJOR:
      return int(launch(window_kernel<PLANE_MAJOR>, grid, TD, 2 * window, st, s, o, c, P, D, HW,
                        TD, gz));
    case Z_MAJOR:
      return int(
          launch(window_kernel<Z_MAJOR>, grid, TD, 2 * window, st, s, o, c, P, D, HW, TD, gz));
    case MOVEAXIS:
      return int(
          launch(window_kernel<MOVEAXIS>, grid, TD, 3 * window, st, s, o, c, P, D, HW, TD, gz));
    case NO_MOVEAXIS:
      return int(launch(window_kernel<NO_MOVEAXIS>, grid, TD, 2 * window, st, s, o, c, P, D, HW,
                        TD, gz));
    case Z_MAJOR_SLIDE:
      return int(launch(window_slide_kernel, dim3(tiles), TD,
                        size_t(P) * (wz + TD) * TILE * sizeof(float), st, s, o, P, D, HW, TD,
                        gz));
    default:
      return int(cudaErrorInvalidValue);
  }
}

// cen [D, cen_pl, H, W] or null; h0..h2 [D, p_i, H, W], the first nwin used;
// out [D, out_pl, H, W]; check [D, H, W] (32-bit).  HW % 4 == 0 and TD <= 16.
extern "C" int ryujin_probe_pk1_shape(const void* cen, const void* h0, const void* h1,
                                      const void* h2, void* out, void* check, int nwin, int p0,
                                      int p1, int p2, int cen_pl, int out_pl, int D,
                                      long long HW, int TD, void* stream) {
  using namespace ryujin;
  const int gz = D / TD - 2, wz = TD + 2;
  if (TD < 1 || TILE * TD > 1024 || HW % VEC != 0 || nwin < 0 || nwin > 3 || gz < 1 ||
      check == nullptr)
    return int(cudaErrorInvalidValue);
  const Pk1Shape a{static_cast<const float*>(cen),
                   {static_cast<const float*>(h0), static_cast<const float*>(h1),
                    static_cast<const float*>(h2)},
                   {p0, p1, p2},
                   nwin,
                   cen_pl,
                   out_pl};
  size_t stage_floats = cen ? size_t(TD) * cen_pl * TILE : 0;
  for (int i = 0; i < nwin; ++i) stage_floats += size_t(wz) * a.np[i] * TILE;
  const size_t smem = 2 * stage_floats * sizeof(float);
  const dim3 grid(unsigned((HW + TILE - 1) / TILE), unsigned((gz + ZCHUNK - 1) / ZCHUNK));
  return int(launch(pk1_shape_kernel, grid, TD, smem, static_cast<cudaStream_t>(stream), a,
                    static_cast<float*>(out), static_cast<unsigned*>(check), D, int64_t(HW), TD,
                    gz));
}
