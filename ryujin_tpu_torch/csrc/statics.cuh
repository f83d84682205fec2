// Accessors of the static stencil planes (c_ij, cmax, the edge mask, m_ij,
// c_ii), a template parameter of the stream kernels and of pk_up: the
// kernels read a plane of offset k at their cell only through one of them.
//
// FullStatics indexes the stored [planes, D, H, W] canvases, with the
// expressions the kernels used before the accessors, so the full-statics
// instances keep their instruction sequence (checked with
// `python -m ryujin_tpu_torch.sass_diff`).
//
// SepStatics is the separable form (3D, reach 1, K = 26): a static plane
// of an extrusion along z is a z-profile times a 2D field,
// f[p](z) * g[q](y, x) (ryujin_tpu_torch/offline/separable.py), and the
// accessor forms that product instead of reading the plane.
//
// Replaces: `_SepTile` (ryujin_tpu/solver/pallas_step.py:1092-1164), which
// the TPU kernels `_pk1_stream` (:1915-1917, 1974, 2003) and `_step_slab`'s
// pk2 / pk3 (:2276-2277, 2340, 2471) use under RYUJIN_SEP=1 to synthesize a
// plane per offset from a VMEM-resident g2 block and an fz halo window.
//
// Bound: the kernels are bound by memory traffic, and the static planes
// are most of it: on the two-direction route pk1_stream reads 104 of them
// (c_ij 78, the mask 26), pk2_stream 107 (+ c_ii 3), pk3_stream 130 (+ m_ij
// 26), pk_up 26, each n = D * H * W values.  The factors are g2 [48, H, W]
// (0.98 MB in f32 at cylinder3d's (72, 40, 128), 1.77 MB at box3d's
// (72, 72, 128)) and fz [133, D]: they stay in the 50 MB L2.  In their
// place a live slot costs one multiply per plane (c_ij 3, the mask 1, m_ij
// 1) and, for cmax on the half-slot route, the transposed slot's three
// products and both norms.
//
// Design: plain read-only global loads, no shared-memory tile.  The fz
// value is uniform across the 128 threads of a block (one (z, y) row), so
// its load is one broadcast per warp; g2 is read at (y, x), neighbouring
// threads on neighbouring addresses, and is the same for every z.  Plane
// order is the JAX package's (pallas_step.py:1383-1395; solver/stencil.py
// writes it out): g2 holds c_ij at 3 q + c, m_ij at 27 + q, the mask at
// 36 + q and c_ii at 45 + c; fz holds c_ij at 3 k + c, m_ij at 78 + k, the
// mask at 104 + k and c_ii at 130 + c, with q = 3 (dy + 1) + dx + 1 the
// in-plane slot of offset k.  The synthesized mask is tested > 0 and read
// as 1 or 0: a dead edge has a zero factor, so its product is exactly 0,
// and a live one reads as the stored mask's 1.  Every product is one
// rounding, as f * g in the plain-torch synthesis (StructuredStencil.
// sep_plane); cmax squares and adds the components in order and takes the
// larger square root, as StructuredStencil.cmax_k.
#pragma once

#include "euler.cuh"

namespace ryujin {

template <typename T>
struct FullStatics {
  static constexpr bool kSeparable = false;
  const T* __restrict__ cij_;
  const T* __restrict__ cmax_;
  const T* __restrict__ mask_;
  const T* __restrict__ mij_;
  const T* __restrict__ cii_;
  // K read once, where the kernel starts: read at each use, PK3 loaded it
  // again after the stores of each slot (16 more instructions)
  const int K_;

  __device__ __forceinline__ FullStatics(const EqConsts<T>& e, const T* cij, const T* cmax,
                                         const T* mask, const T* mij, const T* cii, const T*,
                                         const T*)
      : cij_(cij), cmax_(cmax), mask_(mask), mij_(mij), cii_(cii), K_(e.K) {}

  __device__ __forceinline__ T cij(const Cell& c, const EqConsts<T>&, int d, int k) const {
    return cij_[(d * K_ + k) * c.n + c.i];
  }
  __device__ __forceinline__ T mask(const Cell& c, const EqConsts<T>&, int k) const {
    return mask_[k * c.n + c.i];
  }
  __device__ __forceinline__ T cmax(const Cell& c, const EqConsts<T>&, int k) const {
    return cmax_[k * c.n + c.i];
  }
  __device__ __forceinline__ T mij(const Cell& c, const EqConsts<T>&, int k) const {
    return mij_[k * c.n + c.i];
  }
  __device__ __forceinline__ T cii(const Cell& c, const EqConsts<T>&, int d) const {
    return cii_[d * c.n + c.i];
  }
};

template <typename T>
struct SepStatics {
  static constexpr bool kSeparable = true;
  const T* __restrict__ g2_;  // [48, H, W]
  const T* __restrict__ fz_;  // [133, D]
  // the canvas and K, read once where the kernel starts (as FullStatics::K_)
  const int K_, D_, H_, W_;

  __device__ __forceinline__ SepStatics(const EqConsts<T>& e, const T*, const T*, const T*,
                                        const T*, const T*, const T* g2, const T* fz)
      : g2_(g2), fz_(fz), K_(e.K), D_(e.D), H_(e.H), W_(e.W) {}

  __device__ __forceinline__ static int slot(const EqConsts<T>& e, int k) {
    return 3 * (e.dy[k] + 1) + e.dx[k] + 1;
  }
  // f[p](z) * g[q](y, x)
  __device__ __forceinline__ T prod(int z, int y, int x, int p, int q) const {
    return fz_[p * D_ + z] * g2_[(int64_t(q) * H_ + y) * W_ + x];
  }
  __device__ __forceinline__ T cij(const Cell& c, const EqConsts<T>& e, int d, int k) const {
    return prod(c.z, c.y, c.x, 3 * k + d, 3 * slot(e, k) + d);
  }
  __device__ __forceinline__ T mask(const Cell& c, const EqConsts<T>& e, int k) const {
    return prod(c.z, c.y, c.x, 4 * K_ + k, 36 + slot(e, k)) > T(0) ? T(1) : T(0);
  }
  __device__ __forceinline__ T mij(const Cell& c, const EqConsts<T>& e, int k) const {
    return prod(c.z, c.y, c.x, 3 * K_ + k, 27 + slot(e, k));
  }
  __device__ __forceinline__ T cii(const Cell& c, const EqConsts<T>&, int d) const {
    return prod(c.z, c.y, c.x, 5 * K_ + d, 45 + d);
  }
  // max(|c_ij|, |c_ji|): |c_k| at the cell against |c_{K-1-k}| at neighbour
  // k, whose coordinates wrap as the kernels' neighbour reads do.
  __device__ __forceinline__ T cmax(const Cell& c, const EqConsts<T>& e, int k) const {
    const int kt = K_ - 1 - k, q = slot(e, k), qt = slot(e, kt);
    int zj = c.z + e.dz[k], yj = c.y + e.dy[k], xj = c.x + e.dx[k];
    zj = zj < 0 ? zj + D_ : (zj >= D_ ? zj - D_ : zj);
    yj = yj < 0 ? yj + H_ : (yj >= H_ ? yj - H_ : yj);
    xj = xj < 0 ? xj + W_ : (xj >= W_ ? xj - W_ : xj);
    T ni = T(0), nj = T(0);
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const T a = prod(c.z, c.y, c.x, 3 * k + d, 3 * q + d);
      const T b = prod(zj, yj, xj, 3 * kt + d, 3 * qt + d);
      ni = d == 0 ? a * a : ni + a * a;
      nj = d == 0 ? b * b : nj + b * b;
    }
    return mx(sqrt(ni), sqrt(nj));
  }
};

}  // namespace ryujin
