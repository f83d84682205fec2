"""The port's own copy of ryujin_tpu/offline/separable.py (plain numpy; the
port imports nothing of ryujin_tpu).  The original header follows, with
the reference named by its source file.

Separable static canvases for extruded 3D meshes.

The reference streams its full CSR stencil coefficients through the hot
loop for every mesh (ryujin's source/sparse_matrix_simd.h:40-147);
on TPU the analogous full-canvas statics (c_ij, m_ij, mask) dominate the
HBM traffic of the fused 3D kernels: 26 offsets x (3+1+1) planes of
[D, H, W] read per substep.

For a 3D mesh that is an *extrusion* of a 2D mesh along the canvas major
axis z — the Mach-3 box, the cylinder o-grid x z benchmark, any
tensor-product lattice — every Q1 stencil coefficient factors exactly:

    c_ij^xy(z, y, x) = mz[k](z) * c2^xy[k2d](y, x)    (1D mass x 2D c)
    c_ij^z (z, y, x) = dz[k](z) * m2[k2d](y, x)       (1D deriv x 2D mass)
    m_ij   (z, y, x) = mz[k](z) * m2[k2d](y, x)
    mask   (z, y, x) = maskz[k](z) * mask2[k2d](y, x)

because the trilinear shape functions and the cell set are products of a
2D and a 1D structure (this includes graded spacing in any axis and
boundary-clipped stencils).  The factorization below is purely
*numerical* — per offset k it extracts a shared 2D field g[k2d](y, x)
(k2d = the in-plane part of the offset) and per-k z-profiles f[k](z)
with field == f ⊗ g verified to ~1e-9, so it holds for exactly the
meshes where the algebra holds and safely returns None otherwise
(AMR-refined, true 3D curvilinear, ...).

The Pallas stepper then keeps the ~40 small 2D fields VMEM-resident and
synthesizes c_ij / m_ij / mask / |c|max per offset with one broadcast
multiply each, eliminating the static-canvas HBM traffic entirely.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

# relative tolerance of the rank-1 reconstruction check (the fields are
# exact algebraic products in f64; 1e-9 leaves ~6 decades of slack above
# f64 roundoff while guaranteeing f32-exactness of the synthesis)
_RTOL = 1e-9

# in-plane offset slot: k2d = (dy + 1) * 3 + (dx + 1), K2D = 9 slots
# (the (0, 0) slot is used by the pure-z offsets)
K2D = 9


@dataclasses.dataclass
class SepZ:
    """Separable-statics factors on the canvas [D, H, W] (z = axis 0).

    2D fields are shared across the three z-layers of an offset column
    (indexed by k2d); z-profiles are per offset k (and per component
    for c_ij).  `sd.offsets[k] = (dz, dy, dx)`.
    """

    dim: int
    K: int
    shape: Tuple[int, int, int]
    k2d: np.ndarray  # [K] in-plane slot per offset
    dz: np.ndarray  # [K] z-shift per offset

    g_cij: np.ndarray  # [K2D, dim, H, W]
    f_cij: np.ndarray  # [K, dim, D]
    g_mij: np.ndarray  # [K2D, H, W]
    f_mij: np.ndarray  # [K, D]
    g_mask: np.ndarray  # [K2D, H, W]
    f_mask: np.ndarray  # [K, D]
    g_cii: np.ndarray  # [dim, H, W]
    f_cii: np.ndarray  # [dim, D]


def _shared_rank1(stack: np.ndarray) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Factor stack [n, D, HW] as f[n, D] x g[HW] (g shared across n).

    Returns None unless the reconstruction is exact to _RTOL relative to
    the stack's max magnitude.  All-zero stacks factor as (0, 0).
    """
    n, D, HW = stack.shape
    M = stack.reshape(n * D, HW)
    scale = np.abs(M).max()
    if scale == 0.0:
        return np.zeros((n, D)), np.zeros(HW)
    # seed g with the largest row, refine by one least-squares sweep
    r0 = int(np.argmax(np.abs(M).sum(axis=1)))
    g = M[r0]
    gg = float(g @ g)
    f = (M @ g) / gg
    # one power-iteration style refinement tightens f/g against roundoff
    ff = float(f @ f)
    if ff > 0.0:
        g = (f @ M) / ff
        gg = float(g @ g)
        if gg == 0.0:
            return None
        f = (M @ g) / gg
    err = np.abs(f[:, None] * g[None, :] - M).max()
    if err > _RTOL * scale:
        return None
    return f.reshape(n, D), g


def separate_z(sd) -> Optional[SepZ]:
    """Try to factor the packed stencil statics along canvas axis 0.

    sd: StructuredData with dim == 3 (offline/structured.py).  Returns
    None when any field fails the exact rank-1 check (the mesh is not an
    extrusion along the canvas major axis).
    """
    if sd.dim != 3:
        return None
    D, H, W = sd.shape
    K, dim = sd.max_degree, sd.dim
    HW = H * W

    offsets = [tuple(o) for o in sd.offsets]
    k2d = np.array([(o[1] + 1) * 3 + (o[2] + 1) for o in offsets])
    dzs = np.array([o[0] for o in offsets])

    cij = np.moveaxis(
        np.asarray(sd.cij, np.float64).reshape((D, HW, K, dim)), (2, 3), (0, 1)
    )  # [K, dim, D, HW]
    mij = np.moveaxis(
        np.asarray(sd.mij, np.float64).reshape((D, HW, K)), 2, 0
    )  # [K, D, HW]
    mask = np.moveaxis(
        np.asarray(sd.mask, np.float64).reshape((D, HW, K)), 2, 0
    )
    cii = np.moveaxis(
        np.asarray(sd.cii, np.float64).reshape((D, HW, dim)), 2, 0
    )  # [dim, D, HW]

    g_cij = np.zeros((K2D, dim, H, W))
    f_cij = np.zeros((K, dim, D))
    g_mij = np.zeros((K2D, H, W))
    f_mij = np.zeros((K, D))
    g_mask = np.zeros((K2D, H, W))
    f_mask = np.zeros((K, D))

    for q in range(K2D):
        ks = np.flatnonzero(k2d == q)
        if len(ks) == 0:
            continue
        for c in range(dim):
            r = _shared_rank1(cij[ks, c])
            if r is None:
                return None
            f_cij[ks, c], g = r
            g_cij[q, c] = g.reshape(H, W)
        r = _shared_rank1(mij[ks])
        if r is None:
            return None
        f_mij[ks], g = r
        g_mij[q] = g.reshape(H, W)
        r = _shared_rank1(mask[ks])
        if r is None:
            return None
        f_mask[ks], g = r
        g_mask[q] = g.reshape(H, W)

    g_cii = np.zeros((dim, H, W))
    f_cii = np.zeros((dim, D))
    for c in range(dim):
        r = _shared_rank1(cii[c : c + 1])
        if r is None:
            return None
        f_cii[c] = r[0][0]
        g_cii[c] = r[1].reshape(H, W)

    return SepZ(
        dim=dim, K=K, shape=(D, H, W), k2d=k2d, dz=dzs,
        g_cij=g_cij, f_cij=f_cij,
        g_mij=g_mij, f_mij=f_mij,
        g_mask=g_mask, f_mask=f_mask,
        g_cii=g_cii, f_cii=f_cii,
    )
