"""PK2, slot-streaming form: low-order update U_low, high-order right-hand
side F and the limiter bounds for a 2D or 3D canvas of any lattice reach,
from the wavespeeds e of PK1 on either route (CUDA kernel
csrc/pk2_stream.cu; TPU kernels `pk2_stream` with prescale,
pallas_step.py:2879, and `_step_slab`'s pk2, :2317).  On a dG canvas the
high-order viscosity factor of each slot is at least the incidence
beta_ij (`slot_factor`; pallas_step.py:2942-2944).  With separable
statics (a 3D cG canvas) it launches the SEP instance, which synthesizes
c_ij, the mask and c_ii (_SepTile in _step_slab, :2276-2277, 2340)."""

from __future__ import annotations

import collections

import torch

from ..equations.euler import on_mask
from . import build
from .pk2 import stage_tensor


def slot_d(st, e, k, half=True):
    """The graph viscosity d of slot k (_slot_d, pallas_step.py:2056): from
    the pre-scaled half-slot e [K/2, n], e_k at the node for k < K/2 and
    plane K-1-k of neighbour k otherwise; from the two-direction e [K, n],
    the larger of the two.  0 on masked slots."""
    K = st.K
    if half:
        d_k = e[k] if k < K // 2 else st.shift(e[K - 1 - k], st.offsets[k])
    else:
        d_k = torch.maximum(e[k], st.shift(e[K - 1 - k], st.offsets[k]))
    return torch.where(st.live_k(k), d_k, 0.0)


def slot_factor(st, alpha, k):
    """The high-order viscosity factor of slot k [n]: 1/2 (alpha_i +
    alpha_j), and on a dG canvas at least the incidence beta_ij (the
    per-slot form of hyperbolic.viscosity_factor)."""
    factor = 0.5 * (alpha + st.shift(alpha, st.offsets[k]))
    if st.incidence is not None:
        factor = torch.maximum(factor, st.incidence[k])
    return factor


def pk2_stream_reference(eq, p, ca, U, prec, e, alpha, stage_U, stage_weights,
                         tau, half=True):
    """Plain torch: the per-offset loop on full canvases with running
    sums and the streaming bounds forms, k = 0 .. K-1 in order and the
    diagonal terms last."""
    st = ca.stencil
    ws = list(stage_weights)
    weight = 1.0 - sum(ws)
    regularization = 100.0 * torch.finfo(U.dtype).tiny
    U, prec, e, alpha = map(st.refresh_ghosts, (U, prec, e, alpha))
    f = eq.f(U)
    cii = st.c_ii()
    flux_ii = eq.flux_divergence(f, f, cii)
    f_s = [eq.f(st.refresh_ghosts(stage_U[s])) for s in range(len(ws))]
    low_acc = torch.zeros_like(U)
    F_acc = torch.zeros_like(U)
    bst = eq.limiter_bounds_init(U, prec)
    for k, off in enumerate(st.offsets):
        U_jk = st.shift(U, off)
        c_k = st.cij_k(k)
        mask_k = st.mask_k(k)
        d_k = slot_d(st, e, k, half)
        flux_ij_k = eq.flux_divergence(f, st.shift(f, off), c_k)
        dU_k = U_jk - U
        dH_k = d_k * slot_factor(st, alpha, k)
        low_acc = low_acc + on_mask(flux_ij_k + d_k[None] * dU_k,
                                    mask_k[None])
        F_acc = F_acc + on_mask(dH_k[None] * dU_k + weight * flux_ij_k,
                                mask_k[None])
        for s, w_s in enumerate(ws):
            F_acc = F_acc + on_mask(w_s * eq.flux_divergence(
                f_s[s], st.shift(f_s[s], off), c_k
            ), mask_k[None])
        scaled_c_k = c_k / torch.clamp_min(d_k, regularization)[None]
        bst = eq.limiter_bounds_accum(
            bst, U_jk, st.shift(prec, off), scaled_c_k, mask_k
        )
    U_low = U + (tau * st.m_lumped_inv)[None] * (low_acc + flux_ii)
    F = F_acc + weight * flux_ii
    for s, w_s in enumerate(ws):
        F = F + w_s * eq.flux_divergence(f_s[s], f_s[s], cii)
    hd_i = st.m_lumped * st.measure_inv
    bounds = eq.limiter_bounds_finalize(bst, hd_i, p.limiter_relaxation_factor)
    return U_low, F, bounds


TX = 32  # cells of a tile row (csrc/staged.cuh TILE_TX)


def tile(shape, K: int, dtype, n_stages: int) -> build.Tile:
    """The launch shape of pk2_stream on a 2D [H, W] or 3D [D, H, W] canvas
    with K lattice offsets at `n_stages` stages: a block owns TY rows of TX
    cells (in 3D at TZ consecutive z), one thread a cell; it stages the
    tile and its halo of the lattice reach, pk2_vals values a staged cell
    (U and the parts of f(U), alpha_j, s_j, per stage the parts of
    f(sU_s)).  (TY, TZ): (4, 2) in 3D (2, 2 in f64: 122 KB at two stages,
    183 at (4, 2)), (4, 1) in 2D, the fastest of the tiles timed on the
    bench cells (PERF.md §6).  The same tile holds four stages: in 3D
    f64 191,488 bytes, within build.SMEM_MAX."""
    dim = len(shape)
    D, H, W = build.canvas_dims(shape)
    h = build.reach_of(dim, K)
    item = torch.empty((), dtype=dtype).element_size()
    ty, tz = (4, 1) if dim == 2 else ((4, 2) if item == 4 else (2, 2))
    staged = (TX + 2 * h) * (ty + 2 * h) * (tz + 2 * h if dim == 3 else 1)
    vals = (2 * dim + 4) + 2 + n_stages * (2 * dim + 2)
    grid = (-(-W // TX), -(-H // ty), -(-D // tz) if dim == 3 else 1)
    return build.Tile((TX, ty, tz), h, vals * staged * item, grid)


def pk2_stream(eq, p, ca, U, prec, e, alpha, stage_U, stage_weights, tau,
               half=True):
    """(U_low [C, n], F [C, n], bounds [3, n]).  e is PK1's output on the
    route `half`: pre-scaled [K/2, n] after the boundary-pair fixup, or
    two-direction [K, n]; stage_U [S, C, n] with the static weights
    stage_weights (S <= build.MAX_STAGES: the instances of at most 2
    slots up to 2, of 4 above); tau a 0-d tensor on the device, read by
    the kernel (no host sync)."""
    if not build.on_card(U):
        return pk2_stream_reference(
            eq, p, ca, U, prec, e, alpha, stage_U, stage_weights, tau, half
        )
    n, K, C = ca.n, ca.K, eq.n_comp
    c = build.with_tile(
        build.consts(eq, p, ca, stage_weights, half),
        tile(ca.shape, K, U.dtype, len(stage_weights)),
    )
    sU = stage_tensor(stage_U, stage_weights, C, n)
    tensors = {
        "U": (U, (C, n)),
        "prec": (prec, (eq.n_precomputed, n)),
        "e": (e, (K // 2 if half else K, n)),
        "alpha": (alpha, (n,)),
        "tau": (tau, ()),
        **build.statics(ca, ("g_cij", "g_mask", "g_inc", "g_cii", "g_node",
                             "g_sep2", "f_sepz")),
    }
    if sU is not None:
        tensors["stage_U"] = (sU, sU.shape)
    build.check(U.device, U.dtype, tensors)
    kw = dict(dtype=U.dtype, device=U.device)
    U_low = torch.empty((C, n), **kw)
    F = torch.empty((C, n), **kw)
    bounds = torch.empty((eq.n_bounds, n), **kw)
    ptrs = [ca.g_cij, ca.g_mask, ca.g_inc, ca.g_cii, ca.g_node, U, prec, e,
            alpha, sU, tau, U_low, F, bounds, ca.g_sep2, ca.f_sepz]
    build.launch("pk2_stream", U.dtype, [build.ptr(t) for t in ptrs], c)
    pk2_stream.launches += 1
    pk2_stream.stage_launches[len(stage_weights)] += 1
    # the SEP instance's own count
    pk2_stream.sep_launches += int(ca.separable)
    return U_low, F, bounds


pk2_stream.launches = pk2_stream.sep_launches = 0
# launches by the number of stage slots (the instances of at most 2 slots
# take 0-2, those of build.MAX_STAGES 3-4)
pk2_stream.stage_launches = collections.Counter()
