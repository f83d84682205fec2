"""PK3, slot-streaming form: antidiffusive fluxes P with the edge mask
folded in, the first limiter pass l and the per-node success flag okp for
a 2D or 3D canvas of any lattice reach, from the wavespeeds e of PK1 on
either route (CUDA kernel csrc/pk3_stream.cu; TPU kernels `pk3_stream`
with prescale, pallas_step.py:3093, and `_step_slab`'s pk3, :2409).  On a
dG canvas the high-order viscosity factor of each slot is at least the
incidence beta_ij (pallas_step.py:3167-3171).  With separable statics (a
3D cG canvas) it launches the SEP instance, which synthesizes c_ij, m_ij
and the mask (_SepTile in _step_slab, :2276-2277, 2471)."""

from __future__ import annotations

import collections

import torch

from . import build
from .pk2 import stage_tensor
from .pk2_stream import slot_d, slot_factor


def pk3_stream_reference(eq, p, ca, U, e, alpha, F, U_low, bounds, stage_U,
                         stage_weights, tau, half=True):
    """Plain torch: the per-offset loop on full canvases; P_k and l_k are
    stored slot by slot, 0 on masked slots."""
    st = ca.stencil
    ws = list(stage_weights)
    weight = 1.0 - sum(ws)
    U, e, alpha, F = map(st.refresh_ghosts, (U, e, alpha, F))
    f = eq.f(U)
    f_s = [eq.f(st.refresh_ghosts(stage_U[s])) for s in range(len(ws))]
    pfac = tau * st.m_lumped_inv * st.n_nbrs
    psi0 = eq.limiter_psi0(bounds, U_low)
    real = st.node_mask > 0
    P = torch.empty((eq.n_comp, st.K, U.shape[-1]), dtype=U.dtype,
                    device=U.device)
    l = torch.empty((st.K, U.shape[-1]), dtype=U.dtype, device=U.device)
    okp = torch.ones_like(alpha)
    for k, off in enumerate(st.offsets):
        c_k = st.cij_k(k)
        on = st.live_k(k)
        d_k = slot_d(st, e, k, half)
        flux_ij_k = eq.flux_divergence(f, st.shift(f, off), c_k)
        dH_k = d_k * slot_factor(st, alpha, k)
        P_k = (weight - 1.0) * flux_ij_k + (dH_k - d_k)[None] * (
            st.shift(U, off) - U
        )
        for s, w_s in enumerate(ws):
            P_k = P_k + w_s * eq.flux_divergence(
                f_s[s], st.shift(f_s[s], off), c_k
            )
        m_k = st.mij_k(k)
        b_ij_k = -m_k / st.shift(st.m_lumped, off)
        b_ji_k = -m_k * st.m_lumped_inv
        P_k = P_k + b_ij_k[None] * st.shift(F, off) - b_ji_k[None] * F
        P_k = P_k * pfac[None]
        l_k, succ_k = eq.limiter_limit(
            bounds, U_low, P_k, psi0,
            newton_iterations=p.limiter_newton_max_iterations,
            newton_tol=p.limiter_newton_tolerance,
        )
        okp = torch.minimum(
            okp, torch.where(on & real, succ_k.to(U.dtype), torch.ones_like(okp))
        )
        P[:, k] = torch.where(on[None], P_k, torch.zeros_like(P_k))
        l[k] = torch.where(on, l_k, torch.zeros_like(l_k))
    return P, l, okp


TX = 32  # cells of a tile row (csrc/staged.cuh TILE_TX)


def tile(shape, K: int, dtype, n_stages: int) -> build.Tile:
    """The launch shape of pk3_stream on a 2D [H, W] or 3D [D, H, W]
    canvas with K lattice offsets at `n_stages` stages: a block owns TY rows
    of TX cells (in 3D at one z), G threads a cell; it stages the tile
    and its halo of the lattice reach, pk3_vals values a staged cell (U and
    the parts of f(U), per stage the parts of f(sU_s), F, m_j, alpha_j)
    and one flag a tile cell.  (TY, G): (4, 2) in 3D (2, 2 in f64:
    108 KB at two stages, 162 at (4, 2)), (4, 1) in 2D, the fastest of the
    tiles timed on the bench cells (PERF.md §6).  The same tile holds four
    stages: in 3D f64 160,192 bytes, within build.SMEM_MAX."""
    dim = len(shape)
    D, H, W = build.canvas_dims(shape)
    h = build.reach_of(dim, K)
    item = torch.empty((), dtype=dtype).element_size()
    ty = 4 if dim == 2 or item == 4 else 2
    groups = 2 if dim == 3 else 1
    staged = (TX + 2 * h) * (ty + 2 * h) * (1 + 2 * h if dim == 3 else 1)
    vals = (2 * dim + 4) + n_stages * (2 * dim + 2) + dim + 4
    smem = vals * staged * item + ty * TX * 4
    grid = (-(-W // TX), -(-H // ty), D if dim == 3 else 1)
    return build.Tile((TX, ty, groups), h, smem, grid)


def pk3_stream(eq, p, ca, U, e, alpha, F, U_low, bounds, stage_U,
               stage_weights, tau, half=True):
    """(P [C, K, n], l [K, n], okp [n]) from PK1's e on the route `half`
    (as pk2_stream).  P and l are 0 on masked slots."""
    if not build.on_card(U):
        return pk3_stream_reference(
            eq, p, ca, U, e, alpha, F, U_low, bounds, stage_U, stage_weights,
            tau, half,
        )
    n, K, C = ca.n, ca.K, eq.n_comp
    c = build.with_tile(
        build.consts(eq, p, ca, stage_weights, half),
        tile(ca.shape, K, U.dtype, len(stage_weights)),
    )
    sU = stage_tensor(stage_U, stage_weights, C, n)
    tensors = {
        "U": (U, (C, n)),
        "e": (e, (K // 2 if half else K, n)),
        "alpha": (alpha, (n,)),
        "F": (F, (C, n)),
        "U_low": (U_low, (C, n)),
        "bounds": (bounds, (eq.n_bounds, n)),
        "tau": (tau, ()),
        **build.statics(ca, ("g_cij", "g_mij", "g_mask", "g_inc", "g_node",
                             "g_sep2", "f_sepz")),
    }
    if sU is not None:
        tensors["stage_U"] = (sU, sU.shape)
    build.check(U.device, U.dtype, tensors)
    kw = dict(dtype=U.dtype, device=U.device)
    P = torch.empty((C, K, n), **kw)
    l = torch.empty((K, n), **kw)
    okp = torch.empty((n,), **kw)
    ptrs = [ca.g_cij, ca.g_mij, ca.g_mask, ca.g_inc, ca.g_node, U, e, alpha,
            F, U_low, bounds, sU, tau, P, l, okp, ca.g_sep2, ca.f_sepz]
    build.launch("pk3_stream", U.dtype, [build.ptr(t) for t in ptrs], c)
    pk3_stream.launches += 1
    pk3_stream.stage_launches[len(stage_weights)] += 1
    # the SEP instance's own count
    pk3_stream.sep_launches += int(ca.separable)
    return P, l, okp


pk3_stream.launches = pk3_stream.sep_launches = 0
# launches by the number of stage slots (the instances of at most 2 slots
# take 0-2, those of build.MAX_STAGES 3-4)
pk3_stream.stage_launches = collections.Counter()
