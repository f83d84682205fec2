"""PK1, slot-streaming form: the wavespeeds e and the indicator alpha [n]
for a 2D or 3D canvas of any lattice reach (CUDA kernel
csrc/pk1_stream.cu, a staged tile of launch shape tile(); TPU kernel
`_pk1_stream`, pallas_step.py:1904).

Two routes (`half`): the half-slot route writes the pre-scaled e = lambda
* cmax [K/2, n] (prescale), the two-direction route e = |c_ij| lambda
[K, n] on every slot (3D canvases whose coupling-boundary-pair set is too
large for the half-slot fixup, `sym` False in _step_slab, and 2D
multi-block canvases, whose interfaces break the slot pairing: the TPU
runs its stacked pk1 there with sym off, pallas_step.py:2709-2735).  With
separable statics (a 3D cG canvas) it launches the SEP instance, which
synthesizes c_ij, the mask and cmax per offset (_SepTile, pallas_step.py:
1092-1164, in _pk1_stream :1915-1917, 1974, 2003)."""

from __future__ import annotations

import torch

from . import build


def pk1_stream_reference(eq, p, ca, U, prec, half=True):
    """Plain torch: the per-offset loop on full canvases through the
    streaming indicator forms, summing over k = 0 .. K-1 in order."""
    st = ca.stencil
    K = st.K
    K_e = K // 2 if half else K
    tiny = torch.finfo(U.dtype).tiny
    U, prec = st.refresh_ghosts(U), st.refresh_ghosts(prec)
    f = eq.f(U)
    pa_i = eq.riemann_precompute(U)
    ind = eq.indicator_init(U, prec, f_i=f)
    left = right = None
    e = []
    for k, off in enumerate(st.offsets):
        U_jk = st.shift(U, off)
        c_k = st.cij_k(k)
        mask_k = st.mask_k(k)
        if k < K_e:
            norm_k = torch.sqrt(torch.sum(c_k * c_k, 0))
            n_k = c_k / torch.clamp_min(norm_k, tiny)[None]
            lam_k = eq.riemann_lambda_max(
                U, U_jk, n_k, pa_i=pa_i,
                pa_j=tuple(st.shift(x, off) for x in pa_i),
            )
            e_k = lam_k * st.cmax_k(k) if half else norm_k * lam_k
            e.append(torch.where(mask_k > 0, e_k, torch.zeros_like(e_k)))
        li, ri = eq.indicator_accum(
            ind, U_jk, st.shift(prec, off), st.shift(f, off), c_k, mask_k
        )
        left = li if left is None else left + li
        right = ri if right is None else right + ri
    hd_i = st.m_lumped * st.measure_inv
    alpha = eq.indicator_finalize(ind, left, right, hd_i, p.evc_factor)
    alpha = torch.where(st.node_mask > 0, alpha, torch.zeros_like(alpha))
    return torch.stack(e), alpha


TX = 32  # cells of a tile row (csrc/staged.cuh TILE_TX)


def tile(shape, K: int, dtype) -> build.Tile:
    """The launch shape of pk1_stream on a 2D [H, W] or 3D [D, H, W] canvas
    with K lattice offsets: a block owns TY rows of TX cells (in 3D at TZ
    consecutive z), one thread a cell; it stages the tile and its halo of
    the lattice reach, pk1_vals values a staged cell (U and the parts of
    f(U), the Riemann precompute's a, 1/rho, 1/p and log2 p, eta_j /
    rho_j).  (TY, TZ): (2, 2) in 3D, (4, 1) in 2D, the fastest of the
    tiles timed on the bench cells, or within 2 % of it (PERF.md §6).  The
    SEP instances launch one thread a cell and read no tile."""
    dim = len(shape)
    D, H, W = build.canvas_dims(shape)
    h = build.reach_of(dim, K)
    item = torch.empty((), dtype=dtype).element_size()
    ty, tz = (4, 1) if dim == 2 else (2, 2)
    staged = (TX + 2 * h) * (ty + 2 * h) * (tz + 2 * h if dim == 3 else 1)
    vals = (2 * dim + 4) + 5
    grid = (-(-W // TX), -(-H // ty), -(-D // tz) if dim == 3 else 1)
    return build.Tile((TX, ty, tz), h, vals * staged * item, grid)


def pk1_stream(eq, p, ca, U, prec, half=True):
    """(e, alpha [n]) of the prepared state U [C, n] and its precomputed
    values prec [2, n] on the canvas `ca` (CanvasArrays): e = lambda * cmax
    [K/2, n] with `half`, e = |c_ij| lambda [K, n] without.  Masked slots
    hold e = 0, padded cells alpha = 0."""
    if not build.on_card(U):
        return pk1_stream_reference(eq, p, ca, U, prec, half)
    n, K = ca.n, ca.K
    c = build.with_tile(build.consts(eq, p, ca, half=half),
                        tile(ca.shape, K, U.dtype))
    build.check(U.device, U.dtype, {
        "U": (U, (eq.n_comp, n)),
        "prec": (prec, (eq.n_precomputed, n)),
        **build.statics(ca, ("g_cij", "g_cmax", "g_mask", "g_node",
                             "g_sep2", "f_sepz")),
    })
    e = torch.empty((K // 2 if half else K, n), dtype=U.dtype, device=U.device)
    alpha = torch.empty((n,), dtype=U.dtype, device=U.device)
    ptrs = [ca.g_cij, ca.g_cmax if half else None, ca.g_mask, ca.g_node, U,
            prec, e, alpha, ca.g_sep2, ca.f_sepz]
    build.launch("pk1_stream", U.dtype, [build.ptr(t) for t in ptrs], c)
    pk1_stream.launches += 1
    # the SEP instance's own count
    pk1_stream.sep_launches += int(ca.separable)
    return e, alpha


pk1_stream.launches = pk1_stream.sep_launches = 0
