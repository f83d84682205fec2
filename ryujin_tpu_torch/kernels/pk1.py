"""PK1: half-slot Riemann wavespeeds lambda [K/2, n] and the indicator
alpha [n] on the 2D reach-1 (K = 8) canvas (CUDA kernel csrc/pk1.cu, a
staged tile of launch shape tile(); TPU kernel pallas_step.py:2676)."""

from __future__ import annotations

import torch

from ..solver.hyperbolic import phase_e_alpha
from . import build


def pk1_reference(eq, p, ca, U, prec):
    """Plain torch: hyperbolic.phase_e_alpha(half=True) on the canvas."""
    st = ca.stencil
    return phase_e_alpha(eq, p, st, U, prec, st.nbr(U), st.nbr(prec))


TX = 32  # cells of a tile row (csrc/staged.cuh TILE_TX)
TY = 4  # rows of a tile


def tile(shape, K: int, dtype) -> build.Tile:
    """The launch shape of pk1 on a 2D [H, W] canvas with the K = 8
    offsets of reach 1: a block owns TY rows of TX cells, one thread a
    cell; it stages the tile and its halo of one cell, pk1_vals = 13
    values a staged cell (U and the parts of f(U), a, 1/rho, 1/p, log2 p
    and eta_j / rho_j), the 2D layout of pk1_stream's tile."""
    D, H, W = build.canvas_dims(shape)
    if len(shape) != 2 or build.reach_of(2, K) != 1:
        raise ValueError(f"pk1 takes the 2D reach-1 lattice, not K = {K} on {shape}")
    item = torch.empty((), dtype=dtype).element_size()
    smem = 13 * (TX + 2) * (TY + 2) * item
    return build.Tile((TX, TY, 1), 1, smem, (-(-W // TX), -(-H // TY), 1))


def pk1(eq, p, ca, U, prec):
    """(lam [K/2, n], alpha [n]) of the prepared state U [C, n] and its
    precomputed values prec [2, n] on the canvas `ca` (CanvasArrays).
    Masked slots hold lambda 0, padded cells alpha 0."""
    if not build.on_card(U):
        return pk1_reference(eq, p, ca, U, prec)
    build.check_reach1(ca)
    n, K = ca.n, ca.K
    build.check(U.device, U.dtype, {
        "U": (U, (eq.n_comp, n)),
        "prec": (prec, (eq.n_precomputed, n)),
        **build.statics(ca, ("g_cij", "g_mask", "g_node")),
    })
    lam = torch.empty((K // 2, n), dtype=U.dtype, device=U.device)
    alpha = torch.empty((n,), dtype=U.dtype, device=U.device)
    ptrs = [ca.g_cij, ca.g_mask, ca.g_node, U, prec, lam, alpha]
    build.launch(
        "pk1", U.dtype, [build.ptr(t) for t in ptrs],
        build.with_tile(build.consts(eq, p, ca), tile(ca.shape, K, U.dtype)),
    )
    pk1.launches += 1
    return lam, alpha


pk1.launches = 0
