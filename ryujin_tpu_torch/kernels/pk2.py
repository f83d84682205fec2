"""PK2: low-order update U_low, high-order right-hand side F and the
limiter bounds on the 2D reach-1 (K = 8) canvas (CUDA kernel csrc/pk2.cu,
a staged tile of launch shape tile(); TPU kernel pallas_step.py:2841).
On a dG canvas the kernel also reads the incidence planes g_inc."""

from __future__ import annotations

import collections

import torch

from ..solver.hyperbolic import d_from_lambda, phase_low_order
from . import build


def stage_tensor(stage_U, stage_weights, C, n):
    """The [S, C, n] stage states as the kernels take them (None for S = 0)."""
    S = len(stage_weights)
    if S == 0:
        return None
    if stage_U is None or tuple(stage_U.shape) != (S, C, n):
        raise ValueError(f"stage_U must have shape {(S, C, n)}")
    return stage_U


def pk2_reference(eq, p, ca, U, prec, lam, alpha, stage_U, stage_weights, tau):
    """Plain torch: the d rebuild + hyperbolic.phase_low_order on the
    canvas (with the dG factor where the canvas has incidence)."""
    st = ca.stencil
    d = d_from_lambda(st, lam, ca.g_cmax.reshape(ca.K, -1))
    stage_U_j = [st.nbr(stage_U[s]) for s in range(len(stage_weights))]
    return phase_low_order(
        eq, p, st, U, prec, st.nbr(U), st.nbr(prec), d, alpha, st.nbr(alpha),
        tau, stage_U, stage_U_j, stage_weights,
    )


TX = 32  # cells of a tile row (csrc/staged.cuh TILE_TX)
TY = 4  # rows of a tile


def tile(shape, K: int, dtype, n_stages: int) -> build.Tile:
    """The launch shape of pk2 on a 2D [H, W] canvas with the K = 8
    offsets of reach 1 at `n_stages` stages: a block owns TY rows of TX
    cells, one thread a cell; it stages the tile and its halo of one cell,
    pk2_vals + 4 values a staged cell (U and the parts of f(U), alpha_j,
    s_j, per stage the parts of f(sU_s), the 4 half-slot lambda planes),
    the layout of pk2_stream's tile with the lambda planes after it: at
    four stages 38 values, 62,016 bytes in f64."""
    D, H, W = build.canvas_dims(shape)
    if len(shape) != 2 or build.reach_of(2, K) != 1:
        raise ValueError(f"pk2 takes the 2D reach-1 lattice, not K = {K} on {shape}")
    item = torch.empty((), dtype=dtype).element_size()
    vals = 8 + 2 + 4 + n_stages * 6
    smem = vals * (TX + 2) * (TY + 2) * item
    return build.Tile((TX, TY, 1), 1, smem, (-(-W // TX), -(-H // TY), 1))


def pk2(eq, p, ca, U, prec, lam, alpha, stage_U, stage_weights, tau):
    """(U_low [C, n], F [C, n], bounds [3, n]).  stage_U [S, C, n] with
    the static weights stage_weights (S <= build.MAX_STAGES: the instance
    of at most 2 slots up to 2, of 4 above); tau a 0-d tensor on the
    device, read by the kernel (no host sync)."""
    if not build.on_card(U):
        return pk2_reference(
            eq, p, ca, U, prec, lam, alpha, stage_U, stage_weights, tau
        )
    build.check_reach1(ca)
    n, K, C = ca.n, ca.K, eq.n_comp
    sU = stage_tensor(stage_U, stage_weights, C, n)
    tensors = {
        "U": (U, (C, n)),
        "prec": (prec, (eq.n_precomputed, n)),
        "lam": (lam, (K // 2, n)),
        "alpha": (alpha, (n,)),
        "tau": (tau, ()),
        **build.statics(
            ca, ("g_cij", "g_mask", "g_inc", "g_cmax", "g_cii", "g_node")
        ),
    }
    if sU is not None:
        tensors["stage_U"] = (sU, sU.shape)
    build.check(U.device, U.dtype, tensors)
    kw = dict(dtype=U.dtype, device=U.device)
    U_low = torch.empty((C, n), **kw)
    F = torch.empty((C, n), **kw)
    bounds = torch.empty((eq.n_bounds, n), **kw)
    ptrs = [ca.g_cij, ca.g_mask, ca.g_inc, ca.g_cmax, ca.g_cii, ca.g_node, U,
            prec, lam, alpha, sU, tau, U_low, F, bounds]
    build.launch(
        "pk2", U.dtype, [build.ptr(t) for t in ptrs],
        build.with_tile(build.consts(eq, p, ca, stage_weights),
                        tile(ca.shape, K, U.dtype, len(stage_weights))),
    )
    pk2.launches += 1
    pk2.stage_launches[len(stage_weights)] += 1
    return U_low, F, bounds


pk2.launches = 0
# launches by the number of stage slots (the instance of at most 2 slots
# takes 0-2, that of build.MAX_STAGES 3-4)
pk2.stage_launches = collections.Counter()
