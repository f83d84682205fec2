"""PK2: low-order update U_low, high-order right-hand side F and the
limiter bounds (CUDA kernel csrc/pk2.cu; TPU kernel pallas_step.py:2841)."""

from __future__ import annotations

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
    """Plain torch: the d rebuild + hyperbolic.phase_low_order on the canvas."""
    st = ca.stencil
    d = d_from_lambda(st, lam, ca.g_cmax.reshape(ca.K, -1))
    stage_U_j = [st.nbr(stage_U[s]) for s in range(len(stage_weights))]
    return phase_low_order(
        eq, p, st, U, prec, st.nbr(U), st.nbr(prec), d, alpha, st.nbr(alpha),
        tau, stage_U, stage_U_j, stage_weights,
    )


def pk2(eq, p, ca, U, prec, lam, alpha, stage_U, stage_weights, tau):
    """(U_low [C, n], F [C, n], bounds [3, n]).  stage_U [S, C, n] with
    the static weights stage_weights (S <= 2); tau a 0-d tensor on the
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
        **build.statics(ca, ("g_cij", "g_mask", "g_cmax", "g_cii", "g_node")),
    }
    if sU is not None:
        tensors["stage_U"] = (sU, sU.shape)
    build.check(U.device, U.dtype, tensors)
    kw = dict(dtype=U.dtype, device=U.device)
    U_low = torch.empty((C, n), **kw)
    F = torch.empty((C, n), **kw)
    bounds = torch.empty((eq.n_bounds, n), **kw)
    ptrs = [ca.g_cij, ca.g_mask, ca.g_cmax, ca.g_cii, ca.g_node, U, prec, lam,
            alpha, sU, tau, U_low, F, bounds]
    build.launch(
        "pk2", U.dtype, [build.ptr(t) for t in ptrs],
        build.consts(eq, p, ca, stage_weights),
    )
    pk2.launches += 1
    return U_low, F, bounds


pk2.launches = 0
