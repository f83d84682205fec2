"""PK3: antidiffusive fluxes P, the first limiter pass l and the per-node
success flag okp (CUDA kernel csrc/pk3.cu; TPU kernel pallas_step.py:3044)."""

from __future__ import annotations

import torch

from ..solver.hyperbolic import d_from_lambda, phase_p_l1
from . import build
from .pk2 import stage_tensor


def pk3_reference(eq, p, ca, U, lam, alpha, F, U_low, bounds, stage_U,
                  stage_weights, tau):
    """Plain torch: the d rebuild + hyperbolic.phase_p_l1 on the canvas,
    okp = min of success over the live edges of each node."""
    st = ca.stencil
    d = d_from_lambda(st, lam, ca.g_cmax.reshape(ca.K, -1))
    stage_U_j = [st.nbr(stage_U[s]) for s in range(len(stage_weights))]
    P, l, success = phase_p_l1(
        eq, p, st, U, st.nbr(U), d, alpha, st.nbr(alpha), tau, F, st.nbr(F),
        st.nbr(st.m_lumped), U_low, bounds, stage_U, stage_U_j, stage_weights,
    )
    live = (st.mask > 0) & (st.node_mask[None] > 0)
    okp = torch.amin(
        torch.where(live, success.to(U.dtype), torch.ones_like(st.mask)), 0
    )
    return P, l, okp


def pk3(eq, p, ca, U, lam, alpha, F, U_low, bounds, stage_U, stage_weights,
        tau):
    """(P [C, K, n], l [K, n], okp [n]).  P and l are 0 on masked slots."""
    if not build.on_card(U):
        return pk3_reference(
            eq, p, ca, U, lam, alpha, F, U_low, bounds, stage_U,
            stage_weights, tau,
        )
    build.check_reach1(ca)
    n, K, C = ca.n, ca.K, eq.n_comp
    sU = stage_tensor(stage_U, stage_weights, C, n)
    tensors = {
        "U": (U, (C, n)),
        "lam": (lam, (K // 2, n)),
        "alpha": (alpha, (n,)),
        "F": (F, (C, n)),
        "U_low": (U_low, (C, n)),
        "bounds": (bounds, (eq.n_bounds, n)),
        "tau": (tau, ()),
        **build.statics(
            ca, ("g_cij", "g_cmax", "g_mij", "g_mask", "g_node")
        ),
    }
    if sU is not None:
        tensors["stage_U"] = (sU, sU.shape)
    build.check(U.device, U.dtype, tensors)
    kw = dict(dtype=U.dtype, device=U.device)
    P = torch.empty((C, K, n), **kw)
    l = torch.empty((K, n), **kw)
    okp = torch.empty((n,), **kw)
    ptrs = [ca.g_cij, ca.g_cmax, ca.g_mij, ca.g_mask, ca.g_node, U, lam, alpha,
            F, U_low, bounds, sU, tau, P, l, okp]
    build.launch(
        "pk3", U.dtype, [build.ptr(t) for t in ptrs],
        build.consts(eq, p, ca, stage_weights),
    )
    pk3.launches += 1
    return P, l, okp


pk3.launches = 0
