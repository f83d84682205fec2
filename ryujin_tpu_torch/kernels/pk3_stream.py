"""PK3, slot-streaming form: antidiffusive fluxes P with the edge mask
folded in, the first limiter pass l and the per-node success flag okp for
a canvas of any lattice reach (CUDA kernel csrc/pk3_stream.cu; TPU kernel
`pk3_stream` with prescale, pallas_step.py:3093)."""

from __future__ import annotations

import torch

from . import build
from .pk2 import stage_tensor
from .pk2_stream import slot_d


def pk3_stream_reference(eq, p, ca, U, e, alpha, F, U_low, bounds, stage_U,
                         stage_weights, tau):
    """Plain torch: the per-offset loop on full canvases; P_k and l_k are
    stored slot by slot, 0 on masked slots."""
    st = ca.stencil
    ws = list(stage_weights)
    weight = 1.0 - sum(ws)
    f = eq.f(U)
    f_s = [eq.f(stage_U[s]) for s in range(len(ws))]
    pfac = tau * st.m_lumped_inv * st.n_nbrs
    psi0 = eq.limiter_psi0(bounds, U_low)
    real = st.node_mask > 0
    P = torch.empty((eq.n_comp, st.K, U.shape[-1]), dtype=U.dtype,
                    device=U.device)
    l = torch.empty((st.K, U.shape[-1]), dtype=U.dtype, device=U.device)
    okp = torch.ones_like(alpha)
    for k, off in enumerate(st.offsets):
        c_k = st.cij[:, k]
        on = st.mask[k] > 0
        d_k = slot_d(st, e, k)
        flux_ij_k = eq.flux_divergence(f, st.shift(f, off), c_k)
        dH_k = d_k * (0.5 * (alpha + st.shift(alpha, off)))
        P_k = (weight - 1.0) * flux_ij_k + (dH_k - d_k)[None] * (
            st.shift(U, off) - U
        )
        for s, w_s in enumerate(ws):
            P_k = P_k + w_s * eq.flux_divergence(
                f_s[s], st.shift(f_s[s], off), c_k
            )
        b_ij_k = -st.mij[k] / st.shift(st.m_lumped, off)
        b_ji_k = -st.mij[k] * st.m_lumped_inv
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


def pk3_stream(eq, p, ca, U, e, alpha, F, U_low, bounds, stage_U,
               stage_weights, tau):
    """(P [C, K, n], l [K, n], okp [n]).  P and l are 0 on masked slots."""
    if not build.on_card(U):
        return pk3_stream_reference(
            eq, p, ca, U, e, alpha, F, U_low, bounds, stage_U, stage_weights,
            tau,
        )
    n, K, C = ca.n, ca.K, eq.n_comp
    sU = stage_tensor(stage_U, stage_weights, C, n)
    tensors = {
        "U": (U, (C, n)),
        "e": (e, (K // 2, n)),
        "alpha": (alpha, (n,)),
        "F": (F, (C, n)),
        "U_low": (U_low, (C, n)),
        "bounds": (bounds, (eq.n_bounds, n)),
        "tau": (tau, ()),
        **build.statics(ca, ("g_cij", "g_mij", "g_mask", "g_node")),
    }
    if sU is not None:
        tensors["stage_U"] = (sU, sU.shape)
    build.check(U.device, U.dtype, tensors)
    kw = dict(dtype=U.dtype, device=U.device)
    P = torch.empty((C, K, n), **kw)
    l = torch.empty((K, n), **kw)
    okp = torch.empty((n,), **kw)
    ptrs = [ca.g_cij, ca.g_mij, ca.g_mask, ca.g_node, U, e, alpha, F, U_low,
            bounds, sU, tau, P, l, okp]
    build.launch(
        "pk3_stream", U.dtype, [build.ptr(t) for t in ptrs],
        build.consts(eq, p, ca, stage_weights),
    )
    pk3_stream.launches += 1
    return P, l, okp


pk3_stream.launches = 0
