"""PK2, slot-streaming form: low-order update U_low, high-order right-hand
side F and the limiter bounds for a canvas of any lattice reach, from the
pre-scaled wavespeeds e of PK1 (CUDA kernel csrc/pk2_stream.cu; TPU kernel
`pk2_stream` with prescale, pallas_step.py:2879)."""

from __future__ import annotations

import torch

from . import build
from .pk2 import stage_tensor


def slot_d(st, e, k):
    """The graph viscosity d of slot k from the pre-scaled half-slot e
    [K/2, n]: e_k at the node for k < K/2, plane K-1-k of neighbour k
    otherwise; 0 on masked slots."""
    K = st.K
    lam_k = e[k] if k < K // 2 else st.shift(e[K - 1 - k], st.offsets[k])
    return torch.where(st.mask[k] > 0, lam_k, torch.zeros_like(lam_k))


def pk2_stream_reference(eq, p, ca, U, prec, e, alpha, stage_U, stage_weights,
                         tau):
    """Plain torch: the per-offset loop on full canvases with running
    sums and the streaming bounds forms, k = 0 .. K-1 in order and the
    diagonal terms last."""
    st = ca.stencil
    ws = list(stage_weights)
    weight = 1.0 - sum(ws)
    regularization = 100.0 * torch.finfo(U.dtype).tiny
    f = eq.f(U)
    flux_ii = eq.flux_divergence(f, f, st.cii)
    f_s = [eq.f(stage_U[s]) for s in range(len(ws))]
    low_acc = torch.zeros_like(U)
    F_acc = torch.zeros_like(U)
    bst = eq.limiter_bounds_init(U, prec)
    for k, off in enumerate(st.offsets):
        U_jk = st.shift(U, off)
        c_k = st.cij[:, k]
        mask_k = st.mask[k]
        d_k = slot_d(st, e, k)
        flux_ij_k = eq.flux_divergence(f, st.shift(f, off), c_k)
        dU_k = U_jk - U
        dH_k = d_k * (0.5 * (alpha + st.shift(alpha, off)))
        low_acc = low_acc + (flux_ij_k + d_k[None] * dU_k) * mask_k[None]
        F_acc = F_acc + (dH_k[None] * dU_k + weight * flux_ij_k) * mask_k[None]
        for s, w_s in enumerate(ws):
            F_acc = F_acc + w_s * eq.flux_divergence(
                f_s[s], st.shift(f_s[s], off), c_k
            ) * mask_k[None]
        scaled_c_k = c_k / torch.clamp_min(d_k, regularization)[None]
        bst = eq.limiter_bounds_accum(
            bst, U_jk, st.shift(prec, off), scaled_c_k, mask_k
        )
    U_low = U + (tau * st.m_lumped_inv)[None] * (low_acc + flux_ii)
    F = F_acc + weight * flux_ii
    for s, w_s in enumerate(ws):
        F = F + w_s * eq.flux_divergence(f_s[s], f_s[s], st.cii)
    hd_i = st.m_lumped * st.measure_inv
    bounds = eq.limiter_bounds_finalize(bst, hd_i, p.limiter_relaxation_factor)
    return U_low, F, bounds


def pk2_stream(eq, p, ca, U, prec, e, alpha, stage_U, stage_weights, tau):
    """(U_low [C, n], F [C, n], bounds [3, n]).  e [K/2, n] is PK1's
    pre-scaled output after the boundary-pair fixup; stage_U [S, C, n] with
    the static weights stage_weights (S <= 2); tau a 0-d tensor on the
    device, read by the kernel (no host sync)."""
    if not build.on_card(U):
        return pk2_stream_reference(
            eq, p, ca, U, prec, e, alpha, stage_U, stage_weights, tau
        )
    n, K, C = ca.n, ca.K, eq.n_comp
    sU = stage_tensor(stage_U, stage_weights, C, n)
    tensors = {
        "U": (U, (C, n)),
        "prec": (prec, (eq.n_precomputed, n)),
        "e": (e, (K // 2, n)),
        "alpha": (alpha, (n,)),
        "tau": (tau, ()),
        **build.statics(ca, ("g_cij", "g_mask", "g_cii", "g_node")),
    }
    if sU is not None:
        tensors["stage_U"] = (sU, sU.shape)
    build.check(U.device, U.dtype, tensors)
    kw = dict(dtype=U.dtype, device=U.device)
    U_low = torch.empty((C, n), **kw)
    F = torch.empty((C, n), **kw)
    bounds = torch.empty((eq.n_bounds, n), **kw)
    ptrs = [ca.g_cij, ca.g_mask, ca.g_cii, ca.g_node, U, prec, e, alpha, sU,
            tau, U_low, F, bounds]
    build.launch(
        "pk2_stream", U.dtype, [build.ptr(t) for t in ptrs],
        build.consts(eq, p, ca, stage_weights),
    )
    pk2_stream.launches += 1
    return U_low, F, bounds


pk2_stream.launches = 0
