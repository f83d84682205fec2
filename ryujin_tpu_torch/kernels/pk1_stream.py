"""PK1, slot-streaming form: pre-scaled half-slot wavespeeds e = lambda *
cmax [K/2, n] and the indicator alpha [n] for a canvas of any lattice
reach (CUDA kernel csrc/pk1_stream.cu; TPU kernel `_pk1_stream` with
prescale, pallas_step.py:1904)."""

from __future__ import annotations

import torch

from . import build


def pk1_stream_reference(eq, p, ca, U, prec):
    """Plain torch: the per-offset loop on full canvases through the
    streaming indicator forms, summing over k = 0 .. K-1 in order."""
    st = ca.stencil
    K = st.K
    cmax = ca.g_cmax.reshape(K, -1)
    tiny = torch.finfo(U.dtype).tiny
    f = eq.f(U)
    pa_i = eq.riemann_precompute(U)
    ind = eq.indicator_init(U, prec, f_i=f)
    left = right = None
    e = []
    for k, off in enumerate(st.offsets):
        U_jk = st.shift(U, off)
        c_k = st.cij[:, k]
        mask_k = st.mask[k]
        if k < K // 2:
            norm_k = torch.sqrt(torch.sum(c_k * c_k, 0))
            n_k = c_k / torch.clamp_min(norm_k, tiny)[None]
            lam_k = eq.riemann_lambda_max(
                U, U_jk, n_k, pa_i=pa_i,
                pa_j=tuple(st.shift(x, off) for x in pa_i),
            )
            e.append(torch.where(mask_k > 0, lam_k * cmax[k],
                                 torch.zeros_like(lam_k)))
        li, ri = eq.indicator_accum(
            ind, U_jk, st.shift(prec, off), st.shift(f, off), c_k, mask_k
        )
        left = li if left is None else left + li
        right = ri if right is None else right + ri
    hd_i = st.m_lumped * st.measure_inv
    alpha = eq.indicator_finalize(ind, left, right, hd_i, p.evc_factor)
    alpha = torch.where(st.node_mask > 0, alpha, torch.zeros_like(alpha))
    return torch.stack(e), alpha


def pk1_stream(eq, p, ca, U, prec):
    """(e [K/2, n], alpha [n]) of the prepared state U [C, n] and its
    precomputed values prec [2, n] on the canvas `ca` (CanvasArrays).
    Masked slots hold e = 0, padded cells alpha = 0."""
    if not build.on_card(U):
        return pk1_stream_reference(eq, p, ca, U, prec)
    n, K = ca.n, ca.K
    build.check(U.device, U.dtype, {
        "U": (U, (eq.n_comp, n)),
        "prec": (prec, (eq.n_precomputed, n)),
        **build.statics(ca, ("g_cij", "g_cmax", "g_mask", "g_node")),
    })
    e = torch.empty((K // 2, n), dtype=U.dtype, device=U.device)
    alpha = torch.empty((n,), dtype=U.dtype, device=U.device)
    ptrs = [ca.g_cij, ca.g_cmax, ca.g_mask, ca.g_node, U, prec, e, alpha]
    build.launch(
        "pk1_stream", U.dtype, [build.ptr(t) for t in ptrs],
        build.consts(eq, p, ca),
    )
    pk1_stream.launches += 1
    return e, alpha


pk1_stream.launches = 0
