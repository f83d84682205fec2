"""PK1: half-slot Riemann wavespeeds lambda [K/2, n] and the indicator
alpha [n] (CUDA kernel csrc/pk1.cu; TPU kernel pallas_step.py:2676)."""

from __future__ import annotations

import torch

from ..solver.hyperbolic import phase_e_alpha
from . import build


def pk1_reference(eq, p, ca, U, prec):
    """Plain torch: hyperbolic.phase_e_alpha(half=True) on the canvas."""
    st = ca.stencil
    return phase_e_alpha(eq, p, st, U, prec, st.nbr(U), st.nbr(prec))


def pk1(eq, p, ca, U, prec):
    """(lam [K/2, n], alpha [n]) of the prepared state U [C, n] and its
    precomputed values prec [2, n] on the canvas `ca` (CanvasArrays).
    Masked slots hold lambda 0, padded cells alpha 0."""
    if not build.on_card(U):
        return pk1_reference(eq, p, ca, U, prec)
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
        "pk1", U.dtype, [build.ptr(t) for t in ptrs], build.consts(eq, p, ca)
    )
    pk1.launches += 1
    return lam, alpha


pk1.launches = 0
