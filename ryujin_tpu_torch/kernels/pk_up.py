"""pk_up: the symmetrized limited update, PK4 (re-limits) and PK5 (last),
on the K = 8 (reach 1) and K = 24 (reach 2) canvases (CUDA kernel
csrc/pk_up.cu; TPU kernel pallas_step.py:3265)."""

from __future__ import annotations

import torch

from ..solver.hyperbolic import phase_update
from . import build

INSTANCES = (8, 24)  # the K the kernel template is instantiated for


def pk_up_reference(eq, p, ca, U_cur, bounds, P, l, last):
    """Plain torch: hyperbolic.phase_update with l_T the transposed gather."""
    st = ca.stencil
    return phase_update(eq, p, st, U_cur, bounds, P, l, st.transpose_edge(l),
                        last)


def pk_up(eq, p, ca, U_cur, bounds, P, l, last: bool):
    """(U_next [C, n], l' [K, n] or None when `last`)."""
    if not build.on_card(U_cur):
        return pk_up_reference(eq, p, ca, U_cur, bounds, P, l, last)
    n, K, C = ca.n, ca.K, eq.n_comp
    if K not in INSTANCES:
        raise ValueError(
            f"pk_up is built for K in {INSTANCES} lattice offsets, not {K}"
        )
    build.check(U_cur.device, U_cur.dtype, {
        "U_cur": (U_cur, (C, n)),
        "bounds": (bounds, (eq.n_bounds, n)),
        "P": (P, (C, K, n)),
        "l": (l, (K, n)),
        **build.statics(ca, ("g_lam", "g_mask")),
    })
    kw = dict(dtype=U_cur.dtype, device=U_cur.device)
    U_next = torch.empty((C, n), **kw)
    l_new = None if last else torch.empty((K, n), **kw)
    ptrs = [ca.g_lam, ca.g_mask, U_cur, bounds, P, l, U_next, l_new]
    build.launch(
        "pk_up", U_cur.dtype, [build.ptr(t) for t in ptrs],
        build.consts(eq, p, ca),
    )
    pk_up.launches += 1
    return U_next, l_new


pk_up.launches = 0
