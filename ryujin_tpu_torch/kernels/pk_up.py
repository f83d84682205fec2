"""pk_up: the symmetrized limited update, PK4 (re-limits) and PK5 (last),
on the 2D K = 8 (reach 1), K = 24 (reach 2) and K = 48 (reach 3, cG Q3)
canvases and the 3D K = 26 (reach 1) canvas (CUDA kernel csrc/pk_up.cu;
TPU kernels pallas_step.py:3265 and `_step_slab`'s pk_up, :2528).  With separable
statics (a 3D cG canvas) it launches the SEP instance, which synthesizes
the mask per offset (_SepTile.mask_k, :1139): the port's pk_up reads the
mask, where the TPU's relies on P carrying it."""

from __future__ import annotations

import torch

from . import build

# the (dim, K) the kernel template is instantiated for
INSTANCES = ((2, 8), (2, 24), (2, 48), (3, 26))


TX = 32  # cells a block owns (csrc/pk_up.cu UP_TX)


def tile(shape, K: int, dtype, last: bool = False) -> build.Tile:
    """The launch shape of pk_up on a 2D [H, W] or 3D [D, H, W] canvas with
    K lattice offsets.  PK4 at K = 24, 26 and 48: a block owns TX cells of
    one x row, one warp per component; its shared arrays hold the row's
    C K planes of P, l_sym, the live flags and U' (static at K = 24 and
    26; dynamic at K = 48, 64,000 bytes in f64).  PK5 (`last`) and PK4 at
    K = 8: one thread a cell, 128 along x, no shared memory.  No halo: the
    transposed l is read from device memory."""
    dim = len(shape)
    D, H, W = build.canvas_dims(shape)
    if last or K == 8:
        return build.Tile((128, 1, 1), 0, 0, (-(-W // 128), H, D))
    C = dim + 2
    item = torch.empty((), dtype=dtype).element_size()
    smem = (C * K + K + C) * TX * item + K * TX
    return build.Tile((TX, C, 1), 0, smem, (-(-W // TX), H, D))


def pk_up_reference(eq, p, ca, U_cur, bounds, P, l, last):
    """Plain torch: hyperbolic.phase_update as a loop over the offsets in
    the kernel's order, k = 0 .. K-1: l_sym_k = min(l_k, plane K-1-k of
    neighbour k) on live slots, U + (1/n_i) sum_k l_sym_k P_k, and unless
    `last` the re-limited l'_k = (1 - l_sym_k) l2_k, 0 on masked slots."""
    st = ca.stencil
    K = st.K
    on = [st.live_k(k) for k in range(K)]
    zero = torch.zeros_like(l[0])
    l_ghosts = st.refresh_ghosts(l)
    l_sym = [
        torch.where(on[k], torch.minimum(
            l[k], st.shift(l_ghosts[K - 1 - k], off)), zero)
        for k, off in enumerate(st.offsets)
    ]
    acc = torch.zeros_like(U_cur)
    for k in range(K):
        acc = acc + torch.where(on[k][None], l_sym[k][None] * P[:, k],
                                torch.zeros_like(acc))
    U_next = U_cur + ca.g_lam.reshape(1, -1) * acc
    if last:
        return U_next, None
    psi0 = eq.limiter_psi0(bounds, U_next)
    l_new = torch.empty_like(l)
    for k in range(K):
        rest = 1.0 - l_sym[k]
        l2, _ = eq.limiter_limit(
            bounds, U_next, rest[None] * P[:, k], psi0,
            newton_iterations=p.limiter_newton_max_iterations,
            newton_tol=p.limiter_newton_tolerance,
        )
        l_new[k] = torch.where(on[k], rest * l2, zero)
    return U_next, l_new


def pk_up(eq, p, ca, U_cur, bounds, P, l, last: bool):
    """(U_next [C, n], l' [K, n] or None when `last`)."""
    if not build.on_card(U_cur):
        return pk_up_reference(eq, p, ca, U_cur, bounds, P, l, last)
    n, K, C = ca.n, ca.K, eq.n_comp
    if (len(ca.shape), K) not in INSTANCES:
        raise ValueError(
            f"pk_up is built for (dim, K) in {INSTANCES}, not "
            f"({len(ca.shape)}, {K})"
        )
    build.check(U_cur.device, U_cur.dtype, {
        "U_cur": (U_cur, (C, n)),
        "bounds": (bounds, (eq.n_bounds, n)),
        "P": (P, (C, K, n)),
        "l": (l, (K, n)),
        **build.statics(ca, ("g_lam", "g_mask", "g_sep2", "f_sepz")),
    })
    kw = dict(dtype=U_cur.dtype, device=U_cur.device)
    U_next = torch.empty((C, n), **kw)
    l_new = None if last else torch.empty((K, n), **kw)
    ptrs = [ca.g_lam, ca.g_mask, U_cur, bounds, P, l, U_next, l_new,
            ca.g_sep2, ca.f_sepz]
    build.launch(
        "pk_up", U_cur.dtype, [build.ptr(t) for t in ptrs],
        build.with_tile(build.consts(eq, p, ca),
                        tile(ca.shape, K, U_cur.dtype, last)),
    )
    pk_up.launches += 1
    pk_up.last_launches += int(last)
    # the SEP instance's own count
    pk_up.sep_launches += int(ca.separable)
    return U_next, l_new


pk_up.launches = pk_up.sep_launches = pk_up.last_launches = 0
