"""The padded-ELL substep's four kernels (CUDA, csrc/ell_step.cu; one
thread a row): ell_pk1 (e on every slot and alpha), ell_pk2 (U_low, F and
the limiter bounds), ell_pk3 (P, the first limiter pass and okp) and
ell_pk_up (the limited update; PK4 re-limits, PK5 is the last).  There
is no TPU kernel behind them: the JAX package runs this path in XLA
(ryujin_tpu/solver/hyperbolic.py:65-130, 411-1104).

Each wrapper takes the stencil `st` (solver/stencil.EllStencil) and runs
its plain version for a CPU tensor or launches its kernel for a CUDA
tensor; any other device raises.  The plain versions are the phase
functions of solver/hyperbolic.py on the stencil, the update a loop over
the slots in the kernel's order (as pk_up_reference is).  Each wrapper
counts its launches in `.launches`; ell_pk2 and ell_pk3 also by the number
of stage slots (`.stage_launches`), ell_pk_up its last launches (PK5,
`.last_launches`).
"""

from __future__ import annotations

import collections

import torch

from ..solver.hyperbolic import (
    phase_e_alpha, phase_low_order, phase_p_l1,
)
from . import build
from .pk2 import stage_tensor


# ---- the plain versions ----------------------------------------------------------


def ell_pk1_reference(eq, p, st, U, prec):
    """hyperbolic.phase_e_alpha(half=False): (e [K, n], alpha [n])."""
    return phase_e_alpha(eq, p, st, U, prec, st.nbr(U), st.nbr(prec),
                         half=False)


def ell_pk2_reference(eq, p, st, U, prec, d, alpha, stage_U, stage_weights,
                      tau):
    """hyperbolic.phase_low_order: (U_low, F, bounds)."""
    stage_U_j = [st.nbr(stage_U[s]) for s in range(len(stage_weights))]
    return phase_low_order(
        eq, p, st, U, prec, st.nbr(U), st.nbr(prec), d, alpha, st.nbr(alpha),
        tau, stage_U, stage_U_j, stage_weights,
    )


def ell_pk3_reference(eq, p, st, U, d, alpha, F, U_low, bounds, stage_U,
                      stage_weights, tau):
    """hyperbolic.phase_p_l1 with okp = min of success over the live edges
    of each row: (P [C, K, n], l [K, n], okp [n])."""
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


def ell_pk_up_reference(eq, p, st, U_cur, bounds, P, l, last):
    """hyperbolic.phase_update as a loop over the slots in the kernel's
    order, k = 0 .. K-1: l_sym_k = min(l_k, l at the transposed edge) on
    live slots, U + (1 / n_i) sum_k l_sym_k P_k, and unless `last` the
    re-limited l'_k = (1 - l_sym_k) l2_k, 0 on masked slots.

    The loop exists only to sum in the kernel's order.  phase_update sums
    with torch.sum, which groups the slots otherwise, and l' is decided at
    roundoff where psi is flat at its root: an ulp of U_next can move it
    far beyond the f64 bar on l' (PERF.md section 7).  Formed with the
    kernel's roundings, U_next is the kernel's bit for bit, and l' can be
    held edge by edge."""
    K = st.K
    on = [st.live_k(k) for k in range(K)]
    zero = torch.zeros_like(l[0])
    l_T = st.transpose_edge(l)
    l_sym = [torch.where(on[k], torch.minimum(l[k], l_T[k]), zero)
             for k in range(K)]
    acc = torch.zeros_like(U_cur)
    for k in range(K):
        acc = acc + torch.where(on[k][None], l_sym[k][None] * P[:, k],
                                torch.zeros_like(acc))
    U_next = U_cur + (1.0 / st.n_nbrs)[None] * acc
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


# ---- the wrappers ---------------------------------------------------------------


def _check(st, U, tensors):
    """Raise unless the stencil's statics and `tensors` (name -> (tensor,
    shape)) lie on U's device in U's dtype, contiguous, and the gather
    indices are int64 there."""
    for name in ("cols", "trans"):
        t = getattr(st, name)
        if t.device != U.device or t.dtype != torch.int64 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous int64 on {U.device}")
    statics = {name: (getattr(st, name), getattr(st, name).shape)
               for name in ("cij", "mij", "mask", "cii", "node", "incidence")
               if getattr(st, name) is not None}
    build.check(U.device, U.dtype, {**statics, **tensors})


def _launch(name, U, pointers, st, eq, p, stage_weights=()):
    build.launch(name, U.dtype, [build.ptr(t) for t in pointers],
                 build.ell_consts(eq, p, st, stage_weights))


def ell_pk1(eq, p, st, U, prec):
    """(e [K, n], alpha [n]) of the prepared state U [C, n] and its
    precomputed values prec [2, n].  e is 0 on masked slots, alpha 0 on
    padded rows."""
    if not build.on_card(U):
        return ell_pk1_reference(eq, p, st, U, prec)
    K, n, C = st.K, st.n, eq.n_comp
    _check(st, U, {"U": (U, (C, n)), "prec": (prec, (eq.n_precomputed, n))})
    e = torch.empty((K, n), dtype=U.dtype, device=U.device)
    alpha = torch.empty((n,), dtype=U.dtype, device=U.device)
    _launch("ell_pk1", U, [st.cols, st.cij, st.mask, st.node, U, prec, e,
                           alpha], st, eq, p)
    ell_pk1.launches += 1
    return e, alpha


def ell_pk2(eq, p, st, U, prec, d, alpha, stage_U, stage_weights, tau):
    """(U_low [C, n], F [C, n], bounds [3, n]) from the graph viscosity d
    [K, n] (0 on masked slots).  stage_U [S, C, n] with the static weights
    stage_weights (S <= build.MAX_STAGES); tau a 0-d tensor on the device,
    read by the kernel."""
    if not build.on_card(U):
        return ell_pk2_reference(eq, p, st, U, prec, d, alpha, stage_U,
                                 stage_weights, tau)
    K, n, C = st.K, st.n, eq.n_comp
    sU = stage_tensor(stage_U, stage_weights, C, n)
    tensors = {"U": (U, (C, n)), "prec": (prec, (eq.n_precomputed, n)),
               "d": (d, (K, n)), "alpha": (alpha, (n,)), "tau": (tau, ())}
    if sU is not None:
        tensors["stage_U"] = (sU, sU.shape)
    _check(st, U, tensors)
    kw = dict(dtype=U.dtype, device=U.device)
    U_low = torch.empty((C, n), **kw)
    F = torch.empty((C, n), **kw)
    bounds = torch.empty((eq.n_bounds, n), **kw)
    _launch("ell_pk2", U, [st.cols, st.cij, st.mask, st.incidence, st.cii,
                           st.node, U, prec, d, alpha, sU, tau, U_low, F,
                           bounds], st, eq, p, stage_weights)
    ell_pk2.launches += 1
    ell_pk2.stage_launches[len(stage_weights)] += 1
    return U_low, F, bounds


def ell_pk3(eq, p, st, U, d, alpha, F, U_low, bounds, stage_U, stage_weights,
            tau):
    """(P [C, K, n], l [K, n], okp [n]).  P and l are 0 on masked slots."""
    if not build.on_card(U):
        return ell_pk3_reference(eq, p, st, U, d, alpha, F, U_low, bounds,
                                 stage_U, stage_weights, tau)
    K, n, C = st.K, st.n, eq.n_comp
    sU = stage_tensor(stage_U, stage_weights, C, n)
    tensors = {"U": (U, (C, n)), "d": (d, (K, n)), "alpha": (alpha, (n,)),
               "F": (F, (C, n)), "U_low": (U_low, (C, n)),
               "bounds": (bounds, (eq.n_bounds, n)), "tau": (tau, ())}
    if sU is not None:
        tensors["stage_U"] = (sU, sU.shape)
    _check(st, U, tensors)
    kw = dict(dtype=U.dtype, device=U.device)
    P = torch.empty((C, K, n), **kw)
    l = torch.empty((K, n), **kw)
    okp = torch.empty((n,), **kw)
    _launch("ell_pk3", U, [st.cols, st.cij, st.mij, st.mask, st.incidence,
                           st.node, U, d, alpha, F, U_low, bounds, sU, tau, P,
                           l, okp], st, eq, p, stage_weights)
    ell_pk3.launches += 1
    ell_pk3.stage_launches[len(stage_weights)] += 1
    return P, l, okp


def ell_pk_up(eq, p, st, U_cur, bounds, P, l, last: bool):
    """(U_next [C, n], l' [K, n] or None when `last`)."""
    if not build.on_card(U_cur):
        return ell_pk_up_reference(eq, p, st, U_cur, bounds, P, l, last)
    K, n, C = st.K, st.n, eq.n_comp
    _check(st, U_cur, {"U_cur": (U_cur, (C, n)),
                       "bounds": (bounds, (eq.n_bounds, n)),
                       "P": (P, (C, K, n)), "l": (l, (K, n))})
    kw = dict(dtype=U_cur.dtype, device=U_cur.device)
    U_next = torch.empty((C, n), **kw)
    l_new = None if last else torch.empty((K, n), **kw)
    _launch("ell_pk_up", U_cur, [st.trans, st.mask, st.node, U_cur, bounds,
                                 P, l, U_next, l_new], st, eq, p)
    ell_pk_up.launches += 1
    ell_pk_up.last_launches += int(last)
    return U_next, l_new


ell_pk1.launches = ell_pk2.launches = ell_pk3.launches = 0
ell_pk_up.launches = ell_pk_up.last_launches = 0
# launches by the number of stage slots (the instance of at most 2 slots
# takes 0-2, that of build.MAX_STAGES 3-4)
ell_pk2.stage_launches = collections.Counter()
ell_pk3.stage_launches = collections.Counter()
