"""The padded-ELL substep's four kernels (CUDA, csrc/ell_step.cu):
ell_pk1 (e on every slot and alpha), ell_pk2 (U_low, F and the limiter
bounds), ell_pk3 (P, the first limiter pass and okp) and ell_pk_up (the
limited update; PK4 re-limits, PK5 is the last), blocks of rows that stage
the rows' values in shared memory, ell_pk3 and ell_pk_up a row's slots
over threads, ell_pk1 and ell_pk2 one thread a row; their launch from
ell_step_shape().  There is no TPU kernel
behind them: the JAX package runs this path in XLA
(ryujin_tpu/solver/hyperbolic.py:65-130, 411-1104).

Each wrapper takes the stencil `st` (solver/stencil.EllStencil) and runs
its plain version for a CPU tensor or launches its kernel for a CUDA
tensor; any other device raises.  The plain versions are the phase
functions of solver/hyperbolic.py on the stencil, the update a loop over
the slots in the kernel's order (as pk_up_reference is).  Each wrapper
counts its launches in `.launches`; ell_pk2 and ell_pk3 also by the number
of stage slots (`.stage_launches`), ell_pk_up its last launches (PK5,
`.last_launches`).  ell_pk1, ell_pk2 and ell_pk3 read the int32 columns
`st.cols32` (solver/stencil.int32_columns), ell_pk_up the int32
transposed edges `st.trans32` (solver/stencil.int32_edges).
"""

from __future__ import annotations

import collections
from typing import NamedTuple

import numpy as np
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


# ---- the launch of the four kernels ---------------------------------------------

ELL_THREADS = 128  # the most threads a block (csrc/ell_step.cu ELL_THREADS)
KERNELS = ("ell_pk1", "ell_pk2", "ell_pk3", "ell_pk_up")
# the default launch, (rows, threads) a block, of each kernel and of PK5
# ("ell_pk_up last"), the fastest of tile_sweep's ell-step on the step at
# refinement 3 (PERF.md section 6); fewer rows where the shared bytes need
ELL_DEFAULT = {"ell_pk1": (128, 128), "ell_pk2": (128, 128),
               "ell_pk3": (32, 64), "ell_pk_up": (32, 64),
               "ell_pk_up last": (32, 64)}
# the kernels of one thread a row (threads = rows)
ROW_KERNELS = ("ell_pk1", "ell_pk2")


class EllStepShape(NamedTuple):
    """Launch of an ELL kernel: a block owns `rows` consecutive rows and
    every slot of them, thread (m, ky) of the block (rows, slots) the
    slots ky, ky + slots, ... of row m (ell_pk1 and ell_pk2: one thread a
    row, slots 1); `blocks` blocks cover the n rows; `smem` shared bytes a
    block (dynamic)."""

    rows: int
    slots: int
    threads: int
    blocks: int
    smem: int


def ell_pk3_row_vals(dim: int, stages: int) -> int:
    """ell_pk3's row values (csrc/ell_step.cu): U and its flux parts,
    U_low, F, the bounds, psi0, alpha_i, 1/m_i, pfac and the node mask,
    each stage state's flux parts."""
    return 4 * dim + 19 + stages * (2 * dim + 2)


def ell_pk_up_row_vals(dim: int, K: int, last: bool) -> int:
    """ell_pk_up's row values: each slot's l_sym and P, then (PK4) U_next,
    the bounds and psi0."""
    return K * (dim + 3) + (0 if last else dim + 9)


def ell_step_smem(kernel: str, dim: int, stages: int, rows: int,
                  itemsize: int, K: int = 0, last: bool = False) -> int:
    """Shared bytes of a block of `rows` rows (csrc/ell_step.cu
    ell_step_smem): the row values of `kernel`, for ell_pk2 pk2_vals and
    the row's sums of each stage's flux divergences; ell_pk1 stages
    nothing."""
    vals = {"ell_pk3": lambda: ell_pk3_row_vals(dim, stages),
            "ell_pk2": lambda: pk2_vals(dim, stages) + stages * (dim + 2),
            "ell_pk1": lambda: 0,
            "ell_pk_up": lambda: ell_pk_up_row_vals(dim, K, last)}[kernel]()
    return vals * rows * itemsize


def ell_step_shape(kernel: str, dim: int, K: int, dtype, n_stages: int,
                   n: int, rows=None, threads=None,
                   last: bool = False) -> EllStepShape:
    """The launch of `kernel` (one of KERNELS; `last` PK5's launch of
    ell_pk_up) on n rows of K slots: blocks of `rows` rows and rows *
    min(K, threads // rows) threads (ROW_KERNELS: threads = rows); by default
    ELL_DEFAULT's, the rows halved until the shared bytes fit
    build.SMEM_MAX.  Raises ValueError for a shape that cannot launch."""
    if kernel not in KERNELS:
        raise ValueError(f"no launch shape for {kernel!r}")
    if not (1 <= dim <= 3 and K >= 1 and 0 <= n_stages <= build.MAX_STAGES
            and n >= 0):
        raise ValueError(f"no ELL launch for dim {dim}, K {K}, "
                         f"{n_stages} stage slots, n {n}")
    itemsize = torch.empty((), dtype=dtype).element_size()
    rows0, threads0 = ELL_DEFAULT[kernel + (" last" if last else "")]
    candidates = [rows] if rows is not None else [
        rows0 >> h for h in range(rows0.bit_length())]
    for b in candidates:
        smem = ell_step_smem(kernel, dim, n_stages, b, itemsize, K, last)
        if smem <= build.SMEM_MAX or b == candidates[-1]:
            break
    if threads is None:
        threads = b if kernel in ROW_KERNELS else threads0
    if (not (1 <= b <= threads <= ELL_THREADS) or smem > build.SMEM_MAX
            or (kernel in ROW_KERNELS and threads != b)):
        raise ValueError(f"{kernel}: no block of {rows or 'any'} rows and "
                         f"{threads} threads fits (K {K}, {dim}D, {dtype}, "
                         f"{n_stages} stage slots: {smem} shared bytes)")
    slots = min(K, threads // b)
    return EllStepShape(b, slots, b * slots, -(-n // b), smem)


# ---- the wrappers ---------------------------------------------------------------


def _check(st, U, tensors, index="cols32"):
    """Raise unless the stencil's statics and `tensors` (name -> (tensor,
    shape)) lie on U's device in U's dtype, contiguous, and the gather
    indices `index` (st.cols32 or st.trans32) are contiguous int32 [K, n]
    there."""
    t = getattr(st, index, None)
    if (t is None or t.device != U.device or t.dtype != torch.int32
            or tuple(t.shape) != (st.K, st.n) or not t.is_contiguous()):
        raise ValueError(f"{index} must be contiguous int32 [K, n] on "
                         f"{U.device} (solver/ell_step.EllStepper)")
    statics = {name: (getattr(st, name), getattr(st, name).shape)
               for name in ("cij", "mij", "mask", "cii", "node", "incidence")
               if getattr(st, name) is not None}
    build.check(U.device, U.dtype, {**statics, **tensors})


def _launch(name, U, pointers, st, eq, p, stage_weights=(), shape=None,
            last=False):
    c = build.ell_consts(eq, p, st, stage_weights)
    sh = shape or ell_step_shape(name, st.dim, st.K, U.dtype,
                                 len(stage_weights), st.n, last=last)
    c = build.with_tile(c, build.Tile((sh.rows, sh.slots, 1), 0, sh.smem,
                                      (sh.blocks, 1, 1)))
    build.launch(name, U.dtype, [build.ptr(t) for t in pointers], c)


def ell_pk1(eq, p, st, U, prec, shape=None):
    """(e [K, n], alpha [n]) of the prepared state U [C, n] and its
    precomputed values prec [2, n].  e is 0 on masked slots, alpha 0 on
    padded rows; `shape` an ell_step_shape() other than the default."""
    if not build.on_card(U):
        return ell_pk1_reference(eq, p, st, U, prec)
    K, n, C = st.K, st.n, eq.n_comp
    _check(st, U, {"U": (U, (C, n)), "prec": (prec, (eq.n_precomputed, n))})
    e = torch.empty((K, n), dtype=U.dtype, device=U.device)
    alpha = torch.empty((n,), dtype=U.dtype, device=U.device)
    _launch("ell_pk1", U, [st.cols32, st.cij, st.mask, st.node, U, prec, e,
                           alpha], st, eq, p, shape=shape)
    ell_pk1.launches += 1
    return e, alpha


def ell_pk2(eq, p, st, U, prec, d, alpha, stage_U, stage_weights, tau,
            shape=None):
    """(U_low [C, n], F [C, n], bounds [3, n]) from the graph viscosity d
    [K, n] (0 on masked slots).  stage_U [S, C, n] with the static weights
    stage_weights (S <= build.MAX_STAGES); tau a 0-d tensor on the device,
    read by the kernel; `shape` an ell_step_shape() other than the
    default."""
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
    _launch("ell_pk2", U, [st.cols32, st.cij, st.mask, st.incidence, st.cii,
                           st.node, U, prec, d, alpha, sU, tau, U_low, F,
                           bounds], st, eq, p, stage_weights, shape)
    ell_pk2.launches += 1
    ell_pk2.stage_launches[len(stage_weights)] += 1
    return U_low, F, bounds


def ell_pk3(eq, p, st, U, d, alpha, F, U_low, bounds, stage_U, stage_weights,
            tau, shape=None):
    """(P [C, K, n], l [K, n], okp [n]).  P and l are 0 on masked slots;
    `shape` an ell_step_shape() other than the default."""
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
    _launch("ell_pk3", U, [st.cols32, st.cij, st.mij, st.mask, st.incidence,
                           st.node, U, d, alpha, F, U_low, bounds, sU, tau, P,
                           l, okp], st, eq, p, stage_weights, shape)
    ell_pk3.launches += 1
    ell_pk3.stage_launches[len(stage_weights)] += 1
    return P, l, okp


def ell_pk_up(eq, p, st, U_cur, bounds, P, l, last: bool, shape=None):
    """(U_next [C, n], l' [K, n] or None when `last`); `shape` an
    ell_step_shape() (with `last`) other than the default."""
    if not build.on_card(U_cur):
        return ell_pk_up_reference(eq, p, st, U_cur, bounds, P, l, last)
    K, n, C = st.K, st.n, eq.n_comp
    _check(st, U_cur, {"U_cur": (U_cur, (C, n)),
                       "bounds": (bounds, (eq.n_bounds, n)),
                       "P": (P, (C, K, n)), "l": (l, (K, n))}, "trans32")
    kw = dict(dtype=U_cur.dtype, device=U_cur.device)
    U_next = torch.empty((C, n), **kw)
    l_new = None if last else torch.empty((K, n), **kw)
    _launch("ell_pk_up", U_cur, [st.trans32, st.mask, st.node, U_cur, bounds,
                                 P, l, U_next, l_new], st, eq, p,
            shape=shape, last=last)
    ell_pk_up.launches += 1
    ell_pk_up.last_launches += int(last)
    return U_next, l_new


# ---- the column bands of blocks of rows ------------------------------------------


def band_widths(cols, mask, rows: int) -> np.ndarray:
    """hi - lo + 1 over the live columns of each block of `rows`
    consecutive rows (the last block ragged), 0 for a block without a live
    slot: the rows a block would stage to read every neighbour from shared
    memory.  cols and mask [K, n], numpy arrays or CPU tensors."""
    cols, live = np.asarray(cols), np.asarray(mask) > 0
    K, n = cols.shape
    blocks = -(-n // rows)
    pad = ((0, 0), (0, blocks * rows - n))
    c = np.pad(cols.astype(np.int64), pad).reshape(K, blocks, rows)
    on = np.pad(live, pad).reshape(K, blocks, rows)
    lo = np.where(on, c, np.iinfo(np.int64).max).min(axis=(0, 2))
    hi = np.where(on, c, -1).max(axis=(0, 2))
    return np.where(hi >= lo, hi - lo + 1, 0)


# values a staged neighbour row holds (csrc/staged.cuh pk3_vals, pk2_vals)
def pk3_vals(dim: int, stages: int) -> int:
    return 2 * dim + 4 + stages * (2 * dim + 2) + dim + 4


def pk2_vals(dim: int, stages: int) -> int:
    return 2 * dim + 4 + 2 + stages * (2 * dim + 2)


def band_table(cols, mask, dim: int, itemsize: int, stages: int = 2,
               rows=(32, 64, 128, 256), quantiles=(0.5, 0.9, 0.99, 1.0)):
    """{rows: {"width": [band width at each quantile], "pk3_bytes": [...],
    "pk2_bytes": [...]}} over the blocks of `rows` consecutive rows: the
    shared bytes a block would need to stage its band's neighbour values
    for ell_pk3 and ell_pk2 at `stages` stage slots."""
    out = {}
    for b in rows:
        w = np.quantile(band_widths(cols, mask, b), quantiles,
                        method="higher").astype(np.int64)
        out[b] = {"width": w.tolist(),
                  "pk3_bytes": (w * pk3_vals(dim, stages) * itemsize).tolist(),
                  "pk2_bytes": (w * pk2_vals(dim, stages) * itemsize).tolist()}
    return out


ell_pk1.launches = ell_pk2.launches = ell_pk3.launches = 0
ell_pk_up.launches = ell_pk_up.last_launches = 0
# launches by the number of stage slots (the instance of at most 2 slots
# takes 0-2, that of build.MAX_STAGES 3-4)
ell_pk2.stage_launches = collections.Counter()
ell_pk3.stage_launches = collections.Counter()
