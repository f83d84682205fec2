"""The hyperbolic module in PyTorch: graph-viscosity IDP substep with
convex limiting (ryujin_tpu/solver/hyperbolic.py).

Scope: the Euler equations on a 2D single-block structured canvas of any
lattice reach (the Mach-3 step of bench cases step2d, cG Q1 with K = 8,
and q2step2d, cG Q2 with K = 24), with the symmetric half-slot Riemann
evaluation and the scatter route for boundary conditions.  The phase
functions are plain tensor code on full canvases; `HyperbolicModule.step`
runs them for CPU tensors and the hand-written CUDA kernels
(solver/canvas_step.py) for CUDA tensors.

Differences from the JAX signatures: stage weights are static Python
floats (the JAX lax.cond on a zero weight becomes a Python `if`), and the
stage precomputed values are not threaded through, because the Euler flux
depends on the state alone.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Sequence

import numpy as np
import torch

from ..offline.mesh import Boundary
from ..offline.structured import StructuredData


# ---------------------------------------------------------------------------
# Phase functions (hyperbolic.py:411-1104)
# ---------------------------------------------------------------------------


def phase_e_alpha(eq, p, sa, U, prec, U_j, prec_j, half=True):
    """Step 2: wavespeeds and the indicator alpha_i.

    half=True evaluates the first K/2 directed slots and returns the RAW
    lambda [K/2, n] (the symmetric Riemann solve: slot K-1-k at the
    neighbour holds the same undirected edge); half=False returns the
    directed products e = |c_ij| lambda_max [K, n].  Returns (lam or e,
    alpha [n])."""
    tiny = torch.finfo(U.dtype).tiny
    norm = torch.sqrt(torch.sum(sa.cij * sa.cij, 0))  # [K, n]
    n_ij = sa.cij / torch.clamp_min(norm, tiny)[None]
    pa_i = eq.riemann_precompute(U)
    pa_j = eq.riemann_precompute(U_j)
    if half:
        K2 = sa.cij.shape[1] // 2
        e = eq.riemann_lambda_max(
            U[:, None], U_j[:, :K2], n_ij[:, :K2],
            pa_i=pa_i, pa_j=tuple(x[:K2] for x in pa_j),
        )
    else:
        e = norm * eq.riemann_lambda_max(
            U[:, None], U_j, n_ij, pa_i=pa_i, pa_j=pa_j
        )
    hd_i = sa.m_lumped * sa.measure_inv
    alpha = eq.indicator_alpha(
        U, prec, U_j, prec_j, sa.cij, sa.mask, hd_i, evc_factor=p.evc_factor
    )
    return e, alpha


def _boundary_pair_data(sd: StructuredData, dtype, device):
    """Host precompute of the coupling-boundary-pair slots: directed
    slots k < K/2 whose transposed coefficient c_ji differs from -c_ij
    (both endpoints on the domain boundary, offline_data.template.h:
    1367-1462).  Returns {k, i, j, n_T, w_fwd, w_rev, c_rev_norm} tensors
    or None.

    numpy throughout; c_ij is rounded to `dtype` first, as the JAX
    version reads it back from its device stencil."""
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    shape = tuple(sd.shape)
    K = sd.max_degree
    K2 = K // 2
    offs = np.asarray(sd.offsets)
    cij = np.moveaxis(
        sd.cij.astype(np_dtype).astype(np.float64).reshape(shape + (K, -1)),
        (-1, -2), (0, 1),
    )  # [dim, K, *canvas]
    cT = np.empty_like(cij)
    axes = tuple(range(1, 1 + len(shape)))
    for k, off in enumerate(offs):
        cT[:, k] = np.roll(cij[:, K - 1 - k], tuple(-off), axis=axes)
    cij = cij.reshape(cij.shape[0], K, -1)
    cT = cT.reshape(cij.shape)
    mask = sd.mask.T
    mis = np.linalg.norm(cij + cT, axis=0)
    scale = np.linalg.norm(cij, axis=0) + np.linalg.norm(cT, axis=0)
    mismatch = (mask > 0) & (mis > 1.0e-10 * np.maximum(scale, 1e-300))
    mismatch &= (sd.node_mask > 0)[None]
    kk, nn = np.nonzero(mismatch[:K2])
    if len(kk) == 0:
        return None
    midx = np.stack(np.unravel_index(nn, shape), axis=1)
    midx = (midx + offs[kk]) % np.asarray(shape)[None]
    jj = np.ravel_multi_index(tuple(midx.T), shape)
    c_f = cij[:, kk, nn]
    c_r = cT[:, kk, nn]
    nf = np.linalg.norm(c_f, axis=0)
    nr = np.linalg.norm(c_r, axis=0)
    cmax = np.maximum(nf, nr)

    def t(x, dt=dtype):
        return torch.as_tensor(x, dtype=dt, device=device)

    return {
        "k": t(kk, torch.int64),
        "i": t(nn, torch.int64),
        "j": t(jj, torch.int64),
        "n_T": t(c_r / np.maximum(nr, 1e-300)[None]),
        "w_fwd": t(nf / np.maximum(cmax, 1e-300)),
        "w_rev": t(nr / np.maximum(cmax, 1e-300)),
        "c_rev_norm": t(nr),
    }


def d_from_lambda(st, lam_half, cmax=None):
    """d = lambda * max(|c_ij|, |c_ji|) on live edges from the half-slot
    lambda [K/2, n]: slot k >= K/2 reads plane K-1-k of its neighbour.
    cmax=None takes lam_half as already scaled by cmax (the stream
    kernels' e; cmax_k(i) == cmax_{K-1-k}(j), so the transposed read of e
    is d itself)."""
    K = st.K
    lam_T = torch.stack([
        st.shift(lam_half[K - 1 - k], st.offsets[k]) for k in range(K // 2, K)
    ])
    lam_full = torch.cat([lam_half, lam_T], 0)
    if cmax is not None:
        lam_full = lam_full * cmax
    return torch.where(st.mask > 0, lam_full, torch.zeros_like(lam_full))


def d_from_e(mask, e, e_T):
    """d = max(e_ij, e_ji) on live edges (the two-direction form)."""
    return torch.where(mask > 0, torch.maximum(e, e_T), torch.zeros_like(e))


def tau_max_from_d(sa, d, cfl, tau_cap):
    """Step 3: tau_max = min_i cfl m_i / (-2 d_ii), capped; a 0-d tensor."""
    finfo = torch.finfo(d.dtype)
    d_sum = torch.clamp_max(-torch.sum(d, 0), -1.0e6 * finfo.tiny)
    tau_i = cfl * sa.m_lumped / (-2.0 * d_sum)
    tau_max = torch.amin(
        torch.where(sa.node_mask > 0, tau_i, torch.full_like(tau_i, finfo.max))
    )
    return torch.minimum(tau_max, tau_cap)


def _flux_divergences(eq, sa, U, U_j):
    """Edge and diagonal flux divergences (flux_ij [C, K, n], flux_ii [C, n])."""
    flux_i = eq.f(U)
    flux_ij = eq.flux_divergence(flux_i[..., None, :], eq.f(U_j), sa.cij)
    return flux_ij, eq.flux_divergence(flux_i, flux_i, sa.cii)


def _stage_terms(eq, sa, m, stage_U, stage_U_j, stage_weights, want_P):
    """Accumulated stage contributions sum_s w_s (F_inc, P_inc); stages
    with a zero weight are skipped.  Returns (F_inc [C, n], P_inc
    [C, K, n] or None)."""
    F_acc = None
    P_acc = None
    for s, w_s in enumerate(stage_weights):
        if w_s == 0.0:
            continue
        flux_s_i = eq.f(stage_U[s])
        flux_s_j = eq.f(stage_U_j[s])
        hof_s = eq.flux_divergence(flux_s_i[..., None, :], flux_s_j, sa.cij)
        hof_s_ii = eq.flux_divergence(flux_s_i, flux_s_i, sa.cii)
        F_inc = w_s * (torch.sum(hof_s * m, 1) + hof_s_ii)
        F_acc = F_inc if F_acc is None else F_acc + F_inc
        if want_P:
            P_acc = w_s * hof_s if P_acc is None else P_acc + w_s * hof_s
    return F_acc, P_acc


def phase_low_order(eq, p, sa, U, prec, U_j, prec_j, d, alpha, alpha_j, tau,
                    stage_U, stage_U_j, stage_weights):
    """Step 4: low-order update, high-order RHS F_i, limiter bounds.
    Returns (U_low [C, n], F [C, n], bounds [3, n])."""
    weight = 1.0 - sum(stage_weights)
    d_H = d * (0.5 * (alpha[None] + alpha_j))
    regularization = 100.0 * torch.finfo(U.dtype).tiny
    scaled_c_ij = sa.cij / torch.clamp_min(d, regularization)[None]

    flux_ij, flux_ii = _flux_divergences(eq, sa, U, U_j)
    dU = U_j - U[:, None]
    m = sa.mask[None]

    U_low = U + (tau * sa.m_lumped_inv)[None] * (
        torch.sum((flux_ij + d[None] * dU) * m, 1) + flux_ii
    )
    F = torch.sum((d_H[None] * dU + weight * flux_ij) * m, 1) + weight * flux_ii
    if stage_weights:
        F_inc, _ = _stage_terms(
            eq, sa, m, stage_U, stage_U_j, stage_weights, want_P=False
        )
        if F_inc is not None:
            F = F + F_inc

    hd_i = sa.m_lumped * sa.measure_inv
    bounds = eq.limiter_bounds(
        U, prec, U_j, prec_j, scaled_c_ij, sa.mask, hd_i,
        relaxation_factor=p.limiter_relaxation_factor,
    )
    return U_low, F, bounds


def phase_p_l1(eq, p, sa, U, U_j, d, alpha, alpha_j, tau, F, F_j, m_j,
               U_low, bounds, stage_U, stage_U_j, stage_weights):
    """Step 5: P_ij with the mass-matrix correction and the first limiter
    pass.  Returns (P [C, K, n], l [K, n], success [K, n])."""
    weight = 1.0 - sum(stage_weights)
    d_H = d * (0.5 * (alpha[None] + alpha_j))
    flux_ij, _ = _flux_divergences(eq, sa, U, U_j)

    P = -flux_ij + weight * flux_ij + (d_H - d)[None] * (U_j - U[:, None])
    if stage_weights:
        _, P_inc = _stage_terms(
            eq, sa, sa.mask[None], stage_U, stage_U_j, stage_weights,
            want_P=True,
        )
        if P_inc is not None:
            P = P + P_inc

    # the diagonal P_ii is never applied (hyperbolic_module.template.h:963)
    b_ij = -sa.mij / m_j
    b_ji = -sa.mij * sa.m_lumped_inv[None]
    P = P + b_ij[None] * F_j - b_ji[None] * F[:, None]
    P = P * (tau * sa.m_lumped_inv * sa.n_nbrs)[None, None]

    psi0 = eq.limiter_psi0(bounds[:, None], U_low[:, None])
    l, success = eq.limiter_limit(
        bounds[:, None], U_low[:, None], P, psi0,
        newton_iterations=p.limiter_newton_max_iterations,
        newton_tol=p.limiter_newton_tolerance,
    )
    return P, l, success


def phase_update(eq, p, sa, U_cur, bounds, P, l, l_T, last: bool):
    """Steps 6/7: symmetrized limited update.  l_T is the transposed-edge
    gather of l.  Unless `last`, also returns the next pass's
    l' = (1 - l_sym) l2 (hyperbolic_module.template.h:1163-1170)."""
    l_sym = torch.minimum(l, l_T)
    lam_i = (1.0 / sa.n_nbrs)[None]
    U_next = U_cur + lam_i * torch.sum(l_sym[None] * P * sa.mask[None], 1)
    if last:
        return U_next, None
    psi0 = eq.limiter_psi0(bounds[:, None], U_next[:, None])
    l2, _ = eq.limiter_limit(
        bounds[:, None], U_next[:, None], (1.0 - l_sym)[None] * P, psi0,
        newton_iterations=p.limiter_newton_max_iterations,
        newton_tol=p.limiter_newton_tolerance,
    )
    return U_next, (1.0 - l_sym) * l2


# ---------------------------------------------------------------------------
# The module
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BoundaryCondition:
    """One group of boundary nodes sharing a Boundary id, on the device."""

    bc_id: int
    index: torch.Tensor  # [k] int64 canvas ids, sorted
    normal: torch.Tensor  # [dim, k]
    position: torch.Tensor  # [dim, k]


@dataclasses.dataclass(frozen=True)
class HyperbolicModuleParams:
    """Limiter / indicator / Riemann solver parameters
    (ryujin_tpu.solver.hyperbolic.HyperbolicModuleParams)."""

    evc_factor: float = 1.0
    limiter_iterations: int = 2
    limiter_newton_max_iterations: int = 2
    limiter_newton_tolerance: float = 1.0e-10
    limiter_relaxation_factor: float = 1.0
    riemann_newton_max_iterations: int = 0
    riemann_newton_tolerance: float = 1.0e-10


_PORTED_BCS = (
    Boundary.do_nothing, Boundary.dirichlet, Boundary.slip, Boundary.no_slip,
)


class HyperbolicModule:
    """Owns the stencil and boundary data and provides prepare/step.

    `initial_state_fn(positions [dim, k], t) -> states [C, k]` supplies
    the Dirichlet data.  All arrays are allocated on `device`: the card
    unless the caller names another (the CPU tests pass "cpu")."""

    def __init__(
        self,
        equation,
        sd: StructuredData,
        initial_state_fn: Callable,
        params: HyperbolicModuleParams = HyperbolicModuleParams(),
        dtype=torch.float64,
        device="cuda",
    ):
        if params.riemann_newton_max_iterations != 0:
            raise NotImplementedError(
                "Riemann Newton refinement is not ported (two-rarefaction "
                "bound only)"
            )
        if params.limiter_iterations < 1:
            raise NotImplementedError("limiter_iterations must be >= 1")
        self.eq = equation
        self.params = params
        self.dtype = dtype
        self.device = torch.device(device)
        self.initial_state_fn = initial_state_fn

        self.boundary: List[BoundaryCondition] = []
        for rnd in sd.boundary_rounds:
            for bc_id in sorted(rnd.keys()):
                if bc_id not in _PORTED_BCS:
                    raise NotImplementedError(
                        f"boundary id {bc_id} is not ported (ROADMAP queue 1 "
                        "item 12)"
                    )
                if bc_id == Boundary.do_nothing:
                    continue
                g = rnd[bc_id]
                o = np.argsort(np.asarray(g.index), kind="stable")
                self.boundary.append(BoundaryCondition(
                    bc_id=int(bc_id),
                    index=torch.as_tensor(np.asarray(g.index)[o],
                                          dtype=torch.int64,
                                          device=self.device),
                    normal=torch.as_tensor(g.normal.T[:, o], dtype=dtype,
                                           device=self.device),
                    position=torch.as_tensor(g.position.T[:, o], dtype=dtype,
                                             device=self.device),
                ))

        # symmetric Riemann evaluation: the coupling boundary pairs get the
        # two-direction fixup; the JAX package falls back to evaluating
        # every slot both ways above ~n/16 pairs, which is not ported
        self._bp = _boundary_pair_data(sd, dtype, self.device)
        if self._bp is not None and len(self._bp["k"]) > max(1024, sd.n_pad // 16):
            raise NotImplementedError(
                "coupling-boundary-pair set too large for the half-slot "
                "path; the two-direction path is not ported"
            )

        from .canvas_step import CanvasStepper

        # one set of statics: the plain path reads the kernels' canvases
        self.canvas = CanvasStepper(
            equation, params, sd, dtype, self.device, self._lambda_fixup
        )
        self.stencil = self.canvas.stencil
        self.cmax = self.canvas.arrays.g_cmax.reshape(self.stencil.K, -1)

    def _lambda_fixup(self, lam, Up, prescaled=False):
        """Correct the half-slot lambda at coupling boundary pairs:
        lam_hat = max(lam_fwd |c_ij|, lam_rev |c_ji|) / cmax, so that
        d = lam_hat * cmax equals the reference's max(d_ij, d_ji).

        prescaled: `lam` already holds d = lambda * cmax (the stream
        kernels' e); the current value scales by w_fwd = |c_ij| / cmax as
        before, and the fresh reverse lambda takes the raw |c_ji|."""
        bp = self._bp
        if bp is None:
            return lam
        eq = self.eq
        U_i = Up[:, bp["i"]]
        U_j = Up[:, bp["j"]]
        lam_rev = eq.riemann_lambda_max(
            U_j, U_i, bp["n_T"],
            pa_i=eq.riemann_precompute(U_j), pa_j=eq.riemann_precompute(U_i),
        )
        cur = lam[bp["k"], bp["i"]]
        w_rev = bp["c_rev_norm"] if prescaled else bp["w_rev"]
        val = torch.maximum(cur * bp["w_fwd"], lam_rev * w_rev)
        return lam.index_put((bp["k"], bp["i"]), val)

    # ---- step 1: boundary conditions + precomputation -------------------
    def prepare_state_vector(self, U, t):
        """Apply the boundary conditions (scatter route) and precompute.
        Returns (U, prec); U is a new tensor."""
        U = U.clone()
        for bc in self.boundary:
            dirichlet = (
                self.initial_state_fn(bc.position, t)
                if bc.bc_id == Boundary.dirichlet else None
            )
            U[:, bc.index] = self.eq.apply_boundary_conditions(
                bc.bc_id, U[:, bc.index], bc.normal, dirichlet
            )
        return U, self.eq.precompute(U)

    # ---- steps 2-7 ----------------------------------------------------------
    def step(self, U_old, prec_old, stage_U, stage_weights: Sequence[float],
             tau, cfl: float, tau_cap, compute_tau: bool):
        """One forward-Euler IDP substep.

        U_old, prec_old: prepared state [C, n] / [2, n].  stage_U [S, C, n]
        holds the prepared stage states with static weights (S <= 2).
        tau and tau_cap are 0-d tensors; with compute_tau the computed
        tau_max replaces tau.  CPU tensors run the phase functions, CUDA
        tensors the CUDA kernels.  Returns (U_new, tau, ok) with tau and
        ok 0-d tensors on the device."""
        if U_old.is_cuda:
            return self.canvas.step(
                U_old, prec_old, stage_U, stage_weights, tau, cfl, tau_cap,
                compute_tau,
            )
        if U_old.device.type != "cpu":
            raise ValueError(f"unsupported device {U_old.device}")
        return self.plain_step(
            U_old, prec_old, stage_U, stage_weights, tau, cfl, tau_cap,
            compute_tau,
        )

    def plain_step(self, U_old, prec_old, stage_U, stage_weights, tau, cfl,
                   tau_cap, compute_tau):
        """The substep as plain tensor code (the phase functions on full
        canvases), on whatever device the tensors are on."""
        eq, p, st = self.eq, self.params, self.stencil
        U_j = st.nbr(U_old)
        prec_j = st.nbr(prec_old)
        stage_U_j = [st.nbr(stage_U[s]) for s in range(len(stage_weights))]

        lam, alpha = phase_e_alpha(eq, p, st, U_old, prec_old, U_j, prec_j)
        lam = self._lambda_fixup(lam, U_old)
        d = d_from_lambda(st, lam, self.cmax)
        tau_max = tau_max_from_d(st, d, cfl, tau_cap)
        if compute_tau:
            tau = tau_max

        alpha_j = st.nbr(alpha)
        U_low, F, bounds = phase_low_order(
            eq, p, st, U_old, prec_old, U_j, prec_j, d, alpha, alpha_j, tau,
            stage_U, stage_U_j, stage_weights,
        )
        P, l, success = phase_p_l1(
            eq, p, st, U_old, U_j, d, alpha, alpha_j, tau, F, st.nbr(F),
            st.nbr(st.m_lumped), U_low, bounds, stage_U, stage_U_j,
            stage_weights,
        )
        ok = torch.all(
            success | (st.mask == 0.0) | (st.node_mask[None] == 0.0)
        )
        U_new = U_low
        for it in range(p.limiter_iterations):
            last = it + 1 == p.limiter_iterations
            U_new, l = phase_update(
                eq, p, st, U_new, bounds, P, l, st.transpose_edge(l), last
            )
        return U_new, tau, ok
