"""The hyperbolic module in PyTorch: graph-viscosity IDP substep with
convex limiting (ryujin_tpu/solver/hyperbolic.py).

Scope: the Euler equations on the padded-ELL gather stencil (offline/
ell.py: 1D, 2D and 3D, any mesh, cG or dG; the two-direction wavespeeds
on every slot, no boundary-pair fixup, scatter boundary conditions, as
the JAX package runs ELL), or on a structured canvas, with or without
ghosts (periodic ghost bands, slabs, a padded periodic minor axis, the
cross-block ghost cells of a 2D multi-block canvas with its
extraordinary-vertex side rows, solver/sideband.py: every neighbour read
refreshes them first), 2D of any lattice reach (the Mach-3 step of bench
cases step2d, cG Q1 with K = 8, and q2step2d, cG Q2 with K = 24; cG Q3
with K = 48) or 3D of reach 1 (the Mach-3 box of bench cases box3d, cG
Q1 with K = 26, and dg1box3d, dG Q1 with K = 26), continuous or
discontinuous (the dG incidence raises the high-order viscosity factor
to beta_ij, `viscosity_factor`), with the scatter route for boundary
conditions; a 3D cG canvas that is an extrusion along z (the Mach-3 box,
the cylinder o-grid of bench case cylinder3d) may keep its statics as
separable factors.  The Riemann wavespeeds take the symmetric half-slot
evaluation with the coupling-boundary-pair fixup, or, above the JAX
package's cut-off on the size of that pair set and on a multi-block
canvas unless its half-slot route (with the interface fixup) is asked
for, the two-direction evaluation on every slot.  The phase functions
are plain tensor code on full canvases or the ELL stencil;
`HyperbolicModule.step` runs them for CPU tensors and the hand-written
CUDA kernels (solver/canvas_step.py, solver/ell_step.py) for CUDA
tensors.

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

from ..equations.euler import on_mask as _on_mask
from ..offline.ell import EllData
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
    midx = _owner_index(sd, midx)
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


def _interface_fixup_data(fix, dtype, device):
    """The multi-block interface fixup list (StructuredData.sym_fixup) on
    the device, as hyperbolic.py:1332-1356 builds it: the unit normals of
    the forward and reverse c_ij, and their norms over cmax, all computed
    from c_ij rounded to `dtype`."""
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    tiny = float(np.finfo(np_dtype).tiny)
    c_f = np.asarray(fix["c_f"], np_dtype)
    c_r = np.asarray(fix["c_r"], np_dtype)
    nf = np.sqrt(np.sum(c_f * c_f, axis=1))
    nr = np.sqrt(np.sum(c_r * c_r, axis=1))
    icm = np.asarray(fix["inv_cmax"], np_dtype)

    def t(x, dt=dtype):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dt,
                               device=device)

    return {
        "dst": t(fix["dst"], torch.int64),
        "i": t(fix["i"], torch.int64),
        "j": t(fix["j"], torch.int64),
        "n_f": t((c_f / np.maximum(nf, tiny)[:, None]).T),
        "n_r": t((c_r / np.maximum(nr, tiny)[:, None]).T),
        "w_f": t(nf * icm),
        "w_r": t(nr * icm),
    }


def _owner_index(sd: StructuredData, midx):
    """Canvas multi-indices [m, dim] with every ghost cell replaced by the
    real cell it copies, so that the fixup's direct reads of U see owner
    values: a slab band row to its row in the cyclically adjacent slab and
    a minor-wrap column to its owner column, as the JAX package remaps
    (hyperbolic.py:500-545), and a row of a periodic ghost band to its
    wrapped real row, which the JAX package does not remap (its XLA path
    then reads the unrefreshed U_old there); on a multi-block canvas a
    ghost cell to its owner cell (gmap_node), as the JAX package remaps
    (:501-507)."""
    midx = midx.copy()
    if getattr(sd, "gmap_node", None) is not None:
        shape = tuple(sd.shape)
        dst, src = (np.asarray(a, np.int64) for a in sd.gmap_node)
        own = np.arange(int(np.prod(shape)), dtype=np.int64)
        own[dst] = src
        flat = own[np.ravel_multi_index(tuple(midx.T), shape)]
        midx = np.stack(np.unravel_index(flat, shape), axis=1)
    if sd.slab_spec is not None:
        n_sl, Ls, g = sd.slab_spec
        A = Ls + 2 * g
        r = midx[:, 0]
        s_sl, a_loc = r // A, r % A
        midx[:, 0] = np.where(
            a_loc < g, ((s_sl - 1) % n_sl) * A + Ls + a_loc,
            np.where(a_loc >= g + Ls, ((s_sl + 1) % n_sl) * A + a_loc - Ls,
                     r),
        )
    for ax, gh in enumerate(sd.ghosts or ()):
        if gh is None:
            continue
        g, P = gh
        r = midx[:, ax]
        midx[:, ax] = np.where(r < g, r + P,
                               np.where((r >= g + P) & (r < 2 * g + P),
                                        r - P, r))
    if sd.minor_wrap is not None:
        P, W = sd.minor_wrap
        r = sd.reach
        x = midx[:, -1]
        x = np.where((x >= P) & (x < P + r), x - P, x)
        midx[:, -1] = np.where(x >= W - r, x - (W - P), x)
    return midx


def d_from_lambda(st, lam_half, cmax=None):
    """d = lambda * max(|c_ij|, |c_ji|) on live edges from the half-slot
    lambda [K/2, n]: slot k >= K/2 reads plane K-1-k of its neighbour.
    cmax=None takes lam_half as already scaled by cmax (the stream
    kernels' e; cmax_k(i) == cmax_{K-1-k}(j), so the transposed read of e
    is d itself)."""
    K = st.K
    lam_half = st.refresh_edges(lam_half)
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
    return tau_max_from_row_sum(sa, torch.sum(d, 0), cfl, tau_cap)


def tau_max_from_row_sum(sa, d_row_sum, cfl, tau_cap):
    """tau_max_from_d from the row sums sum_j d_ij [n]."""
    finfo = torch.finfo(d_row_sum.dtype)
    d_sum = torch.clamp_max(-d_row_sum, -1.0e6 * finfo.tiny)
    tau_i = cfl * sa.m_lumped / (-2.0 * d_sum)
    tau_max = torch.amin(
        torch.where(sa.node_mask > 0, tau_i, torch.full_like(tau_i, finfo.max))
    )
    return torch.minimum(tau_max, tau_cap)


def viscosity_factor(sa, alpha, alpha_j):
    """The high-order graph viscosity factor of d_H = d * factor [K, n]:
    1/2 (alpha_i + alpha_j), and on a dG canvas at least the incidence
    beta_ij, which forces low-order dissipation across element interfaces
    (hyperbolic.py:924-928, 1006-1010; hyperbolic_module.template.h:
    733-737)."""
    factor = 0.5 * (alpha[None] + alpha_j)
    if sa.incidence is not None:
        factor = torch.maximum(factor, sa.incidence)
    return factor


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
        F_inc = w_s * (torch.sum(_on_mask(hof_s, m), 1) + hof_s_ii)
        F_acc = F_inc if F_acc is None else F_acc + F_inc
        if want_P:
            P_acc = w_s * hof_s if P_acc is None else P_acc + w_s * hof_s
    return F_acc, P_acc


def phase_low_order(eq, p, sa, U, prec, U_j, prec_j, d, alpha, alpha_j, tau,
                    stage_U, stage_U_j, stage_weights):
    """Step 4: low-order update, high-order RHS F_i, limiter bounds.
    Returns (U_low [C, n], F [C, n], bounds [3, n])."""
    weight = 1.0 - sum(stage_weights)
    d_H = d * viscosity_factor(sa, alpha, alpha_j)
    regularization = 100.0 * torch.finfo(U.dtype).tiny
    scaled_c_ij = sa.cij / torch.clamp_min(d, regularization)[None]

    flux_ij, flux_ii = _flux_divergences(eq, sa, U, U_j)
    dU = U_j - U[:, None]
    m = sa.mask[None]

    U_low = U + (tau * sa.m_lumped_inv)[None] * (
        torch.sum(_on_mask(flux_ij + d[None] * dU, m), 1) + flux_ii
    )
    F = (torch.sum(_on_mask(d_H[None] * dU + weight * flux_ij, m), 1)
         + weight * flux_ii)
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
    d_H = d * viscosity_factor(sa, alpha, alpha_j)
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
    l' = (1 - l_sym) l2 (hyperbolic_module.template.h:1163-1170).

    The sum selects on the mask, so a masked slot's l_sym P never enters
    U, even where it is NaN read from rows no refresh makes valid (the
    outer slab bands; the JAX package zeroes l_sym there instead,
    mask_lT, hyperbolic.py:1065-1090, which leaves the same U)."""
    l_sym = torch.minimum(l, l_T)
    lam_i = (1.0 / sa.n_nbrs)[None]
    U_next = U_cur + lam_i * torch.sum(
        _on_mask(l_sym[None] * P, sa.mask[None]), 1)
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

    `sd` is a StructuredData canvas or an EllData padded stencil.
    `initial_state_fn(positions [dim, k], t) -> states [C, k]` supplies
    the Dirichlet data.  All arrays are allocated on `device`: the card
    unless the caller names another (the CPU tests pass "cpu").
    `separable=True` keeps the statics of a 3D cG canvas that is an
    extrusion along z as z-profiles x 2D fields, never allocating the
    full static canvases (the JAX package's RYUJIN_SEP=1); it raises on
    any other canvas.  A 2D multi-block canvas (offline/multiblock.py)
    runs the two-direction route, as the JAX package runs it by default;
    `sym_mb=True` asks for its half-slot route with the interface fixup
    instead (the JAX package's RYUJIN_SYM_MB=1), which a canvas with
    extraordinary-vertex side rows does not have (ValueError).  `canvas` is
    the CanvasStepper of a canvas, `ell` the EllStepper of an ELL stencil
    (None otherwise), `sideband` the side rows of a multi-block canvas
    (solver/sideband.py; None otherwise)."""

    def __init__(
        self,
        equation,
        sd,
        initial_state_fn: Callable,
        params: HyperbolicModuleParams = HyperbolicModuleParams(),
        dtype=torch.float64,
        device="cuda",
        separable: bool = False,
        sym_mb: bool = False,
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
                        f"boundary id {bc_id} is not ported (ROADMAP queue 1, "
                        '"The rest of the single-block canvas")'
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

        self.canvas = self.ell = self.sideband = None
        self._if = None
        multiblock = getattr(sd, "gmap_node", None) is not None
        if sym_mb and not multiblock:
            raise ValueError("sym_mb takes a multi-block canvas")
        if isinstance(sd, EllData):
            # ELL keeps the two-direction evaluation (the generic transpose
            # is an arbitrary permutation, hyperbolic.py:1276-1278)
            if separable:
                raise ValueError("separable statics take a 3D cG canvas, "
                                 "not an ELL stencil")
            from .ell_step import EllStepper

            self.half, self._bp = False, None
            self.ell = EllStepper(equation, params, sd, dtype, self.device)
            self.stencil = self.ell.stencil
            return

        # The Riemann route, decided once (hyperbolic.py:1297-1320): the
        # symmetric half-slot evaluation, where the coupling boundary pairs
        # get the two-direction fixup; above max(1024, n_pad / 16) pairs
        # (a 3D box's whole surface) every slot is evaluated both ways
        # instead, with no fixup.  Both the kernels and plain_step follow
        # `half`.
        # A multi-block canvas breaks the k <-> K-1-k pairing at its block
        # interfaces: the two-direction route by default, the half-slot
        # route with the boundary pairs and the interface fixup on request
        # (hyperbolic.py:1276-1368; the JAX package's cut-off on the pair
        # set does not apply there).
        if multiblock:
            if sym_mb and sd.sym_fixup is None:
                raise ValueError(
                    "this multi-block canvas has no half-slot route (its "
                    "extraordinary-vertex side rows take the two-direction "
                    "evaluation; StructuredData.sym_fixup is None)"
                )
            self.half = sym_mb
            self._bp = (_boundary_pair_data(sd, dtype, self.device)
                        if sym_mb else None)
            if sym_mb:
                self._if = _interface_fixup_data(sd.sym_fixup, dtype,
                                                 self.device)
        else:
            self._bp = _boundary_pair_data(sd, dtype, self.device)
            self.half = self._bp is None or (
                len(self._bp["k"]) <= max(1024, sd.n_pad // 16)
            )
            if not self.half:
                self._bp = None
        if getattr(sd, "ev_side", None) is not None:
            from .sideband import Sideband

            self.sideband = Sideband(equation, params, sd, dtype, self.device)

        from .canvas_step import CanvasStepper

        # one set of statics: the plain path reads the kernels' canvases
        self.canvas = CanvasStepper(
            equation, params, sd, dtype, self.device, self._lambda_fixup,
            self.half, separable,
            interface_fixup=self._interface_fixup if sym_mb else None,
            sideband=self.sideband,
        )
        self.stencil = self.canvas.stencil

    @property
    def cmax(self):
        """max(|c_ij|, |c_ji|) [K, n] (synthesized with separable statics)."""
        return self.stencil.full().cmax

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

    def _interface_fixup(self, lam, Up):
        """The multi-block half-slot route's interface fixup
        (hyperbolic.py:1418-1463): each directed edge whose transposed-slot
        route breaks at a block interface is evaluated in both directions,
        and max(lambda_f |c_f|, lambda_r |c_r|) / cmax is written into the
        half-slot lambda [K/2, n] at the route's read entry, so that the d
        rebuild lambda * cmax recovers the two-direction d_ij there.
        Returns a new tensor."""
        f = self._if
        if f is None or f["dst"].numel() == 0:
            return lam
        eq = self.eq
        U_i, U_j = Up[:, f["i"]], Up[:, f["j"]]
        pa_i, pa_j = eq.riemann_precompute(U_i), eq.riemann_precompute(U_j)
        lam_f = eq.riemann_lambda_max(U_i, U_j, f["n_f"], pa_i=pa_i,
                                      pa_j=pa_j)
        lam_r = eq.riemann_lambda_max(U_j, U_i, f["n_r"], pa_i=pa_j,
                                      pa_j=pa_i)
        val = torch.maximum(lam_f * f["w_f"], lam_r * f["w_r"])
        return torch.index_copy(lam.reshape(-1), 0, f["dst"],
                                val).reshape(lam.shape)

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
        holds the prepared stage states with static weights (S <= 4 through
        the kernels, kernels.build.MAX_STAGES).
        tau and tau_cap are 0-d tensors; with compute_tau the computed
        tau_max replaces tau.  CPU tensors run the phase functions, CUDA
        tensors the CUDA kernels (of the canvas or of ELL).  Returns
        (U_new, tau, ok) with tau and ok 0-d tensors on the device."""
        if U_old.is_cuda:
            return (self.canvas or self.ell).step(
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
        canvases or on the ELL stencil), on whatever device the tensors
        are on; with separable statics on the stacks synthesized for this
        call.  The side rows of a multi-block canvas are computed and
        written in the order of hyperbolic.py:1621-1699."""
        eq, p, st = self.eq, self.params, self.stencil.full()
        sb = self.sideband
        U_j = st.nbr(U_old)
        prec_j = st.nbr(prec_old)
        stage_U_j = [st.nbr(stage_U[s]) for s in range(len(stage_weights))]

        if self.half:
            lam, alpha = phase_e_alpha(eq, p, st, U_old, prec_old, U_j, prec_j)
            lam = self._lambda_fixup(lam, U_old)
            if self._if is not None:
                lam = self._interface_fixup(st.refresh_edges(lam), U_old)
            d = d_from_lambda(st, lam, st.cmax)
        else:
            e, alpha = phase_e_alpha(
                eq, p, st, U_old, prec_old, U_j, prec_j, half=False
            )
            if sb is not None:
                e_s, alpha_s = sb.e_alpha(U_old, prec_old)
                sb.scatter_edge_(e, e_s)
                sb.scatter_rows_(alpha, alpha_s)
            d = d_from_e(st.mask, e, st.transpose_edge(e))
        tau_max = tau_max_from_d(st, d, cfl, tau_cap)
        if sb is not None:
            # the side transposes read owner slots: no refresh needed
            d_s = sb.d_side(e_s, e)
            tau_max = torch.minimum(tau_max, sb.tau_side(d_s, cfl, tau_cap))
        if compute_tau:
            tau = tau_max

        alpha_j = st.nbr(alpha)
        U_low, F, bounds = phase_low_order(
            eq, p, st, U_old, prec_old, U_j, prec_j, d, alpha, alpha_j, tau,
            stage_U, stage_U_j, stage_weights,
        )
        if sb is not None:
            Ul_s, F_s, b_s = sb.low_order(U_old, prec_old, d_s, alpha, tau,
                                          stage_U, stage_weights)
            sb.scatter_rows_(U_low, Ul_s)
            sb.scatter_rows_(F, F_s)
            sb.scatter_rows_(bounds, b_s)
        P, l, success = phase_p_l1(
            eq, p, st, U_old, U_j, d, alpha, alpha_j, tau, F, st.nbr(F),
            st.nbr(st.m_lumped), U_low, bounds, stage_U, stage_U_j,
            stage_weights,
        )
        if sb is not None:
            P_s, l_s, succ_s = sb.p_l1(U_old, d_s, alpha, tau, F,
                                       st.m_lumped, Ul_s, b_s, stage_U,
                                       stage_weights)
            sb.scatter_edge_(l, l_s)
            # the side rows' partial canvas success is replaced
            success[:, sb.cells] = True
        ok = torch.all(
            success | (st.mask == 0.0) | (st.node_mask[None] == 0.0)
        )
        if sb is not None:
            ok = ok & torch.all(succ_s | (sb.st.mask == 0.0))
        U_new = U_low
        U_side = Ul_s if sb is not None else None
        for it in range(p.limiter_iterations):
            last = it + 1 == p.limiter_iterations
            l_T = st.transpose_edge(l)
            U_next, l_next = phase_update(
                eq, p, st, U_new, bounds, P, l, l_T, last
            )
            if sb is not None:
                # the side pass reads the same pass's canvas l
                U_side, l_s_next = sb.update(U_side, b_s, P_s, l_s, l, last)
                sb.scatter_rows_(U_next, U_side)
                if not last:
                    sb.scatter_edge_(l_next, l_s_next)
                    l_s = l_s_next
            U_new, l = U_next, l_next
        return U_new, tau, ok
