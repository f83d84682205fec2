"""Compressible Euler equations with polytropic gas EOS, in PyTorch.

Counterpart of ryujin_tpu/equations/euler.py, restricted to what the 2D
structured-canvas step uses.  The layout is the JAX package's: the
component axis first, the node axis last ([C, ...batch]), and every
function broadcasts over trailing batch axes.  The arithmetic follows the
JAX version operation by operation, so that both packages (and the CUDA
device functions in csrc/euler.cuh) compute the same numbers.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..offline.mesh import Boundary


def on_mask(x, mask):
    """x * mask on the live slots (mask > 0) and 0 on the others: a select,
    so that a neighbour value read through a masked slot never enters a
    sum, even where it is NaN (NaN * 0 is NaN).  mask broadcasts to x."""
    return torch.where(mask > 0, x * mask, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))


def _pos(x):
    return torch.clamp_min(x, 0.0)


def _neg(x):
    return torch.clamp_min(-x, 0.0)


def _pow(x, e: float):
    """torch.pow with (near-)integer exponents strength-reduced to
    multiplies by binary exponentiation, as ryujin_tpu.equations.euler._pow
    (2 gamma / (gamma - 1) is 7 for gamma = 1.4)."""
    er = round(e)
    if abs(e - er) < 1.0e-8 and 1 <= abs(er) <= 16:
        n = abs(er)
        acc = None
        base = x
        while n:
            if n & 1:
                acc = base if acc is None else acc * base
            n >>= 1
            if n:
                base = base * base
        return acc if er > 0 else 1.0 / acc
    return torch.pow(x, e)


@dataclasses.dataclass(frozen=True)
class EulerParams:
    """Runtime parameters (ryujin_tpu.equations.euler.EulerParams)."""

    gamma: float = 1.4
    reference_density: float = 1.0
    vacuum_state_relaxation_small: float = 1.0e2
    vacuum_state_relaxation_large: float = 1.0e4


@dataclasses.dataclass(frozen=True)
class Euler:
    """The Euler description: state algebra, Riemann solver, indicator,
    limiter and boundary conditions on [C, ...] tensors."""

    dim: int
    params: EulerParams = EulerParams()

    name = "euler"
    n_precomputed = 2  # [s, eta_harten]
    n_bounds = 3  # [rho_min, rho_max, s_min]

    @property
    def n_comp(self) -> int:
        return 2 + self.dim

    @property
    def component_names(self):
        if self.dim == 1:
            return ["rho", "m", "E"]
        return ["rho"] + [f"m_{i + 1}" for i in range(self.dim)] + ["E"]

    # ---- derived quantities --------------------------------------------
    def density(self, U):
        return U[0]

    def momentum(self, U):
        return U[1 : 1 + self.dim]

    def total_energy(self, U):
        return U[1 + self.dim]

    def internal_energy(self, U):
        rho_inv = 1.0 / self.density(U)
        m = self.momentum(U)
        return self.total_energy(U) - 0.5 * torch.sum(m * m, 0) * rho_inv

    def pressure(self, U):
        return (self.params.gamma - 1.0) * self.internal_energy(U)

    def specific_entropy(self, U):
        rho_inv = 1.0 / self.density(U)
        return self.internal_energy(U) * torch.pow(rho_inv, self.params.gamma)

    def harten_entropy(self, U):
        g = self.params.gamma
        m = self.momentum(U)
        rho_rho_e = self.density(U) * self.total_energy(U) - 0.5 * torch.sum(
            m * m, 0
        )
        return torch.pow(rho_rho_e, 1.0 / (g + 1.0))

    def harten_entropy_derivative(self, U):
        g = self.params.gamma
        rho = self.density(U)
        m = self.momentum(U)
        E = self.total_energy(U)
        rho_rho_e = rho * E - 0.5 * torch.sum(m * m, 0)
        factor = (1.0 / (g + 1.0)) * torch.pow(rho_rho_e, -g / (g + 1.0))
        return torch.cat(
            [(factor * E)[None], -factor[None] * m, (factor * rho)[None]], 0
        )

    def filter_vacuum_density(self, rho):
        eps = torch.finfo(rho.dtype).eps
        cutoff = (
            self.params.reference_density
            * self.params.vacuum_state_relaxation_large
            * eps
        )
        return torch.where(torch.abs(rho) < cutoff, torch.zeros_like(rho), rho)

    def is_admissible(self, U):
        return (
            (self.density(U) > 0)
            & (self.internal_energy(U) > 0)
            & (self.specific_entropy(U) > 0)
        )

    def from_primitive_state(self, prim):
        g = self.params.gamma
        rho = prim[0]
        u = prim[1 : 1 + self.dim]
        p = prim[1 + self.dim]
        E = p / (g - 1.0) + 0.5 * rho * torch.sum(u * u, 0)
        return torch.cat([rho[None], rho[None] * u, E[None]], 0)

    def to_primitive_state(self, U):
        rho_inv = 1.0 / self.density(U)
        p = self.pressure(U)
        return torch.cat(
            [U[:1], self.momentum(U) * rho_inv[None], p[None]], 0
        )

    # ---- precomputation -------------------------------------------------
    def precompute(self, U):
        """[s, eta_harten] (hyperbolic_system.h:702-737)."""
        return torch.stack(
            [self.specific_entropy(U), self.harten_entropy(U)], 0
        )

    # ---- fluxes -----------------------------------------------------------
    def f(self, U):
        """Flux tensor [C, dim, ...batch]."""
        d = self.dim
        rho_inv = 1.0 / self.density(U)
        m = self.momentum(U)
        p = self.pressure(U)
        E = self.total_energy(U)
        v = m * rho_inv[None]
        rows = [m]
        for a in range(d):
            comps = [m[a] * v[b] for b in range(d)]
            comps[a] = comps[a] + p
            rows.append(torch.stack(comps, 0))
        rows.append(v * (E + p)[None])
        return torch.stack(rows, 0)

    def flux_divergence(self, flux_i, flux_j, c_ij):
        """-(f_i + f_j) . c_ij: flux_* [C, dim, ...], c_ij [dim, ...]."""
        return -torch.sum((flux_i + flux_j) * c_ij[None], 1)

    # ---- Riemann solver ---------------------------------------------------
    def riemann_precompute(self, U):
        """Node-local Riemann inputs (p, a, 1/rho, 1/p, log2 p)."""
        g = self.params.gamma
        rho_inv = 1.0 / self.density(U)
        m = self.momentum(U)
        rho_e = self.total_energy(U) - 0.5 * torch.sum(m * m, 0) * rho_inv
        p = (g - 1.0) * rho_e
        a = torch.sqrt(g * p * rho_inv)
        return p, a, rho_inv, 1.0 / p, torch.log2(p)

    def riemann_lambda_max(self, U_i, U_j, n_ij, pa_i, pa_j):
        """Two-rarefaction upper bound on the maximal wave speed, without
        Newton refinement (riemann_solver.template.h:406-582).  pa_* are
        `riemann_precompute` of U_i and U_j."""
        g = self.params.gamma

        def data(U, pa):
            proj_m = torch.sum(n_ij * self.momentum(U), 0)
            p, a, rho_inv, p_inv, lp = pa
            return self.density(U), proj_m * rho_inv, p, a, p_inv, lp

        rho_i, u_i, p_i, a_i, p_inv_i, lp_i = data(U_i, pa_i)
        rho_j, u_j, p_j, a_j, p_inv_j, lp_j = data(U_j, pa_j)

        p_max = torch.maximum(p_i, p_j)

        factor = (g - 1.0) * 0.5
        num = _pos(a_i + a_j - factor * (u_j - u_i))
        ratio_pow = torch.exp2((-factor / g) * (lp_i - lp_j))
        den = a_i * ratio_pow + a_j
        p_rarefaction = p_j * _pow(num / den, 2.0 * g / (g - 1.0))

        sqrt_2pmax = torch.sqrt(2.0 * p_max)
        ri = rho_i * ((g + 1.0) * p_max + (g - 1.0) * p_i)
        rj = rho_j * ((g + 1.0) * p_max + (g - 1.0) * p_j)
        ri_rsqrt = torch.rsqrt(ri)
        rj_rsqrt = torch.rsqrt(rj)
        x_i = sqrt_2pmax * ri_rsqrt
        x_j = sqrt_2pmax * rj_rsqrt
        a_q = x_i + x_j
        b_q = u_j - u_i
        c_q = -p_i * x_i - p_j * x_j
        base = (-b_q + torch.sqrt(b_q * b_q - 4.0 * a_q * c_q)) / (2.0 * a_q)
        p_failsafe = base * base

        p_star_tilde = torch.minimum(p_rarefaction, p_failsafe)

        sqrt2 = float(np.sqrt(2.0))
        vi = (p_max - p_i) * (sqrt2 * ri_rsqrt)
        vj = (p_max - p_j) * (sqrt2 * rj_rsqrt)
        phi_p_max = vi + vj + u_j - u_i

        p_2 = torch.where(
            phi_p_max < 0.0, p_star_tilde, torch.minimum(p_max, p_star_tilde)
        )

        fac = (g + 1.0) * 0.5 / g
        nu_11 = u_i - a_i * torch.sqrt(1.0 + fac * _pos((p_2 - p_i) * p_inv_i))
        nu_32 = u_j + a_j * torch.sqrt(1.0 + fac * _pos((p_2 - p_j) * p_inv_j))
        return torch.maximum(_pos(nu_32), _neg(nu_11))

    # ---- indicator ----------------------------------------------------------
    def indicator_alpha(self, U_i, prec_i, U_j, prec_j, c_ij, mask, hd_i,
                        evc_factor: float = 1.0):
        """Entropy-viscosity commutator over the stencil
        (euler/indicator.h:187-258).  U_i [C, n], U_j [C, K, n],
        c_ij [dim, K, n], mask [K, n]; returns alpha [n]."""
        eta_i = prec_i[1]
        rho_i_inv = 1.0 / self.density(U_i)
        d_eta_i = self.harten_entropy_derivative(U_i)
        d_eta_i = torch.cat(
            [(d_eta_i[0] - eta_i * rho_i_inv)[None], d_eta_i[1:]], 0
        )
        f_i = self.f(U_i)
        f_j = self.f(U_j)

        eta_j = prec_j[1]
        entropy_flux = (
            eta_j / self.density(U_j) - (eta_i * rho_i_inv)[None]
        ) * torch.sum(self.momentum(U_j) * c_ij, 0)
        left = torch.sum(on_mask(entropy_flux, mask), 0)
        components = torch.sum((f_j - f_i[:, :, None]) * c_ij[None], 1)
        right = torch.sum(on_mask(components, mask[None]), 1)

        numerator = left - torch.sum(d_eta_i * right, 0)
        denominator = torch.abs(left) + torch.sum(torch.abs(d_eta_i * right), 0)
        quotient = torch.abs(numerator) / (denominator + hd_i * torch.abs(eta_i))
        return torch.clamp_max(evc_factor * quotient, 1.0)

    # Slot-streaming form of the indicator (ryujin_tpu/equations/euler.py:
    # 473-505): the stencil reduction one lattice offset at a time, as
    # running (left, right) sums of [n]-sized slabs, for the stream
    # kernels' plain versions.  Same math as indicator_alpha up to the
    # order of the sums.
    def indicator_init(self, U_i, prec_i, f_i=None):
        """Node-local state shared by every indicator_accum call."""
        eta_i = prec_i[1]
        rho_i_inv = 1.0 / self.density(U_i)
        d_eta_i = self.harten_entropy_derivative(U_i)
        d_eta_i = torch.cat(
            [(d_eta_i[0] - eta_i * rho_i_inv)[None], d_eta_i[1:]], 0
        )
        if f_i is None:
            f_i = self.f(U_i)
        return eta_i, rho_i_inv, d_eta_i, f_i

    def indicator_accum(self, state, U_j, prec_j, f_j, c_k, mask_k):
        """One stencil slot's (left [n], right [C, n]) increments."""
        eta_i, rho_i_inv, _, f_i = state
        left = on_mask(
            (prec_j[1] / self.density(U_j) - eta_i * rho_i_inv)
            * torch.sum(self.momentum(U_j) * c_k, 0),
            mask_k,
        )
        right = on_mask(torch.sum((f_j - f_i) * c_k[None], 1), mask_k[None])
        return left, right

    def indicator_finalize(self, state, left, right, hd_i,
                           evc_factor: float = 1.0):
        eta_i, _, d_eta_i, _ = state
        numerator = left - torch.sum(d_eta_i * right, 0)
        denominator = torch.abs(left) + torch.sum(torch.abs(d_eta_i * right), 0)
        quotient = torch.abs(numerator) / (denominator + hd_i * torch.abs(eta_i))
        return torch.clamp_max(evc_factor * quotient, 1.0)

    # ---- limiter --------------------------------------------------------------
    def limiter_bounds(self, U_i, prec_i, U_j, prec_j, scaled_c_ij, mask,
                       hd_i, relaxation_factor: float = 1.0):
        """Accumulated and relaxed bounds [rho_min, rho_max, s_min]
        (euler/limiter.h:255-363), diagonal included."""
        dtype = U_i.dtype
        big = torch.finfo(dtype).max
        on = mask > 0
        rho_i = self.density(U_i)
        rho_j = self.density(U_j)
        m_i = self.momentum(U_i)
        m_j = self.momentum(U_j)

        rho_ij_bar = 0.5 * (
            rho_i[None] + rho_j
            + torch.sum((m_i[:, None] - m_j) * scaled_c_ij, 0)
        )
        rho_min = torch.amin(torch.where(on, rho_ij_bar, big), 0)
        rho_max = torch.amax(torch.where(on, rho_ij_bar, -big), 0)
        rho_min = torch.minimum(rho_min, rho_i)
        rho_max = torch.maximum(rho_max, rho_i)

        s_i = prec_i[0]
        s_min = torch.minimum(torch.amin(torch.where(on, prec_j[0], big), 0), s_i)

        k_count = torch.sum(mask, 0)
        rho_relax_num = (torch.sum(on_mask(rho_i[None] + rho_j, mask), 0)
                         + 2.0 * rho_i)
        rho_relax_den = k_count + 1.0

        s_interp = self.specific_entropy(0.5 * (U_i[:, None] + U_j))
        s_interp_max = torch.maximum(
            torch.amax(torch.where(on, s_interp, -big), 0), s_i
        )

        return self._relax_bounds(
            rho_min, rho_max, s_min, s_interp_max, rho_relax_num,
            rho_relax_den, hd_i, relaxation_factor,
        )

    # Slot-streaming form of the limiter bounds (ryujin_tpu/equations/
    # euler.py:583-647): running (rho_min, rho_max, s_min, s_interp_max,
    # rho_relax_num, k_count) per node, seeded with the diagonal (j = i)
    # contributions, one offset folded in per accum call.
    def limiter_bounds_init(self, U_i, prec_i):
        rho_i = self.density(U_i)
        s_i = prec_i[0]
        return {
            "rho_i": rho_i,
            "m_i": self.momentum(U_i),
            "rho_min": rho_i,
            "rho_max": rho_i,
            "s_min": s_i,
            "s_interp_max": s_i,
            "rho_relax_num": 2.0 * rho_i,
            "k_count": torch.zeros_like(rho_i),
            "U_i": U_i,
        }

    def limiter_bounds_accum(self, st, U_j, prec_j, scaled_c_k, mask_k):
        big = torch.finfo(U_j.dtype).max
        on = mask_k > 0
        rho_j = self.density(U_j)
        rho_ij_bar = 0.5 * (
            st["rho_i"] + rho_j
            + torch.sum((st["m_i"] - self.momentum(U_j)) * scaled_c_k, 0)
        )
        s_interp = self.specific_entropy(0.5 * (st["U_i"] + U_j))
        st = dict(st)
        st["rho_min"] = torch.minimum(
            st["rho_min"], torch.where(on, rho_ij_bar, big)
        )
        st["rho_max"] = torch.maximum(
            st["rho_max"], torch.where(on, rho_ij_bar, -big)
        )
        st["s_min"] = torch.minimum(
            st["s_min"], torch.where(on, prec_j[0], big)
        )
        st["s_interp_max"] = torch.maximum(
            st["s_interp_max"], torch.where(on, s_interp, -big)
        )
        st["rho_relax_num"] = st["rho_relax_num"] + on_mask(
            st["rho_i"] + rho_j, mask_k)
        st["k_count"] = st["k_count"] + mask_k
        return st

    def limiter_bounds_finalize(self, st, hd_i, relaxation_factor: float = 1.0):
        return self._relax_bounds(
            st["rho_min"], st["rho_max"], st["s_min"], st["s_interp_max"],
            st["rho_relax_num"], st["k_count"] + 1.0, hd_i, relaxation_factor,
        )

    def _relax_bounds(self, rho_min, rho_max, s_min, s_interp_max,
                      rho_relax_num, rho_relax_den, hd_i, relaxation_factor):
        """The relaxation of the accumulated bounds (limiter.h:330-363)."""
        if self.dim == 2:
            r_i = torch.sqrt(torch.sqrt(hd_i)) ** 3
        elif self.dim == 1:
            r_i = torch.sqrt(hd_i) ** 3
        else:
            r_i = torch.sqrt(hd_i)
        r_i = r_i * relaxation_factor

        eps = torch.finfo(rho_min.dtype).eps
        rho_relaxation = torch.abs(rho_relax_num) / (torch.abs(rho_relax_den) + eps)
        relaxation = 2.0 * relaxation_factor * rho_relaxation

        rho_min = torch.maximum((1.0 - r_i) * rho_min, rho_min - relaxation)
        rho_max = torch.minimum((1.0 + r_i) * rho_max, rho_max + relaxation)

        entropy_relaxation = relaxation_factor * (s_interp_max - s_min)
        s_min = torch.maximum((1.0 - r_i) * s_min, s_min - entropy_relaxation)
        return torch.stack([rho_min, rho_max, s_min], 0)

    def limiter_psi0(self, bounds, U):
        """Node-local (rho, rho^gamma, rho*rho_e, psi) at t = 0, hoisted out
        of the per-slot limiter calls."""
        eps = torch.finfo(U.dtype).eps
        relax_small = 1.0 + self.params.vacuum_state_relaxation_small * eps
        rho = self.density(U)
        rho_gamma = torch.pow(rho, self.params.gamma)
        m = self.momentum(U)
        ae = rho * self.total_energy(U) - 0.5 * torch.sum(m * m, 0)
        psi = relax_small * ae - bounds[2] * rho_gamma * rho
        return rho, rho_gamma, ae, psi

    def limiter_limit(self, bounds, U, P, psi0, newton_iterations: int = 2,
                      newton_tol: float = 1.0e-10):
        """Convex limiter (euler/limiter.template.h:15-327) on [C, ...]
        tensors with t_min = 0, t_max = 1.  psi0 is
        `limiter_psi0(bounds, U)`.  Returns (l, success).

        The JAX version skips the Newton loop when psi(t_r) > 0 on every
        lane; the loop leaves such a lane at t_l = t_r exactly (the
        bracket collapses), so it runs here unconditionally and gives the
        same numbers lane by lane."""
        dtype = U.dtype
        g = self.params.gamma
        gp1 = g + 1.0
        eps = torch.finfo(dtype).eps
        relax_small = 1.0 + self.params.vacuum_state_relaxation_small * eps
        relax = 1.0 + self.params.vacuum_state_relaxation_large * eps

        rho_min, rho_max, s_min = bounds[0], bounds[1], bounds[2]
        rho_U = self.density(U)
        rho_P = self.density(P)

        test_min = self.filter_vacuum_density(_pos(rho_U - relax * rho_max))
        test_max = self.filter_vacuum_density(_pos(rho_min - relax * rho_U))
        success = (test_min == 0.0) & (test_max == 0.0)

        shape = torch.broadcast_shapes(rho_U.shape, rho_P.shape)
        t_r = torch.ones(shape, dtype=dtype, device=U.device)
        denominator = 1.0 / (torch.abs(rho_P) + eps * rho_max)
        t_r = torch.where(
            rho_max < rho_U + t_r * rho_P, (rho_max - rho_U) * denominator, t_r
        )
        t_r = torch.where(
            rho_U + t_r * rho_P < rho_min, (rho_U - rho_min) * denominator, t_r
        )
        t_r = torch.clamp(t_r, 0.0, 1.0)

        E_U = self.total_energy(U)
        E_P = self.total_energy(P)
        m_U = self.momentum(U)
        m_P = self.momentum(P)
        ae = psi0[2]
        be = rho_U * E_P + rho_P * E_U - torch.sum(m_U * m_P, 0)
        ce = rho_P * E_P - 0.5 * torch.sum(m_P * m_P, 0)

        def psi_eval(t):
            rho_t = rho_U + t * rho_P
            rho_g = torch.pow(rho_t, g)
            psi = relax_small * (ae + t * (be + t * ce)) - s_min * rho_g * rho_t
            return rho_t, rho_g, psi

        def dpsi_eval(t, rho_g):
            return (be + 2.0 * ce * t) - gp1 * s_min * rho_g * rho_P

        t_l = torch.zeros_like(t_r)
        if newton_iterations == 0:
            return t_l, success
        rho_r, rho_r_gamma, psi_r = psi_eval(t_r)
        succ = success
        for n in range(newton_iterations):
            if n > 0:
                rho_r, rho_r_gamma, psi_r = psi_eval(t_r)
            pr_pos = psi_r > 0.0
            t_l = torch.where(pr_pos, t_r, t_l)
            if n == 0:
                rho_l = torch.where(pr_pos, rho_r, psi0[0])
                rho_l_gamma = torch.where(pr_pos, rho_r_gamma, psi0[1])
                psi_l = torch.where(pr_pos, psi_r, psi0[3])
                lower_bound = (1.0 - relax) * s_min * rho_l * rho_l_gamma
                succ = succ & (psi_l - lower_bound >= 0.0)
            else:
                rho_l, rho_l_gamma, psi_l = psi_eval(t_l)
            dpsi_l = dpsi_eval(t_l, rho_l_gamma)
            dpsi_r = dpsi_eval(t_r, rho_r_gamma)
            nl, nr = quadratic_newton_step(
                t_l, t_r, psi_l, psi_r, dpsi_l, dpsi_r, sign=-1.0
            )
            active = (t_r - t_l) > newton_tol
            t_l = torch.where(active, nl, t_l)
            t_r = torch.where(active, nr, t_r)
        return t_l, succ

    # ---- boundary conditions -------------------------------------------------
    def apply_boundary_conditions(self, bc_id: int, U, normal, dirichlet_data):
        """U [C, k], normal [dim, k]; the ids the step mesh uses
        (its re-entrant corner node is no_slip)."""
        if bc_id == Boundary.do_nothing:
            return U
        if bc_id == Boundary.dirichlet:
            return dirichlet_data
        if bc_id == Boundary.slip:
            m = self.momentum(U)
            m = m - torch.sum(m * normal, 0, keepdim=True) * normal
            return torch.cat([U[:1], m, U[1 + self.dim :]], 0)
        if bc_id == Boundary.no_slip:
            return torch.cat(
                [U[:1], torch.zeros_like(self.momentum(U)), U[1 + self.dim :]],
                0,
            )
        raise NotImplementedError(
            f"boundary id {bc_id}: only dirichlet, slip, no_slip and do_nothing are "
            'ported (ROADMAP queue 1, "The rest of the single-block canvas")'
        )


def quadratic_newton_step(p_1, p_2, phi_p_1, phi_p_2, dphi_p_1, dphi_p_2,
                          sign=1.0):
    """One step of the two-sided quadratic Newton method (newton.h:37-101)."""
    eps = torch.finfo(p_1.dtype).eps
    scaling = 1.0 / (p_2 - p_1 + eps)

    dd_11 = dphi_p_1
    dd_12 = (phi_p_2 - phi_p_1) * scaling
    dd_22 = dphi_p_2
    dd_112 = (dd_12 - dd_11) * scaling
    dd_122 = (dd_22 - dd_12) * scaling

    discriminant_1 = torch.abs(dphi_p_1 * dphi_p_1 - 4.0 * phi_p_1 * dd_112)
    discriminant_2 = torch.abs(dphi_p_2 * dphi_p_2 - 4.0 * phi_p_2 * dd_122)
    denominator_1 = dphi_p_1 + sign * torch.sqrt(discriminant_1)
    denominator_2 = dphi_p_2 + sign * torch.sqrt(discriminant_2)

    small_1 = torch.abs(denominator_1) < eps
    small_2 = torch.abs(denominator_2) < eps
    t_1 = p_1 - torch.where(
        small_1, torch.zeros_like(p_1),
        2.0 * phi_p_1 / torch.where(small_1, torch.ones_like(p_1), denominator_1),
    )
    t_2 = p_2 - torch.where(
        small_2, torch.zeros_like(p_2),
        2.0 * phi_p_2 / torch.where(small_2, torch.ones_like(p_2), denominator_2),
    )
    t_1 = torch.minimum(torch.maximum(t_1, p_1), p_2)
    t_2 = torch.minimum(torch.maximum(t_2, p_1), p_2)
    return torch.minimum(t_1, t_2), torch.maximum(t_1, t_2)
