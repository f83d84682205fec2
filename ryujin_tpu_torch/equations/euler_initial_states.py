"""The Euler initial state library in PyTorch (ryujin_tpu/equations/
euler_initial_states.py, the reference's initial_state_library_euler.h):

  uniform, isentropic vortex, becker solution, contrast, radial contrast,
  three state contrast, four state contrast, shock front, rarefaction,
  leblanc, smooth wave, ramp up, noh, astro jet, icf like,
  function (expressions)

plus the Galilei transform of InitialValues.  States are functions
`(points [dim, ...], t) -> states [C, ...]` on tensors; the points' dtype
and device carry over to the state.  `t` is a Python float or a 0-d
tensor on the points' device (the module's Dirichlet data is evaluated at
the device time): no state reads it back to the host, and every branch on
t is a tensor select.
"""

from __future__ import annotations

import math
import types
from typing import Sequence

import numpy as np
import torch


def galilei_wrap(state_fn, direction, position, dim):
    """Affine transform of InitialValues (initial_values.template.h:66-155):
    points are rotated so `direction` maps onto the x-axis around
    `position`, and the momentum is rotated back.  In 3D the rotation in
    the x-z plane comes first for points and last for the momentum, as in
    ryujin_tpu/equations/euler_initial_states.py:29-75.  In 1D the points
    are only shifted by `position`: there is nothing to rotate."""
    if dim not in (1, 2, 3):
        raise ValueError(f"no initial states in dim {dim}")
    direction = np.asarray(direction, dtype=np.float64)
    direction = tuple(float(v) for v in direction / np.linalg.norm(direction))
    position = np.asarray(position, dtype=np.float64)

    def plane(a, b):
        """(cos, sin) of the rotation taking direction's (a, b) components
        onto a, or None where they vanish."""
        n_a, n_b = direction[a], direction[b]
        norm = math.sqrt(n_a * n_a + n_b * n_b)
        return (n_a / norm, n_b / norm) if norm > 1e-14 else None

    xy = plane(0, 1) if dim >= 2 else None
    xz = plane(0, 2) if dim == 3 else None

    def rotate(v, rot, b, back=False):
        """v [dim, ...] with components 0 and b rotated by rot onto the
        x-axis (points), or `back` from it (momentum)."""
        c, s = rot
        if back:
            s = -s
        rows = list(v)
        rows[0] = c * v[0] + s * v[b]
        rows[b] = -s * v[0] + c * v[b]
        return torch.stack(rows, 0)

    def wrapped(points, t):
        d = points - torch.as_tensor(
            position, dtype=points.dtype, device=points.device
        ).reshape((dim,) + (1,) * (points.ndim - 1))
        if xz is not None:
            d = rotate(d, xz, 2)
        if xy is not None:
            d = rotate(d, xy, 1)
        state = state_fn(d, t)
        m = state[1 : 1 + dim]
        if xy is not None:
            m = rotate(m, xy, 1, back=True)
        if xz is not None:
            m = rotate(m, xz, 2, back=True)
        return torch.cat([state[:1], m, state[1 + dim :]], 0)

    return wrapped


def _time(t, points):
    """t as a 0-d tensor of the points' dtype on their device (a tensor
    already there is returned as it is: no copy, no host read)."""
    return torch.as_tensor(t, dtype=points.dtype, device=points.device)


def _where(cond, a, b, like):
    """torch.where with Python numbers taken as tensors of like's dtype."""
    def t(v):
        return v if torch.is_tensor(v) else torch.full_like(like, v)

    return torch.where(cond, t(a), t(b))


def _stack_1d(eq, rho, u, E):
    """[rho, rho u, 0 .., E]: a state moving along x."""
    zeros = [torch.zeros_like(rho) for _ in range(eq.dim - 1)]
    return torch.stack([rho, rho * u] + zeros + [E], 0)


def isentropic_vortex(eq, mach_number=2.0, beta=5.0):
    """(euler/initial_state_isentropic_vortex.h:53-91)."""
    gamma = eq.params.gamma
    dim = eq.dim
    if dim < 2:
        raise ValueError("isentropic vortex requires dim >= 2")

    def fn(points, t):
        x = points[0] - mach_number * t
        y = points[1]
        r_sq = x * x + y * y
        factor = beta / (2.0 * math.pi) * torch.exp(0.5 - 0.5 * r_sq)
        T = 1.0 - (gamma - 1.0) / (2.0 * gamma) * factor * factor
        u = mach_number - factor * y
        v = factor * x
        rho = torch.pow(T, 1.0 / (gamma - 1.0))
        p = torch.pow(rho, gamma)
        E = p / (gamma - 1.0) + 0.5 * rho * (u * u + v * v)
        rows = [rho, rho * u, rho * v] + (
            [torch.zeros_like(rho)] if dim == 3 else []
        )
        return torch.stack(rows + [E], 0)

    return fn


def uniform(eq, primitive_state: Sequence[float] = (1.4, 3.0, 1.0)):
    """Constant state from primitive [rho, u, p] or [rho, v_1..v_dim, p]
    (initial_state_uniform.h)."""
    prim = [float(v) for v in primitive_state]
    dim = eq.dim

    def fn(points, t):
        del t
        shape = points.shape[1:]
        kw = dict(dtype=points.dtype, device=points.device)
        if len(prim) == 3:
            vel = [torch.full(shape, prim[1], **kw)] + [
                torch.zeros(shape, **kw) for _ in range(dim - 1)
            ]
            p = prim[2]
        else:
            vel = [torch.full(shape, prim[1 + d], **kw) for d in range(dim)]
            p = prim[1 + dim]
        prim_state = torch.stack(
            [torch.full(shape, prim[0], **kw)] + vel
            + [torch.full(shape, p, **kw)],
            0,
        )
        return eq.from_primitive_state(prim_state)

    return fn


def contrast(eq, primitive_left=(1.4, 0.0, 1.0),
             primitive_right=(1.4, 0.0, 1.0)):
    """Jump at x = 0 between two primitive states (initial_state_contrast.h)."""
    L = uniform(eq, primitive_left)
    R = uniform(eq, primitive_right)

    def fn(points, t):
        return torch.where((points[0] > 0.0)[None], R(points, t),
                           L(points, t))

    return fn


def shock_front(eq, mach_number=2.0, primitive_right=(1.4, 0.0, 1.0)):
    """Moving shock front via Rankine-Hugoniot (initial_state_shock_front.h):
    the right (unshocked) state is given, the left state and the shock
    speed follow for the shock Mach number `mach_number`."""
    gamma = eq.params.gamma
    rho_R, u_R, p_R = primitive_right[0], primitive_right[1], primitive_right[-1]
    a_R = math.sqrt(gamma * p_R / rho_R)
    mach = mach_number
    S3 = mach * a_R
    delta_mach = mach * mach - 1.0

    rho_L = rho_R * (gamma + 1.0) * mach * mach / (
        (gamma - 1.0) * mach * mach + 2.0
    )
    u_L = u_R + 2.0 * a_R / (gamma + 1.0) * delta_mach / mach
    p_L = p_R * (2.0 * gamma * mach * mach - (gamma - 1.0)) / (gamma + 1.0)

    L = uniform(eq, (rho_L, u_L, p_L))
    R = uniform(eq, (rho_R, u_R, p_R))

    def fn(points, t):
        sel = ((points[0] - S3 * t) > 0.0)[None]
        return torch.where(sel, R(points, t), L(points, t))

    return fn


def leblanc(eq):
    """LeBlanc shock tube analytic solution (initial_state_leblanc.h)."""
    gamma = 5.0 / 3.0

    def fn(points, t):
        x = points[0]
        t = _time(t, points)
        rho_L, p_L = 1.0, (2.0 / 3.0) * 1.0e-1
        rho_R, p_R = 1.0e-3, (2.0 / 3.0) * 1.0e-10
        a_L = math.sqrt(gamma * p_L / rho_L)
        u_star = 0.621838
        p_star = 0.515577e-3
        rho_star_L = 5.40793353493162e-2
        rho_star_R = 3.99999806043000e-3
        S_shock = 0.829867

        xt = torch.where(t > 0, x / torch.clamp_min(t, 1e-300),
                         torch.sign(x) * 1e10)
        a_star_L = a_L - 0.5 * (gamma - 1.0) * u_star

        u_f = 2.0 / (gamma + 1.0) * (a_L + xt)
        a_f = a_L - 0.5 * (gamma - 1.0) * u_f
        rho_f = rho_L * torch.pow(a_f / a_L, 2.0 / (gamma - 1.0))
        p_f = p_L * torch.pow(a_f / a_L, 2.0 * gamma / (gamma - 1.0))

        def pick(left, fan, star_l, star_r, right):
            return _where(xt < -a_L, left, _where(
                xt < u_star - a_star_L, fan, _where(
                    xt < u_star, star_l, _where(xt < S_shock, star_r, right,
                                                xt), xt), xt), xt)

        rho = pick(rho_L, rho_f, rho_star_L, rho_star_R, rho_R)
        u = pick(0.0, u_f, u_star, u_star, 0.0)
        p = pick(p_L, p_f, p_star, p_star, p_R)
        g = eq.params.gamma
        return _stack_1d(eq, rho, u, p / (g - 1.0) + 0.5 * rho * u * u)

    return fn


def smooth_wave(eq, rho_ref=1.0, p_ref=1.0, mach=1.0, x0=0.1, x1=0.3):
    """Smooth travelling density wave (initial_state_smooth_wave.h)."""

    def fn(points, t):
        x = points[0] - mach * t
        inside = (x > x0) & (x < x1)
        z = _where(inside, (x - x0) * (x1 - x), 0.0, x)
        # rho = rho_ref + 64 (x-x0)^3 (x1-x)^3 / (x1-x0)^6
        # (initial_state_smooth_wave.h:95-99)
        rho = rho_ref + 64.0 * (z * z * z) / (x1 - x0) ** 6
        zeros = [torch.zeros_like(rho) for _ in range(eq.dim - 1)]
        prim = torch.stack([rho, torch.full_like(rho, mach)] + zeros
                           + [torch.full_like(rho, p_ref)], 0)
        return eq.from_primitive_state(prim)

    return fn


def ramp_up(eq, primitive_initial=(1.4, 0.0, 1.0),
            primitive_final=(1.4, 3.0, 1.0), t_initial=0.0, t_final=1.0):
    """Time-dependent ramp of a uniform state (initial_state_ramp_up.h)."""
    I = uniform(eq, primitive_initial)
    F = uniform(eq, primitive_final)

    def fn(points, t):
        s = torch.clamp((_time(t, points) - t_initial)
                        / (t_final - t_initial), 0.0, 1.0)
        prim_i = eq.to_primitive_state(I(points, t))
        prim_f = eq.to_primitive_state(F(points, t))
        return eq.from_primitive_state((1.0 - s) * prim_i + s * prim_f)

    return fn


def becker_solution(
    eq,
    velocity_galilean_frame: float = 0.2,
    velocity_left: float = 1.0,
    velocity_right: float = 7.0 / 27.0,
    density_left: float = 1.0,
    mu: float = 0.01,
):
    """Becker's stationary viscous shock profile
    (euler/initial_state_becker_solution.h:30-260).  The implicit velocity
    profile psi(x, v) = 0 is inverted by the JAX package's fixed 80-step
    bisection (the reference uses a Newton iteration)."""
    gamma = eq.params.gamma
    v_l, v_r = velocity_left, velocity_right
    v0 = math.sqrt(v_l * v_r)
    Pr = 0.75
    factor = 2.0 * gamma / (gamma + 1.0) * mu / (density_left * v_l * Pr)
    c_l = v_l / (v_l - v_r)
    c_r = v_r / (v_l - v_r)
    R_infty = (gamma + 1.0) / (gamma - 1.0)

    def stuff(v, log=torch.log):
        log_l = log(v_l - v) - math.log(v_l - v0)
        log_r = log(v - v_r) - math.log(v0 - v_r)
        return factor * (c_l * log_l - c_r * log_r)

    tol = 1.0e-12
    v_lo = tol * v_l + (1.0 - tol) * v_r
    v_hi = (1.0 - tol) * v_l + tol * v_r
    x_left = stuff(v_hi, math.log)
    x_right = stuff(v_lo, math.log)

    def find_velocity(x):
        lo = torch.full_like(x, v_lo)
        hi = torch.full_like(x, v_hi)
        for _ in range(80):
            mid = 0.5 * (lo + hi)
            too_large = stuff(mid) < x  # stuff is decreasing in v
            hi = torch.where(too_large, mid, hi)
            lo = torch.where(too_large, lo, mid)
        v = 0.5 * (lo + hi)
        v = _where(x <= x_left, v_l, v, x)
        return _where(x >= x_right, v_r, v, x)

    def fn(points, t):
        x = points[0] - velocity_galilean_frame * t
        v = find_velocity(x)
        rho = density_left * v_l / v
        e = 1.0 / (2.0 * gamma) * (R_infty * v_l * v_r - v * v)
        vel = velocity_galilean_frame + v
        return _stack_1d(eq, rho, vel, rho * (e + 0.5 * vel * vel))

    return fn


def rarefaction(eq, gamma=None):
    """Analytic 1-rarefaction solution (initial_state_rarefaction.h:46-153):
    left state (rho, u, p) = (3, c_L, 1), the right state from the
    isentropic condition and the 1-Riemann invariant with rho_R = 0.5; the
    fan is centred so it has opened for 0.2 / (u_R - u_L) at t = 0."""
    gamma = eq.params.gamma if gamma is None else gamma

    rho_L, p_L = 3.0, 1.0
    c_L = math.sqrt(gamma * p_L / rho_L)
    u_L = c_L
    rho_R = 0.5
    p_R = (rho_R / rho_L) ** gamma * p_L
    c_R = math.sqrt(gamma * p_R / rho_R)
    u_R = u_L + 2.0 * (c_L - c_R) / (gamma - 1.0)

    k1 = 2.0 / (gamma + 1.0)
    k2 = (gamma - 1.0) / ((gamma + 1.0) * c_L)
    k3 = c_L + 0.5 * (gamma - 1.0) * u_L
    de = 2.0 / (gamma - 1.0)
    pe = 2.0 * gamma / (gamma - 1.0)
    t0 = 0.2 / (u_R - u_L)

    def fn(points, t):
        x = points[0]
        tt = t0 + _time(t, points)
        chi = x / tt
        base = torch.clamp_min(k1 + k2 * (u_L - chi), 1e-30)
        in_left = x <= tt * (u_L - c_L)
        in_fan = x <= tt * (u_R - c_R)

        def pick(left, fan, right):
            return _where(in_left, left, _where(in_fan, fan, right, x), x)

        rho = pick(rho_L, rho_L * torch.pow(base, de), rho_R)
        u = pick(u_L, k1 * (k3 + chi), u_R)
        p = pick(p_L, p_L * torch.pow(base, pe), p_R)
        return _stack_1d(eq, rho, u, p / (gamma - 1.0) + 0.5 * rho * u * u)

    return fn


def _radius(points, dim):
    return torch.sqrt(sum(points[d] ** 2 for d in range(dim)))


def noh(eq, reference_density=1.0, reference_velocity_magnitude=1.0,
        reference_pressure=1.0e-12, gamma=None):
    """Noh implosion with analytic solution (initial_state_noh.h:36-110)."""
    gamma = eq.params.gamma if gamma is None else gamma
    dim = eq.dim
    rho0, u0, p0 = (
        reference_density, reference_velocity_magnitude, reference_pressure
    )

    def fn(points, t):
        t = _time(t, points)
        r = _radius(points, dim)
        tiny = 10.0 * torch.finfo(points.dtype).tiny
        D = u0 * (gamma - 1.0) / 2.0
        interior = (t > 0.0) & (r / torch.clamp_min(t, tiny) < D)
        rho_in = rho0 * ((gamma + 1.0) / (gamma - 1.0)) ** dim
        p_in = (
            0.5 * rho0 * u0 * u0
            * (gamma + 1.0) ** dim / (gamma - 1.0) ** (dim - 1)
        )
        rho_out = rho0 * torch.pow(1.0 + t / (r + tiny), dim - 1)
        rho = _where(interior, rho_in, rho_out, r)
        p = _where(interior, p_in, p0, r)
        vel = [_where(interior, 0.0, -u0 * points[d] / (r + tiny), r)
               for d in range(dim)]
        E = p / (gamma - 1.0) + 0.5 * rho * sum(v * v for v in vel)
        return torch.stack([rho] + [rho * v for v in vel] + [E], 0)

    return fn


def radial_contrast(eq, primitive_inner=(1.4, 0.0, 1.0),
                    primitive_outer=(1.4, 0.0, 1.0), radius=0.5):
    """Disk of one state inside another (initial_state_radial_contrast.h)."""
    inner = uniform(eq, primitive_inner)
    outer = uniform(eq, primitive_outer)
    dim = eq.dim

    def fn(points, t):
        return torch.where((_radius(points, dim) > radius)[None],
                           outer(points, t), inner(points, t))

    return fn


def three_state_contrast(
    eq,
    primitive_left=(1.0, 0.0, 1.0e3),
    left_region_length=0.1,
    primitive_middle=(1.0, 0.0, 1.0e-2),
    middle_region_length=0.8,
    primitive_right=(1.0, 0.0, 1.0e2),
):
    """Woodward-Colella style triple state
    (initial_state_three_state_contrast.h:38-92)."""
    L = uniform(eq, primitive_left)
    M = uniform(eq, primitive_middle)
    R = uniform(eq, primitive_right)
    x1, x2 = left_region_length, left_region_length + middle_region_length

    def fn(points, t):
        x = points[0][None]
        return torch.where(
            x >= x2, R(points, t),
            torch.where(x >= x1, M(points, t), L(points, t)),
        )

    return fn


def four_state_contrast(
    eq,
    primitive_bottom_left=(1.4, 0.0, 0.0, 1.0),
    primitive_bottom_right=(1.4, 0.0, 0.0, 1.0),
    primitive_top_left=(1.4, 0.0, 0.0, 1.0),
    primitive_top_right=(1.4, 0.0, 0.0, 1.0),
):
    """2D Riemann quadrant data (initial_state_four_state_contrast.h)."""
    if eq.dim < 2:
        raise ValueError("four state contrast requires dim >= 2")
    BL = uniform(eq, primitive_bottom_left)
    BR = uniform(eq, primitive_bottom_right)
    TL = uniform(eq, primitive_top_left)
    TR = uniform(eq, primitive_top_right)

    def fn(points, t):
        right = (points[0] >= 0.0)[None]
        top = torch.where(right, TR(points, t), TL(points, t))
        bottom = torch.where(right, BR(points, t), BL(points, t))
        return torch.where((points[1] >= 0.0)[None], top, bottom)

    return fn


def astro_jet(eq, jet_width=0.05, primitive_jet_state=(5.0, 30.0, 0.4127),
              primitive_ambient_right=(5.0, 0.0, 0.4127), gamma=None):
    """Mach-2000 astrophysical jet inflow (initial_state_astro_jet.h)."""
    del gamma  # only affects the EOS, which lives on eq
    jet = uniform(eq, primitive_jet_state)
    ambient = uniform(eq, primitive_ambient_right)

    def fn(points, t):
        # in 1D the JAX package's points[1] reads points[0] (an index past
        # the end clamps there), and so does this one
        y = points[min(1, points.shape[0] - 1)]
        sel = ((points[0] < 1.0e-12) & (torch.abs(y) <= jet_width))[None]
        return torch.where(sel, jet(points, t), ambient(points, t))

    return fn


def icf_like(
    eq,
    primitive_state_inside=(0.1, 0.0, 1.0),
    primitive_state_outside=(1.0, 0.0, 1.0),
    interface_radius=1.0,
    number_of_modes=8.0,
    amplitude=0.02,
    mach_number=3.0,
    shock_radius=1.2,
    gamma=None,
):
    """ICF-like perturbed interface and incoming radial shock
    (initial_state_icf_like.h:40-160)."""
    gamma = eq.params.gamma if gamma is None else gamma
    dim = eq.dim
    inside = uniform(eq, primitive_state_inside)
    outside = uniform(eq, primitive_state_outside)

    rho_R, u_R, p_R = (
        primitive_state_outside[0], primitive_state_outside[1],
        primitive_state_outside[-1],
    )
    b = getattr(eq.params, "covolume_b", 0.0)
    a_R = math.sqrt(gamma * p_R / rho_R / (1.0 - b * rho_R))
    mach_R = u_R / a_R
    S3 = mach_number * a_R
    dm = mach_R - mach_number
    rho_sh = rho_R * (gamma + 1.0) * dm * dm / ((gamma - 1.0) * dm * dm + 2.0)
    u_sh = (1.0 - rho_R / rho_sh) * S3 + rho_R / rho_sh * u_R
    p_sh = p_R * (2.0 * gamma * dm * dm - (gamma - 1.0)) / (gamma + 1.0)

    def fn(points, t):
        r = _radius(points, dim)
        tiny = 10.0 * torch.finfo(points.dtype).tiny
        r_safe = torch.clamp_min(r, tiny)
        # the incoming radial shock state (velocity -u_sh r_hat)
        vel = [-u_sh * points[d] / r_safe for d in range(dim)]
        rho = torch.full_like(r, rho_sh)
        E = p_sh / (gamma - 1.0) + 0.5 * rho_sh * sum(v * v for v in vel)
        shock = torch.stack([rho] + [rho_sh * v for v in vel] + [E], 0)

        angle = torch.arccos(
            torch.clamp(torch.abs(points[dim - 1]) / r_safe, 0.0, 1.0)
        )
        perturbation = amplitude * torch.cos(number_of_modes * angle)
        full = torch.where(
            (r > interface_radius + perturbation)[None],
            outside(points, t), inside(points, t),
        )
        return torch.where((r > shock_radius)[None], shock, full)

    return fn


# the functions an expression of `function` may call, by their JAX names
_EXPRESSION_FUNCTIONS = {
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan, "exp": torch.exp,
    "log": torch.log, "sqrt": torch.sqrt, "abs": torch.abs,
    "tanh": torch.tanh, "cosh": torch.cosh, "sinh": torch.sinh,
    "arctan": torch.atan, "where": torch.where, "minimum": torch.minimum,
    "maximum": torch.maximum, "power": torch.pow, "sign": torch.sign,
}


def function(eq, density_expression="1.4", velocity_x_expression="3.0",
             velocity_y_expression="0.0", velocity_z_expression="0.0",
             pressure_expression="1.0"):
    """Primitive state from expressions over x, y, z, t
    (euler/initial_state_function.h:36-70).  An expression calls the
    functions of _EXPRESSION_FUNCTIONS by their JAX names, bare or as
    `np.` / `jnp.` attributes; Python numbers among their arguments become
    tensors of the points' dtype."""
    dim = eq.dim
    exprs = [density_expression, velocity_x_expression]
    if dim >= 2:
        exprs.append(velocity_y_expression)
    if dim >= 3:
        exprs.append(velocity_z_expression)
    exprs.append(pressure_expression)
    compiled = [compile(str(e), "<initial state expression>", "eval")
                for e in exprs]

    def fn(points, t):
        kw = dict(dtype=points.dtype, device=points.device)

        def tensors(f):
            def call(*args):
                return f(*(a if torch.is_tensor(a) else torch.as_tensor(a, **kw)
                           for a in args))
            return call

        funcs = {k: tensors(f) for k, f in _EXPRESSION_FUNCTIONS.items()}
        names = types.SimpleNamespace(**funcs)
        env = {"x": points[0], "t": _time(t, points), "jnp": names,
               "np": names, "pi": math.pi, **funcs}
        if dim >= 2:
            env["y"] = points[1]
        if dim >= 3:
            env["z"] = points[2]
        vals = [
            torch.broadcast_to(
                torch.as_tensor(eval(c, env), **kw),  # noqa: S307
                points.shape[1:],
            )
            for c in compiled
        ]
        return eq.from_primitive_state(torch.stack(vals, 0))

    return fn


LIBRARY = {
    "isentropic vortex": isentropic_vortex,
    "becker solution": becker_solution,
    "uniform": uniform,
    "contrast": contrast,
    "shock front": shock_front,
    "leblanc": leblanc,
    "smooth wave": smooth_wave,
    "ramp up": ramp_up,
    "rarefaction": rarefaction,
    "noh": noh,
    "radial contrast": radial_contrast,
    "three state contrast": three_state_contrast,
    "four state contrast": four_state_contrast,
    "astro jet": astro_jet,
    "icf like": icf_like,
    "function": function,
}


def make_initial_state(eq, configuration: str, direction=None, position=None,
                       **kwargs):
    """The configured, Galilei-transformed initial state callable; an
    unknown configuration raises KeyError, as the JAX package's does."""
    fn = LIBRARY[configuration](eq, **kwargs)
    if direction is None:
        direction = [1.0] + [0.0] * (eq.dim - 1)
    if position is None:
        position = [0.0] * eq.dim
    return galilei_wrap(fn, direction, position, eq.dim)
