"""Euler initial states in PyTorch: the uniform state and the Galilei
transform of ryujin_tpu/equations/euler_initial_states.py.

States are functions `(points [dim, ...], t) -> states [C, ...]` on
tensors; the points' dtype and device carry over to the state.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch


def galilei_wrap(state_fn, direction, position, dim):
    """Affine transform of InitialValues (initial_values.template.h:66-155):
    points are rotated so `direction` maps onto the x-axis around
    `position`, and the momentum is rotated back.  In 3D the rotation in
    the x-z plane comes first for points and last for the momentum, as in
    ryujin_tpu/equations/euler_initial_states.py:29-75."""
    if dim not in (2, 3):
        raise NotImplementedError(
            "the torch initial states are ported for dim 2 and 3 "
            '(ROADMAP queue 1, "Initial states, error norms and the '
            'explicit tableaux")'
        )
    direction = np.asarray(direction, dtype=np.float64)
    direction = tuple(float(v) for v in direction / np.linalg.norm(direction))
    position = np.asarray(position, dtype=np.float64)

    def plane(a, b):
        """(cos, sin) of the rotation taking direction's (a, b) components
        onto a, or None where they vanish."""
        n_a, n_b = direction[a], direction[b]
        norm = math.sqrt(n_a * n_a + n_b * n_b)
        return (n_a / norm, n_b / norm) if norm > 1e-14 else None

    xy = plane(0, 1)
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
        else:
            vel = [torch.full(shape, prim[1 + d], **kw) for d in range(dim)]
        prim_state = torch.stack(
            [torch.full(shape, prim[0], **kw)]
            + vel
            + [torch.full(shape, prim[-1], **kw)],
            0,
        )
        return eq.from_primitive_state(prim_state)

    return fn


def make_initial_state(eq, configuration: str, direction=None, position=None,
                       **kwargs):
    """The configured, Galilei-transformed initial state callable.  Only
    "uniform" is ported; any other name raises."""
    if configuration != "uniform":
        raise NotImplementedError(
            f"initial state '{configuration}' is not ported (only "
            "'uniform'; ROADMAP queue 1, \"Initial states, error norms and "
            "the explicit tableaux\")"
        )
    fn = uniform(eq, **kwargs)
    if direction is None:
        direction = [1.0] + [0.0] * (eq.dim - 1)
    if position is None:
        position = [0.0] * eq.dim
    return galilei_wrap(fn, direction, position, eq.dim)
