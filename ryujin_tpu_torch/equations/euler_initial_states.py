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
    `position`, and the momentum is rotated back."""
    if dim != 2:
        raise NotImplementedError(
            "the torch initial states are ported for dim 2 only "
            "(ROADMAP queue 1 item 7)"
        )
    direction = np.asarray(direction, dtype=np.float64)
    n_x, n_y = (float(v) for v in direction / np.linalg.norm(direction))
    position = np.asarray(position, dtype=np.float64)
    norm = math.sqrt(n_x * n_x + n_y * n_y)
    rotate = norm > 1e-14
    nx, ny = (n_x / norm, n_y / norm) if rotate else (1.0, 0.0)

    def wrapped(points, t):
        d = points - torch.as_tensor(
            position, dtype=points.dtype, device=points.device
        ).reshape((dim,) + (1,) * (points.ndim - 1))
        if rotate:
            d = torch.stack(
                [nx * d[0] + ny * d[1], -ny * d[0] + nx * d[1]], 0
            )
        state = state_fn(d, t)
        m = state[1 : 1 + dim]
        if rotate:
            m = torch.stack(
                [nx * m[0] - ny * m[1], ny * m[0] + nx * m[1]], 0
            )
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
            "'uniform'; ROADMAP queue 1 item 7)"
        )
    fn = uniform(eq, **kwargs)
    if direction is None:
        direction = [1.0] + [0.0] * (eq.dim - 1)
    if position is None:
        position = [0.0] * eq.dim
    return galilei_wrap(fn, direction, position, eq.dim)
