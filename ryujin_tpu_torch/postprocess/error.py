"""Nodal interpolation of an initial state (ryujin_tpu/postprocess/error.py)."""

from __future__ import annotations

import torch


def interpolate_nodal(initial_state_fn, sd, eq, t, dtype, device):
    """Initial/analytic state at the packed nodes [C, n_pad]
    (initial_values.template.h:223-266).  Padded nodes receive the safe
    state rho = E = 1, m = 0, so downstream math never sees zeros."""
    pos = torch.as_tensor(sd.positions.T, dtype=dtype, device=device)
    U = initial_state_fn(pos, t)
    safe = torch.zeros((eq.n_comp, 1), dtype=dtype, device=device)
    safe[0, 0] = 1.0
    safe[-1, 0] = 1.0
    mask = torch.as_tensor(sd.node_mask, dtype=dtype, device=device)[None]
    return torch.where(mask > 0, U, safe)
