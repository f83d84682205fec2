"""Carry the JAX package's parameters and states across to the port.

Both packages then compute on the same StructuredData (the statics go
through CanvasArrays.from_structured and its StructuredStencil views),
parameters and state.  Nothing here imports jax: the reference objects
are read by their fields, states as numpy arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .equations.euler import Euler, EulerParams
from .solver.hyperbolic import HyperbolicModuleParams


def params_from_reference(eq, hm_params):
    """(Euler, HyperbolicModuleParams) of the port from a
    ryujin_tpu.equations.euler.Euler and a
    ryujin_tpu.solver.hyperbolic.HyperbolicModuleParams."""
    if getattr(eq, "name", None) != "euler":
        raise ValueError(f"only the Euler equations are ported, not {eq!r}")
    eq_t = Euler(
        dim=eq.dim, params=EulerParams(**dataclasses.asdict(eq.params))
    )
    return eq_t, HyperbolicModuleParams(**dataclasses.asdict(hm_params))


def state_from_reference(U_np, device, dtype):
    """A state of the JAX package, read as `np.asarray(U)`, as a tensor."""
    return torch.tensor(np.asarray(U_np), dtype=dtype, device=device)
