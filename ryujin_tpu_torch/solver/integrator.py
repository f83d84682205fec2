"""Time integration in PyTorch (ryujin_tpu/solver/integrator.py), for the
"erk 33" scheme with cfl_recovery_strategy "none" or "bang bang control".

The JAX package scans the substeps on the device; here the step is a
Python loop over the static tableau.  t, tau and the counts stay 0-d
tensors on the device.  With recovery "none" the loop never reads a value
back to the host, so the kernels of consecutive substeps queue up without
a sync.  Bang-bang recovery (_step_recover, :336-368) must know on the
host whether the step at cfl_max succeeded before it can redo it at
cfl_min, so it reads the 0-d `ok` once per step.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .hyperbolic import HyperbolicModule


@dataclasses.dataclass(frozen=True)
class Tableau:
    """Explicit scheme table (time_integrator.template.h:278-512): W[i][s]
    weight of stage slot s in substep i (slot 0 is U^n, slot s the output
    of substep s-1); c[i] time offset of substep i's output in units of
    tau; eff the advance per step in units of tau."""

    n_sub: int
    S: int
    W: Tuple[Tuple[float, ...], ...]
    c: Tuple[float, ...]
    eff: float


TABLEAUX = {
    "erk 33": Tableau(
        3, 2, ((0.0, 0.0), (-1.0, 0.0), (0.75, -2.0)), (1.0, 2.0, 3.0), 3.0
    ),
}


RECOVERY_STRATEGIES = ("none", "bang bang control")


@dataclasses.dataclass
class TimeIntegrator:
    """Drives time steps of the selected scheme."""

    hyperbolic_module: HyperbolicModule
    scheme: str = "erk 33"
    cfl_min: float = 0.45
    cfl_max: float = 0.90
    cfl_recovery_strategy: str = "bang bang control"  # or "none"

    def __post_init__(self):
        if self.scheme not in TABLEAUX:
            raise NotImplementedError(
                f"scheme '{self.scheme}' is not ported (only 'erk 33'; "
                'ROADMAP queue 1, "Initial states, error norms and the '
                'explicit tableaux")'
            )
        if self.cfl_recovery_strategy not in RECOVERY_STRATEGIES:
            raise NotImplementedError(
                f"cfl_recovery_strategy '{self.cfl_recovery_strategy}' is "
                f"not ported (only {RECOVERY_STRATEGIES})"
            )

    @property
    def efficiency(self) -> float:
        return TABLEAUX[self.scheme].eff

    def _scalar(self, x):
        hm = self.hyperbolic_module
        return torch.as_tensor(x, dtype=hm.dtype, device=hm.device)

    def _scheme(self, Up, prec, t, cfl: float, tau_cap):
        """All substeps of the tableau with their static weights at the
        CFL number `cfl`; each substep passes only its active stage slots.
        Returns (U prepared at t + eff tau, prec, tau, ok)."""
        hm = self.hyperbolic_module
        tb = TABLEAUX[self.scheme]
        bufs = [(Up, prec)]
        Tp, pn = Up, prec
        tau = self._scalar(0.0)
        ok = None
        for idx in range(tb.n_sub):
            active = [s for s in range(tb.S) if tb.W[idx][s] != 0.0]
            sU = torch.stack([bufs[s][0] for s in active]) if active else None
            cap = tau_cap / tb.eff if idx == 0 else self._scalar(float("inf"))
            T, tau, ok_i = hm.step(
                Tp, pn, sU, [tb.W[idx][s] for s in active], tau,
                cfl, cap, compute_tau=idx == 0,
            )
            Tp, pn = hm.prepare_state_vector(T, t + tb.c[idx] * tau)
            if idx + 1 < tb.S:
                bufs.append((Tp, pn))
            ok = ok_i if ok is None else ok & ok_i
        return Tp, pn, tau, ok

    def step(self, U, t, t_final=float("inf")):
        """One scheme step from the (possibly unprepared) state U.
        Returns (U_prepared, tau_total, ok) as device tensors."""
        U2, _, _, tau, _, warns = self.advance(U, t, 1, t_final)
        return U2, tau, warns == 0

    def advance(self, U, t, n_steps: int, t_final=float("inf")):
        """n_steps scheme steps.  Returns (U_prepared, prec, t_new,
        tau_last, n_restarts, n_warnings), all on the device.

        Every step runs at cfl_max.  With "bang bang control" a step that
        did not succeed is redone once from the same prepared state at
        cfl_min and counted in n_restarts (one host read of `ok` per step);
        a step whose last attempt did not succeed counts in n_warnings."""
        hm = self.hyperbolic_module
        eff = self.efficiency
        recover = self.cfl_recovery_strategy == "bang bang control"
        t = self._scalar(t)
        t_final = self._scalar(t_final)
        Up, prec = hm.prepare_state_vector(U, t)
        tau_last = self._scalar(0.0)
        n_restarts = 0
        warns = torch.zeros((), dtype=torch.int32, device=hm.device)
        for _ in range(n_steps):
            cap = torch.clamp_min(t_final - t, 0.0)
            U2, p2, tau, ok = self._scheme(Up, prec, t, self.cfl_max, cap)
            if recover and not bool(ok):
                n_restarts += 1
                U2, p2, tau, ok = self._scheme(Up, prec, t, self.cfl_min, cap)
            Up, prec = U2, p2
            tau_last = eff * tau
            t = t + tau_last
            warns = warns + (~ok).to(torch.int32)
        restarts = torch.full((), n_restarts, dtype=torch.int32,
                              device=hm.device)
        return Up, prec, t, tau_last, restarts, warns
