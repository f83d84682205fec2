"""Time integration in PyTorch (ryujin_tpu/solver/integrator.py): the
explicit tableaux ("erk 11", "erk 22", "erk 33", "erk 43", "erk 54",
"ssprk 22", "ssprk 33") with cfl_recovery_strategy "none" or "bang bang
control".  The Strang and IMEX schemes need the parabolic module and
raise.

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
import math
from typing import Tuple

import torch

from .hyperbolic import HyperbolicModule


@dataclasses.dataclass(frozen=True)
class Tableau:
    """Explicit scheme table (time_integrator.template.h:278-512): W[i][s]
    weight of stage slot s in substep i (slot 0 is U^n, slot s the output
    of substep s-1); comb[i] = (a, b): T <- a T + b U^n after substep i;
    c[i] time offset of substep i's output in units of tau; eff the
    advance per step in units of tau."""

    n_sub: int
    S: int
    W: Tuple[Tuple[float, ...], ...]
    comb: Tuple[Tuple[float, float], ...]
    c: Tuple[float, ...]
    eff: float


_T = Tableau
TABLEAUX = {
    "erk 11": _T(1, 0, ((),), ((1.0, 0.0),), (1.0,), 1.0),
    "ssprk 22": _T(
        2, 0, ((), ()), ((1.0, 0.0), (0.5, 0.5)), (1.0, 1.0), 1.0
    ),
    "ssprk 33": _T(
        3,
        0,
        ((), (), ()),
        ((1.0, 0.0), (0.25, 0.75), (2.0 / 3.0, 1.0 / 3.0)),
        (1.0, 0.5, 1.0),
        1.0,
    ),
    "erk 22": _T(
        2, 1, ((0.0,), (-1.0,)), ((1.0, 0.0),) * 2, (1.0, 2.0), 2.0
    ),
    "erk 33": _T(
        3,
        2,
        ((0.0, 0.0), (-1.0, 0.0), (0.75, -2.0)),
        ((1.0, 0.0),) * 3,
        (1.0, 2.0, 3.0),
        3.0,
    ),
    "erk 43": _T(
        4,
        3,
        (
            (0.0, 0.0, 0.0),
            (-1.0, 0.0, 0.0),
            (0.0, -1.0, 0.0),
            (0.0, 5.0 / 3.0, -10.0 / 3.0),
        ),
        ((1.0, 0.0),) * 4,
        (1.0, 2.0, 3.0, 4.0),
        4.0,
    ),
}


def _erk54_tableau() -> Tableau:
    # ERK(5,4) with equidistant c_i (time_integrator.template.h:445-512)
    c = 0.2
    a_21 = +0.2
    a_31 = +0.26075582269554909
    a_32 = +0.13924417730445096
    a_41 = -0.25856517872570289
    a_42 = +0.91136274166280729
    a_43 = -0.05279756293710430
    a_51 = +0.21623276431503774
    a_52 = +0.51534223099602405
    a_53 = -0.81662794199265554
    a_54 = +0.88505294668159373
    a_61 = -0.10511678454691901
    a_62 = +0.87880047152100838
    a_63 = -0.58903404061484477
    a_64 = +0.46213380485434047
    W = (
        (0.0, 0.0, 0.0, 0.0),
        ((a_31 - a_21) / c, 0.0, 0.0, 0.0),
        ((a_41 - a_31) / c, (a_42 - a_32) / c, 0.0, 0.0),
        ((a_51 - a_41) / c, (a_52 - a_42) / c, (a_53 - a_43) / c, 0.0),
        (
            (a_61 - a_51) / c,
            (a_62 - a_52) / c,
            (a_63 - a_53) / c,
            (a_64 - a_54) / c,
        ),
    )
    return Tableau(
        5, 4, W, ((1.0, 0.0),) * 5, (1.0, 2.0, 3.0, 4.0, 5.0), 5.0
    )


TABLEAUX["erk 54"] = _erk54_tableau()

# The advance per step of every scheme the JAX package names, in units of
# tau: the explicit tableaux, the Strang splits (twice their explicit
# part's) and the IMEX schemes.  Only the explicit tableaux are ported.
EFFICIENCY = {name: tb.eff for name, tb in TABLEAUX.items()}
STRANG = {
    "strang ssprk 33 cn": "ssprk 33",
    "strang erk 33 cn": "erk 33",
    "strang erk 43 cn": "erk 43",
}
EFFICIENCY.update(
    {name: 2.0 * TABLEAUX[base].eff for name, base in STRANG.items()}
)
EFFICIENCY.update({"imex 11": 1.0, "imex 22": 2.0, "imex 33": 3.0})


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
        if self.scheme not in EFFICIENCY:
            raise ValueError(f"unknown time stepping scheme '{self.scheme}'")
        if self.scheme in ("imex 22", "imex 33"):
            # as the reference: parabolic_module.template.h:73 asserts
            # stages == 0 (no high-order parabolic fluxes)
            raise NotImplementedError(
                f"scheme '{self.scheme}' requires high-order parabolic "
                "fluxes which the reference asserts out as well"
            )
        if self.scheme not in TABLEAUX:
            raise NotImplementedError(
                f"scheme '{self.scheme}' needs the parabolic module, which "
                'is not ported (ROADMAP queue 1 item 7, "Navier–Stokes")'
            )
        if self.cfl_recovery_strategy not in RECOVERY_STRATEGIES:
            raise NotImplementedError(
                f"cfl_recovery_strategy '{self.cfl_recovery_strategy}' is "
                f"not ported (only {RECOVERY_STRATEGIES})"
            )
        # steps of the last advance toward a finite t_final that ran
        self.steps_taken = None
        # restarts and warnings of every step() so far, host integers, as
        # the JAX package keeps them (ryujin_tpu/solver/integrator.py:
        # 181-182); advance() returns its own counts and adds nothing here
        self.n_restarts = 0
        self.n_warnings = 0

    @property
    def efficiency(self) -> float:
        return TABLEAUX[self.scheme].eff

    def _scalar(self, x):
        hm = self.hyperbolic_module
        return torch.as_tensor(x, dtype=hm.dtype, device=hm.device)

    def _scheme(self, Up, prec, t, cfl: float, tau_cap):
        """All substeps of the tableau with their static weights at the
        CFL number `cfl`; each substep passes only its active stage slots.
        Each substep's output T becomes a T + b U^n by the tableau's
        convex combination (a, b) where that is not (1, 0), as the JAX
        package's _scheme_scan does (:325-327).
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
            a, b = tb.comb[idx]
            if (a, b) != (1.0, 0.0):
                T = a * T + b * Up
            Tp, pn = hm.prepare_state_vector(T, t + tb.c[idx] * tau)
            if idx + 1 < tb.S:
                bufs.append((Tp, pn))
            ok = ok_i if ok is None else ok & ok_i
        return Tp, pn, tau, ok

    def step(self, U, t, t_final=float("inf")):
        """One scheme step from the (possibly unprepared) state U.
        Returns (U_prepared, tau_total, ok) as device tensors, and adds the
        step's restarts and warnings to n_restarts / n_warnings (one host
        read, as the JAX package's step() syncs them, :200-212)."""
        U2, _, _, tau, restarts, warns = self.advance(U, t, 1, t_final)
        self.n_restarts += int(restarts)
        self.n_warnings += int(warns)
        return U2, tau, warns == 0

    def advance(self, U, t, n_steps: int, t_final=float("inf")):
        """n_steps scheme steps.  Returns (U_prepared, prec, t_new,
        tau_last, n_restarts, n_warnings), all on the device.

        Every step runs at cfl_max.  With "bang bang control" a step that
        did not succeed is redone once from the same prepared state at
        cfl_min and counted in n_restarts (one host read of `ok` per step);
        a step whose last attempt did not succeed counts in n_warnings.

        With a finite t_final the advance stops there: each step is capped
        to end at t_final at the latest (a capped step sets t = t_final
        exactly), and a step that starts at
        t >= t_final changes nothing (a device select, no host read):
        neither the state, t, tau_last, the warnings nor the restarts.  So
        a caller may ask for more steps than it needs and read t between
        calls; `steps_taken`, a 0-d device tensor, then holds how many of
        this call's steps started before t_final."""
        hm = self.hyperbolic_module
        eff = self.efficiency
        recover = self.cfl_recovery_strategy == "bang bang control"
        stops = math.isfinite(float(t_final))
        t = self._scalar(t)
        t_final = self._scalar(t_final)
        Up, prec = hm.prepare_state_vector(U, t)
        tau_last = self._scalar(0.0)
        n_restarts = 0
        warns = torch.zeros((), dtype=torch.int32, device=hm.device)
        taken = torch.zeros((), dtype=torch.int32, device=hm.device)
        for _ in range(n_steps):
            live = t < t_final if stops else None
            cap = torch.clamp_min(t_final - t, 0.0)
            U2, p2, tau, ok = self._scheme(Up, prec, t, self.cfl_max, cap)
            if recover and not bool(ok if live is None else ok | ~live):
                n_restarts += 1
                U2, p2, tau, ok = self._scheme(Up, prec, t, self.cfl_min, cap)
            if stops:
                Up = torch.where(live, U2, Up)
                prec = torch.where(live, p2, prec)
                tau_last = torch.where(live, eff * tau, tau_last)
                # a step that the cap cut short ends at t_final itself, not
                # at the rounded t + eff (t_final - t) / eff, which may fall
                # short by an ulp and leave steps of tau ~ 1e-17 to run
                t_next = torch.where(tau >= cap / eff, t_final, t + eff * tau)
                t = torch.where(live, t_next, t)
                warns = warns + (live & ~ok).to(torch.int32)
                taken = taken + live.to(torch.int32)
                continue
            Up, prec = U2, p2
            tau_last = eff * tau
            t = t + tau_last
            warns = warns + (~ok).to(torch.int32)
        if stops:
            self.steps_taken = taken
        restarts = torch.full((), n_restarts, dtype=torch.int32,
                              device=hm.device)
        return Up, prec, t, tau_last, restarts, warns
