"""The reference's 1D shock tubes on the port (tests/test_euler_1d_verification.py:
24-89, the reference's prm/verification/euler-{leblanc, shock_front,
smooth_wave, rarefaction}_erk33.prm).

Each case: 1D Euler on [0, 1] (25 cells refined `refinement` times;
refinement 6 gives 1,601 dofs), Dirichlet data at both ends, cG Q1 packed
as padded ELL, float64, ERK33 at the case's CFL, recovery "none", up to
t_final; the L1 norm (normalized and summed over rho, m and E) of
compute_error against the committed value of the reference's baseline
file, at the JAX test's bar.  On a CUDA device the substeps run ell_pk1,
ell_pk2, ell_pk3 and ell_pk_up.

    python -m ryujin_tpu_torch.shocktube [--device cuda|cpu] [CASE ...]

runs the named cases (all four by default) and exits 1 if any misses its
bar; chip_smoke.py phase 14c runs the rarefaction on the card.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import subprocess
import sys
import time
from typing import Dict, Tuple

import torch

from .equations.euler import Euler, EulerParams
from .equations.euler_initial_states import make_initial_state
from .offline import assembly, ell, geometry
from .offline.mesh import Boundary
from .postprocess.error import compute_error, interpolate_nodal
from .solver.hyperbolic import HyperbolicModule, HyperbolicModuleParams
from .solver.integrator import TimeIntegrator

REFINEMENT = 6
CHUNK = 256  # most steps a call of the advance takes
COMPONENTS = ("rho", "m", "E")


@dataclasses.dataclass(frozen=True)
class Case:
    """One shock tube: the initial state and its keywords, gamma, the
    discontinuity's position, t_final, the CFL number, the limiter's
    relaxation factor, the reference's committed L1 at refinement 6 and
    the JAX test's relative bar on it."""

    config: str
    gamma: float
    position: float
    t_final: float
    cfl: float
    relax: float
    l1: float
    bar: float


# tests/test_euler_1d_verification.py:53-89
CASES: Dict[str, Case] = {
    "leblanc": Case("leblanc", 1.66666666666667, 0.326732673267,
                    0.66666666666667, 0.10, 4.0, 1.126070081400691e-2, 0.05),
    "shock front": Case("shock front", 1.4, 0.25, 0.25, 0.10, 8.0,
                        3.365082670890948e-3, 0.05),
    "smooth wave": Case("smooth wave", 1.4, 0.1, 0.60, 0.30, 1.0,
                        1.291602520873936e-6, 0.05),
    "rarefaction": Case("rarefaction", 1.4, 0.2, 0.30558, 0.50, 8.0,
                        1.643470771031956e-5, 0.08),
}


def build_case(case: Case, refinement: int, dtype, device):
    """(eq, mesh, packed, init, hm) of `case` at `refinement`."""
    eq = Euler(dim=1, params=EulerParams(gamma=case.gamma))
    mesh = geometry.rectangular_domain(
        [0.0], [1.0], [25], refinement=refinement,
        boundary_conditions=[Boundary.dirichlet] * 2, dim=1,
    )
    packed = ell.pack(assembly.assemble(mesh))
    init = make_initial_state(eq, case.config, direction=[1.0],
                              position=[case.position])
    params = HyperbolicModuleParams(limiter_relaxation_factor=case.relax)
    hm = HyperbolicModule(eq, packed, init, params=params, dtype=dtype,
                          device=device)
    return eq, mesh, packed, init, hm


@dataclasses.dataclass
class TubeRun:
    """One drive: the norms (L-inf, L1, L2), the steps taken and those
    asked for (the advance runs, and then discards, the steps of a chunk
    that start at t_final), the warnings, the final time, the wall seconds
    of the time loop and the final prepared state with its module."""

    norms: Tuple[float, float, float]
    steps: int
    requested: int
    warnings: int
    t: float
    seconds: float
    U: torch.Tensor
    hm: HyperbolicModule

    def rel(self, case: Case) -> float:
        """|L1 / committed L1 - 1|."""
        return abs(self.norms[1] / case.l1 - 1.0)


def drive(case: Case, refinement: int = REFINEMENT, dtype=torch.float64,
          device="cuda", built=None) -> TubeRun:
    """`case` up to its t_final through TimeIntegrator.advance in chunks of
    at most CHUNK steps, reading t and tau between them; the advance stops
    at t_final inside a chunk.  `built` a build_case result to reuse."""
    eq, mesh, packed, init, hm = built or build_case(case, refinement, dtype,
                                                     device)
    ti = TimeIntegrator(hm, "erk 33", cfl_min=case.cfl, cfl_max=case.cfl,
                        cfl_recovery_strategy="none")
    U = interpolate_nodal(init, packed, eq, 0.0, dtype, device)
    t = torch.zeros((), dtype=dtype, device=device)
    n, steps, requested, warnings = 2, 0, 0, 0
    if U.is_cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    while t.item() < case.t_final:
        U, _, t, tau, _, warns = ti.advance(U, t, n, case.t_final)
        steps += int(ti.steps_taken)
        requested += n
        warnings += int(warns)
        left = (case.t_final - t.item()) / max(tau.item(), 1e-300)
        n = max(1, min(CHUNK, math.ceil(left) + 1))
    seconds = time.perf_counter() - t0
    norms = compute_error(eq, mesh, packed, U, t.item(), init,
                          components=list(COMPONENTS))
    return TubeRun(norms, steps, requested, warnings, t.item(), seconds, U,
                   hm)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("cases", nargs="*", choices=list(CASES), metavar="CASE",
                    help="all four when none is named")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("shocktube: no CUDA device", flush=True)
        return 1
    if args.device == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip(), flush=True)
    ok = True
    for name in args.cases or list(CASES):
        case = CASES[name]
        run = drive(case, REFINEMENT, torch.float64, args.device)
        good = (run.rel(case) <= case.bar and run.warnings == 0
                and run.t == case.t_final)
        ok &= good
        print(f"{name:12s} refinement {REFINEMENT}: Linf "
              f"{run.norms[0]:.6e}  L1 {run.norms[1]:.6e}  L2 "
              f"{run.norms[2]:.6e}; reference L1 {case.l1:.6e}: "
              f"{100 * (run.norms[1] / case.l1 - 1.0):+.3f} % (bar "
              f"{100 * case.bar:.0f} %); {run.steps} steps, {run.warnings} "
              f"warnings, {run.seconds:.2f} s wall "
              f"{'ok' if good else 'FAIL'}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
