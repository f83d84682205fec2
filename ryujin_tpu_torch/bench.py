"""Throughput of the port on the 2D Euler Mach-3 forward-facing step.

    python -m ryujin_tpu_torch.bench
    BENCH_CASE=q2step2d python -m ryujin_tpu_torch.bench

Runs two of bench.py's cases on a CUDA device, in f32 with ERK33 through
the CUDA kernels:

  step2d    (default) cG Q1, refinement 3, CFL 0.9, cfl_recovery_strategy
            "none", 1500-step warmup; metric euler2d_mach3_step_throughput
  q2step2d  cG Q2 (reach-2 canvas, K = 24, the slot-streaming kernels),
            refinement 2, CFL 0.9 / 0.45 with "bang bang control",
            1000-step warmup; metric euler2d_mach3_step_cgq2

Prints one JSON line {"metric", "value", "unit", "vs_baseline"} (+ "reps"
with BENCH_REPS > 1), where value is MQ/s = real nodes x substeps / wall
seconds / 1e6.  The same BENCH_* variables as bench.py set the sizes:
BENCH_REFINEMENT, BENCH_WARMUP (steps, so the bow shock spans the domain
and the limiter works everywhere), BENCH_STEPS (20 timed steps),
and BENCH_REPS (1).
"""

from __future__ import annotations

import json
import os
import sys
import time

import torch

from .offline import assembly, geometry, structured

from .equations.euler import Euler
from .equations.euler_initial_states import make_initial_state
from .postprocess.error import interpolate_nodal
from .solver.hyperbolic import HyperbolicModule
from .solver.integrator import TimeIntegrator

BASELINE_MQS = 100.0  # bench.py's north-star constant, not a measurement


def _build_step(refinement: int, dtype, device, ansatz: str, recovery: str):
    """(eq, sd, hm, ti, U0) on the Mach-3 step: uniform inflow."""
    eq = Euler(dim=2)
    mesh = geometry.step(refinement=refinement)
    sd = structured.pack_structured(
        assembly.assemble(mesh, ansatz=ansatz), mesh
    )
    init = make_initial_state(eq, "uniform", primitive_state=(1.4, 3.0, 1.0))
    hm = HyperbolicModule(eq, sd, init, dtype=dtype, device=device)
    ti = TimeIntegrator(hm, "erk 33", cfl_min=0.45, cfl_max=0.9,
                        cfl_recovery_strategy=recovery)
    U0 = interpolate_nodal(init, sd, eq, 0.0, dtype, device)
    return eq, sd, hm, ti, U0


def build_step2d(refinement: int, dtype, device):
    """(eq, sd, hm, ti, U0) of the step2d case: cG Q1, no CFL recovery."""
    return _build_step(refinement, dtype, device, "cG Q1", "none")


def build_q2step2d(refinement: int, dtype, device, ansatz: str = "cG Q2"):
    """(eq, sd, hm, ti, U0) of the q2step2d case: a higher-order ansatz on
    the node lattice (cG Q2: reach 2, K = 24) with bang-bang recovery."""
    return _build_step(refinement, dtype, device, ansatz, "bang bang control")


# case -> (build_case, default refinement, default warmup steps, metric)
CASES = {
    "step2d": (build_step2d, 3, 1500, "euler2d_mach3_step_throughput"),
    "q2step2d": (build_q2step2d, 2, 1000, "euler2d_mach3_step_cgq2"),
}


def entry(device=None):
    """(fn, example_args): one IDP substep (prepare + step) on the step
    mesh at refinement 0 in f32, as __graft_entry__.entry().  device=None
    means the card, and raises without one."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "ryujin_tpu_torch.bench.entry needs a CUDA device; pass "
                "device='cpu' to run the plain-torch path"
            )
        device = "cuda"
    dtype = torch.float32
    _, _, hm, _, U0 = build_step2d(0, dtype, device)

    def fn(U, t):
        Up, prec = hm.prepare_state_vector(U, t)
        zero = torch.zeros((), dtype=dtype, device=device)
        cap = torch.full((), float("inf"), dtype=dtype, device=device)
        return hm.step(Up, prec, None, [], zero, 0.9, cap, compute_tau=True)

    return fn, (U0, torch.zeros((), dtype=dtype, device=device))


def main():
    if not torch.cuda.is_available():
        sys.exit("ryujin_tpu_torch.bench needs a CUDA device")
    case = os.environ.get("BENCH_CASE", "step2d")
    if case not in CASES:
        sys.exit(f"BENCH_CASE={case} is not ported (only {sorted(CASES)})")
    build_case, refinement_default, warmup_default, metric = CASES[case]
    refinement = int(os.environ.get("BENCH_REFINEMENT", str(refinement_default)))
    n_steps = int(os.environ.get("BENCH_STEPS", "20"))
    warmup = int(os.environ.get("BENCH_WARMUP", str(warmup_default)))
    reps = int(os.environ.get("BENCH_REPS", "1"))

    _, sd, _, ti, U0 = build_case(refinement, torch.float32, "cuda")
    U, _, t, _, _, _ = ti.advance(U0, 0.0, max(warmup, 2))
    torch.cuda.synchronize()

    mqs_reps = []
    for _ in range(reps):
        t0 = time.perf_counter()
        ti.advance(U, t, n_steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        mqs_reps.append(sd.n_nodes * n_steps * 3 / wall / 1e6)
    mqs = mqs_reps[-1]
    rec = {
        "metric": metric,
        "value": round(mqs, 3),
        "unit": "MQ/s/chip",
        "vs_baseline": round(mqs / BASELINE_MQS, 4),
    }
    if reps > 1:
        rec["reps"] = [round(v, 2) for v in mqs_reps]
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
