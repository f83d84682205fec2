"""Throughput of the port on the 2D Euler Mach-3 forward-facing step.

    python -m ryujin_tpu_torch.bench

Runs bench.py's default case (step2d) on a CUDA device: refinement 3,
f32, ERK33, CFL 0.9, cfl_recovery_strategy "none", through the CUDA
kernels.  Prints one JSON line {"metric", "value", "unit", "vs_baseline"}
(+ "reps" with BENCH_REPS > 1), where value is MQ/s = real nodes x
substeps / wall seconds / 1e6.  The same BENCH_* variables as bench.py
set the sizes: BENCH_REFINEMENT (3), BENCH_WARMUP (1500 steps, so the
bow shock spans the domain and the limiter works everywhere),
BENCH_STEPS (20 timed steps), BENCH_REPS (1).
"""

from __future__ import annotations

import json
import os
import sys
import time

import torch

from ryujin_tpu.offline import assembly, geometry, structured

from .equations.euler import Euler
from .equations.euler_initial_states import make_initial_state
from .postprocess.error import interpolate_nodal
from .solver.hyperbolic import HyperbolicModule
from .solver.integrator import TimeIntegrator

BASELINE_MQS = 100.0  # bench.py's north-star constant, not a measurement


def build_step2d(refinement: int, dtype, device):
    """(eq, sd, hm, ti, U0) of the step2d case: uniform Mach-3 inflow."""
    eq = Euler(dim=2)
    mesh = geometry.step(refinement=refinement)
    sd = structured.pack_structured(assembly.assemble(mesh), mesh)
    init = make_initial_state(eq, "uniform", primitive_state=(1.4, 3.0, 1.0))
    hm = HyperbolicModule(eq, sd, init, dtype=dtype, device=device)
    ti = TimeIntegrator(hm, "erk 33", cfl_min=0.45, cfl_max=0.9,
                        cfl_recovery_strategy="none")
    U0 = interpolate_nodal(init, sd, eq, 0.0, dtype, device)
    return eq, sd, hm, ti, U0


def entry(device=None):
    """(fn, example_args): one IDP substep (prepare + step) on the step
    mesh at refinement 0 in f32, as __graft_entry__.entry()."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
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
    refinement = int(os.environ.get("BENCH_REFINEMENT", "3"))
    n_steps = int(os.environ.get("BENCH_STEPS", "20"))
    warmup = int(os.environ.get("BENCH_WARMUP", "1500"))
    reps = int(os.environ.get("BENCH_REPS", "1"))

    _, sd, _, ti, U0 = build_step2d(refinement, torch.float32, "cuda")
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
        "metric": "euler2d_mach3_step_throughput",
        "value": round(mqs, 3),
        "unit": "MQ/s/chip",
        "vs_baseline": round(mqs / BASELINE_MQS, 4),
    }
    if reps > 1:
        rec["reps"] = [round(v, 2) for v in mqs_reps]
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
