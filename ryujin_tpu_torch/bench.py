"""Throughput of the port on the Euler Mach-3 flows of bench.py.

    python -m ryujin_tpu_torch.bench
    BENCH_CASE=q2step2d python -m ryujin_tpu_torch.bench
    BENCH_CASE=box3d python -m ryujin_tpu_torch.bench
    BENCH_CASE=dg1box3d python -m ryujin_tpu_torch.bench

Runs three of bench.py's cases and a dG form of the third on a CUDA
device, in f32 with ERK33 through the CUDA kernels:

  step2d    (default) cG Q1, refinement 3, CFL 0.9, cfl_recovery_strategy
            "none", 1500-step warmup; metric euler2d_mach3_step_throughput
  q2step2d  cG Q2 (reach-2 canvas, K = 24, the slot-streaming kernels),
            refinement 2, CFL 0.9 / 0.45 with "bang bang control",
            1000-step warmup; metric euler2d_mach3_step_cgq2
  box3d     3D, cG Q1 on the box [0, 3] x [0, 1] x [0, 1] (31 x 16 x 16
            cells, refinement 2; inflow dirichlet, outflow do_nothing, slip
            walls), a (D, H, W) canvas with K = 26 and the slot-streaming
            kernels on the two-direction Riemann route, CFL 0.9 / 0.45
            with "bang bang control", 1000-step warmup; metric
            euler3d_mach3_box_throughput
  dg1box3d  box3d with the ansatz switched to dG Q1 at refinement 1
            (507,904 dofs on the same (72, 72, 128) canvas, K = 26, the
            incidence beta_ij in PK2 / PK3, the two-direction route);
            1000-step warmup; metric euler3d_mach3_box_dgq1_throughput.
            Its host assembly takes a minute or more (numpy).

Prints one JSON line {"metric", "value", "unit", "vs_baseline"} (+
"reps" with BENCH_REPS > 1), where value is MQ/s = real nodes x substeps
/ wall seconds / 1e6, and, on standard error, a "setup" line with the
seconds of mesh, assembly, packing and statics.  The same BENCH_*
variables as bench.py set the sizes: BENCH_REFINEMENT, BENCH_WARMUP
(steps, so the bow shock spans the domain and the limiter works
everywhere), BENCH_STEPS (20 timed steps), and BENCH_REPS (1).
"""

from __future__ import annotations

import json
import os
import sys
import time

import torch

from .offline import assembly, geometry, structured
from .offline.mesh import Boundary

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


def build_box3d(refinement: int, dtype, device, subdiv=(31, 16, 16),
                ansatz: str = "cG Q1"):
    """(eq, sd, hm, ti, U0) of the box3d case (bench.py:60-82): 3D Euler,
    uniform Mach-3 inflow on [0, 3] x [0, 1] x [0, 1] with `subdiv` cells
    before `refinement`, `ansatz` (cG Q1, or dG Q1 for dg1box3d) packed
    with z and y margins of 2, bang-bang recovery.  (The JAX bench packs
    with the TPU kernels' margin gate, which is not carried over.)"""
    eq = Euler(dim=3)
    mesh = geometry.rectangular_domain(
        [0.0, 0.0, 0.0], [3.0, 1.0, 1.0], list(subdiv),
        refinement=refinement,
        boundary_conditions=[
            Boundary.dirichlet, Boundary.do_nothing,
            Boundary.slip, Boundary.slip, Boundary.slip, Boundary.slip,
        ],
        dim=3,
    )
    sd = structured.pack_structured(
        assembly.assemble(mesh, ansatz=ansatz), mesh, margin=(2, 2)
    )
    init = make_initial_state(eq, "uniform", primitive_state=(1.4, 3.0, 1.0))
    hm = HyperbolicModule(eq, sd, init, dtype=dtype, device=device)
    ti = TimeIntegrator(hm, "erk 33", cfl_min=0.45, cfl_max=0.9,
                        cfl_recovery_strategy="bang bang control")
    U0 = interpolate_nodal(init, sd, eq, 0.0, dtype, device)
    return eq, sd, hm, ti, U0


def build_dg1box3d(refinement: int, dtype, device, subdiv=(31, 16, 16)):
    """(eq, sd, hm, ti, U0) of the dg1box3d case: box3d's flow, domain,
    boundary conditions, packing and recovery with the dG Q1 ansatz."""
    return build_box3d(refinement, dtype, device, subdiv, ansatz="dG Q1")


# case -> (build_case, default refinement, default warmup steps, metric)
CASES = {
    "step2d": (build_step2d, 3, 1500, "euler2d_mach3_step_throughput"),
    "q2step2d": (build_q2step2d, 2, 1000, "euler2d_mach3_step_cgq2"),
    "box3d": (build_box3d, 2, 1000, "euler3d_mach3_box_throughput"),
    "dg1box3d": (build_dg1box3d, 1, 1000,
                 "euler3d_mach3_box_dgq1_throughput"),
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

    t0 = time.perf_counter()
    _, sd, _, ti, U0 = build_case(refinement, torch.float32, "cuda")
    print(f"setup {time.perf_counter() - t0:.1f} s: {case}, canvas "
          f"{sd.shape}, {sd.n_nodes} real nodes, K = {sd.max_degree}",
          file=sys.stderr, flush=True)
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
