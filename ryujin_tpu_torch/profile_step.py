"""Where the time of an ERK33 step goes on the card.

    python -m ryujin_tpu_torch.profile_step              # step2d
    BENCH_CASE=q2step2d python -m ryujin_tpu_torch.profile_step
    BENCH_CASE=box3d python -m ryujin_tpu_torch.profile_step
    BENCH_CASE=dg1box3d python -m ryujin_tpu_torch.profile_step
    BENCH_CASE=cylinder3d RYUJIN_SEP=1 python -m ryujin_tpu_torch.profile_step
    BENCH_CASE=amr2d python -m ryujin_tpu_torch.profile_step

After the warmup of the bench case (BENCH_WARMUP, BENCH_REFINEMENT and
RYUJIN_SEP as in ryujin_tpu_torch.bench) it

1. traces PROFILE_STEPS (5) steps with torch.profiler and prints the device
   time of the hand-written kernels by name, of everything else (the torch
   glue between them), the number of device launches, the wall time of the
   traced window and the device's idle share in it, and, of the glue, the
   device time of the ghost refreshes (canvas_step.refresh) and of the
   side rows of a multi-block canvas (solver/sideband.py), each traced in
   a range of its own;
2. times windows of BENCH_STEPS (20) steps on the host clock, without the
   profiler, in turns with cfl_recovery_strategy "none" (no host read in
   the loop) and "bang bang control" (one read of `ok` per step), and
   prints ms per step, MQ/s and the idle share of each, taking the device
   time per step from the trace.  Both run the same work as long as no
   step restarts, which is printed.

Every line names the card (nvidia-smi name and power limit).
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import torch

from .bench import CASES, separable_from_env, sym_mb_from_env
from .solver import canvas_step
from .solver.integrator import TimeIntegrator
from .solver.sideband import Sideband

OUR_KERNELS = ("pk1_kernel", "pk2_kernel", "pk3_kernel", "pk_up_kernel",
               "pk_up_tile_kernel", "pk_up_last_kernel", "pk1_stream_kernel",
               "pk1_stream_tile_kernel", "pk2_stream_kernel",
               "pk2_stream_tile_kernel", "pk3_stream_kernel")


def _kernel_name(key: str):
    """The hand-written kernel a profiler key names (its SEP instance
    marked), or None."""
    for name in sorted(OUR_KERNELS, key=len, reverse=True):
        if name in key:
            return name + (" SEP" if "SepStatics" in key else "")
    return None


# the glue traced in ranges of its own: (range name, owner, attributes)
GLUE_RANGES = (
    ("ghost refresh", canvas_step, ("refresh",)),
    ("side rows", Sideband, ("e_alpha", "d_side", "tau_side", "low_order",
                             "p_l1", "update", "scatter_edge_",
                             "scatter_rows_")),
)


def _ranged(fn, name):
    """fn inside a torch.profiler.record_function range `name`, keeping
    fn's attributes (refresh's launch count)."""
    from torch.profiler import record_function

    def wrapped(*args, **kwargs):
        with record_function(name):
            return fn(*args, **kwargs)

    wrapped.__dict__.update(fn.__dict__)
    return wrapped


def main():
    if not torch.cuda.is_available():
        sys.exit("ryujin_tpu_torch.profile_step needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    case = os.environ.get("BENCH_CASE", "step2d")
    if case not in CASES:
        sys.exit(f"BENCH_CASE={case} is not ported (only {sorted(CASES)})")
    build_case, refinement_default, warmup_default, _ = CASES[case]
    refinement = int(os.environ.get("BENCH_REFINEMENT", str(refinement_default)))
    warmup = int(os.environ.get("BENCH_WARMUP", str(warmup_default)))
    n_steps = int(os.environ.get("BENCH_STEPS", "20"))
    n_profiled = int(os.environ.get("PROFILE_STEPS", "5"))
    separable = separable_from_env()
    kw = {"sym_mb": True} if sym_mb_from_env() else {}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]

    t0 = time.perf_counter()
    _, sd, hm, ti, U0 = build_case(refinement, torch.float32, "cuda",
                                   separable=separable, **kw)
    print(f"setup {time.perf_counter() - t0:.1f} s (mesh, assembly, packing,"
          f" statics; {'separable' if separable else 'full'} statics, "
          f"factoring {hm.canvas.arrays.factor_seconds:.1f} s) on {card}",
          flush=True)
    integrators = {
        rec: TimeIntegrator(hm, ti.scheme, cfl_min=ti.cfl_min,
                            cfl_max=ti.cfl_max, cfl_recovery_strategy=rec)
        for rec in ("none", "bang bang control")
    }
    U, _, t, _, restarts, warns = ti.advance(U0, 0.0, max(warmup, 2))
    torch.cuda.synchronize()
    print(f"{case}: canvas {sd.shape}, {sd.n_nodes} real nodes, K = "
          f"{sd.max_degree}, recovery '{ti.cfl_recovery_strategy}', warmup "
          f"{warmup} steps (restarts {int(restarts)}, warnings {int(warns)}) "
          f"on {card}", flush=True)

    # ---- 1. the trace --------------------------------------------------------
    saved = [(owner, attr, getattr(owner, attr))
             for _, owner, attrs in GLUE_RANGES for attr in attrs]
    for name, owner, attrs in GLUE_RANGES:
        for attr in attrs:
            setattr(owner, attr, _ranged(getattr(owner, attr), name))
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            ti.advance(U, t, n_profiled)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)
    ours, glue_us, launches = {}, 0.0, 0
    ranges = {name: 0.0 for name, _, _ in GLUE_RANGES}
    for ev in prof.key_averages():
        if ev.key in ranges:
            # the range's CPU event sums the device time of the kernels
            # launched inside it; its twin on the device timeline
            # (gpu_user_annotation) spans first launch to last, gaps and
            # all, and is left out
            if str(ev.device_type).endswith("CPU"):
                ranges[ev.key] += ev.device_time_total
            continue
        dev_us = ev.self_device_time_total
        if dev_us <= 0 or str(ev.device_type).endswith("CPU"):
            continue
        launches += ev.count
        name = _kernel_name(ev.key)
        if name is None:
            glue_us += dev_us
        else:
            n, us = ours.get(name, (0, 0.0))
            ours[name] = (n + ev.count, us + dev_us)
    kernels_us = sum(us for _, us in ours.values())
    device_ms_per_step = (kernels_us + glue_us) / 1e3 / n_profiled
    if device_ms_per_step <= 0.0:
        sys.exit("the trace shows no device time")
    print(f"trace of {n_profiled} steps: wall {wall * 1e3 / n_profiled:.3f} "
          f"ms/step, device {device_ms_per_step:.3f} ms/step (hand-written "
          f"kernels {kernels_us / 1e3 / n_profiled:.3f}, torch glue "
          f"{glue_us / 1e3 / n_profiled:.3f}), {launches / n_profiled:.0f} "
          f"device launches/step, idle share "
          f"{1.0 - device_ms_per_step / (wall * 1e3 / n_profiled):.3f} "
          f"(under the profiler) on {card}", flush=True)
    for name, (n, us) in sorted(ours.items()):
        print(f"  {name:18s} {n:4d} launches  {us / n:9.1f} us each  "
              f"{us / 1e3 / n_profiled:7.3f} ms/step", flush=True)
    for name, us in ranges.items():
        print(f"  of the glue, {name}: {us / 1e3 / n_profiled:.3f} ms/step, "
              f"{us / 1e3 / n_profiled / device_ms_per_step:.3f} of the "
              "device time", flush=True)

    # ---- 2. host-clock windows, with and without the per-step read ---------
    for rec in ("none", "bang bang control", "bang bang control", "none"):
        t0 = time.perf_counter()
        out = integrators[rec].advance(U, t, n_steps)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / n_steps
        print(f"window of {n_steps} steps, recovery '{rec}': {ms:.3f} ms/step,"
              f" {sd.n_nodes * 3 / ms / 1e3:.3f} MQ/s, idle share "
              f"{1.0 - device_ms_per_step / ms:.3f}, restarts {int(out[4])}, "
              f"warnings {int(out[5])} on {card}", flush=True)


if __name__ == "__main__":
    main()
