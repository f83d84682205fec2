"""Where the time of an ERK33 step goes on the card.

    python -m ryujin_tpu_torch.profile_step              # step2d
    BENCH_CASE=q2step2d python -m ryujin_tpu_torch.profile_step
    BENCH_CASE=box3d python -m ryujin_tpu_torch.profile_step
    BENCH_CASE=dg1box3d python -m ryujin_tpu_torch.profile_step
    BENCH_CASE=cylinder3d RYUJIN_SEP=1 python -m ryujin_tpu_torch.profile_step

After the warmup of the bench case (BENCH_WARMUP, BENCH_REFINEMENT and
RYUJIN_SEP as in ryujin_tpu_torch.bench) it

1. traces PROFILE_STEPS (5) steps with torch.profiler and prints the device
   time of the hand-written kernels by name, of everything else (the torch
   glue between them), the number of device launches, the wall time of the
   traced window and the device's idle share in it;
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

from .bench import CASES, separable_from_env
from .solver.integrator import TimeIntegrator

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
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]

    t0 = time.perf_counter()
    _, sd, hm, ti, U0 = build_case(refinement, torch.float32, "cuda",
                                   separable=separable)
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
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ti.advance(U, t, n_profiled)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ours, glue_us, launches = {}, 0.0, 0
    for ev in prof.key_averages():
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
