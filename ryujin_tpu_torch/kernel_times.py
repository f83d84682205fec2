"""Kernel times on the bench shapes, to compare two trees on one card.

    python -m ryujin_tpu_torch.kernel_times [CASE ...]   # from a checkout's root

Builds this checkout's kernels, develops the states of chip_smoke.py
phases 2, 4 and 6 and times every kernel there with
chip_smoke.compare_kernels (CUDA events, mean of 20 launches).  CASE is
step2d (refinement 3 after 40 plain ERK33 steps; the stream kernels also
on its K = 8 canvas, as phase 2a does), q2step2d (refinement 2 after 150
ERK33 steps through the kernels) or box3d (refinement 2, 150 steps
through the kernels from a blast); without one, step2d and q2step2d.
Prints one JSON line {"card", "ms": {kernel: ms}}.

To compare two trees, run it from the root of each in turns (A, B, B, A)
on one card.  It uses only chip_smoke.compare_kernels,
chip_smoke.PlainSteps, the bench builders and TimeIntegrator, so an older
checkout that has them (the cG Q2 slice onward) runs it once this file is
copied into its ryujin_tpu_torch/.
"""

from __future__ import annotations

import json
import sys

import torch


def main():
    if not torch.cuda.is_available():
        sys.exit("ryujin_tpu_torch.kernel_times needs a CUDA device")
    import chip_smoke as cs

    from .bench import build_q2step2d, build_step2d
    from .kernels import build
    from .solver.integrator import TimeIntegrator

    build.build()
    build.library()
    dev = torch.device("cuda")
    ms = {}

    def timed(hm, U_a, U_b, prefix="", stream=None):
        records = {}
        if not cs.compare_kernels(hm, U_a, U_b, cs.TOL_F32, cs.REPS, records,
                                  stream=stream):
            sys.exit("a kernel disagrees with its plain-torch reference")
        ms.update((prefix + name, rec["ms"]) for name, rec in records.items())

    cases = sys.argv[1:] or ["step2d", "q2step2d"]
    if "step2d" in cases:
        _, _, hm, _, U0 = build_step2d(cs.REFINEMENT, torch.float32, dev)
        plain = TimeIntegrator(cs.PlainSteps(hm), "erk 33", cfl_min=0.45,
                               cfl_max=0.9, cfl_recovery_strategy="none")
        U_a, _, t_a, _, _, _ = plain.advance(U0, 0.0, cs.PLAIN_STEPS)
        U_b = plain.advance(U_a, t_a, 1)[0]
        timed(hm, U_a, U_b)
        timed(hm, U_a, U_b, "K=8 ", stream=True)
        del hm, plain, U_a, U_b, U0
    if "q2step2d" in cases:
        _, _, hm, ti, U0 = build_q2step2d(cs.Q2_REFINEMENT, torch.float32,
                                          dev)
        U_a, _, t_a, _, _, _ = ti.advance(U0, 0.0, cs.Q2_DEVELOP_STEPS)
        U_b = ti.advance(U_a, t_a, 1)[0]
        timed(hm, U_a, U_b)
        del hm, ti, U_a, U_b, U0
    if "box3d" in cases:
        from .bench import build_box3d

        _, sd, hm, ti, U0 = build_box3d(cs.BOX_REFINEMENT, torch.float32, dev)
        U_a, _, t_a, _, _, _ = ti.advance(cs.bumped(sd, U0, blast=True), 0.0,
                                          cs.BOX_DEVELOP_STEPS)
        U_b = ti.advance(U_a, t_a, 1)[0]
        timed(hm, U_a, U_b, "3D ")
    print(json.dumps({"card": cs.smi_line(), "ms": ms}), flush=True)


if __name__ == "__main__":
    main()
