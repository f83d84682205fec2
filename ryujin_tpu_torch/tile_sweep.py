"""Time the stacked pk1 and pk2 and pk1_stream over their tiles, and
other checkouts' builds of them on the same inputs; the sublane gather
probe over its row groups and the lane gather over its column groups;
the ELL gather-sum's, the layout probe's, moveaxis's, pk1_shape's and the
pow probe's kernels over their launches; and the pow probe, the ELL
gather-sum, the lane gather, moveaxis and pk1_shape of other checkouts in
turns.

    python -m ryujin_tpu_torch.tile_sweep [--tree NAME=ROOT ...] [CASE ...]

From a checkout's root.  Builds this checkout's kernels and, with
--tree, those of each other checkout ROOT (one build process each, all
at once), develops the states of chip_smoke.py phases 2, 4, 6 and 10
through this checkout's kernels and takes the inputs of the third ERK33
substep as compare_kernels does.  CASE is step2d (the stacked pk1, the
stacked pk2 at 2, 1 and 0 stages, and pk1_stream on its K = 8 canvas),
q2step2d, box3d or
cylinder3d (pk1_stream with the full statics, and with the separable
ones on the same state), or gather (the sublane gather of
probes/gather.py at S = 1024, L = 128 with each group count of GROUPS,
held exactly against the plain version, beside torch.gather, each in
a CUDA graph of probes.CHAIN calls: probes.graph_ms; and the lane gather
at P = 8, W = 2048 and 2047 over the launches of LANE_CANDIDATES, the
same way; this checkout only), or layouts (the three layouts of probes/layout3d.py at the
script's sizes over the launches of LAYOUT_CANDIDATES, and at the
default launch, each held exactly against the plain version and timed
the same way beside its PyTorch call; this checkout only), or pow (every
PowForm pointwise and summed at the sizes of rows 11 and 12 over the
launches of POW_CANDIDATES, and at the default launch, each held
against the plain version at its bar and against the default launch
bit for bit, timed the same way beside its PyTorch call; this checkout
only), or pow-turns (pow_turn, run in each checkout's own process with
its package first on the path, in turns: the others, this, this, the
others reversed; every form's chained time at the default launch and a
digest of its output, compared with this checkout's; so P C C P with
the parent as the one other), or ell (the ELL gather-sum of
probes/gather.py at the script's input over the launches of
ELL_CANDIDATES whose ring holds every block's band, and at the default
launch, each held exactly against the plain version and against the
default launch, with its staged-block count against ell_staged_blocks,
timed in CUDA graphs beside X[:, cols].sum(1); this checkout only), or
moveaxis (both MOV of probes/layout3d.py at the script's sizes over the
launches of LAYOUT_CANDIDATES["full"], each held exactly, timed the same
way; this checkout only), or pk1-shape (pk1_shape at the script's
sizes over the launches of LAYOUT_CANDIDATES["pk1_shape"], each held
exactly, timed the same way; this checkout only), or gather-turns
(gather_turn: the ELL gather-sum at the script's input and the lane
gather at P = 8, W = 2048, digests of out and chained ms), moveaxis-turns
(moveaxis_turn: both MOV, digests of out and check) or pk1-shape-turns
(pk1_shape_turn: digests of out and check, chained and single ms), each
in turns as pow-turns; or ell-step (ell_pk1, ell_pk2, ell_pk3, PK4 and
PK5 on the step at chip_smoke.ELL_REFINEMENT, f32, after
chip_smoke.ELL_WARMUP ERK33 steps, over the launches of
ELL_STEP_CANDIDATES and at the default launch, each bit-equal to the
default launch, chip_smoke.time_ms; this checkout only), or
ell-step-turns (ell_step_turn: the same five on the inputs
ell_step_inputs saves, the same step timed, f64 on phase 14a's 3D box and
airfoil at 2 and 4 stage slots; digests of every output, in turns as
pow-turns), or ell-cuts (no card: the copies of ELL_CUTS of this
checkout and of each --tree, and with --blocks this checkout's with
other launch bounds, written under _checkout/, as --trees of
ell-step-turns); without one,
all but the turns and the ELL cases.  For
each launch of the solver kernels it
times, with CUDA events (chip_smoke.time_ms, mean of 20 launches after
a warm one), this checkout's kernel at the tile its wrapper chooses and
each other checkout's, in turns (this, the others, this, the others
reversed), then this checkout's kernel at every tile of TILES, and
checks whether each other checkout's outputs equal this one's bit for
bit.  Every launch goes through this checkout's wrappers and tile():
another checkout's library must accept that launch shape (a
one-thread-a-cell launcher ignores it), and may compute something else
(a copy with a part cut out, to time that part).  Prints one line per
timing and, last, one JSON line {"card", "ms": {key: ms}, "equal": {key:
bool}, "resources": {tree: {instance: {regs, stack, threads, smem,
warps}}}}.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import functools
import inspect
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# candidate tiles (TY, TZ); TZ is 1 in 2D
TILES = {2: [(1, 1), (2, 1), (4, 1), (8, 1)],
         3: [(2, 2), (4, 2), (2, 4), (8, 1), (4, 1), (1, 8)]}
# candidate row groups of the sublane gather (its blocks: 4 tiles each);
# column groups and threads of the lane gather (its blocks: P = 8 rows
# each)
GROUPS = (1, 2, 4, 8, 16, 32)
LANE_CANDIDATES = {"groups": (1, 2, 4, 8, 16, 32, 64),
                   "threads": (32, 64, 128, 256)}
# candidate launches of the pow kernels (kernels/probe_pow.py pow_shape):
# threads and items a thread of the pointwise float4 kernel, threads,
# elements a thread and unroll of the summed one; the scalar pointwise
# instance is timed at 256 threads
POW_CANDIDATES = {
    False: {"threads": (128, 256, 512), "items": (1, 2, 4), "unroll": (1,),
            "vec": (4,)},
    True: {"threads": (64, 128, 256), "items": (1, 2),
           "unroll": (1, 2, 4, 8)},
}
# candidate launches of the ELL gather-sum (kernels/probe_gather.py
# ell_shape): nodes a block, threads, stages and blocks an SM
ELL_CANDIDATES = {"nodes": (512, 1024, 2048, 4096), "threads": (256, 512),
                  "stages": (2, 3), "per_sm": (1, 2, 3, 4)}
# candidate launches of ell_pk2 and ell_pk3 (kernels/ell.py
# ell_step_shape): rows a block and threads
ELL_STEP_CANDIDATES = {"rows": (16, 32, 64, 128), "threads": (32, 64, 128)}
# candidate launches of the layout kernels (kernels/probe_layout3d.py
# layout_shape): tile widths, stages and z segments, for the full-window
# kernels and the slide
LAYOUT_CANDIDATES = {
    "full": {"tile": (64, 128), "stages": (2, 3, 4),
             "segments": (1, 2, 3, 4, 6, 8, 12, 17)},
    "slide": {"tile": (64, 128), "stages": (2, 3, 4, 6),
              "segments": (1, 2, 3, 4, 6, 8, 12, 17)},
    # pk1_shape (pk1_shape_shape): threads a block, in groups of TD tile
    "pk1_shape": {"tile": (64, 128), "stages": (1, 2, 3, 4),
                  "segments": (1, 2, 3, 4, 6, 11, 17, 34),
                  "threads": (128, 256, 512, 1024)},
}


def pow_turn():
    """One turn of `pow-turns`, run in a checkout's own process (its
    package first on the path): every PowForm pointwise and summed at the
    sizes of rows 11 (512 x 1024, 40 terms, b = 1.4) and 12 (64 x 2048,
    16 terms, a 64-launch chain each on x + 1e-9 carry), through that
    checkout's default launch; for each, a digest of the output's bytes
    and the mean ms of a call (of a launch in the chain) in a CUDA graph
    of probes.CHAIN calls (probes.graph_ms), beside the PyTorch calls.
    Uses only what every checkout since the chained reading has:
    kernels.probe_pow's probe_pow and FORMS, probes.graph_ms and
    probes.CHAIN, and probes.pow's parser and cases (for the inputs).
    Returns {"ms": {entry: ms}, "digest": {entry: hex}}."""
    import hashlib

    import torch

    from ryujin_tpu_torch import probes
    from ryujin_tpu_torch.kernels import probe_pow as kp
    from ryujin_tpu_torch.probes import pow as ppow

    _, _, (x11, s11, x12, s12) = ppow.cases(ppow.parser().parse_args([]),
                                            None, 0)
    X11 = torch.stack([x11 + s for s in s11.tolist()])
    X12 = torch.stack([x12 + s for s in s12.tolist()])
    b, loop = 1.4, 64
    res = {"ms": {}, "digest": {}}

    def chain(form):
        def run():
            a = x12
            for _ in range(loop):
                a = kp.probe_pow(x12, form, b, s12, a)
            return a
        return run

    def entry(name, fn, per=1, digest=True):
        out = fn()
        torch.cuda.synchronize()
        if digest:
            res["digest"][name] = hashlib.sha256(
                out.cpu().numpy().tobytes()).hexdigest()[:16]
        res["ms"][name] = probes.graph_ms(fn, probes.CHAIN) / per

    for form in kp.FORMS:
        entry(f"{form} row11 pointwise", lambda: kp.probe_pow(x11, form, b))
        entry(f"{form} row11 summed",
              lambda: kp.probe_pow(x11, form, b, s11))
        entry(f"{form} row12 pointwise", lambda: kp.probe_pow(x12, form, b))
        entry(f"{form} row12 summed",
              lambda: kp.probe_pow(x12, form, b, s12))
        entry(f"{form} row12 chain", chain(form), per=loop)
    for name, fn in (
            ("torch.mul row11", lambda: torch.mul(x11, b)),
            ("torch.sqrt row11", lambda: torch.sqrt(x11)),
            ("torch.pow row11", lambda: torch.pow(x11, b)),
            ("torch.mul(X).sum(0) row11", lambda: torch.mul(X11, b).sum(0)),
            ("torch.sqrt(X).sum(0) row11", lambda: torch.sqrt(X11).sum(0)),
            ("torch.pow(X).sum(0) row11", lambda: torch.pow(X11, b).sum(0)),
            ("torch.pow(X).sum(0) row12", lambda: torch.pow(X12, b).sum(0))):
        entry(name, fn, digest=False)
    return res


def gather_turn():
    """One turn of `gather-turns`, run in a checkout's own process: the
    ELL gather-sum at the script's input (probes.gather.ell_inputs, n =
    2^20, K = 9, C = 12) and the lane gather at the probe's P = 8, W =
    2048 (probes.gather.lane_inputs) through that checkout's default
    launches, a digest of each out's bytes, the mean ms of a call in a
    CUDA graph of probes.CHAIN calls and, for the lane gather, of a
    single call after an L2 flush (probes.time_ms), beside
    X[:, cols].sum(1) and torch.gather.  Uses only what every checkout
    since the chained reading has.  Returns {"ms": {entry: ms}, "digest":
    {entry: hex}}."""
    import hashlib

    import torch

    from ryujin_tpu_torch import probes
    from ryujin_tpu_torch.kernels import probe_gather as kg
    from ryujin_tpu_torch.probes import gather

    X, cols = (torch.from_numpy(a).cuda()
               for a in gather.ell_inputs(1 << 20, 9, 12))
    x, idx = (torch.from_numpy(a).cuda() for a in gather.lane_inputs(8, 2048))
    cols64, idx64 = cols.long(), idx.long()
    res = {"ms": {}, "digest": {}}
    for name, fn, digest in (
            ("ell_gather_sum", lambda: kg.ell_gather_sum(X, cols), True),
            ("X[:, cols].sum(1)", lambda: X[:, cols64].sum(1), False),
            ("lane_gather", lambda: kg.lane_gather(x, idx), True),
            ("torch.gather", lambda: torch.gather(x, 1, idx64), False)):
        out = fn()
        torch.cuda.synchronize()
        if digest:
            res["digest"][name] = hashlib.sha256(
                out.cpu().numpy().tobytes()).hexdigest()[:16]
        del out
        res["ms"][name] = probes.graph_ms(fn, probes.CHAIN)
        if name in ("lane_gather", "torch.gather"):
            res["ms"][f"{name} single"] = probes.time_ms(fn, probes.REPS, True)
    return res


def moveaxis_turn():
    """One turn of `moveaxis-turns`, run in a checkout's own process:
    moveaxis with MOV = 1 and 0 at the script's sizes (probes.layout3d's
    cases, --MOV both) through that checkout's default launch, digests of
    out and check and the mean ms of a call in a CUDA graph of
    probes.CHAIN calls.  Returns {"ms": {entry: ms}, "digest": {entry:
    hex}}."""
    import hashlib

    import torch

    from ryujin_tpu_torch import probes
    from ryujin_tpu_torch.probes import layout3d

    res = {"ms": {}, "digest": {}}
    args = layout3d.parser().parse_args(["--MOV", "both"])
    for case in layout3d.cases(args, "moveaxis_cost"):
        name = "moveaxis " + case.name[case.name.index("MOV="):][:5]
        out, check = case.kernel()
        torch.cuda.synchronize()
        for part, t in (("out", out), ("check", check)):
            res["digest"][f"{name} {part}"] = hashlib.sha256(
                t.cpu().numpy().tobytes()).hexdigest()[:16]
        del out, check
        res["ms"][name] = probes.graph_ms(case.kernel, probes.CHAIN)
    return res


def pk1_shape_turn():
    """One turn of `pk1-shape-turns`, run in a checkout's own process:
    pk1_shape at the script's sizes (probes.layout3d's cases, part
    pk1_shape: CENPL 78, windows of 5, 4 and 2 planes, OUTPL 14 on
    (72, 72, 128), TD = 2) through that checkout's default launch,
    digests of out and check, the mean ms of a call in a CUDA graph of
    probes.CHAIN calls and of 30 single calls back to back (its 264 MB
    do not fit the L2; probes.time_ms).  Returns {"ms": {entry: ms},
    "digest": {entry: hex}}."""
    import hashlib

    import torch

    from ryujin_tpu_torch import probes
    from ryujin_tpu_torch.probes import layout3d

    res = {"ms": {}, "digest": {}}
    (case,) = layout3d.cases(layout3d.parser().parse_args([]), "pk1_shape")
    out, check = case.kernel()
    torch.cuda.synchronize()
    for part, t in (("out", out), ("check", check)):
        res["digest"][f"pk1_shape {part}"] = hashlib.sha256(
            t.cpu().numpy().tobytes()).hexdigest()[:16]
    del out, check
    res["ms"]["pk1_shape"] = probes.graph_ms(case.kernel, probes.CHAIN)
    res["ms"]["pk1_shape single"] = probes.time_ms(case.kernel, case.reps,
                                                   False)
    return res


def ell_step_turn(path):
    """One turn of `ell-step-turns`, run in a checkout's own process: the
    five ELL launches of a substep of that checkout at their default
    launch on the inputs ell_step_inputs saved (torch.save, the file
    `path`): ell_pk1 (e, alpha) once a case, and for every call ell_pk2
    (U_low, F, bounds), ell_pk3 (P, l, okp), PK4 (ell_pk_up re-limiting:
    U_next, l') and PK5 (ell_pk_up, last: U_next), each on the inputs this
    checkout's kernels made, so that a kernel that differs moves no other's
    digest; a digest of each output's bytes, and the mean ms of 20 calls
    back to back after 100 warm ones (probes.time_ms) for the calls of a
    case marked timed.  Uses only what every checkout since the padded-ELL
    path has.  Returns {"ms": {entry: ms}, "digest": {entry: hex}}."""
    import dataclasses
    import hashlib

    import torch

    from ryujin_tpu_torch import probes
    from ryujin_tpu_torch.equations.euler import Euler
    from ryujin_tpu_torch.kernels import ell
    from ryujin_tpu_torch.solver.hyperbolic import HyperbolicModuleParams
    from ryujin_tpu_torch.solver.stencil import EllStencil

    cases = torch.load(path, map_location="cuda")
    fields = {f.name for f in dataclasses.fields(EllStencil)}
    p = HyperbolicModuleParams()
    res = {"ms": {}, "digest": {}}

    def entry(key, fn, args, names, timed):
        out = fn(*args)
        torch.cuda.synchronize()
        for part, t in zip(names, out):
            if t is not None:
                res["digest"][f"{key} {part}"] = hashlib.sha256(
                    t.cpu().numpy().tobytes()).hexdigest()[:16]
        del out
        if timed:
            for _ in range(100):  # the card at its clocks first
                fn(*args)
            res["ms"][key] = probes.time_ms(lambda: fn(*args), 20, False)

    for case, c in cases.items():
        st = EllStencil(**{k: v for k, v in c["stencil"].items()
                           if k in fields})
        eq = Euler(dim=st.dim)
        U, d, alpha, tau = c["U"], c["d"], c["alpha"], c["tau"]
        entry(f"ell_pk1 {case}", ell.ell_pk1, (eq, p, st, U, c["prec"]),
              ("e", "alpha"), c["timed"])
        for w, sU, F, U_low, bounds, P, l, U4, l4 in c["calls"]:
            w = list(w)
            calls = {
                "ell_pk2": ((eq, p, st, U, c["prec"], d, alpha, sU, w, tau),
                            ("U_low", "F", "bounds")),
                "ell_pk3": ((eq, p, st, U, d, alpha, F, U_low, bounds, sU, w,
                             tau), ("P", "l", "okp")),
                "PK4": ((eq, p, st, U_low, bounds, P, l, False),
                        ("U_next", "l'")),
                "PK5": ((eq, p, st, U4, bounds, P, l4, True), ("U_next",)),
            }
            for kern, (args, names) in calls.items():
                fn = getattr(ell, {"PK4": "ell_pk_up", "PK5": "ell_pk_up"}
                             .get(kern, kern))
                entry(f"{kern} {case} S={len(w)}", fn, args, names,
                      c["timed"])
    return res


def ell_step_launches(res, dev):
    """ell_pk1, ell_pk2, ell_pk3 and ell_pk_up (PK4 and PK5) on
    ell_step_inputs' "step" over ELL_STEP_CANDIDATES and at the default
    launch, each held bit for bit against the default launch, timed with
    CUDA events (chip_smoke.time_ms, mean of 20 calls back to back), into
    res["ms"]."""
    import itertools

    import chip_smoke as cs

    from .equations.euler import Euler
    from .kernels import ell
    from .solver.hyperbolic import HyperbolicModuleParams
    from .solver.stencil import EllStencil

    c = ell_step_inputs(dev, ("step",))["step"]
    st = EllStencil(**c["stencil"])
    eq, p = Euler(dim=st.dim), HyperbolicModuleParams()
    (w, sU, F, U_low, bounds, P, l, U4, l4), = c["calls"]
    U, d, alpha, tau = c["U"], c["d"], c["alpha"], c["tau"]
    args = {"ell_pk1": ("ell_pk1", (eq, p, st, U, c["prec"]), 0),
            "ell_pk2": ("ell_pk2", (eq, p, st, U, c["prec"], d, alpha, sU,
                                    list(w), tau), len(w)),
            "ell_pk3": ("ell_pk3", (eq, p, st, U, d, alpha, F, U_low, bounds,
                                    sU, list(w), tau), len(w)),
            "PK4": ("ell_pk_up", (eq, p, st, U_low, bounds, P, l, False), 0),
            "PK5": ("ell_pk_up", (eq, p, st, U4, bounds, P, l4, True), 0)}
    for label, (kern, a, S) in args.items():
        fn = getattr(ell, kern)
        last = label == "PK5"
        want = fn(*a)
        default = ell.ell_step_shape(kern, st.dim, st.K, U.dtype, S, st.n,
                                     last=last)
        shapes = {default: "default"}
        for rows, threads in itertools.product(*ELL_STEP_CANDIDATES.values()):
            try:
                shapes.setdefault(ell.ell_step_shape(
                    kern, st.dim, st.K, U.dtype, S, st.n, rows, threads,
                    last=last), "")
            except ValueError:  # fewer threads than rows
                continue
        for shape, tag in shapes.items():
            ok = all((x is None and y is None) or torch.equal(x, y)
                     for x, y in zip(fn(*a, shape=shape), want))
            key = (f"{label} {tuple(shape)}{' ' + tag if tag else ''}"
                   f"{'' if ok else ' WRONG'}")
            res["ms"][key] = cs.time_ms(lambda: fn(*a, shape=shape), cs.REPS)
            print(f"  {key}: {res['ms'][key]:.4f} ms", flush=True)


def ell_step_inputs(dev, names=("step", "3D", "airfoil")):
    """{case: inputs} of ell-step-turns, through this checkout's kernels:
    "step" the step at chip_smoke.ELL_REFINEMENT packed by ell.pack, f32,
    chip_smoke.ELL_WARMUP ERK33 steps, the inputs of the third substep
    (two stage slots, as chip_smoke.compare_ell takes them), timed; "3D"
    and "airfoil" chip_smoke phase 14a's 3D box and airfoil in f64,
    developed as there, at two stage slots and ERK54's four.  ell_pk3's
    F, U_low and bounds are this checkout's ell_pk2's, PK4's P and l its
    ell_pk3's, PK5's U and l' its PK4's; `names` those of the three to
    build.  Prints each mesh's band table (kernels/ell.py
    band_table)."""
    import dataclasses

    import chip_smoke as cs

    from .bench import build_ell, ell_case
    from .kernels import ell
    from .offline import geometry
    from .solver.hyperbolic import d_from_e, tau_max_from_d

    built = {}
    if "step" in names:
        built["step"] = build_ell(geometry.step(
            refinement=cs.ELL_REFINEMENT), torch.float32, dev,
            recovery="none")
    for name, refinement in (("3D", 1), ("airfoil", 0)):
        if name not in names:
            continue
        eq, packed, hm, ti, U0 = ell_case(name, refinement, torch.float64,
                                          dev)
        built[name] = (eq, packed, hm, ti,
                       cs.bumped(packed, U0, blast=name == "3D"))
    cases = {}
    for case, (eq, _, hm, ti, U0) in built.items():
        p, st = hm.params, hm.stencil
        if case == "step":
            U_a, _, t_a, _, _, _ = ti.advance(U0, 0.0, cs.ELL_WARMUP)
            U_b = ti.advance(U_a, t_a, 1)[0]
        else:
            U_a, U_b = cs.ell_developed(case, eq, hm, ti, U0,
                                        cs.ELL_DEVELOP_STEPS)
        U, prec = hm.prepare_state_vector(U_b, 0.0)
        e, alpha = ell.ell_pk1(eq, p, st, U, prec)
        d = d_from_e(st.mask, e, st.transpose_edge(e))
        tau = tau_max_from_d(st, d, 0.9, torch.full(
            (), float("inf"), dtype=U.dtype, device=dev))
        stages = torch.stack(cs.stage_states(hm, U_a, U))
        weights = ([(0.75, -2.0)] if case == "step"
                   else [(0.75, -2.0), tuple(cs.erk54_weights(4))])
        calls = []
        for w in weights:
            sU = stages[: len(w)].contiguous()
            U_low, F, bounds = ell.ell_pk2(eq, p, st, U, prec, d, alpha, sU,
                                           list(w), tau)
            P, l, _ = ell.ell_pk3(eq, p, st, U, d, alpha, F, U_low, bounds,
                                  sU, list(w), tau)
            U4, l4 = ell.ell_pk_up(eq, p, st, U_low, bounds, P, l, False)
            calls.append((w, sU, F, U_low, bounds, P, l, U4, l4))
        cases[case] = {
            "stencil": {f.name: getattr(st, f.name)
                        for f in dataclasses.fields(st)},
            "U": U, "prec": prec, "d": d, "alpha": alpha, "tau": tau,
            "calls": calls, "timed": case == "step"}
        table = ell.band_table(st.cols.cpu(), st.mask.cpu(), st.dim,
                               U.element_size())
        print(f"  {case}: {st.n} rows, K = {st.K}, {U.dtype}; band width "
              "(quantiles 0.5 / 0.9 / 0.99 / 1) and shared bytes a block "
              f"would stage at two stage slots: {json.dumps(table)}",
              flush=True)
    return cases


# the cut copies of `ell-cuts`: name -> (start, end, [(text in the part of
# a checkout's csrc/ell_step.cu from the heading `start` to the heading `end`
# (None: the next heading), replacement, times it must occur there)]); a cut
# is made of each checkout where every text occurs so often, and timed as a
# --tree of ell-step-turns.  coalesced, compute, unrolled and nodiv cut the
# ell_pk2 and ell_pk3 kernels: coalesced, compute and unrolled step 0's of
# their one-thread-a-row forms (coalesced and compute also apply to the
# redesign), nodiv forms each neighbour's flux and b_ij without a division
# (the flux's parts m, m, rho, E; m_ij m_j) where the kernels form flux(U_j)
# whole.  The pk1- and pk4- cuts are those of ell_pk1 and ell_pk_up
_PK23 = ("// ---- ell_pk2", "// ---- ell_pk_up")
_PK1 = ("// ---- ell_pk1", None)
_UP = ("// ---- ell_pk_up", None)
ELL_CUTS = {
    # every neighbour read at i: the columns are still read, never used
    "coalesced": _PK23 + ([("const int64_t j = cols[k * n + i];",
                            "const int64_t j = i + (cols[k * n + i] == -1);",
                            2)],),
    # the per-edge solves gone: the limiter a constant, the entropy u_half[0]
    "compute": _PK23 + ([("l_out[k * n + i] = limiter_limit(e, bnd, ul, psi0, "
                          "P, success);",
                          "l_out[k * n + i] = T(0.5) + T(0) * P[0];\n    "
                          "success = true;", 1),
                         ("specific_entropy(e, u_half)", "u_half[0]", 1)],),
    # the stage loops unrolled over the instance's MS, nothing else
    "unrolled": _PK23 + ([("for (int s = 0; s < S; ++s) {",
                           "_Pragma(\"unroll\") for (int s = 0; s < MS; ++s) "
                           "if (s < S) {", 5)],),
    "nodiv": _PK23 + ([
        ("flux(e, uj, fj);",
         "{ T m_[DIM]; for (int d_ = 0; d_ < DIM; ++d_) m_[d_] = "
         "uj[1 + d_]; flux_from_parts(m_, m_, uj[0], uj[NC - 1], fj); }", 2),
        ("flux(e, usj, fsj);",
         "{ T m_[DIM]; for (int d_ = 0; d_ < DIM; ++d_) m_[d_] = "
         "usj[1 + d_]; flux_from_parts(m_, m_, usj[0], usj[NC - 1], "
         "fsj); }", 2),
        ("const T b_ij = -m_ij / node[j];",
         "const T b_ij = -m_ij * node[j];", 1)],),
    # ell_pk1's lambda_max a constant; the precomputes it reads are still
    # formed and read
    "pk1-lambda": _PK1 + ([(
        "e_k = norm * lambda_max(e, ui, pa_i, uj, pa_j, nv);",
        "e_k = norm * (T(1) + T(0) * (pa_i[1] + pa_i[3] + pa_j[0] + pa_j[1] "
        "+ pa_j[3] + pa_j[4] + nv[0]));", 1)],),
    # ell_pk1's neighbour read at i: the columns are still read, never used
    "pk1-coalesced": _PK1 + ([("const int64_t j = cols[k * n + i];",
                               "const int64_t j = i + (cols[k * n + i] == -1);",
                               1)],),
    # PK4's re-limit a constant (PK5 does not re-limit)
    "pk4-limiter": _UP + ([(
        "out = rest * limiter_limit(e, bnd, un, psi0, Pr, success);",
        "out = rest * (T(0.5) + T(0) * Pr[0]);", 1)],),
    # l at the transposed edge read at the edge itself (PK4 and PK5): trans
    # is still read, never used
    "pk4-trans": _UP + ([("l[trans[k * n + i]]",
                          "l[k * n + i + (trans[k * n + i] == -1)]", 2)],),
}
# the launch-bound constants of csrc/ell_step.cu that `ell-cuts --blocks
# PK1=8,PK4=10` sets in a copy named blocks-PK1=8,PK4=10 (the f32 1D and 2D
# instances' blocks of ELL_THREADS an SM must hold)
_BLOCKS = re.compile(r"\b(ELL_(PK\d|PK3_WIDE)_BLOCKS = )\d+")


def _ell_part(src, start, end):
    """(a, b): the part of `src` from the heading `start` to the heading
    `end`, or to the next heading ("// ---- ") after it."""
    a = src.index(start)
    b = src.index(end) if end else src.index("\n// ---- ", a + 1) + 1
    return a, b


def make_ell_cuts(root: Path, out: Path, prefix="", blocks=()):
    """Write the copies of ELL_CUTS that apply to the checkout at `root`
    (its package, csrc/ell_step.cu patched) under `out`/<prefix><name>,
    and for each of `blocks` ("PK1=8,PK4=10": ELL_PK1_BLOCKS 8,
    ELL_PK4_BLOCKS 10) a copy with those launch bounds, blocks-<it>."""
    import shutil

    src = (root / "ryujin_tpu_torch" / "csrc" / "ell_step.cu").read_text()
    variants = {name: (_ell_part(src, start, end), edits)
                for name, (start, end, edits) in ELL_CUTS.items()}
    for spec in blocks:
        want = dict(kv.split("=") for kv in spec.split(","))
        a = src.index("constexpr int ELL_PK2_BLOCKS")
        b = src.index("\n", src.index("ELL_PK1_BLOCKS", a)) + 1
        variants["blocks-" + spec] = ((a, b), [
            (m.group(0), m.group(1) + want[m.group(2)], 1)
            for m in _BLOCKS.finditer(src[a:b]) if m.group(2) in want])
    for name, ((a, b), edits) in variants.items():
        text = src[a:b]
        if any(text.count(old) != count for old, _, count in edits):
            print(f"  {root}: cut {name} does not apply", flush=True)
            continue
        for old, new, _ in edits:
            text = text.replace(old, new)
        dest = out / (prefix + name)
        shutil.rmtree(dest, ignore_errors=True)
        shutil.copytree(root / "ryujin_tpu_torch", dest / "ryujin_tpu_torch",
                        ignore=shutil.ignore_patterns("_build", "_cache",
                                                      "__pycache__"))
        (dest / "ryujin_tpu_torch" / "csrc" / "ell_step.cu").write_text(
            src[:a] + text + src[b:])
        print(f"  {dest}: cut {name}", flush=True)


def ell_launches(res, dev):
    """The ELL gather-sum at the script's input over ELL_CANDIDATES (the
    launches whose ring holds every block's band) and at the default
    launch, beside X[:, cols].sum(1), in CUDA graphs of probes.CHAIN
    calls, into res["ms"]."""
    import itertools

    from . import probes
    from .kernels import probe_gather as kg
    from .probes.gather import ell_inputs

    X, cols = (torch.from_numpy(a).to(dev) for a in ell_inputs(1 << 20, 9, 12))
    K, n = cols.shape
    want, cols64 = kg.ell_gather_sum_reference(X, cols), cols.long()
    default = kg.ell_gather_sum(X, cols)
    shapes = {kg.ell_shape(n, K): "default"}
    for values in itertools.product(*ELL_CANDIDATES.values()):
        try:
            shapes.setdefault(kg.ell_shape(
                n, K, True, **dict(zip(ELL_CANDIDATES, values))), "")
        except ValueError:  # the ring cannot hold a block's own nodes
            continue
    for shape, tag in shapes.items():
        mirror = kg.ell_staged_blocks(cols, shape)
        if mirror < shape.blocks:
            print(f"  ell {tuple(shape)}: {mirror} of {shape.blocks} blocks "
                  "stage, not timed", flush=True)
            continue
        staged = torch.zeros(1, dtype=torch.int32, device=dev)
        got = kg.ell_gather_sum(X, cols, shape, staged)
        ok = (torch.equal(got, want) and torch.equal(got, default)
              and int(staged) == mirror)
        del got
        fn = lambda: kg.ell_gather_sum(X, cols, shape)  # noqa: E731
        fn()
        key = (f"ell {tuple(shape)}{' ' + tag if tag else ''}"
               f"{'' if ok else ' WRONG'}")
        res["ms"][key] = probes.graph_ms(fn, probes.CHAIN)
        print(f"  {key}: {res['ms'][key]:.5f} ms", flush=True)
    lib = lambda: X[:, cols64].sum(1)  # noqa: E731
    lib()
    res["ms"]["ell X[:, cols].sum(1)"] = probes.graph_ms(lib, probes.CHAIN)
    print(f"  ell X[:, cols].sum(1): {res['ms']['ell X[:, cols].sum(1)']:.5f}"
          " ms", flush=True)


def moveaxis_launches(res, dev):
    """moveaxis, both MOV, at the script's sizes over
    LAYOUT_CANDIDATES["full"] and at the default launch, each held
    exactly, in CUDA graphs of probes.CHAIN calls, into res["ms"]."""
    import itertools

    from . import probes
    from .kernels import probe_layout3d as kl
    from .probes import layout3d

    la = layout3d.parser().parse_args([])
    P, D, H, W, TD = la.P, la.D, la.H, la.W, la.TD
    h = torch.from_numpy(np.random.default_rng(0).random(
        (D, P, H, W), dtype=np.float32)).to(dev)
    cand = LAYOUT_CANDIDATES["full"]
    shapes = {kl.layout_shape("moveaxis", P, D, H * W, TD): "default"}
    for values in itertools.product(*cand.values()):
        try:
            shapes.setdefault(kl.layout_shape(
                "moveaxis", P, D, H * W, TD, **dict(zip(cand, values))), "")
        except ValueError:  # does not fit the shared memory
            continue
    for mov in (1, 0):
        want = kl.moveaxis_reference(h, TD, mov)
        for shape, tag in shapes.items():
            fn = functools.partial(kl.moveaxis, h, TD, mov, shape)
            ok = all(torch.equal(a, b) for a, b in zip(fn(), want))
            key = (f"moveaxis MOV={mov} {tuple(shape)}"
                   f"{' ' + tag if tag else ''}{'' if ok else ' WRONG'}")
            res["ms"][key] = probes.graph_ms(fn, probes.CHAIN)
            print(f"  {key}: {res['ms'][key]:.5f} ms", flush=True)


def pk1_shape_launches(res, dev):
    """pk1_shape at the script's sizes over LAYOUT_CANDIDATES["pk1_shape"]
    and at the default launch, out and check each held exactly against the
    plain version, in CUDA graphs of probes.CHAIN calls, into
    res["ms"]."""
    import itertools

    from . import probes
    from .kernels import probe_layout3d as kl
    from .probes import layout3d

    la = layout3d.parser().parse_args([])
    D, HW, TD = la.D, la.H * la.W, la.TD
    rng = np.random.default_rng(0)
    cen = torch.from_numpy(rng.random((D, la.CENPL, la.H, la.W),
                                      dtype=np.float32)).to(dev)
    wins = [torch.from_numpy(rng.random((D, p, la.H, la.W),
                                        dtype=np.float32)).to(dev)
            for p in layout3d.WINDOW_PLANES[: la.NWIN]]
    planes = layout3d.WINDOW_PLANES[: la.NWIN]
    want = kl.pk1_shape_reference(cen, wins, TD, la.OUTPL)
    cand = LAYOUT_CANDIDATES["pk1_shape"]
    shapes = {kl.pk1_shape_shape(la.CENPL, planes, D, HW, TD): "default"}
    for values in itertools.product(*cand.values()):
        try:
            shapes.setdefault(kl.pk1_shape_shape(
                la.CENPL, planes, D, HW, TD, **dict(zip(cand, values))), "")
        except ValueError:  # does not fit the shared memory or the threads
            continue
    for shape, tag in shapes.items():
        fn = functools.partial(kl.pk1_shape, cen, wins, TD, la.OUTPL, shape)
        ok = all(torch.equal(a, b) for a, b in zip(fn(), want))
        key = (f"pk1_shape {tuple(shape)}{' ' + tag if tag else ''}"
               f"{'' if ok else ' WRONG'}")
        res["ms"][key] = probes.graph_ms(fn, probes.CHAIN)
        print(f"  {key}: {res['ms'][key]:.5f} ms", flush=True)


def pow_launches(res, dev, argv=()):
    """Every PowForm pointwise and summed at rows 11 and 12's sizes
    (row 12: one launch of its chain, on x + 1e-9 x) over
    POW_CANDIDATES, each held against the plain version at its bar
    and against the default launch bit for bit, beside the PyTorch
    calls, in CUDA graphs of probes.CHAIN calls, into res["ms"]; argv:
    probes.pow's options, for other sizes."""
    import itertools

    from . import probes
    from .kernels import probe_pow as kpow
    from .probes import held
    from .probes import pow as ppow

    pa = ppow.parser().parse_args(list(argv))
    _, _, (x11, s11, x12, s12) = ppow.cases(pa, None, 0, dev)
    rows = {"row11": (x11, pa.b, s11, None),
            "row12": (x12, pa.G, s12, x12)}

    def gm(key, fn):
        fn()
        res["ms"][key] = probes.graph_ms(fn, probes.CHAIN)
        print(f"  {key}: {res['ms'][key]:.5f} ms", flush=True)

    for (row, (x, b, sh, carry)), form, summed in itertools.product(
            rows.items(), kpow.FORMS, (False, True)):
        shifts = sh if summed else None
        cy = carry if summed else None
        plain = kpow.probe_pow_reference(x, form, b, shifts, cy)
        bar = ("exact" if form not in ppow.LIBM
               else "rel 1e-6" if summed else "4 ulp")
        want = kpow.probe_pow(x, form, b, shifts, cy)
        cand = POW_CANDIDATES[summed]
        shapes = {kpow.pow_shape(x.numel(), summed, form=form): "default"}
        if not summed:
            shapes.setdefault(kpow.pow_shape(x.numel(), False, vec=1),
                              "scalar")
        for values in itertools.product(*cand.values()):
            shapes.setdefault(kpow.pow_shape(
                x.numel(), summed, True, *values), "")
        kind = "summed" if summed else "pointwise"
        for shape, tag in shapes.items():
            got = kpow.probe_pow(x, form, b, shifts, cy, shape)
            ok = held(bar, got, plain)[2] and torch.equal(got, want)
            gm(f"pow {row} {form} {kind} {tuple(shape)}"
               f"{' ' + tag if tag else ''}{'' if ok else ' WRONG'}",
               lambda: kpow.probe_pow(x, form, b, shifts, cy, shape))
        library = ppow.library_call(
            form, x if shifts is None else
            torch.stack([x + s for s in shifts.tolist()]), b, summed)
        if library is not None:  # row 12's: the stack of x, no carry
            gm(f"pow {row} {form} {kind} torch", library)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("cases", nargs="*",
                    default=["step2d", "q2step2d", "box3d", "cylinder3d",
                             "gather", "layouts", "pow", "ell", "moveaxis",
                             "pk1-shape"])
    ap.add_argument("--tree", action="append", default=[],
                    metavar="NAME=ROOT")
    ap.add_argument("--blocks", action="append", default=[],
                    metavar="PK1=8,PK4=10",
                    help="ell-cuts: also a copy with these launch bounds")
    args = ap.parse_args(argv)
    if args.cases == ["ell-cuts"]:  # no card needed
        from .kernels import build

        here = build.PACKAGE.parent
        make_ell_cuts(here, here / "_checkout", blocks=args.blocks)
        for tree in args.tree:
            name, root = tree.split("=", 1)
            make_ell_cuts(Path(root), here / "_checkout", name + "-")
        return 0
    if not torch.cuda.is_available():
        print("tile_sweep: no CUDA device", flush=True)
        return 1
    import chip_smoke as cs

    from . import bench, kernel_times
    from .kernels import build, pk1, pk1_stream, pk2
    from .solver.hyperbolic import (
        HyperbolicModule, d_from_e, d_from_lambda, tau_max_from_d,
    )
    from .solver.integrator import TimeIntegrator

    here = build.PACKAGE.parent
    trees = {"this": here, **{t.split("=", 1)[0]: Path(t.split("=", 1)[1])
                              for t in args.tree}}
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(
        [sys.executable, "-c",
         "import ryujin_tpu_torch.kernels.build as b; print(b.build())"],
        cwd=str(root), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for name, root in trees.items()}
    libs, res = {}, {"card": cs.smi_line(), "ms": {}, "equal": {},
                     "resources": {}}
    for name, proc in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            print(f"tile_sweep: the build of {name} failed\n{out}", flush=True)
            return 1
        so = Path(out.strip().splitlines()[-1])
        res["resources"][name] = {
            k: v for k, v in kernel_times.resources(
                so.with_suffix(".so.log").read_text(),
                kernel_times.launch_shape).items()
            if k.startswith(("pk1_stream", "pk1<", "pk2<", "ell_"))}
        build._LIB = None
        build.CSRC = trees[name] / "ryujin_tpu_torch" / "csrc"
        build.BUILD_DIR = trees[name] / "ryujin_tpu_torch" / "_build"
        libs[name] = build.library()
    build.CSRC = here / "ryujin_tpu_torch" / "csrc"
    build.BUILD_DIR = here / "ryujin_tpu_torch" / "_build"
    print(f"built {list(libs)} in {time.perf_counter() - t0:.1f} s on "
          f"{res['card']}", flush=True)
    others = [k for k in libs if k != "this"]
    turns = ["this"] + others + ["this"] + others[::-1]

    def use(name):
        build._LIB = libs[name]

    def tm(key, fn):
        fn()
        res["ms"][key] = cs.time_ms(fn, cs.REPS)
        print(f"  {key}: {res['ms'][key]:.4f} ms", flush=True)

    def compare(key, fn, mod, tiles):
        """Bit-equality of the other trees' outputs with this tree's, the
        turns, then this tree's kernel at each tile of `tiles`."""
        use("this")
        want = fn()
        for other in others:
            use(other)
            res["equal"][f"{key} {other}"] = all(
                torch.equal(a, b) for a, b in zip(want, fn()))
            print(f"  {key} {other} == this bit for bit: "
                  f"{res['equal'][f'{key} {other}']}", flush=True)
        for turn, tree in enumerate(turns):
            use(tree)
            tm(f"{key} {tree} {turn}", fn)
        use("this")
        default = mod.tile
        for ty, tz in tiles:
            def tile(shape, K, dtype, *stages, _t=(ty, tz)):
                t = default(shape, K, dtype, *stages)
                D, H, W = build.canvas_dims(shape)
                per = t.smem // (t.block[1] + 2 * t.halo) // (
                    t.block[2] + 2 * t.halo if len(shape) == 3 else 1)
                return build.Tile(
                    (t.block[0], _t[0], _t[1]), t.halo,
                    per * (_t[0] + 2 * t.halo) * (
                        _t[1] + 2 * t.halo if len(shape) == 3 else 1),
                    (t.grid[0], -(-H // _t[0]),
                     -(-D // _t[1]) if len(shape) == 3 else 1))
            mod.tile = tile
            try:
                same = all(torch.equal(a, b) for a, b in zip(want, fn()))
                tm(f"{key} this tile {(ty, tz)}{'' if same else ' WRONG'}",
                   fn)
            finally:
                mod.tile = default

    def inputs(hm, U_a, U_b, stream):
        """compare_kernels' inputs of the third substep: U, prec, the
        fixed-up wavespeeds, alpha, the stage states and tau."""
        eq, p, ca = hm.eq, hm.params, hm.canvas.arrays
        st = ca.stencil
        U, prec = hm.prepare_state_vector(U_b, 0.0)
        if stream:
            lam, alpha = pk1_stream.pk1_stream(eq, p, ca, U, prec,
                                               half=hm.half)
        else:
            lam, alpha = pk1.pk1(eq, p, ca, U, prec)
        full = st.full()
        if stream and not hm.half:
            d = d_from_e(full.mask, lam, full.transpose_edge(lam))
        else:
            lam = hm._lambda_fixup(lam, U, prescaled=stream)
            d = d_from_lambda(full, lam, None if stream else full.cmax)
        tau = tau_max_from_d(st, d, 0.9, torch.full(
            (), float("inf"), dtype=U.dtype, device=U.device))
        return U, prec, lam, alpha, torch.stack([U_a, U]), tau

    def pk1_cases(case, sd, hm, U_a, U_b):
        """pk1_stream with the full statics and, in 3D, the separable
        ones (no tile: one thread a cell)."""
        eq, p, dim = hm.eq, hm.params, len(sd.shape)
        for sep in (False, True) if dim == 3 else (False,):
            h = hm if not sep else HyperbolicModule(
                eq, sd, hm.initial_state_fn, dtype=torch.float32,
                device=dev, separable=True)
            U, prec = inputs(h, U_a, U_b, True)[:2]
            compare(f"{case}{' SEP' if sep else ''} pk1_stream",
                    lambda: pk1_stream.pk1_stream(
                        eq, p, h.canvas.arrays, U, prec, half=h.half),
                    pk1_stream, [] if sep else TILES[dim])

    def gather_groups():
        """The sublane gather at each group count of GROUPS and the lane
        gather at each launch of LANE_CANDIDATES (P = 8, W = 2048, and W =
        2047: 4-byte pieces), each held exactly, and torch.gather, in CUDA
        graphs of probes.CHAIN calls."""
        import itertools

        from . import probes
        from .kernels import probe_gather as pg
        from .probes.gather import lane_inputs, sublane_inputs

        def gm(key, fn):
            fn()
            res["ms"][key] = probes.graph_ms(fn, probes.CHAIN)
            print(f"  {key}: {res['ms'][key]:.4f} ms", flush=True)

        x, idx = (torch.from_numpy(a).to(dev) for a in sublane_inputs(1024, 128))
        want, idx64 = pg.sublane_gather_reference(x, idx), idx.long()
        default = pg.sublane_shape
        for groups in GROUPS:
            pg.sublane_shape = lambda S, L, _g=groups: default(S, L, _g)
            try:
                same = torch.equal(pg.sublane_gather(x, idx), want)
                gm(f"gather sublane groups {groups}{'' if same else ' WRONG'}",
                   lambda: pg.sublane_gather(x, idx))
            finally:
                pg.sublane_shape = default
        gm("gather torch.gather", lambda: torch.gather(x, 0, idx64))
        for W in (2048, 2047):
            x, idx = (torch.from_numpy(a).to(dev) for a in lane_inputs(8, W))
            want, idx64 = pg.lane_gather_reference(x, idx), idx.long()
            shapes = {pg.lane_shape(8, W): "default"}
            for values in itertools.product(*LANE_CANDIDATES.values()):
                shapes.setdefault(pg.lane_shape(
                    8, W, **dict(zip(LANE_CANDIDATES, values))), "")
            for shape, tag in shapes.items():
                same = torch.equal(pg.lane_gather(x, idx, shape), want)
                gm(f"gather lane W={W} {tuple(shape)}"
                   f"{' ' + tag if tag else ''}{'' if same else ' WRONG'}",
                   functools.partial(pg.lane_gather, x, idx, shape))
            gm(f"gather lane W={W} torch.gather",
               lambda: torch.gather(x, 1, idx64))

    def layout_launches():
        """The three layouts over LAYOUT_CANDIDATES and at the default
        launch, and their PyTorch calls, in CUDA graphs of probes.CHAIN
        calls."""
        import itertools

        from . import probes
        from .kernels import probe_layout3d as kl
        from .probes import layout3d

        la = layout3d.parser().parse_args([])
        P, D, HW, TD = la.P, la.D, la.H * la.W, la.TD
        hz, hp = layout3d.layout_inputs(la, dev)
        library = layout3d.layout_calls(hz, hp, TD)

        def gm(key, fn):
            fn()
            res["ms"][key] = probes.graph_ms(fn, probes.CHAIN)
            print(f"  {key}: {res['ms'][key]:.4f} ms", flush=True)

        for layout, h in (("plane-major", hp), ("z-major", hz),
                          ("z-major-slide", hz)):
            want = kl.window_sum_reference(h, layout, TD)
            cand = LAYOUT_CANDIDATES[
                "slide" if layout == "z-major-slide" else "full"]
            shapes = {kl.layout_shape(layout, P, D, HW, TD): "default"}
            for values in itertools.product(*cand.values()):
                try:
                    shape = kl.layout_shape(layout, P, D, HW, TD,
                                            **dict(zip(cand, values)))
                except ValueError:  # does not fit the shared memory
                    continue
                shapes.setdefault(shape, "")
            for shape, tag in shapes.items():
                same = torch.equal(kl.window_sum(h, layout, TD, shape), want)
                gm(f"layouts {layout} {tuple(shape)}{' ' + tag if tag else ''}"
                   f"{'' if same else ' WRONG'}",
                   lambda: kl.window_sum(h, layout, TD, shape))
            gm(f"layouts {layout} torch", library[layout])

    def turns_of(case, turn, args=""):
        """`turn` (pow_turn, gather_turn, moveaxis_turn, ...) called with
        `args` (source text) in each checkout's own process, in turns: the
        others, this, this, the others reversed (P C C P with one other);
        each entry's digest against this checkout's."""
        src = (inspect.getsource(turn) + "\nimport json\n"
               f"print('TURN', json.dumps({turn.__name__}({args})))")
        digests = {}
        for n, tree in enumerate(others + ["this", "this"] + others[::-1]):
            root = str(trees[tree])
            proc = subprocess.run(
                [sys.executable, "-c", src], cwd=root, capture_output=True,
                text=True, env={**os.environ, "PYTHONPATH": root})
            line = [ln for ln in proc.stdout.splitlines()
                    if ln.startswith("TURN ")]
            if proc.returncode or not line:
                raise RuntimeError(f"{case} turn of {tree} failed:\n"
                                   f"{proc.stdout}\n{proc.stderr}")
            got = json.loads(line[0].split(" ", 1)[1])
            digests.setdefault(tree, got["digest"])
            for entry, ms in got["ms"].items():
                res["ms"][f"{case} {entry} {tree} {n}"] = ms
                print(f"  {case} {entry} {tree} {n}: {ms:.5f} ms", flush=True)
        for tree in others:
            for entry, d in digests["this"].items():
                same = digests[tree].get(entry) == d
                res["equal"][f"{case} {entry} {tree}"] = same
                print(f"  {case} {entry}: {tree} {digests[tree].get(entry)}"
                      f" this {d} {'equal' if same else 'DIFFER'}", flush=True)

    dev = torch.device("cuda")
    use("this")
    for case in args.cases:
        print(f"{case}:", flush=True)
        turn = {"pow-turns": pow_turn, "gather-turns": gather_turn,
                "moveaxis-turns": moveaxis_turn,
                "pk1-shape-turns": pk1_shape_turn,
                "ell-step-turns": ell_step_turn}.get(case)
        if turn is ell_step_turn:
            import tempfile

            with tempfile.TemporaryDirectory() as tmp:
                path = str(Path(tmp) / "inputs.pt")
                torch.save(ell_step_inputs(dev), path)
                torch.cuda.empty_cache()
                turns_of(case, turn, repr(path))
            continue
        if turn is not None:
            turns_of(case, turn)
            continue
        if case in ("pow", "ell", "moveaxis", "pk1-shape", "ell-step"):
            {"pow": pow_launches, "ell": ell_launches,
             "moveaxis": moveaxis_launches,
             "pk1-shape": pk1_shape_launches,
             "ell-step": ell_step_launches}[case](res, dev)
            continue
        if case == "gather":
            gather_groups()
            continue
        if case == "layouts":
            layout_launches()
            continue
        if case == "step2d":
            eq, sd, hm, _, U0 = bench.build_step2d(cs.REFINEMENT,
                                                   torch.float32, dev)
            plain = TimeIntegrator(cs.PlainSteps(hm), "erk 33",
                                   cfl_min=0.45, cfl_max=0.9,
                                   cfl_recovery_strategy="none")
            U_a, _, t_a, _, _, _ = plain.advance(U0, 0.0, cs.PLAIN_STEPS)
            U_b = plain.advance(U_a, t_a, 1)[0]
            U, prec, lam, alpha, stage_U, tau = inputs(hm, U_a, U_b, False)
            compare("step2d pk1",
                    lambda: pk1.pk1(eq, hm.params, hm.canvas.arrays, U, prec),
                    pk1, TILES[2])
            res["equal"]["step2d pk1 == pk1_stream"] = cs.pk1_against_stream(
                hm, U_b)
            for w in ([0.75, -2.0], [0.25], []):
                sU = stage_U[: len(w)]
                compare(f"step2d pk2 S={len(w)}",
                        lambda: pk2.pk2(eq, hm.params, hm.canvas.arrays, U,
                                        prec, lam, alpha, sU, w, tau),
                        pk2, TILES[2])
            # pk1_stream on the same K = 8 canvas, as phase 2a
            pk1_cases("step2d K=8", sd, hm, U_a, U_b)
            continue
        build_case = getattr(bench, "build_" + case)
        refinement = {"q2step2d": cs.Q2_REFINEMENT,
                      "box3d": cs.BOX_REFINEMENT,
                      "cylinder3d": cs.CYL_REFINEMENT}[case]
        eq, sd, hm, ti, U0 = build_case(refinement, torch.float32, dev)
        if case == "box3d":
            U0 = cs.bumped(sd, U0, blast=True)
        steps = {"q2step2d": cs.Q2_DEVELOP_STEPS,
                 "box3d": cs.BOX_DEVELOP_STEPS,
                 "cylinder3d": cs.CYL_DEVELOP_STEPS}[case]
        U_a, _, t_a, _, _, _ = ti.advance(U0, 0.0, steps)
        U_b = ti.advance(U_a, t_a, 1)[0]
        pk1_cases(case, sd, hm, U_a, U_b)
        del hm, ti, U_a, U_b, U0
        torch.cuda.empty_cache()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
