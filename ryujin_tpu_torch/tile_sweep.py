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
in turns as pow-turns; without one, all but the turns.  For
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
    args = ap.parse_args(argv)
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
            if k.startswith(("pk1_stream", "pk1<", "pk2<"))}
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

    def turns_of(case, turn):
        """`turn` (pow_turn, gather_turn, moveaxis_turn) in each
        checkout's own process, in turns: the others, this, this, the
        others reversed (P C C P with one other); each entry's digest
        against this checkout's."""
        src = (inspect.getsource(turn)
               + f"\nimport json\nprint('TURN', json.dumps({turn.__name__}()))")
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
                "pk1-shape-turns": pk1_shape_turn}.get(case)
        if turn is not None:
            turns_of(case, turn)
            continue
        if case in ("pow", "ell", "moveaxis", "pk1-shape"):
            {"pow": pow_launches, "ell": ell_launches,
             "moveaxis": moveaxis_launches,
             "pk1-shape": pk1_shape_launches}[case](res, dev)
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
