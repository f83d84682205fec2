"""Time the stacked pk1 and pk2 and pk1_stream over their tiles, and
other checkouts' builds of them on the same inputs; the sublane gather
probe over its row groups; and the layout probe's kernels over their
launches.

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
a CUDA graph of probes.CHAIN calls: probes.graph_ms; this checkout
only), or layouts (the three layouts of probes/layout3d.py at the
script's sizes over the launches of LAYOUT_CANDIDATES, and at the
default launch, each held exactly against the plain version and timed
the same way beside its PyTorch call; this checkout only); without one,
all six.  For each launch it
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
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

# candidate tiles (TY, TZ); TZ is 1 in 2D
TILES = {2: [(1, 1), (2, 1), (4, 1), (8, 1)],
         3: [(2, 2), (4, 2), (2, 4), (8, 1), (4, 1), (1, 8)]}
# candidate row groups of the sublane gather (its blocks: 4 tiles each)
GROUPS = (1, 2, 4, 8, 16, 32)
# candidate launches of the layout kernels (kernels/probe_layout3d.py
# layout_shape): tile widths, stages and z segments, for the full-window
# kernels and the slide
LAYOUT_CANDIDATES = {
    "full": {"tile": (64, 128), "stages": (2, 3, 4),
             "segments": (1, 2, 3, 4, 6, 8, 12, 17)},
    "slide": {"tile": (64, 128), "stages": (2, 3, 4, 6),
              "segments": (1, 2, 3, 4, 6, 8, 12, 17)},
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("cases", nargs="*",
                    default=["step2d", "q2step2d", "box3d", "cylinder3d",
                             "gather", "layouts"])
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
        """The sublane gather at each group count of GROUPS and
        torch.gather, in CUDA graphs of probes.CHAIN calls."""
        from . import probes
        from .kernels import probe_gather as pg
        from .probes.gather import sublane_inputs

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

    dev = torch.device("cuda")
    use("this")
    for case in args.cases:
        print(f"{case}:", flush=True)
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
