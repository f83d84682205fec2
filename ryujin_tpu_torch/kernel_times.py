"""Kernel times on the bench shapes, to compare two trees on one card.

    python -m ryujin_tpu_torch.kernel_times [CASE ...]   # from a checkout's root

Builds this checkout's kernels, develops the states of chip_smoke.py
phases 2, 4, 6, 8 and 10 and times every kernel there with
chip_smoke.compare_kernels (CUDA events, mean of 20 launches).  CASE is
step2d (refinement 3 after 40 plain ERK33 steps; the stream kernels also
on its K = 8 canvas, as phase 2a does), q2step2d (refinement 2 after 150
ERK33 steps through the kernels), box3d (refinement 2, 150 steps through
the kernels from a blast), dg1box3d (box3d's flow with dG Q1 at
refinement 1, 150 steps from a blast) or cylinder3d (refinement 3, 300
steps from the inflow; the kernels with the full statics, then the SEP
instances on the same state) or ell (the step at refinement 3 packed by
ell.pack, 200 ERK33 steps through the ELL kernels, as chip_smoke.py
phases 14a and 14d develop it; ell_pk1 .. ell_pk_up timed with
chip_smoke.compare_ell, no digests); without one, step2d and q2step2d.
Prints
one JSON line {"card", "ms": {kernel: ms}, "resources": {instance:
{regs, stack, threads, smem, warps}}, "digests": {kernel: {"in", "out"}}}:
the registers and stack bytes of every pk1_stream (pk1_stream_tile),
pk2_stream (pk2_stream_tile), pk3_stream, pk_up and stacked pk1, pk2 and
pk3 instance (and of every ELL kernel instance) from nvcc's -Xptxas -v
report of the build, the block and the
shared bytes of its launch (at two stages), and the warps an
SM holds at once by the occupancy rules of the H100 (65,536 registers in
256-register steps a warp, 228 KB of shared memory less 1 KB a block, 64
warps, 32 blocks); and, for each kernel launch that compare_kernels
checks, a digest of the bytes of the tensors it was given and of those
it returned, taken on its first call (the checked one, before the
timing), keyed "CASE: " and the kernel's prefix in "ms" before the
wrapper's name ("pk_up last" for PK5).  Two
trees whose kernels compute the same bits print the same digests.

To compare two trees, run it from the root of each in turns (A, B, B, A)
on one card.  It uses only chip_smoke.compare_kernels,
chip_smoke.PlainSteps, the bench builders, HyperbolicModule,
TimeIntegrator and the kernel wrappers of kernels/, so an older checkout
that has them (the cylinder3d slice onward) runs it once this file is
copied into its ryujin_tpu_torch/; a kernel without a tile() beside its
wrapper is taken to launch 128 threads a block without shared memory.
"""

from __future__ import annotations

import contextlib
import functools
import hashlib
import importlib
import json
import re
import sys

import torch

# one pk2_stream, pk3_stream, pk_up, stacked pk2 or pk3 or pk1_stream
# instance in nvcc's mangled name
_STREAM = re.compile(
    r"_ZN6ryujin\d+(pk2_stream|pk3_stream)_kernelI([fd])Li(\d)ELb(\d)ELb(\d)E"
    r"NS_\d+(Full|Sep)Statics"
)
_UP = re.compile(
    r"_ZN6ryujin\d+(pk_up|pk_up_tile|pk_up_last)_kernelI([fd])Li(\d)ELi(\d+)E"
    r"NS_\d+(Full|Sep)Statics"
)
# the stacked kernels: pk2 and pk3 with their dG flag, pk1 without one
_STACKED = re.compile(
    r"_ZN6ryujin\d+(pk1|pk2|pk3)_kernelI([fd])(?:Lb(\d)E)?(?:Li\dE)?E")
_TILE = re.compile(
    r"_ZN6ryujin\d+(pk2_stream_tile)_kernelI([fd])Li(\d)ELb(\d)ELb(\d)E"
    r"(?:Li\dE)?EEv")
# the most stage slots of an instance of pk2, pk3, pk2_stream or
# pk3_stream, its last template argument (none in a tree built before it)
_SLOTS = re.compile(r"Li(\d)EEEvPK")
# the ELL kernels (csrc/ell_step.cu): type and DIM, for ell_pk2 and ell_pk3
# also the dG flag and the most stage slots
_ELL = re.compile(
    r"_ZN6ryujin\d+(ell_pk1|ell_pk2|ell_pk3|ell_pk_up)_kernelI([fd])Li(\d)E"
    r"(?:Lb(\d)ELi(\d)E)?")
# pk1_stream has no dG flag; its staged tile (full statics only) no
# statics accessor
_PK1 = re.compile(
    r"_ZN6ryujin\d+(pk1_stream|pk1_stream_tile)_kernelI([fd])Li(\d)ELb(\d)E"
    r"(?:NS_\d+(Full|Sep)Statics)?")
# the kernel wrappers whose calls get digests, each kernels/<name>.py's
# function <name>
WRAPPERS = ("pk1", "pk2", "pk3", "pk1_stream", "pk2_stream", "pk3_stream",
            "pk_up")


def _label(name):
    """(label, kernel, dim, dtype) of an instance's mangled name, or None
    for a kernel this report leaves out."""
    m = _STREAM.match(name) or _TILE.match(name)
    if m:
        kern, t, dim, half, dg, st = (m.groups() + ("Full",))[:6]
        label = (f"{kern}<{'f32' if t == 'f' else 'f64'}, {dim}D, "
                 f"{'half-slot' if half == '1' else 'two-direction'}, "
                 f"{'dG' if dg == '1' else 'cG'}, {st}>")
    elif _UP.match(name):
        kern, t, dim, k, st = _UP.match(name).groups()
        label = f"{kern}<{'f32' if t == 'f' else 'f64'}, {dim}D, K={k}, {st}>"
    elif _PK1.match(name):
        kern, t, dim, half, st = _PK1.match(name).groups()
        st = st or "Full"
        label = (f"{kern}<{'f32' if t == 'f' else 'f64'}, {dim}D, "
                 f"{'half-slot' if half == '1' else 'two-direction'}, {st}>")
    elif _ELL.match(name):
        kern, t, dim, dg, ms = _ELL.match(name).groups()
        label = (f"{kern}<{'f32' if t == 'f' else 'f64'}, {dim}D"
                 + ("" if dg is None else
                    f", {'dG' if dg == '1' else 'cG'}, S<={ms}") + ">")
        return (label, kern, int(dim),
                torch.float32 if t == "f" else torch.float64,
                int(ms) if ms else 2)
    elif _STACKED.match(name):
        kern, t, dg = _STACKED.match(name).groups()
        dim = "2"
        label = (f"{kern}<{'f32' if t == 'f' else 'f64'}"
                 f"{'' if dg is None else ', dG' if dg == '1' else ', cG'}>")
    else:
        return None
    slots = _SLOTS.search(name) if kern in STAGED else None
    if slots and slots.group(1) != "2":
        # the instances of ERK54's 3 and 4 slots: the two-slot ones keep
        # their labels, so that an older tree's line up with them
        label = label[:-1] + f", S<={slots.group(1)}>"
    stages = int(slots.group(1)) if slots else 2
    return (label, kern, int(dim), torch.float32 if t == "f" else torch.float64,
            stages)


# the kernels whose instances take their most stage slots as a template
# argument
STAGED = ("pk2", "pk3", "pk2_stream", "pk2_stream_tile", "pk3_stream")


def resources(log: str, tiles):
    """{instance: {regs, stack, threads, smem, warps}} of every pk1_stream
    (pk1_stream, pk1_stream_tile), pk2_stream (pk2_stream,
    pk2_stream_tile), pk3_stream, pk_up (pk_up, pk_up_tile, pk_up_last)
    and stacked pk1, pk2 and pk3 instance in a -Xptxas -v report;
    tiles(kernel, dim, dtype[, stages]) gives the instance's (threads a
    block, shared bytes), at two stage slots without `stages`, else at
    the most stage slots the instance takes."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame", line)
        if m and name:
            stack = int(m.group(1))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if not (m and name):
            continue
        inst = _label(name)
        name, regs = None, int(m.group(1))
        if not inst:
            continue
        label, kern, dim, dtype, stages = inst
        # the two-slot instances' launch is tiles()'s default
        threads, smem = (tiles(kern, dim, dtype) if stages == 2
                         else tiles(kern, dim, dtype, stages))
        out[label] = {"regs": regs, "stack": stack, "threads": threads,
                      "smem": smem, "warps": resident_warps(regs, threads,
                                                            smem)}
    return out


def digest(value) -> str:
    """A digest of the bytes of every tensor in `value` (nested tuples,
    lists and dicts; floats, ints, bools and None by their repr; other
    objects, such as the module's canvas, left out)."""
    h = hashlib.blake2b(digest_size=8)

    def feed(v):
        if isinstance(v, torch.Tensor):
            h.update(f"{v.dtype}{tuple(v.shape)}".encode())
            h.update(v.detach().contiguous().cpu().numpy().tobytes())
        elif isinstance(v, (tuple, list)):
            for x in v:
                feed(x)
        elif isinstance(v, dict):
            for k in sorted(v):
                h.update(str(k).encode())
                feed(v[k])
        elif v is None or isinstance(v, (bool, int, float)):
            h.update(repr(v).encode())

    feed(value)
    return h.hexdigest()


@contextlib.contextmanager
def digests(out, prefix=""):
    """Within the block every kernel wrapper of WRAPPERS records into
    `out`, on its first call under a key (prefix + its name, " last" for
    pk_up's PK5), the digests of its arguments and of its result."""
    saved = []
    for name in WRAPPERS:
        mod = importlib.import_module(f"{__package__}.kernels.{name}")
        fn = getattr(mod, name)

        def recorded(*args, _fn=fn, _name=name, **kw):
            res = _fn(*args, **kw)
            key = prefix + _name + (" last" if _name == "pk_up" and args[-1]
                                    else "")
            if key not in out:
                out[key] = {"in": digest((args, kw)), "out": digest(res)}
            return res

        # the wrapper counts its launches on the module's name, now this one
        setattr(mod, name, functools.update_wrapper(recorded, fn))
        saved.append((mod, name, fn))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def resident_warps(regs: int, threads: int, smem: int) -> int:
    """Warps an H100 SM holds at once for blocks of `threads` with `regs`
    registers a thread and `smem` shared bytes a block."""
    warps = -(-threads // 32)
    per_warp = -(-regs * 32 // 256) * 256
    blocks = min(65536 // (per_warp * warps), 64 // warps, 32)
    if smem:
        blocks = min(blocks, (228 * 1024) // (smem + 1024))
    return blocks * warps


def launch_shape(kern, dim, dtype, stages=2):
    """(threads a block, shared bytes) of kernel `kern`'s launch at
    `stages` stage slots (two on the main path): K = 24 in 2D (the
    stacked pk1, pk2 and pk3: 8), 26 in 3D; ell_pk2 and ell_pk3 from
    ell_step_shape() at K = 2 in 1D, 8 in 2D, 26 in 3D; a kernel without
    a tile() beside its wrapper launches 128 threads a block without
    shared memory."""
    from .kernels import pk1 as k1
    from .kernels import pk1_stream as k1s
    from .kernels import pk2 as k2
    from .kernels import pk2_stream as k2s
    from .kernels import pk3 as k3
    from .kernels import pk3_stream as k3s
    from .kernels import pk_up as ku

    from .kernels import ell

    if kern in ("ell_pk2", "ell_pk3") and hasattr(ell, "ell_step_shape"):
        sh = ell.ell_step_shape(kern, dim, {1: 2, 2: 8, 3: 26}[dim], dtype,
                                stages, 1)
        return sh.threads, sh.smem
    K = 8 if kern in ("pk1", "pk2", "pk3") else (24 if dim == 2 else 26)
    shape = (64, 64) if dim == 2 else (8, 64, 64)
    mod = {"pk2": k2, "pk2_stream_tile": k2s, "pk3": k3,
           "pk3_stream": k3s}.get(kern)
    if mod is not None and hasattr(mod, "tile"):
        t = mod.tile(shape, K, dtype, stages)
    elif kern in ("pk_up_tile", "pk1_stream_tile") or (
            kern == "pk1" and hasattr(k1, "tile")):
        t = {"pk_up_tile": ku, "pk1_stream_tile": k1s, "pk1": k1}[kern].tile(
            shape, K, dtype)
    else:  # one thread a cell: the older trees, pk_up and pk_up_last
        return 128, 0
    return t.block[0] * t.block[1] * t.block[2], t.smem


def main():
    if not torch.cuda.is_available():
        sys.exit("ryujin_tpu_torch.kernel_times needs a CUDA device")
    import chip_smoke as cs

    from .bench import build_ell, build_q2step2d, build_step2d
    from .kernels import build
    from .offline import geometry
    from .solver.hyperbolic import HyperbolicModule
    from .solver.integrator import TimeIntegrator

    so = build.build()
    build.library()
    dev = torch.device("cuda")
    ms, digested = {}, {}

    def timed(case, hm, U_a, U_b, prefix="", stream=None):
        records = {}
        with digests(digested, f"{case}: {prefix}"):
            if not cs.compare_kernels(hm, U_a, U_b, cs.TOL_F32, cs.REPS,
                                      records, stream=stream):
                sys.exit("a kernel disagrees with its plain-torch reference")
        ms.update((prefix + name, rec["ms"]) for name, rec in records.items())

    cases = sys.argv[1:] or ["step2d", "q2step2d"]
    if "step2d" in cases:
        _, _, hm, _, U0 = build_step2d(cs.REFINEMENT, torch.float32, dev)
        plain = TimeIntegrator(cs.PlainSteps(hm), "erk 33", cfl_min=0.45,
                               cfl_max=0.9, cfl_recovery_strategy="none")
        U_a, _, t_a, _, _, _ = plain.advance(U0, 0.0, cs.PLAIN_STEPS)
        U_b = plain.advance(U_a, t_a, 1)[0]
        timed("step2d", hm, U_a, U_b)
        timed("step2d", hm, U_a, U_b, "K=8 ", stream=True)
        del hm, plain, U_a, U_b, U0
    if "q2step2d" in cases:
        _, _, hm, ti, U0 = build_q2step2d(cs.Q2_REFINEMENT, torch.float32,
                                          dev)
        U_a, _, t_a, _, _, _ = ti.advance(U0, 0.0, cs.Q2_DEVELOP_STEPS)
        U_b = ti.advance(U_a, t_a, 1)[0]
        timed("q2step2d", hm, U_a, U_b)
        del hm, ti, U_a, U_b, U0
    for case, prefix in (("box3d", "3D "), ("dg1box3d", "dG ")):
        if case not in cases:
            continue
        from . import bench

        refinement = (cs.BOX_REFINEMENT if case == "box3d"
                      else cs.DG_BOX_REFINEMENT)
        _, sd, hm, ti, U0 = getattr(bench, "build_" + case)(
            refinement, torch.float32, dev)
        U_a, _, t_a, _, _, _ = ti.advance(cs.bumped(sd, U0, blast=True), 0.0,
                                          cs.BOX_DEVELOP_STEPS)
        U_b = ti.advance(U_a, t_a, 1)[0]
        timed(case, hm, U_a, U_b, prefix)
        del hm, ti, U_a, U_b, U0
        torch.cuda.empty_cache()
    if "cylinder3d" in cases:
        from .bench import build_cylinder3d

        eq, sd, hm, ti, U0 = build_cylinder3d(cs.CYL_REFINEMENT,
                                              torch.float32, dev)
        U_a, _, t_a, _, _, _ = ti.advance(U0, 0.0, cs.CYL_DEVELOP_STEPS)
        U_b = ti.advance(U_a, t_a, 1)[0]
        timed("cylinder3d", hm, U_a, U_b, "cyl ")
        hm_sep = HyperbolicModule(eq, sd, hm.initial_state_fn,
                                  dtype=torch.float32, device=dev,
                                  separable=True)
        timed("cylinder3d", hm_sep, U_a, U_b, "cyl SEP ")
        del hm, hm_sep, ti, U_a, U_b, U0
    if "ell" in cases:
        step = geometry.step(refinement=cs.ELL_REFINEMENT)
        _, _, hm, ti, U0 = build_ell(step, torch.float32, dev,
                                     recovery="none")
        U_a, _, t_a, _, _, _ = ti.advance(U0, 0.0, cs.ELL_WARMUP)
        U_b = ti.advance(U_a, t_a, 1)[0]
        records = {}
        if not cs.compare_ell(hm, U_a, U_b, cs.TOL_F32, cs.REPS, records):
            sys.exit("an ELL kernel disagrees with its plain version")
        ms.update(("ELL " + name, rec["ms"]) for name, rec in records.items())
        del hm, ti, U_a, U_b, U0
    log = so.with_suffix(".so.log")
    res = resources(log.read_text(), launch_shape) if log.exists() else {}
    print(json.dumps({"card": cs.smi_line(), "ms": ms, "resources": res,
                      "digests": digested}), flush=True)


if __name__ == "__main__":
    main()
