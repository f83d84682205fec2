"""The pow microbenchmark on the card: scripts/bench_pow.py (row 11) and
scripts/bench_pow_tpu.py (row 12) through csrc/probe_pow.cu.

    python -m ryujin_tpu_torch.probes.pow [--H 512 --W 1024 --REPS 40 ...]

Row 11: sum_{k < REPS} f(x + f32(0.01 k), b) over an H x W array, x
uniform on [0.5, 3) (numpy default_rng(0)), for powf, exp2(b log2 x), the
bit-twiddled fast pow, x b and sqrt: ms and ps per pow, then the errors of
exp2 and of the fast pow against powf, as the script prints them.  Row 12:
sum_{r < reps} f(x + f32(1e-3 r)) over an N array, x uniform on [0.01, 4)
(default_rng(0): jax.random's bits cannot be reproduced), for
powf, exp2 log2 and the Newton form (x^1.4 whatever G is), the summed and
pointwise errors against powf (torch.pow) and the time per launch of a
`loop`-launch chain in which each launch takes x + 1e-9 (its predecessor's
output).  Every form also runs once pointwise.  The operations bound
counts, in the SASS of each form's single-evaluation instance (ONE_EVAL:
the scalar pointwise kernel, one element a thread; read with cuobjdump
from the built library), the fewest FMA-pipe and MUFU instructions that
any evaluation executes (least_issued).
"""

from __future__ import annotations

import argparse
import heapq
import re
import sys

import numpy as np
import torch

from ..kernels import build
from ..kernels.probe_pow import (
    FORMS, key, probe_pow, probe_pow_reference, shifts,
)
from . import SMS, Case, card, measure, report, smi

SOURCE = "ryujin_tpu_torch/csrc/probe_pow.cu"
ROW11 = "scripts/bench_pow.py:71"
ROW12 = "scripts/bench_pow_tpu.py:58"
# (form, the script's name) of each row
FORMS_11 = (("powf", "jnp.power"), ("exp2_log2", "exp2(b*log2)"),
            ("fast", "fast bit-twiddle"), ("mult", "baseline mult (x*b)"),
            ("sqrt", "sqrt"))
FORMS_12 = (("powf", "xla_pow"), ("exp2_log2", "exp2_log2"),
            ("newton", "bithack_newton"))
# forms that call the maths library (powf, exp2f, log2f, sqrtf) where the
# plain version calls torch's, whose implementations may differ by ulps
# (torch's CPU sqrt is 1 ulp off the rounded root on some inputs): held to
# 4 ulp pointwise and 1e-6 relative on the sums; the others bit-equal
LIBM = ("powf", "exp2_log2", "sqrt")
# lanes a clock per SM of the two pipes the bound counts: the FMA pipe
# (FADD, FMUL, FFMA) and the MUFU (the special-function unit)
RATES = {"fma": 128, "mufu": 16}
_FMA = {"FADD", "FMUL", "FFMA", "FADD32I", "FMUL32I", "FFMA32I"}
# the instance of each form that evaluates f once a thread: the scalar
# pointwise kernel, probe_pow_pointwise_kernel<FORM, 1, 1> (its vector
# instances evaluate f four times an item and may skip every item)
ONE_EVAL = re.compile(
    r"_ZN6ryujin26probe_pow_pointwise_kernelILi(\d)ELi1ELi1EE")
_TARGET = re.compile(r"(0x[0-9a-f]+)$")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m ryujin_tpu_torch.probes.pow",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--H", type=int, default=512)
    ap.add_argument("--W", type=int, default=1024)
    ap.add_argument("--REPS", type=int, default=40,
                    help="row 11: pow evaluations per element")
    ap.add_argument("--b", type=float, default=1.4)
    ap.add_argument("--n-iter", type=int, default=20,
                    help="row 11: timed launches")
    ap.add_argument("--N", type=int, nargs=2, default=(64, 2048))
    ap.add_argument("--G", type=float, default=1.4)
    ap.add_argument("--reps", type=int, default=16,
                    help="row 12: pow evaluations per element")
    ap.add_argument("--loop", type=int, default=64,
                    help="row 12: launches a chain")
    ap.add_argument("--iters", type=int, default=4,
                    help="row 12: timed chains")
    return ap


def _decode(text: str):
    """(guarded, opcode, pipe of RATES or None) of one SASS instruction."""
    tokens = text.split()
    guarded = tokens[0].startswith("@")
    op = tokens[int(guarded)].split(".")[0]
    return guarded, op, "fma" if op in _FMA else "mufu" if op == "MUFU" else None


def least_issued(code, pipe: str, start: int = 0, stop: str = "EXIT") -> int:
    """The fewest unguarded `pipe` instructions (pipe "all": instructions
    of any kind) that one thread executes in
    the function `code` ([(address, text)] from sass_diff.listing) from the
    instruction at `start` to an unguarded `stop`: a shortest path over the
    instructions that may go either way at each conditional branch and
    passes a guarded EXIT (the bounds guard: a thread that takes it
    evaluates nothing).  A CALL costs its subroutine's least path to RET; a
    guarded instruction costs nothing, since its guard may be off.  So no
    evaluation, on any input, executes fewer."""
    at = {addr: i for i, (addr, _) in enumerate(code)}
    best = {start: 0}
    heap = [(0, start)]
    while heap:
        d, i = heapq.heappop(heap)
        if d > best[i]:
            continue
        guarded, op, unit = _decode(code[i][1])
        d += int((pipe == "all" or unit == pipe) and not guarded)
        if op == stop and not guarded:
            return d
        nxt = [(i + 1, d)]
        if op in ("BRA", "CALL"):
            target = at[int(_TARGET.search(code[i][1]).group(1), 16)]
            if op == "CALL":
                nxt = [(i + 1, d + least_issued(code, pipe, target, "RET"))]
            else:  # conditional: a guard, or a predicate operand
                conditional = guarded or "," in code[i][1]
                nxt = [(target, d)] + (nxt if conditional else [])
        for j, dj in nxt:
            if dj < best.get(j, dj + 1):
                best[j] = dj
                heapq.heappush(heap, (dj, j))
    raise ValueError(f"no path from {code[start][0]:#x} to {stop}")


def pow_mix(library):
    """{form: {"fma", "mufu": least_issued of one evaluation, "issued":
    the fewest instructions of any kind it executes (each takes an issue
    slot: a warp scheduler issues one a clock, and the FMA pipe takes one
    warp instruction a clock per scheduler, so "issued" bounds as "fma"
    does), "static": the ONE_EVAL instance's instruction count}} from the
    built library's SASS; None where cuobjdump is missing."""
    from ..sass_diff import listing

    if not build.cuda_tool("cuobjdump").exists():
        return None
    names = {code: name for name, code in FORMS.items()}
    mix = {}
    for fn, code in listing(library).items():
        m = ONE_EVAL.match(fn)
        if m:
            mix[names[int(m.group(1))]] = {
                **{unit: least_issued(code, unit) for unit in RATES},
                "issued": least_issued(code, "all"),
                "static": sum(not t.startswith("NOP") for _, t in code)}
    return mix or None


def ops_ms(mix, clock_mhz, form, evals, summed):
    """Least ms for `evals` evaluations of `form` by its least-issued mix:
    the busier pipe at its rate on every SM at the card's top SM clock.  A
    summed evaluation adds two FADDs (the shift and the sum); the loop's
    other work on these pipes depends on b alone, and the compiler may
    hoist it, so it is not counted.  None without a mix."""
    if mix is None or form not in mix:
        return None
    counts = {unit: mix[form][unit] for unit in RATES}
    counts["fma"] += 2 if summed else 0
    per_clock = max(counts[unit] / (SMS * rate) for unit, rate in RATES.items())
    return evals * per_clock / (clock_mhz * 1e6) * 1e3


def library_call(form, x, b, summed=False):
    """The PyTorch call that computes `form` on x, summed over its first
    axis (x the stack of shifted inputs [R, ...]) when `summed`, or None.
    exp2(b log2 x) computes x^b, as powf does: it is held to the same bars
    against torch.pow (LIBM), so torch.pow is its call too; the fast and
    Newton forms compute other values (7.8 % and 4e-5 off x^b) and no
    single call evaluates them."""
    one = {"powf": lambda v: torch.pow(v, b),
           "exp2_log2": lambda v: torch.pow(v, b),
           "mult": lambda v: torch.mul(v, b), "sqrt": torch.sqrt}.get(form)
    if one is None:
        return None
    return (lambda: one(x).sum(0)) if summed else (lambda: one(x))


def cases(args, mix, clock_mhz, device="cuda"):
    """(row 11 cases, row 12 cases, (x11, s11, x12, s12)): per form the
    summed kernel and the pointwise one, on inputs made on the host and
    moved to `device`."""
    dev = torch.device(device)
    x11 = torch.from_numpy(np.random.default_rng(0)
                           .uniform(0.5, 3.0, (args.H, args.W))
                           .astype(np.float32)).to(dev)
    s11 = shifts(0.01, args.REPS).to(dev)
    X11 = torch.stack([x11 + s for s in s11.tolist()])
    x12 = torch.from_numpy(np.random.default_rng(0)
                           .uniform(0.01, 4.0, tuple(args.N))
                           .astype(np.float32)).to(dev)
    s12 = shifts(1e-3, args.reps).to(dev)
    X12 = torch.stack([x12 + s for s in s12.tolist()])
    n11, n12 = x11.numel(), x12.numel()
    shape11 = f"{args.H}x{args.W}"
    shape12 = f"{args.N[0]}x{args.N[1]}"

    def pointwise(form, x, b, shape, replaces):
        return Case(
            name=f"probe_pow[{form}, {shape}, pointwise]",
            kernel=lambda: probe_pow(x, form, b),
            plain=lambda: probe_pow_reference(x, form, b),
            bar="4 ulp" if form in LIBM else "exact",
            nbytes=8 * x.numel(), source=SOURCE, replaces=replaces,
            instance=key(form, 1, x.shape),
            library=library_call(form, x, b),
            ops_ms=ops_ms(mix, clock_mhz, form, x.numel(), False))

    summed_bar = {form: "rel 1e-6" for form in LIBM}
    row11 = []
    for form, _ in FORMS_11:
        row11.append(Case(
            name=f"probe_pow[{form}, {shape11}, R={args.REPS}]",
            kernel=lambda f=form: probe_pow(x11, f, args.b, s11),
            plain=lambda f=form: probe_pow_reference(x11, f, args.b, s11),
            bar=summed_bar.get(form, "exact"), nbytes=8 * n11, source=SOURCE,
            replaces=ROW11, instance=key(form, args.REPS, x11.shape),
            library=library_call(form, X11, args.b, summed=True),
            ops_ms=ops_ms(mix, clock_mhz, form, n11 * args.REPS, True),
            reps=args.n_iter))
        row11.append(pointwise(form, x11, args.b, shape11, ROW11))

    def chain(f, fn):
        def run():
            a = x12
            for _ in range(args.loop):
                a = fn(x12, f, args.G, s12, a)
            return a
        return run

    row12 = []
    for form, _ in FORMS_12:
        row12.append(Case(
            name=f"probe_pow[{form}, {shape12}, R={args.reps}, "
                 f"{args.loop}-launch chain]",
            kernel=chain(form, probe_pow),
            plain=chain(form, probe_pow_reference),
            bar=summed_bar.get(form, "exact"), nbytes=12 * n12,
            source=SOURCE, replaces=ROW12,
            instance=key(form, args.reps, x12.shape),
            library=library_call(form, X12, args.G, summed=True),
            ops_ms=ops_ms(mix, clock_mhz, form, n12 * args.reps, True),
            launches_per_call=args.loop, reps=args.iters))
        row12.append(pointwise(form, x12, args.G, shape12, ROW12))
    return row11, row12, (x11, s11, x12, s12)


def main(argv=None, records=None) -> int:
    """Run both rows; append each kernel's record to `records` when given.
    0 when every kernel holds its bar, 1 otherwise or without a card."""
    args = parser().parse_args(argv)
    if card() is None:
        return 1
    lib = build.build()
    mix = pow_mix(lib)
    clock = int(smi("clocks.max.sm").split()[0])
    row11, row12, (x11, s11, x12, s12) = cases(args, mix, clock)
    recs = []

    print(f"row 11 (scripts/bench_pow.py): {args.H} x {args.W}, "
          f"{args.REPS} pows per element, b = {args.b}", flush=True)
    outs = {}
    for (form, label), case, pt in zip(FORMS_11, row11[::2], row11[1::2]):
        rec = measure(case)
        per = rec["ms"] * 1e-3 / (args.H * args.W * args.REPS) * 1e12
        print(f"{label:28s} {rec['ms']:8.3f} ms  {per:8.2f} ps/pow",
              flush=True)
        print(report(rec), flush=True)
        recs.append(rec)
        rec = measure(pt)
        print(report(rec), flush=True)
        recs.append(rec)
        outs[form] = probe_pow(x11, form, args.b, s11)
    ya = outs["powf"]
    for form, what in (("exp2_log2", "exp2"), ("fast", "fast")):
        rel = float(((outs[form] - ya).abs() / ya).max())
        print(f"rel err {what}-vs-power: {rel}", flush=True)

    print(f"row 12 (scripts/bench_pow_tpu.py): {args.N[0]} x {args.N[1]}, "
          f"{args.reps} pows per element, chains of {args.loop} launches",
          flush=True)
    kref = probe_pow_reference(x12, "powf", args.G, s12)
    ref_pt = probe_pow_reference(x12, "powf", args.G)
    for (form, label), case, pt in zip(FORMS_12, row12[::2], row12[1::2]):
        err = float(((probe_pow(x12, form, args.G, s12) - kref).abs()
                     / kref).max())
        err_pt = float(((probe_pow(x12, form, args.G) - ref_pt).abs()
                        / ref_pt).max())
        rec = measure(case)
        dt = rec["ms"] * 1e-3
        print(f"{label:16s} rel_err={err:.2e} (summed) {err_pt:.2e} "
              f"(pointwise)  {dt * 1e6:8.1f} us/kernel "
              f"({x12.numel() * args.reps / dt / 1e9:.2f} Gpow/s)",
              flush=True)
        print(report(rec), flush=True)
        recs.append(rec)
        rec = measure(pt)
        print(report(rec), flush=True)
        recs.append(rec)

    if mix is None:
        print("SASS per pow: not measured (no cuobjdump, or no ONE_EVAL "
              "instance found in its listing)", flush=True)
    else:
        print(f"SASS per pow (one evaluation, the fewest executed on any "
              f"path; top SM clock {clock} MHz):", flush=True)
        for form in FORMS:
            m = mix.get(form, {})
            print(f"  {form:10s} FMA pipe {m.get('fma', 0):3d}  MUFU "
                  f"{m.get('mufu', 0):3d}  issued {m.get('issued', 0):3d}  "
                  f"(of {m.get('static', 0)} instructions in the function)",
                  flush=True)
    if records is not None:
        records.extend(recs)
    return 0 if all(r["ok"] for r in recs) else 1


if __name__ == "__main__":
    sys.exit(main())
