"""The 3D layout probe on the card: scripts/probe_dma3d.py (row 14) through
csrc/probe_layout3d.cu.

    python -m ryujin_tpu_torch.probes.layout3d [layouts] [pk1_shape]
        [moveaxis_cost] [--P 24 --D 72 --H 72 --W 128 --TD 2 --REPS ...]

layouts (the script's main): the same (TD + 2)-deep window of P planes
over a (D, H, W) canvas in three layouts, plane-major [P, D, H, W],
z-major [D, P, H, W] and z-major with a sliding window, summed over the
planes: ms and effective GB/s (the windows' bytes, P (TD + 2) H W 4 a z
tile), then the three times as JSON.  pk1_shape: PK1's transfer set (a
CENPL-plane centre in TD-row blocks, windows of 5, 4 and 2 planes, OUTPL
output planes) with no compute.  moveaxis_cost: a z-major window read
with (MOV = 1) or without the relayout to plane-major; MOV both runs
each.  pk1_shape and moveaxis_cost read one plane, so their kernels also
write a checksum of every staged value, held with the output against the
plain version; no PyTorch call moves their transfer set (library_ms
null).  With no part named, all three run.  The scripts' environment knobs
are options of the same names and defaults; REPS defaults to each part's
own (50, 30, 30).  Inputs are uniform on [0, 1) from
np.random.default_rng(0); the z-major canvas is the plane-major one
transposed, so the three layouts must agree.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..kernels import build
from ..kernels.probe_layout3d import (
    interior_rows, moveaxis, moveaxis_reference, pk1_shape,
    pk1_shape_reference, window_sum, window_sum_reference,
)
from . import Case, card, measure, report

SOURCE = "ryujin_tpu_torch/csrc/probe_layout3d.cu"
# each part's environment knobs in scripts/probe_dma3d.py, with defaults
LAYOUTS_ENV = {"P": 24, "D": 72, "H": 72, "W": 128, "TD": 2, "REPS": 50}
PK1_SHAPE_ENV = {"D": 72, "H": 72, "W": 128, "TD": 2, "REPS": 30, "CEN": 1,
                 "NWIN": 3, "OUTPL": 14, "CENPL": 78}
MOVEAXIS_ENV = {"D": 72, "H": 72, "W": 128, "TD": 2, "P": 24, "REPS": 30,
                "MOV": 1}
PARTS = ("layouts", "pk1_shape", "moveaxis_cost")
REPLACES = {"plane-major": "scripts/probe_dma3d.py:83",
            "z-major": "scripts/probe_dma3d.py:117",
            "z-major-slide": "scripts/probe_dma3d.py:168",
            "pk1_shape": "scripts/probe_dma3d.py:290",
            "moveaxis": "scripts/probe_dma3d.py:373"}
WINDOW_PLANES = (5, 4, 2)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m ryujin_tpu_torch.probes.layout3d",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("parts", nargs="*", choices=PARTS, default=None,
                    help="the parts to run (default: all three)")
    for name in ("P", "D", "H", "W", "TD", "CEN", "NWIN", "OUTPL", "CENPL"):
        default = {**LAYOUTS_ENV, **PK1_SHAPE_ENV}[name]
        ap.add_argument(f"--{name}", type=int, default=default)
    ap.add_argument("--REPS", type=int, default=None,
                    help="timed launches (default: layouts 50, pk1_shape "
                         "and moveaxis_cost 30)")
    ap.add_argument("--MOV", choices=("0", "1", "both"),
                    default=str(MOVEAXIS_ENV["MOV"]))
    return ap


def layout_inputs(args, device="cuda"):
    """(hz [D, P, H, W], hp [P, D, H, W]) of the layouts part: hz uniform
    on [0, 1) from np.random.default_rng(0), hp the same canvas
    plane-major."""
    rng = np.random.default_rng(0)
    hz = torch.from_numpy(rng.random((args.D, args.P, args.H, args.W),
                                     dtype=np.float32)).to(device)
    return hz, hz.movedim(0, 1).contiguous()


def layout_calls(hz, hp, TD: int):
    """The PyTorch call that computes each layout's window sums: rows
    1 .. gz TD of the canvas summed over the planes."""
    rows = interior_rows(hz.shape[0], TD)
    return {"plane-major": lambda: hp[:, 1 : rows + 1].sum(0),
            "z-major": lambda: hz[1 : rows + 1].sum(1),
            "z-major-slide": lambda: hz[1 : rows + 1].sum(1)}


def cases(args, part: str, device="cuda"):
    """The cases of one part at the options' sizes, on `device`."""
    rng = np.random.default_rng(0)
    D, H, W, TD = args.D, args.H, args.W, args.TD
    HW = H * W
    rows = interior_rows(D, TD)
    dev = torch.device(device)

    def canvas(*shape):
        return torch.from_numpy(rng.random(shape, dtype=np.float32)).to(dev)

    def named(base, **kw):
        dims = ", ".join(f"{k}={v}" for k, v in kw.items())
        return f"{base}[{dims}, ({D}, {H}, {W}), TD={TD}]"

    if part == "layouts":
        reps = args.REPS or LAYOUTS_ENV["REPS"]
        hz, hp = layout_inputs(args, dev)
        nbytes = 4 * (args.P * (rows + 2) * HW + D * HW)
        library = layout_calls(hz, hp, TD)
        return [
            Case(name=named(f"window_sum_{layout}", P=args.P),
                 kernel=lambda L=layout, h=h: window_sum(h, L, TD),
                 plain=lambda L=layout, h=h: window_sum_reference(h, L, TD),
                 bar="exact", nbytes=nbytes, source=SOURCE,
                 replaces=REPLACES[layout],
                 instance=build.probe_key("window_sum", layout),
                 library=library[layout], reps=reps)
            for layout, h in (("plane-major", hp), ("z-major", hz),
                              ("z-major-slide", hz))
        ]
    if part == "pk1_shape":
        reps = args.REPS or PK1_SHAPE_ENV["REPS"]
        cen = canvas(D, args.CENPL, H, W) if args.CEN else None
        wins = [canvas(D, p, H, W) for p in WINDOW_PLANES[: args.NWIN]]
        nbytes = 4 * (rows * args.CENPL * HW * bool(args.CEN)
                      + sum(w.shape[1] for w in wins) * (rows + 2) * HW
                      + D * (args.OUTPL + 1) * HW)
        return [Case(
            name=named("pk1_shape", CENPL=args.CENPL * bool(args.CEN),
                       NWIN=args.NWIN, OUTPL=args.OUTPL),
            kernel=lambda: pk1_shape(cen, wins, TD, args.OUTPL),
            plain=lambda: pk1_shape_reference(cen, wins, TD, args.OUTPL),
            bar="exact", nbytes=nbytes, source=SOURCE,
            replaces=REPLACES["pk1_shape"],
            instance=build.probe_key("pk1_shape"), reps=reps)]
    reps = args.REPS or MOVEAXIS_ENV["REPS"]
    h = canvas(D, args.P, H, W)
    nbytes = 4 * (args.P * (rows + 2) * HW + 2 * D * HW)
    movs = (1, 0) if args.MOV == "both" else (int(args.MOV),)
    return [
        Case(name=named("moveaxis", MOV=mov, P=args.P),
             kernel=lambda m=mov: moveaxis(h, TD, m),
             plain=lambda m=mov: moveaxis_reference(h, TD, m), bar="exact",
             nbytes=nbytes, source=SOURCE, replaces=REPLACES["moveaxis"],
             instance=build.probe_key("moveaxis", f"MOV={mov}"), reps=reps)
        for mov in movs
    ]


def main(argv=None, records=None) -> int:
    """Run the named parts; append each kernel's record to `records` when
    given.  0 when every kernel holds its bar (and the three layouts agree),
    1 otherwise or without a card."""
    args = parser().parse_args(argv)
    if card() is None:
        return 1
    D, H, W, TD = args.D, args.H, args.W, args.TD
    gz, wz = D // TD - 2, TD + 2
    recs, good = [], True
    for part in [p for p in PARTS if p in (args.parts or PARTS)]:
        part_cases = cases(args, part)
        part_recs = [measure(case) for case in part_cases]
        if part == "layouts":
            vol = args.P * wz * H * W * 4 * gz / 1e9
            for tag, rec in zip(("plane-major", "z-major", "z-major-slide"),
                                part_recs):
                ms = rec["ms"]
                print(f"{tag:14s} {ms:8.3f} ms  ({vol / (ms / 1e3):7.1f} "
                      "GB/s eff)", flush=True)
            outs = [case.kernel() for case in part_cases]
            agree = all(torch.equal(outs[0], o) for o in outs[1:])
            print(f"the three layouts agree: {agree}", flush=True)
            good &= agree
            del outs
            print(json.dumps({
                "plane_major_ms": part_recs[0]["ms"],
                "z_major_ms": part_recs[1]["ms"],
                "z_major_slide_ms": part_recs[2]["ms"],
            }), flush=True)
        elif part == "pk1_shape":
            print(f"pk1-shape cen={bool(args.CEN)}({args.CENPL}) "
                  f"nwin={args.NWIN} outpl={args.OUTPL}: "
                  f"{part_recs[0]['ms']:.3f} ms", flush=True)
        else:
            for case, rec in zip(part_cases, part_recs):
                mov = "MOV=1" in case.name
                print(f"moveaxis={mov} P={args.P}: {rec['ms']:.3f} ms",
                      flush=True)
        for rec in part_recs:
            print(report(rec), flush=True)
        recs += part_recs
        del part_cases
        torch.cuda.empty_cache()
    if records is not None:
        records.extend(recs)
    return 0 if good and all(r["ok"] for r in recs) else 1


if __name__ == "__main__":
    sys.exit(main())
