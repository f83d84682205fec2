"""The gather probe on the card: scripts/probe_gather.py (row 13) through
csrc/probe_gather.cu.

    python -m ryujin_tpu_torch.probes.gather [--P 8 --W 128 256 ... --n ...]

The lane gather out[p, w] = x[p, idx[p, w]] for each W and the sublane
gather out[s, l] = x[idx[s, l], l] for each S, from a shared-memory
window, each held exactly against np.take_along_axis ("ok=", as the
script prints it); then the ELL gather-sum sum_k X[:, cols[k]] over
banded columns (|j - i| <= 1500), whose ms, GB/s gathered (n K C 4 bytes)
and Mnode/s the script prints for the TPU's XLA gather, and the blocks
that staged their band in shared memory, counted by the kernel, against
ell_staged_blocks and the blocks of the launch.  Inputs are made as the
script makes them: x = arange, indices and X from
np.random.default_rng(0).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..kernels import build
from ..kernels.probe_gather import (
    ell_default_shape, ell_gather_sum, ell_gather_sum_reference,
    ell_staged_blocks, lane_gather, lane_gather_reference, sublane_gather,
    sublane_gather_reference,
)
from . import Case, card, measure, report

SOURCE = "ryujin_tpu_torch/csrc/probe_gather.cu"


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m ryujin_tpu_torch.probes.gather",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--P", type=int, default=8)
    ap.add_argument("--W", type=int, nargs="+",
                    default=[128, 256, 512, 1024, 2048])
    ap.add_argument("--L", type=int, default=128)
    ap.add_argument("--S", type=int, nargs="+", default=[8, 64, 512, 1024])
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--K", type=int, default=9)
    ap.add_argument("--C", type=int, default=12)
    ap.add_argument("--iters", type=int, default=20)
    return ap


def lane_inputs(P: int, W: int):
    """(x, idx) of probe_lane_gather: x = arange [P, W] f32, idx int32
    from default_rng(0) in [0, W)."""
    x = np.arange(P * W, dtype=np.float32).reshape(P, W)
    idx = np.random.default_rng(0).integers(0, W, size=(P, W)).astype(np.int32)
    return x, idx


def sublane_inputs(S: int, L: int):
    """(x, idx) of probe_sublane_gather: x = arange [S, L] f32, idx int32
    from default_rng(0) in [0, S)."""
    x = np.arange(S * L, dtype=np.float32).reshape(S, L)
    idx = np.random.default_rng(0).integers(0, S, size=(S, L)).astype(np.int32)
    return x, idx


def ell_inputs(n: int, K: int, C: int):
    """(X [C, n] f32, cols [K, n] int32) of bench_xla_ell_gather: columns
    i + jitter, jitter in [-1500, 1500), clipped to [0, n), then X standard
    normal, both from one default_rng(0)."""
    rng = np.random.default_rng(0)
    base = np.arange(n)[None, :].repeat(K, 0)
    jitter = rng.integers(-1500, 1500, size=(K, n))
    cols = np.clip(base + jitter, 0, n - 1).astype(np.int32)
    X = rng.standard_normal((C, n)).astype(np.float32)
    return X, cols


def ell_staged(X, cols):
    """(blocks that staged their band, as the kernel counts them in one
    launch of the default shape; as ell_staged_blocks mirrors the rule;
    blocks of the launch) and that launch's output."""
    shape = ell_default_shape(X, cols)
    staged = torch.zeros(1, dtype=torch.int32, device=X.device)
    out = ell_gather_sum(X, cols, shape, staged)
    return (int(staged), ell_staged_blocks(cols, shape), shape.blocks), out


def _to(device, *arrays):
    return [torch.from_numpy(a).to(device) for a in arrays]


def cases(args, device="cuda"):
    """The lane gather at the largest W, the sublane gather at the largest
    S, and the ELL gather-sum, on `device`."""
    lx, lidx = _to(device, *lane_inputs(args.P, max(args.W)))
    sx, sidx = _to(device, *sublane_inputs(max(args.S), args.L))
    X, cols = _to(device, *ell_inputs(args.n, args.K, args.C))
    lidx64, sidx64, cols64 = lidx.long(), sidx.long(), cols.long()
    return [
        Case(name=f"lane_gather[P={args.P}, W={max(args.W)}]",
             kernel=lambda: lane_gather(lx, lidx),
             plain=lambda: lane_gather_reference(lx, lidx), bar="exact",
             nbytes=12 * lx.numel(), source=SOURCE,
             replaces="scripts/probe_gather.py:50",
             instance=build.probe_key("lane_gather", args.P, max(args.W)),
             library=lambda: torch.gather(lx, 1, lidx64)),
        Case(name=f"sublane_gather[S={max(args.S)}, L={args.L}]",
             kernel=lambda: sublane_gather(sx, sidx),
             plain=lambda: sublane_gather_reference(sx, sidx), bar="exact",
             nbytes=12 * sx.numel(), source=SOURCE,
             replaces="scripts/probe_gather.py:69",
             instance=build.probe_key("sublane_gather", max(args.S), args.L),
             library=lambda: torch.gather(sx, 0, sidx64)),
        Case(name=f"ell_gather_sum[C={args.C}, K={args.K}, n={args.n}]",
             kernel=lambda: ell_gather_sum(X, cols),
             plain=lambda: ell_gather_sum_reference(X, cols), bar="exact",
             nbytes=4 * (2 * X.numel() + cols.numel()), source=SOURCE,
             replaces="scripts/probe_gather.py:78 (XLA)",
             instance=build.probe_key("ell_gather_sum", args.C, args.K,
                                      args.n),
             library=lambda: X[:, cols64].sum(1), reps=args.iters),
    ]


def main(argv=None, records=None) -> int:
    """Run the probe; append each kernel's record to `records` when given.
    0 when every gather is right, every kernel holds its bar and the
    staged blocks are those ell_staged_blocks finds, 1 otherwise or
    without a card."""
    args = parser().parse_args(argv)
    if card() is None:
        return 1
    good = True
    for W in args.W:
        x, idx = lane_inputs(args.P, W)
        out = lane_gather(*_to("cuda", x, idx)).cpu().numpy()
        ok = np.array_equal(out, np.take_along_axis(x, idx, axis=1))
        print(f"lane gather W={W}: ok={ok}", flush=True)
        good &= ok
    for S in args.S:
        x, idx = sublane_inputs(S, args.L)
        out = sublane_gather(*_to("cuda", x, idx)).cpu().numpy()
        ok = np.array_equal(out, np.take_along_axis(x, idx, axis=0))
        print(f"sublane gather S={S}: ok={ok}", flush=True)
        good &= ok
    recs = [measure(case) for case in cases(args)]
    dt = recs[-1]["ms"] * 1e-3
    gathered_gb = args.n * args.K * args.C * 4 / 1e9
    print(f"ELL gather (band staged in shared memory): n={args.n} K={args.K} "
          f"C={args.C}: {dt * 1e3:.4f} ms/iter, {gathered_gb / dt:.1f} GB/s "
          f"gathered, {args.n / dt / 1e6:.1f} Mnode/s", flush=True)
    for rec in recs:
        print(report(rec), flush=True)
    (counted, mirror, blocks), _ = ell_staged(
        *_to("cuda", *ell_inputs(args.n, args.K, args.C)))
    print(f"ELL gather-sum: {counted} of {blocks} blocks staged their band "
          f"(ell_staged_blocks: {mirror})", flush=True)
    good &= counted == mirror
    if records is not None:
        records.extend(recs)
    return 0 if good and all(r["ok"] for r in recs) else 1


if __name__ == "__main__":
    sys.exit(main())
