"""Gather probe: gathers from a shared-memory window and the ELL gather-sum
(CUDA kernels csrc/probe_gather.cu; row 13 of the kernel table, the TPU
kernels scripts/probe_gather.py:41 and :60, and its XLA ELL gather :78)."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import build

# the sublane gather's window (csrc/probe_gather.cu SUBLANE_TILE,
# SUBLANE_THREADS): columns a block stages, its threads, and the output rows
# a group takes at least (one a warp)
SUBLANE_TILE = 32
SUBLANE_THREADS = 256
SUBLANE_MIN_ROWS = SUBLANE_THREADS // SUBLANE_TILE
# blocks the default launch aims at, about one an SM: at S = 1024, L = 128
# 1 / 2 / 4 / 8 / 16 / 32 groups took 0.0098 / 0.0060 / 0.0039 / 0.0032 /
# 0.0027 / 0.0026 ms a call in a CUDA graph (NVIDIA H100 80GB HBM3, 700.00
# W; tile_sweep gather)
SUBLANE_BLOCKS = 128


def lane_gather_reference(x, idx):
    """Plain torch: out[p, w] = x[p, idx[p, w]]."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx.long()]


def lane_gather(x, idx):
    """out[p, w] = x[p, idx[p, w]] of f32 x [P, W] and int32 idx [P, W]
    (indices in [0, W); the kernel gives NaN for any other).  Counted under
    build.probe_key("lane_gather", P, W)."""
    if not build.on_card(x):
        return lane_gather_reference(x, idx)
    build.check_probe(x.device, {"x": (x, x.shape), "idx": (idx, x.shape)})
    out = torch.empty_like(x)
    P, W = x.shape
    build.launch_probe(build.probe_key("lane_gather", P, W),
                       "ryujin_probe_lane_gather", x.data_ptr(),
                       idx.data_ptr(), out.data_ptr(), P, W)
    return out


def sublane_gather_reference(x, idx):
    """Plain torch: out[s, l] = x[idx[s, l], l]."""
    return x[idx.long(), torch.arange(x.shape[1], device=x.device)[None, :]]


class SublaneShape(NamedTuple):
    """Launch shape of the sublane gather: a grid of `tiles` column tiles x
    `groups` row groups of `rows` output rows, `threads` a block, `smem`
    shared bytes a block (the window of a tile)."""

    tiles: int
    groups: int
    rows: int
    threads: int
    smem: int


def sublane_shape(S: int, L: int, groups: Optional[int] = None) -> SublaneShape:
    """The sublane gather's launch on x [S, L]: each block stages the
    whole window of its 32 columns (S * 128 bytes, so S up to 1816) and
    gathers one group of output rows; without `groups`, as many groups as
    bring the blocks near SUBLANE_BLOCKS, each of at least SUBLANE_MIN_ROWS
    rows.  A group count is cut to the groups its rows need."""
    smem = S * SUBLANE_TILE * 4
    if S < 1 or L < 1 or smem > build.SMEM_MAX:
        raise ValueError(f"the sublane gather takes 1 <= S <= "
                         f"{build.SMEM_MAX // (SUBLANE_TILE * 4)} rows and "
                         f"L >= 1 columns, not {S} x {L}")
    tiles = -(-L // SUBLANE_TILE)
    if groups is None:
        groups = min(-(-S // SUBLANE_MIN_ROWS),
                     max(1, SUBLANE_BLOCKS // tiles))
    rows = -(-S // max(1, groups))
    return SublaneShape(tiles, -(-S // rows), rows, SUBLANE_THREADS, smem)


def sublane_gather(x, idx):
    """out[s, l] = x[idx[s, l], l] of f32 x [S, L] and int32 idx [S, L]
    (indices in [0, S); the kernel gives NaN for any other), S up to 1816
    (sublane_shape).  Counted under build.probe_key("sublane_gather", S,
    L)."""
    if not build.on_card(x):
        return sublane_gather_reference(x, idx)
    build.check_probe(x.device, {"x": (x, x.shape), "idx": (idx, x.shape)})
    out = torch.empty_like(x)
    S, L = x.shape
    shape = sublane_shape(S, L)
    build.launch_probe(build.probe_key("sublane_gather", S, L),
                       "ryujin_probe_sublane_gather", x.data_ptr(),
                       idx.data_ptr(), out.data_ptr(), S, L, *shape)
    return out


def ell_gather_sum_reference(X, cols):
    """Plain torch: out[c, i] = sum_k X[c, cols[k, i]], summed from 0 in k
    order."""
    acc = torch.zeros_like(X)
    for k in range(cols.shape[0]):
        acc = acc + X.index_select(1, cols[k])
    return acc


def ell_gather_sum(X, cols):
    """out[c, i] = sum_{k < K} X[c, cols[k, i]] of f32 X [C, n] and int32
    cols [K, n], K <= 16 (indices in [0, n); the kernel gives NaN for any
    other).  Counted under build.probe_key("ell_gather_sum", C, K, n)."""
    if not build.on_card(X):
        return ell_gather_sum_reference(X, cols)
    C, n = X.shape
    K = cols.shape[0]
    if K > 16:
        raise ValueError(f"the ELL gather-sum takes at most 16 slots, not {K}")
    build.check_probe(X.device, {"X": (X, X.shape), "cols": (cols, (K, n))})
    out = torch.empty_like(X)
    build.launch_probe(build.probe_key("ell_gather_sum", C, K, n),
                       "ryujin_probe_ell_gather_sum", X.data_ptr(),
                       cols.data_ptr(), out.data_ptr(), C, K, n)
    return out
