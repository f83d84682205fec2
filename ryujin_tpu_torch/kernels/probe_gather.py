"""Gather probe: gathers from a shared-memory window and the ELL gather-sum
(CUDA kernels csrc/probe_gather.cu; row 13 of the kernel table, the TPU
kernels scripts/probe_gather.py:41 and :60, and its XLA ELL gather :78)."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import build

# the lane gather's layout (csrc/probe_gather.cu LANE_ITEMS,
# LANE_MAX_THREADS): index vectors a thread holds, and the most threads a
# block
LANE_ITEMS = 4
LANE_MAX_THREADS = 1024
# the lane gather's default launch: threads a block, and the blocks the
# default group count aims at (each group at least a warp's vectors); at
# P = 8, W = 2048, 2 or 4 groups of 128 or 256 threads took 0.0016 ms a
# call in a CUDA graph of 100 calls, 16 groups 0.0018, torch.gather
# 0.0045 (NVIDIA H100 80GB HBM3, 700.00 W; tile_sweep gather)
LANE_DEFAULTS = {"threads": 128, "blocks": 32}

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

# the ELL gather-sum's layout (csrc/probe_gather.cu ELL_MAX_K,
# ELL_MAX_THREADS, ELL_MAX_STAGES, ELL_HEADER_BYTES): slots a node,
# threads and stages a block, the shared bytes ahead of the columns
ELL_MAX_K = 16
ELL_MAX_THREADS = 512
ELL_MAX_STAGES = 8
ELL_HEADER_BYTES = 256
# shared bytes an SM holds, and what the card keeps of it for each block
SM_SMEM = 233472
BLOCK_RESERVED_SMEM = 1024
# the default launch: nodes a block, threads, stages and blocks an SM the
# shared bytes leave room for, the fastest of tile_sweep ell at the
# script's input (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md §6 row 13)
ELL_DEFAULTS = {"nodes": 1024, "threads": 256, "stages": 2, "per_sm": 3}


def lane_gather_reference(x, idx):
    """Plain torch: out[p, w] = x[p, idx[p, w]]."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx.long()]


class LaneShape(NamedTuple):
    """Launch shape of the lane gather: a grid of rows x `groups` groups of
    `span` vectors of `vec` output columns (4: 16-byte pieces, 1: 4-byte
    ones), `threads` a block, `smem` shared bytes a block (the row)."""

    groups: int
    span: int
    threads: int
    vec: int
    smem: int


def lane_shape(P: int, W: int, groups: Optional[int] = None,
               threads: Optional[int] = None,
               aligned: bool = True) -> LaneShape:
    """The lane gather's launch on x [P, W]; aligned: x's and idx's bases
    are 16-byte aligned (out's is).  Each block stages the whole row
    (W * 4 bytes, so W up to 58,112) and gathers one group of its
    columns, in vectors of 4 where W % 4 == 0 and aligned, else of 1, at
    most LANE_ITEMS vectors a thread; without `groups`, as many groups as
    bring the blocks near LANE_DEFAULTS["blocks"], each of at least 32
    vectors.  A group count is raised to what the threads can hold and cut
    to the groups its vectors need."""
    threads = threads or LANE_DEFAULTS["threads"]
    smem = W * 4
    if (P < 1 or W < 1 or smem > build.SMEM_MAX or threads % 32
            or not 32 <= threads <= LANE_MAX_THREADS):
        raise ValueError(f"the lane gather takes P >= 1, 1 <= W <= "
                         f"{build.SMEM_MAX // 4} and whole warps up to "
                         f"{LANE_MAX_THREADS} threads, not {P} x {W}, "
                         f"{threads} threads")
    vec = 4 if aligned and W % 4 == 0 else 1
    nvec = W // vec
    if groups is None:
        groups = min(-(-nvec // 32), max(1, LANE_DEFAULTS["blocks"] // P))
    groups = min(max(groups, -(-nvec // (LANE_ITEMS * threads))), nvec)
    span = -(-nvec // groups)
    return LaneShape(-(-nvec // span), span, threads, vec, smem)


def lane_gather(x, idx, shape: Optional[LaneShape] = None):
    """out[p, w] = x[p, idx[p, w]] of f32 x [P, W] and int32 idx [P, W]
    (indices in [0, W); the kernel gives NaN for any other), W up to
    58,112 (lane_shape), launched with `shape` (default: lane_shape's).
    Counted under build.probe_key("lane_gather", P, W)."""
    if not build.on_card(x):
        return lane_gather_reference(x, idx)
    build.check_probe(x.device, {"x": (x, x.shape), "idx": (idx, x.shape)})
    out = torch.empty_like(x)
    P, W = x.shape
    if not out.numel():
        return out
    if shape is None:
        shape = lane_shape(P, W, aligned=(x.data_ptr() | idx.data_ptr()
                                          | out.data_ptr()) % 16 == 0)
    build.launch_probe(build.probe_key("lane_gather", P, W),
                       "ryujin_probe_lane_gather", x.data_ptr(),
                       idx.data_ptr(), out.data_ptr(), P, W, *shape)
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
    order; a column outside [0, n) adds NaN, as in the kernel."""
    n = X.shape[1]
    acc = torch.zeros_like(X)
    for k in range(cols.shape[0]):
        inside = (cols[k] >= 0) & (cols[k] < n)
        picked = X.index_select(1, torch.where(inside, cols[k], 0))
        acc = acc + torch.where(inside, picked, float("nan"))
    return acc


class EllShape(NamedTuple):
    """Launch shape of the ELL gather-sum: `nodes` consecutive nodes a
    block, `threads` a block, a ring of `stages` bands of `band` floats in
    shared memory (the last four past any staged band, the last of them
    the NaN cell), each band and the block's columns staged by bulk
    copies (`bulk` 1) or by 4-byte cp.async (`bulk` 0), `blocks` covering
    n, `smem` shared bytes a block (the header, the block's K x nodes
    columns and the ring)."""

    nodes: int
    threads: int
    stages: int
    bulk: int
    band: int
    blocks: int
    smem: int


def ell_shape(n: int, K: int, aligned: bool = True,
              nodes: Optional[int] = None, threads: Optional[int] = None,
              stages: Optional[int] = None,
              per_sm: Optional[int] = None) -> EllShape:
    """The ELL gather-sum's launch on X [C, n] and K slots a node; aligned:
    X's and cols' bases are 16-byte aligned.  Bulk copies need both
    aligned and n % 4 == 0; else 4-byte cp.async.  The ring takes what
    shared memory is left when `per_sm` blocks share an SM, cut to whole
    16-byte pieces.  Defaults: ELL_DEFAULTS, the blocks an SM cut to what
    the columns leave room for.  Raises ValueError for a shape the kernel
    refuses, or whose ring cannot hold the band of a block's own nodes
    (nodes + 8 floats with the NaN cell's piece)."""
    d = ELL_DEFAULTS
    nodes = nodes or d["nodes"]
    threads = threads or d["threads"]
    stages = stages or d["stages"]
    if (n < 1 or not 0 <= K <= ELL_MAX_K or threads % 32
            or not 32 <= threads <= ELL_MAX_THREADS or nodes % threads
            or not 1 <= stages <= ELL_MAX_STAGES
            or (per_sm is not None and per_sm < 1)):
        raise ValueError(
            f"the ELL gather-sum takes n >= 1, K <= {ELL_MAX_K}, whole warps "
            f"up to {ELL_MAX_THREADS} threads, nodes a multiple of them and "
            f"1 to {ELL_MAX_STAGES} stages, not n = {n}, K = {K}, nodes = "
            f"{nodes}, threads = {threads}, stages = {stages}")
    columns = K * nodes * 4

    def band_of(per):  # floats a ring buffer holds at `per` blocks an SM
        budget = min(build.SMEM_MAX, SM_SMEM // per - BLOCK_RESERVED_SMEM)
        return (budget - ELL_HEADER_BYTES - columns) // stages // 16 * 4

    if per_sm is None:
        per_sm = d["per_sm"]
        while per_sm > 1 and band_of(per_sm) < nodes + 8:
            per_sm -= 1
    band = band_of(per_sm)
    if band < nodes + 8:
        raise ValueError(
            f"the ELL gather-sum's ring of {stages} bands at {per_sm} blocks "
            f"an SM cannot hold {nodes} nodes' band at K = {K}")
    return EllShape(nodes, threads, stages, int(aligned and n % 4 == 0),
                    band, -(-n // nodes),
                    ELL_HEADER_BYTES + columns + stages * band * 4)


def ell_staged_blocks(cols, shape: EllShape) -> int:
    """The blocks of `shape` that stage their band, by the kernel's rule:
    a block's band runs from its least to its greatest column in [0, n),
    rounded out to 16 bytes within the row; it stages when it has such a
    column and that band fits `shape.band` - 4 floats (the rest of a ring
    buffer holds the NaN cell)."""
    K, n = cols.shape
    if K == 0:
        return 0
    B = shape.nodes
    c = cols.long()
    inside = (c >= 0) & (c < n)
    pad = shape.blocks * B - n
    lo = torch.nn.functional.pad(torch.where(inside, c, n), (0, pad), value=n)
    hi = torch.nn.functional.pad(torch.where(inside, c, -1), (0, pad),
                                 value=-1)
    lo = lo.view(K, shape.blocks, B).amin(dim=(0, 2))
    hi = hi.view(K, shape.blocks, B).amax(dim=(0, 2))
    width = torch.clamp((hi // 4 + 1) * 4, max=n) - lo // 4 * 4
    return int(((hi >= 0) & (width <= shape.band - 4)).sum())


def ell_default_shape(X, cols) -> EllShape:
    """ell_shape's default launch for X [C, n] and cols [K, n]."""
    return ell_shape(X.shape[1], cols.shape[0],
                     (X.data_ptr() | cols.data_ptr()) % 16 == 0)


def ell_gather_sum(X, cols, shape: Optional[EllShape] = None, staged=None):
    """out[c, i] = sum_{k < K} X[c, cols[k, i]] of f32 X [C, n] and int32
    cols [K, n], K <= 16 (a column outside [0, n) adds NaN), launched with
    `shape` (default: ell_default_shape).  staged: None, or an int32
    tensor of one element to which the kernel adds the blocks that staged
    their band (the plain version: ell_staged_blocks).  Counted under
    build.probe_key("ell_gather_sum", C, K, n)."""
    C, n = X.shape
    K = cols.shape[0]
    if not build.on_card(X):
        if staged is not None:
            shape = shape or ell_default_shape(X, cols)
            staged += ell_staged_blocks(cols, shape)
        return ell_gather_sum_reference(X, cols)
    if K > ELL_MAX_K:
        raise ValueError(f"the ELL gather-sum takes at most {ELL_MAX_K} "
                         f"slots, not {K}")
    build.check_probe(X.device, {"X": (X, X.shape), "cols": (cols, (K, n))})
    if staged is not None and (staged.dtype != torch.int32
                               or staged.device != X.device
                               or staged.numel() != 1):
        raise ValueError("staged is one int32 on X's device")
    if shape is None:
        shape = ell_default_shape(X, cols)
    out = torch.empty_like(X)
    build.launch_probe(build.probe_key("ell_gather_sum", C, K, n),
                       "ryujin_probe_ell_gather_sum", X.data_ptr(),
                       cols.data_ptr(), out.data_ptr(), build.ptr(staged), C,
                       K, n, *shape)
    return out
