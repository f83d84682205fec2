"""3D layout probe: a (TD + 2)-deep z window of planes over a (D, H, W)
canvas, staged in shared memory and reduced (CUDA kernels
csrc/probe_layout3d.cu; row 14 of the kernel table, the TPU kernels of
scripts/probe_dma3d.py: main's three layouts :83, :117, :168, pk1_shape
:290 and moveaxis_cost :373).

Of the z tiles TD rows deep, gz = D // TD - 2 are interior: tile t reads
rows [t TD, t TD + TD + 2) and writes rows [t TD, t TD + TD).  Output rows
z >= gz TD are 0.  moveaxis and pk1_shape read one plane of what they
stage, so they also return a checksum of everything staged
(staged_checksum_reference)."""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from . import build

# the kernel's WindowMode codes of the three layouts
LAYOUTS = {"plane-major": 0, "z-major": 1, "z-major-slide": 2}
# moveaxis_cost, with (MOV = 1) and without the relayout
MOVEAXIS = {1: 3, 0: 4}
# the three layouts' kernels and moveaxis's (csrc/probe_layout3d.cu): the
# tile widths they are built for, the shared bytes of barriers ahead of the
# staged rows (LAYOUT_BARRIER_BYTES) and the most stages those serve
# (LAYOUT_MAX_STAGES)
LAYOUT_TILES = (64, 128)
LAYOUT_BARRIER_BYTES = 128
LAYOUT_MAX_STAGES = LAYOUT_BARRIER_BYTES // 8 - 1
# the default launch of each layout: tile width, stages and z segments,
# the fastest of tile_sweep layouts at the script's sizes in a CUDA graph
# of 100 calls (NVIDIA H100 80GB HBM3, 700.00 W): full-window 0.0247 ms a
# call, the slide 0.0253 (torch's sums 0.0252-0.0256); moveaxis's of
# tile_sweep moveaxis, 0.0263 (MOV = 1) and 0.0264 (MOV = 0)
LAYOUT_DEFAULTS = {
    "plane-major": {"tile": 64, "stages": 2, "segments": 2},
    "z-major": {"tile": 64, "stages": 2, "segments": 2},
    "z-major-slide": {"tile": 64, "stages": 2, "segments": 6},
    "moveaxis": {"tile": 64, "stages": 2, "segments": 2},
}
# pk1_shape's default launch (pk1_shape_shape): tile width, stages, z
# segments and thread groups (a group is TD x tile threads); the fastest
# of tile_sweep pk1-shape at the script's sizes in a CUDA graph of 100
# calls (NVIDIA H100 80GB HBM3, 700.00 W): 0.0909 ms a call, a block a z
# tile, 4 blocks an SM (one group: 0.0921; 2 stages, 17 segments: 0.0935)
PK1_SHAPE_DEFAULTS = {"tile": 64, "stages": 1, "segments": 34, "groups": 2}


def interior_rows(D: int, TD: int) -> int:
    """gz TD, the rows the interior z tiles write; raises unless gz >= 1."""
    gz = D // TD - 2
    if TD < 1 or gz < 1:
        raise ValueError(f"D = {D} holds no interior z tile of depth TD = {TD}")
    return gz * TD


def _check(tensors, HW, TD):
    if HW % 4 or not 1 <= TD <= 16:
        raise ValueError(
            f"the layout kernels take H * W a multiple of 4 and TD <= 16, "
            f"not H * W = {HW}, TD = {TD}")
    first = next(iter(tensors.values()))[0]
    build.check_probe(first.device, tensors)


def window_sum_reference(h, layout: str, TD: int):
    """Plain torch: out[z] = sum_p h[p, z + 1] (plane-major h [P, D, H, W];
    the z-major layouts take h [D, P, H, W]), summed from 0 in p order."""
    pm = layout == "plane-major"
    P, D = (h.shape[0], h.shape[1]) if pm else (h.shape[1], h.shape[0])
    rows = interior_rows(D, TD)
    acc = torch.zeros((rows,) + tuple(h.shape[2:]), dtype=h.dtype,
                      device=h.device)
    for p in range(P):
        acc = acc + (h[p, 1 : rows + 1] if pm else h[1 : rows + 1, p])
    out = torch.zeros((D,) + tuple(h.shape[2:]), dtype=h.dtype, device=h.device)
    out[:rows] = acc
    return out


class LayoutShape(NamedTuple):
    """Launch shape of a layout kernel: `tile` cells of the (H, W) plane a
    block, `stages` windows (full-window) or groups of TD rows (slide) in
    flight, `blocks` = x tiles x `segments` (runs of z tiles), `threads`
    and `smem` shared bytes a block."""

    tile: int
    stages: int
    blocks: int
    segments: int
    threads: int
    smem: int


@functools.lru_cache(maxsize=64)
def layout_shape(layout: str, P: int, D: int, HW: int, TD: int,
                 tile: Optional[int] = None, stages: Optional[int] = None,
                 segments: Optional[int] = None) -> LayoutShape:
    """The launch of `layout`'s kernel (or of "moveaxis"'s, both MOV) on a
    (D, H, W) canvas of P planes, HW = H W cells a plane: x tiles of
    `tile` cells x `segments` runs of the gz z tiles (at most gz), a block
    each, with a ring of `stages` windows of TD + 2 rows (full-window:
    plane-major, z-major, moveaxis) or of TD + 2 + stages TD rows
    (z-major-slide), P planes of `tile` cells a row.  Defaults:
    LAYOUT_DEFAULTS, the stages cut to what fits the shared memory.
    Raises ValueError where nothing fits.  Cached, so that a launch spends
    little host time on it."""
    if layout not in LAYOUT_DEFAULTS:
        raise ValueError(f"unknown layout {layout!r}; one of "
                         f"{tuple(LAYOUT_DEFAULTS)}")
    gz = interior_rows(D, TD) // TD
    d = LAYOUT_DEFAULTS[layout]
    tile = tile or d["tile"]
    if tile not in LAYOUT_TILES or not 1 <= P <= 256 or HW < 1:
        raise ValueError(f"the layout kernels take a tile of {LAYOUT_TILES} "
                         f"cells, 1 <= P <= 256 and HW >= 1, not {tile}, "
                         f"{P}, {HW}")
    wz = TD + 2

    def smem_of(s):
        rows = wz + s * TD if layout == "z-major-slide" else s * wz
        return LAYOUT_BARRIER_BYTES + rows * P * tile * 4

    if stages is None:
        stages = d["stages"]
        while stages > 1 and smem_of(stages) > build.SMEM_MAX:
            stages -= 1
    smem = smem_of(stages)
    if not 1 <= stages <= LAYOUT_MAX_STAGES or smem > build.SMEM_MAX:
        raise ValueError(f"{layout}: {stages} stages of P = {P}, TD = {TD}, "
                         f"tile {tile} take {smem} shared bytes; at most "
                         f"{LAYOUT_MAX_STAGES} stages and {build.SMEM_MAX} "
                         "bytes")
    segments = min(segments or d["segments"], gz)
    return LayoutShape(tile, stages, -(-HW // tile) * segments, segments,
                       min(1024, TD * tile), smem)


@functools.lru_cache(maxsize=64)
def pk1_shape_shape(cen_pl: int, planes: tuple, D: int, HW: int, TD: int,
                    tile: Optional[int] = None, stages: Optional[int] = None,
                    segments: Optional[int] = None,
                    threads: Optional[int] = None) -> LayoutShape:
    """The launch of pk1_shape's kernel for a centre of cen_pl planes (0:
    none) and windows of `planes` planes (a tuple, at most 3) on a
    (D, H, W) canvas, HW = H W cells a plane: x tiles of `tile` cells x
    `segments` runs of the gz z tiles (at most gz), a block each, with a
    ring of `stages` z tiles, each the centre's TD rows and each window's
    TD + 2 rows of all their planes, `tile` cells a row, one TMA box a
    part; `threads` a multiple of TD tile (its groups split the checksum
    and the output planes).  smem: the barriers, the ring and the groups'
    partial checksums ([2][groups - 1][TD tile] words).  Defaults:
    PK1_SHAPE_DEFAULTS (tile 64 where TD 128 > 1024 threads), the stages
    cut to what fits the shared memory, the groups to 1024 threads.
    Raises ValueError where a box cannot take a part (more than 256 planes
    or TD + 2 > 256 rows, H W not a multiple of 4) or nothing fits."""
    gz = interior_rows(D, TD) // TD
    d = PK1_SHAPE_DEFAULTS
    planes = tuple(planes)
    if (HW < 1 or HW % 4 or not 0 <= cen_pl <= 256 or TD + 2 > 256
            or len(planes) > 3 or not all(1 <= p <= 256 for p in planes)
            or not (cen_pl or planes)):
        raise ValueError(
            f"pk1_shape takes H * W a multiple of 4, a centre of at most 256 "
            f"planes and 0 to 3 windows of 1 to 256 planes (not none of "
            f"either), TD + 2 <= 256, not H * W = {HW}, CENPL = {cen_pl}, "
            f"windows {planes}, TD = {TD}")
    tile = tile or (d["tile"] if TD * d["tile"] <= 1024 else 64)
    rows = TD * tile
    if threads is None:
        threads = max(1, min(d["groups"], 1024 // rows)) * rows
    if tile not in LAYOUT_TILES or threads % rows or not rows <= threads <= 1024:
        raise ValueError(f"pk1_shape takes a tile of {LAYOUT_TILES} cells and "
                         f"whole groups of TD * tile = {rows} threads, at "
                         f"most 1024, not {tile}, {threads}")
    stage = (TD * cen_pl + (TD + 2) * sum(planes)) * tile * 4

    def smem_of(s):
        return (LAYOUT_BARRIER_BYTES + s * stage
                + 2 * (threads // rows - 1) * rows * 4)

    if stages is None:
        stages = d["stages"]
        while stages > 1 and smem_of(stages) > build.SMEM_MAX:
            stages -= 1
    smem = smem_of(stages)
    if not 1 <= stages <= LAYOUT_MAX_STAGES or smem > build.SMEM_MAX:
        raise ValueError(f"pk1_shape: {stages} stages of {stage} bytes and "
                         f"{threads} threads take {smem} shared bytes; at most "
                         f"{LAYOUT_MAX_STAGES} stages and {build.SMEM_MAX} "
                         "bytes")
    segments = min(segments or d["segments"], gz)
    return LayoutShape(tile, stages, -(-HW // tile) * segments, segments,
                       threads, smem)


def moveaxis_map(P: int, D: int, HW: int, TD: int, tile: int, mov: int):
    """(dims, byte strides of the outer two, box), innermost first, of the
    tensor map moveaxis's kernel encodes over a z-major h [D, P, HW]
    (csrc/probe_layout3d.cu encode_windows); the box at coordinates
    (q0, z0, 0) for mov = 1, (q0, 0, z0) for mov = 0, is the window of z
    tile z0 / TD at cells q0 ..: for mov = 1 the dimensions run (cell, z,
    plane), so that it lands plane-major, h[z0 : z0 + TD + 2, :,
    q0 : q0 + tile].movedim(0, 1); for mov = 0 (cell, plane, z), the
    window as it lies."""
    plane, row = HW * 4, P * HW * 4
    if mov:
        return (HW, D, P), (row, plane), (tile, TD + 2, P)
    return (HW, P, D), (plane, row), (tile, P, TD + 2)


def window_sum(h, layout: str, TD: int, shape: Optional[LayoutShape] = None):
    """out [D, H, W] of window_sum_reference through the layout's kernel,
    launched with `shape` (default: layout_shape's).  Counted under
    build.probe_key("window_sum", layout)."""
    if not build.on_card(h):
        return window_sum_reference(h, layout, TD)
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}; one of {tuple(LAYOUTS)}")
    pm = layout == "plane-major"
    P, D, H, W = h.shape if pm else (h.shape[1], h.shape[0]) + h.shape[2:]
    _check({"h": (h, h.shape)}, H * W, TD)
    if shape is None:
        shape = layout_shape(layout, P, D, H * W, TD)
    out = torch.empty((D, H, W), dtype=h.dtype, device=h.device)
    build.launch_probe(build.probe_key("window_sum", layout),
                       "ryujin_probe_layout", LAYOUTS[layout], h.data_ptr(),
                       out.data_ptr(), P, D, H * W, TD, *shape)
    return out


def staged_checksum_reference(parts, TD: int):
    """Plain torch: check [D, H, W], int32, of the z-major f32 stacks
    parts = [(h [D, p, H, W], depth), ...] that a z tile stages depth rows
    deep: for z = t TD + zo < gz TD, the XOR of the bit patterns of
    h[t TD + zl, p] over the parts, every plane p, rows zl = zo, zo + TD,
    ... < depth; 0 for z >= gz TD."""
    first = parts[0][0]
    D = first.shape[0]
    rows = interior_rows(D, TD)
    check = torch.zeros((D,) + tuple(first.shape[2:]), dtype=torch.int32,
                        device=first.device)
    for zo in range(TD):
        acc = torch.zeros_like(check[zo:rows:TD])
        for h, depth in parts:
            for p in range(h.shape[1]):
                for zl in range(zo, depth, TD):
                    acc ^= h[zl : zl + rows : TD, p].view(torch.int32)
        check[zo:rows:TD] = acc
    return check


def moveaxis_reference(h, TD: int, mov: int):
    """Plain torch: (out, check) of a z-major h [D, P, H, W]: out[z] =
    0 + h[z + 1, 0] (with mov = 1 read through h moved to plane-major
    [P, D, H, W]), check the checksum (staged_checksum_reference) of every
    tile's TD + 2 staged rows of all P planes."""
    D = h.shape[0]
    rows = interior_rows(D, TD)
    src = h.movedim(0, 1)[0] if mov else h[:, 0]
    out = torch.zeros((D,) + tuple(h.shape[2:]), dtype=h.dtype, device=h.device)
    out[:rows] = out[:rows] + src[1 : rows + 1]
    return out, staged_checksum_reference([(h, TD + 2)], TD)


def moveaxis(h, TD: int, mov: int, shape: Optional[LayoutShape] = None):
    """(out [D, H, W], check [D, H, W] int32) of moveaxis_reference; the
    kernel stages all P planes of each window with one TMA box, for mov =
    1 through a tensor map whose box lands plane-major (the relayout done
    by the copy engine), and both outputs read it there.  Launched with
    `shape` (default: layout_shape("moveaxis", ...)).  Counted under
    build.probe_key("moveaxis", f"MOV={mov}")."""
    if not build.on_card(h):
        return moveaxis_reference(h, TD, mov)
    D, P, H, W = h.shape
    interior_rows(D, TD)
    _check({"h": (h, h.shape)}, H * W, TD)
    if shape is None:
        shape = layout_shape("moveaxis", P, D, H * W, TD)
    out = torch.empty((D, H, W), dtype=h.dtype, device=h.device)
    check = torch.empty((D, H, W), dtype=torch.int32, device=h.device)
    build.launch_probe(build.probe_key("moveaxis", f"MOV={int(mov)}"),
                       "ryujin_probe_window", MOVEAXIS[int(mov)], h.data_ptr(),
                       out.data_ptr(), check.data_ptr(), P, D, H * W, TD,
                       *shape)
    return out, check


def pk1_shape_reference(cen, wins, TD: int, out_pl: int):
    """Plain torch: (out, check).  out[z, o] = sum_i wins[i][z + 1, 0]
    (+ cen[z, 0]) for o < out_pl, summed from 0, windows first; cen
    [D, CENPL, H, W] or None, wins [D, p_i, H, W].  check [D, H, W] is the
    checksum (staged_checksum_reference) of every tile's TD + 2 staged rows
    of each window and TD rows of the centre, all planes."""
    first = cen if cen is not None else wins[0]
    D, _, H, W = first.shape
    rows = interior_rows(D, TD)
    acc = torch.zeros((rows, H, W), dtype=first.dtype, device=first.device)
    for h in wins:
        acc = acc + h[1 : rows + 1, 0]
    if cen is not None:
        acc = acc + cen[:rows, 0]
    out = torch.zeros((D, out_pl, H, W), dtype=first.dtype, device=first.device)
    out[:rows] = acc[:, None]
    parts = [(h, TD + 2) for h in wins]
    if cen is not None:
        parts.append((cen, TD))
    return out, staged_checksum_reference(parts, TD)


def pk1_shape(cen, wins, TD: int, out_pl: int,
              shape: Optional[LayoutShape] = None):
    """(out [D, out_pl, H, W], check [D, H, W] int32) of
    pk1_shape_reference; the kernel stages the centre's TD rows and each
    window's TD + 2 rows, every plane, one TMA box a part, and both
    outputs read them from there.  Every tensor's base 16-byte aligned.
    Launched with `shape` (default: pk1_shape_shape's).  Counted under
    build.probe_key("pk1_shape")."""
    first = cen if cen is not None else wins[0]
    if not build.on_card(first):
        return pk1_shape_reference(cen, wins, TD, out_pl)
    if len(wins) > 3 or (cen is None and not wins):
        raise ValueError("pk1_shape takes a centre or 1 to 3 windows, at most 3 windows")
    D, _, H, W = first.shape
    interior_rows(D, TD)
    tensors = {f"h{i}": (h, (D, h.shape[1], H, W)) for i, h in enumerate(wins)}
    if cen is not None:
        tensors["cen"] = (cen, (D, cen.shape[1], H, W))
    _check(tensors, H * W, TD)
    if any(t.data_ptr() % 16 for t, _ in tensors.values()):
        raise ValueError("pk1_shape's tensor maps take 16-byte aligned bases")
    cen_pl = 0 if cen is None else cen.shape[1]
    planes = tuple(h.shape[1] for h in wins)
    default = pk1_shape_shape(cen_pl, planes, D, H * W, TD)
    out = torch.empty((D, out_pl, H, W), dtype=first.dtype, device=first.device)
    check = torch.empty((D, H, W), dtype=torch.int32, device=first.device)
    ptrs = [h.data_ptr() for h in wins] + [None] * (3 - len(wins))
    build.launch_probe(
        build.probe_key("pk1_shape"), "ryujin_probe_pk1_shape", build.ptr(cen),
        *ptrs, out.data_ptr(), check.data_ptr(), len(wins),
        *(planes + (0,) * (3 - len(planes))), cen_pl, out_pl, D, H * W, TD,
        *(shape or default))
    return out, check
