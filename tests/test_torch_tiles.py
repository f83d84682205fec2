"""The launch shapes of the tiled kernels, pk1_stream, pk2_stream,
pk3_stream, the stacked pk1, pk2 and pk3 and pk_up, on the CPU: each
instance's tile fits the card's shared memory, stages a halo of the
lattice reach, and its grid covers every cell of the bench canvases and
of the small test canvases, ragged edges included; the C side of the
launch (the Consts struct, the entry points, the staged layouts) mirrors
what the wrappers pass; and the launches of the sublane gather probe,
of the ELL gather-sum, of the layout probe's three layouts and moveaxis
and of the pow probe's two kernels cover their outputs and fit their
windows in shared memory and their blocks on the card; moveaxis's tensor
maps land the windows the kernel reads."""

import itertools
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ryujin_tpu_torch.kernels import (  # noqa: E402
    build, pk1, pk1_stream, pk2, pk2_stream, pk3, pk3_stream, pk_up,
    probe_gather, probe_layout3d, probe_pow,
)
from ryujin_tpu_torch.offline.structured import lattice_offsets  # noqa: E402

CSRC = build.CSRC
DTYPES = (torch.float32, torch.float64)
# (dim, K) of every pk1_stream, pk2_stream, pk3_stream and pk_up instance:
# 2D reach 1
# (the stream kernels on step2d's canvas, dG Q1) and reach 2 (cG / dG Q2),
# 3D reach 1
INSTANCES = ((2, 8), (2, 24), (3, 26))
# canvases the kernels launch on: the bench cells (chip_smoke.py setup
# lines: step2d and q2step2d, box3d and dg1box3d, cylinder3d) and the small
# canvases of chip_smoke.py phases 2, 6b, 8b, 8c, 10b and of the gpu tests
# (the K = 8 step at refinement 0, the boxes at refinement 1, the dG steps
# at refinement 0, the cylinder at refinement 1 with pad_minor 32, the
# ragged box and steps of test_torch_gpu.py: cG Q2, and the K = 8 cG Q1
# step and dG Q1 rectangle)
SHAPES = {
    2: [(664, 2048), (104, 256), (176, 512), (256, 768), (165, 496),
        (83, 248), (18, 48)],
    3: [(72, 72, 128), (72, 40, 128), (16, 16, 128), (24, 16, 32),
        (7, 7, 16)],
}


def _covers(tile, shape, cells):
    """The grid covers the canvas, and no block lies wholly past it;
    cells: the (x, y[, z]) extent of the cells a block owns."""
    D, H, W = build.canvas_dims(shape)
    gx, gy, gz = tile.grid
    ty, tz = cells[1], (cells + (1,))[2]
    assert gx * cells[0] >= W and (gx - 1) * cells[0] < W
    assert gy * ty >= H and (gy - 1) * ty < H
    if len(shape) == 3:
        assert gz * tz >= D and (gz - 1) * tz < D
    else:
        assert gz == 1 and tz == 1


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dim,K", INSTANCES)
def test_pk3_stream_tile_fits_and_covers(dim, K, dtype):
    reach = max(abs(v) for o in lattice_offsets(dim, build.reach_of(dim, K))
                for v in o)
    assert len(lattice_offsets(dim, reach)) == K
    item = torch.empty((), dtype=dtype).element_size()
    for stages in range(build.MAX_STAGES + 1):
        for shape in SHAPES[dim]:
            t = pk3_stream.tile(shape, K, dtype, stages)
            bx, ty, groups = t.block
            assert bx == pk3_stream.TX == 32 and groups == (2 if dim == 3 else 1)
            assert bx * ty * groups <= 256  # __launch_bounds__(256)
            assert t.halo == reach
            assert 0 < t.smem <= build.SMEM_MAX
            # U and the parts of f(U), each stage's flux parts, F, m_j and
            # alpha_j a staged cell, and one okp flag a tile cell
            vals = (dim + 2) + (dim + 2) + stages * (2 * dim + 2) + (dim + 2) + 2
            staged = (bx + 2 * reach) * (ty + 2 * reach) * (
                1 + 2 * reach if dim == 3 else 1)
            assert t.smem == vals * staged * item + ty * bx * 4
            _covers(t, shape, (bx, ty))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dim,K", INSTANCES)
def test_pk2_stream_tile_fits_and_covers(dim, K, dtype):
    reach = build.reach_of(dim, K)
    item = torch.empty((), dtype=dtype).element_size()
    for stages in range(build.MAX_STAGES + 1):
        for shape in SHAPES[dim]:
            t = pk2_stream.tile(shape, K, dtype, stages)
            bx, ty, tz = t.block
            assert bx == pk2_stream.TX == 32 and ty >= 1 and tz >= 1
            assert bx * ty * tz <= 256  # __launch_bounds__(256)
            assert t.halo == reach
            assert 0 < t.smem <= build.SMEM_MAX
            # U and the parts of f(U), alpha_j and s_j, and each stage's
            # flux parts a staged cell; one z in 2D
            vals = (dim + 2) + (dim + 2) + 2 + stages * (2 * dim + 2)
            staged = (bx + 2 * reach) * (ty + 2 * reach) * (
                tz + 2 * reach if dim == 3 else 1)
            assert t.smem == vals * staged * item
            _covers(t, shape, t.block)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dim,K", INSTANCES)
def test_pk1_stream_tile_fits_and_covers(dim, K, dtype):
    reach = build.reach_of(dim, K)
    item = torch.empty((), dtype=dtype).element_size()
    for shape in SHAPES[dim]:
        t = pk1_stream.tile(shape, K, dtype)
        bx, ty, tz = t.block
        assert bx == pk1_stream.TX == 32 and ty >= 1 and tz >= 1
        assert bx * ty * tz <= 256  # __launch_bounds__(256)
        assert t.halo == reach
        assert 0 < t.smem <= build.SMEM_MAX
        # U and the parts of f(U), a, 1/rho, 1/p, log2 p and eta_j / rho_j
        # a staged cell; one z in 2D
        vals = (dim + 2) + (dim + 2) + 4 + 1
        staged = (bx + 2 * reach) * (ty + 2 * reach) * (
            tz + 2 * reach if dim == 3 else 1)
        assert t.smem == vals * staged * item
        _covers(t, shape, t.block)


@pytest.mark.parametrize("dtype", DTYPES)
def test_pk1_tile_fits_and_covers(dtype):
    """The stacked pk1 (2D, K = 8): pk1_stream's 2D layout, 13 values a
    staged cell, one thread a cell and the halo of one cell."""
    item = torch.empty((), dtype=dtype).element_size()
    for shape in SHAPES[2]:
        t = pk1.tile(shape, 8, dtype)
        bx, ty, tz = t.block
        assert bx == pk1.TX == 32 and tz == 1 and bx * ty <= 256
        assert t.halo == 1
        assert t.smem == 13 * (bx + 2) * (ty + 2) * item
        assert t.smem == pk1_stream.tile(shape, 8, dtype).smem
        assert 0 < t.smem <= build.SMEM_MAX
        _covers(t, shape, (bx, ty))
    with pytest.raises(ValueError):
        pk1.tile((165, 496), 24, dtype)
    with pytest.raises(ValueError):
        pk1.tile((8, 64, 64), 26, dtype)


@pytest.mark.parametrize("S", [1, 8, 64, 300, 512, 1024, 1816])
def test_sublane_gather_shape_covers_and_fits(S):
    """The sublane gather's launch (column tiles x row groups) covers
    every (s, l) of x [S, L] once, at the probe's L = 128 and ragged ones,
    with no block wholly past the array; each block's window (S rows of 32
    columns) fits the shared memory up to the stated largest S, 1816; at
    S = 1024, L = 128 it launches more than the L / 32 blocks of one
    block a tile; a larger S raises."""
    for L in (128, 70, 33, 1):
        for groups in (None, 1, 3, 8, 64, 10_000):
            sh = probe_gather.sublane_shape(S, L, groups)
            assert sh.threads == probe_gather.SUBLANE_THREADS == 256
            assert sh.smem == S * 32 * 4 <= build.SMEM_MAX
            tile = probe_gather.SUBLANE_TILE
            assert sh.tiles * tile >= L > (sh.tiles - 1) * tile
            assert sh.groups * sh.rows >= S > (sh.groups - 1) * sh.rows
            covered = torch.zeros((S, L), dtype=torch.int32)
            for gx in range(sh.tiles):
                for gy in range(sh.groups):
                    covered[gy * sh.rows: (gy + 1) * sh.rows,
                            gx * tile: (gx + 1) * tile] += 1
            assert bool((covered == 1).all())
            if groups is None:
                assert sh.rows >= min(S, probe_gather.SUBLANE_MIN_ROWS)
    if S == 1024:
        assert probe_gather.sublane_shape(S, 128).groups * 4 > 128 // 32
    largest = build.SMEM_MAX // (32 * 4)
    assert largest == 1816
    assert "S up to 1816" in " ".join(probe_gather.sublane_gather.__doc__.split())
    with pytest.raises(ValueError):
        probe_gather.sublane_shape(largest + 1, 128)


def _layout_written(sh, D, HW, TD):
    """How often each (interior z tile, cell) is written by the launch
    `sh`, as the kernels split the work (csrc/probe_layout3d.cu): block
    (x tile, segment) the z tiles [gz segment / S, gz (segment + 1) / S),
    S segments; each segment's first window lies within D."""
    gz = D // TD - 2
    tiles = -(-HW // sh.tile)
    assert sh.blocks == tiles * sh.segments and 1 <= sh.segments <= gz
    written = torch.zeros((gz, HW), dtype=torch.int32)
    for seg in range(sh.segments):
        t0, t1 = gz * seg // sh.segments, gz * (seg + 1) // sh.segments
        assert t1 > t0 and 0 <= t0 * TD and t0 * TD + TD + 2 <= D
        for x in range(tiles):
            written[t0:t1, x * sh.tile:(x + 1) * sh.tile] += 1
    return written


@pytest.mark.parametrize("P,D,H,W,TD", [
    (24, 72, 72, 128, 2),  # the script's sizes
    (3, 8, 4, 8, 2), (3, 8, 4, 8, 1),  # the CPU tests' sizes
    (5, 20, 5, 36, 3), (2, 9, 3, 44, 1),  # ragged H W, one tile or several
])
def test_layout_shape_covers_and_fits(P, D, H, W, TD):
    """The three layouts' launches and moveaxis's (as the full-window
    kernels'), by default and over the candidates of tile_sweep layouts:
    every interior z tile and every (H, W) cell is
    written exactly once; each segment's first window lies within D; the
    full-window ring holds `stages` windows of TD + 2 rows, the slide's
    TD + 2 + stages TD rows; the shared bytes are the barriers and those
    rows of P planes of `tile` cells and fit 232,448 B; the threads fit
    1,024."""
    from ryujin_tpu_torch.tile_sweep import LAYOUT_CANDIDATES

    HW = H * W
    for layout in (*probe_layout3d.LAYOUTS, "moveaxis"):
        slide = layout == "z-major-slide"
        cand = LAYOUT_CANDIDATES["slide" if slide else "full"]
        kinds = [{}] + [dict(zip(cand, values))
                        for values in itertools.product(*cand.values())]
        for kw in kinds:
            try:
                sh = probe_layout3d.layout_shape(layout, P, D, HW, TD, **kw)
            except ValueError:
                assert kw, "the default launch always fits"
                continue
            rows = TD + 2 + sh.stages * TD if slide else sh.stages * (TD + 2)
            assert sh.smem == (probe_layout3d.LAYOUT_BARRIER_BYTES
                               + rows * P * sh.tile * 4)
            assert sh.smem <= build.SMEM_MAX == 232448
            assert sh.threads == min(1024, TD * sh.tile) <= 1024
            assert 1 <= sh.stages <= probe_layout3d.LAYOUT_MAX_STAGES
            written = _layout_written(sh, D, HW, TD)
            assert bool((written == 1).all()), (layout, sh)
    for bad in ({"tile": 32}, {"stages": 16}, {"stages": 0}):
        with pytest.raises(ValueError):
            probe_layout3d.layout_shape("z-major", P, D, HW, TD, **bad)
    with pytest.raises(ValueError):
        probe_layout3d.layout_shape("z-major", 257, D, HW, TD)
    with pytest.raises(ValueError):
        probe_layout3d.layout_shape("diagonal", P, D, HW, TD)


@pytest.mark.parametrize("cen_pl,planes,D,H,W,TD", [
    (78, (5, 4, 2), 72, 72, 128, 2),  # the script's sizes
    (7, (5, 4, 2), 13, 4, 40, 2),  # the gpu tests' probe sizes
    (78, (5, 4, 2), 20, 9, 20, 1), (78, (5, 4, 2), 20, 9, 20, 4),
    (0, (5, 4, 2), 20, 9, 20, 2), (78, (), 20, 9, 20, 2),
    (78, (5,), 20, 9, 20, 4), (0, (5, 4), 20, 9, 20, 1),  # partial tiles
    (256, (16,), 9, 1, 4, 1), (0, (200,), 9, 1, 4, 1),
    (3, (2,), 72, 4, 8, 16),
])
def test_pk1_shape_shape_covers_and_fits(cen_pl, planes, D, H, W, TD):
    """pk1_shape's launches, by default and over the candidates of
    tile_sweep pk1-shape: every interior z tile and every (H, W) cell is
    written exactly once (as the layouts split the work); the ring holds
    `stages` z tiles of the centre's TD rows and each window's TD + 2
    rows of all their planes, the groups' partial checksums two words a
    thread past the first group, within 232,448 B; the threads are whole
    groups of TD tile, at most 1,024."""
    from ryujin_tpu_torch.tile_sweep import LAYOUT_CANDIDATES

    HW = H * W
    cand = LAYOUT_CANDIDATES["pk1_shape"]
    kinds = [{}] + [dict(zip(cand, values))
                    for values in itertools.product(*cand.values())]
    fitted = 0
    for kw in kinds:
        try:
            sh = probe_layout3d.pk1_shape_shape(cen_pl, planes, D, HW, TD,
                                                **kw)
        except ValueError:
            assert kw, "the default launch always fits"
            continue
        fitted += 1
        rows = TD * sh.tile
        stage = (TD * cen_pl + (TD + 2) * sum(planes)) * sh.tile * 4
        assert sh.smem == (probe_layout3d.LAYOUT_BARRIER_BYTES
                           + sh.stages * stage
                           + 2 * (sh.threads // rows - 1) * rows * 4)
        assert sh.smem <= build.SMEM_MAX
        assert sh.threads % rows == 0 and rows <= sh.threads <= 1024
        assert 1 <= sh.stages <= probe_layout3d.LAYOUT_MAX_STAGES
        assert bool((_layout_written(sh, D, HW, TD) == 1).all()), sh
    assert fitted > 1


@pytest.mark.parametrize("bad", [
    {"cen_pl": 257}, {"planes": (5, 257)}, {"planes": (5, 4, 2, 1)},
    {"cen_pl": 0, "planes": ()}, {"planes": (5, 0)}, {"H": 9, "W": 21},
    {"TD": 255, "D": 800}, {"tile": 32}, {"threads": 192},
    {"threads": 2048}, {"stages": 0}, {"stages": 16}, {"stages": 5},
    {"tile": 128, "TD": 16, "D": 72},
])
def test_pk1_shape_shape_refuses(bad):
    """pk1_shape_shape raises ValueError where a TMA box cannot take a
    part (more than 256 planes, TD + 2 > 256 rows, H W not a multiple of
    4), for more than 3 windows or no part at all, and for a launch the C
    side refuses (a tile of 32, threads that are not whole groups of TD
    tile or more than 1024, stages outside 1 .. 15 or past the shared
    memory)."""
    args = {"cen_pl": 78, "planes": (5, 4, 2), "D": 72, "H": 72, "W": 128,
            "TD": 2}
    args.update({k: v for k, v in bad.items() if k in args})
    launch = {k: v for k, v in bad.items() if k not in args}
    with pytest.raises(ValueError):
        probe_layout3d.pk1_shape_shape(args["cen_pl"], args["planes"],
                                       args["D"], args["H"] * args["W"],
                                       args["TD"], **launch)


@pytest.mark.parametrize("W", [1, 3, 128, 2047, 2048, 58112])
def test_lane_shape_covers_and_fits(W):
    """The lane gather's launches (rows x column groups), by default and
    over the candidates of tile_sweep gather, aligned and not: each
    group's vectors cover the row's W columns once, none wholly past it,
    at most LANE_ITEMS vectors a thread; vectors of 4 only where W % 4 ==
    0 and aligned; the row fits the shared memory up to the stated
    largest W, 58,112; at P = 8, W = 2048 the default launches more than
    the 8 blocks of one block a row; a larger W raises."""
    from ryujin_tpu_torch.tile_sweep import LANE_CANDIDATES

    for P, aligned in itertools.product((1, 8), (True, False)):
        kinds = [{}] + [dict(zip(LANE_CANDIDATES, values)) for values in
                        itertools.product(*LANE_CANDIDATES.values())]
        for kw in kinds:
            sh = probe_gather.lane_shape(P, W, aligned=aligned, **kw)
            assert sh.vec == (4 if aligned and W % 4 == 0 else 1)
            nvec = W // sh.vec
            assert sh.groups * sh.span >= nvec > (sh.groups - 1) * sh.span
            assert sh.span <= probe_gather.LANE_ITEMS * sh.threads
            assert sh.threads % 32 == 0 and 32 <= sh.threads <= 1024
            assert sh.smem == W * 4 <= build.SMEM_MAX
            covered = np.zeros(W, dtype=int)
            for g in range(sh.groups):
                covered[g * sh.span * sh.vec:(g + 1) * sh.span * sh.vec] += 1
            assert (covered == 1).all()
    if W == 2048:
        assert probe_gather.lane_shape(8, W).groups > 1
    assert build.SMEM_MAX // 4 == 58112
    assert "W up to 58,112" in " ".join(probe_gather.lane_gather.__doc__.split())
    for bad in ({"W": 58113}, {"threads": 48}, {"threads": 2048},
                {"P": 0}):
        args = {"P": 8, "W": W, **bad}
        with pytest.raises(ValueError):
            probe_gather.lane_shape(args["P"], args["W"],
                                    threads=args.get("threads"))


def test_moveaxis_map_lands_the_moved_window():
    """moveaxis_map's dimensions, strides and box, applied with as_strided
    at a window's coordinates, take h[z0 : z0 + wz, :, q0 : q0 + tile]
    moved to plane-major (MOV = 1) or as it lies (MOV = 0); the C side
    (encode_windows, the box's coordinates in moveaxis_kernel) encodes the
    same."""
    P, D, H, W = 5, 13, 4, 48
    HW = H * W
    h = torch.arange(D * P * HW, dtype=torch.float32).view(D, P, HW)
    for TD, tile, mov in itertools.product((1, 2, 4), (64, 128), (1, 0)):
        dims, strides, box = probe_layout3d.moveaxis_map(P, D, HW, TD, tile,
                                                         mov)
        assert dims == ((HW, D, P) if mov else (HW, P, D))
        assert box[0] == tile and sorted(box[1:]) == sorted((TD + 2, P))
        for z0, q0 in ((0, 0), (TD, 0), ((D // TD - 3) * TD, HW - tile)):
            coord = (q0, z0, 0) if mov else (q0, 0, z0)
            view = torch.as_strided(
                h, size=box[::-1], stride=(strides[1] // 4, strides[0] // 4, 1),
                storage_offset=(coord[0] + coord[1] * strides[0] // 4
                                + coord[2] * strides[1] // 4))
            window = h[z0:z0 + TD + 2, :, q0:q0 + tile]
            assert torch.equal(view, window.movedim(0, 1) if mov else window)
    src = (CSRC / "probe_layout3d.cu").read_text()
    for mirrored in (
            "const cuuint64_t plane = cuuint64_t(HW) * sizeof(float), "
            "row = cuuint64_t(P) * plane;",
            "const cuuint64_t dims[3] = {cuuint64_t(HW), cuuint64_t(moved ? D "
            ": P),\n                              cuuint64_t(moved ? P : D)};",
            "const cuuint64_t strides[2] = {moved ? row : plane, moved ? plane "
            ": row};",
            "const cuuint32_t box[3] = {cuuint32_t(tile), cuuint32_t(moved ? "
            "wz : P),\n                             cuuint32_t(moved ? P : "
            "wz)};",
            "encode_windows(&map[m], src, mode == MOVEAXIS, P, D, HW, TD + 2, "
            "TILE);",
            "tma_copy_3d(buf + k % stages * window, &map, q0, MODE == MOVEAXIS "
            "? z0 : 0,\n                MODE == MOVEAXIS ? 0 : z0, b);"):
        assert mirrored in src, mirrored


def _ell_written(sh, n):
    """How often each of the n nodes is taken by the launch `sh`, as
    csrc/probe_gather.cu splits the work: block b, thread t, the nodes
    b nodes + t, + threads, ... of the block's nodes that lie below n."""
    b, j, t = np.meshgrid(np.arange(sh.blocks),
                          np.arange(sh.nodes // sh.threads),
                          np.arange(sh.threads), indexing="ij")
    node = (b * sh.nodes + t + j * sh.threads).ravel()
    return np.bincount(node[node < n], minlength=n)


@pytest.mark.parametrize("n", [1, 9, 1000, (1 << 20) + 3])
def test_ell_shape_covers_and_fits(n):
    """The ELL gather-sum's launches, by default and over the candidates
    of tile_sweep ell, for K = 0, 1, 9 and 16 slots, on an aligned X and
    not: every node is taken by exactly one thread; whole warps up to 512
    threads, nodes a multiple of them; the header, the block's columns and
    `stages` bands of whole 16-byte pieces fill the shared bytes, which
    fit 232,448 B and leave room for `per_sm` blocks an SM; each band
    holds a block's own nodes and the NaN cell; bulk copies only on
    aligned X and cols with n % 4 == 0.  A shape that
    cannot be raises."""
    from ryujin_tpu_torch.tile_sweep import ELL_CANDIDATES

    kg = probe_gather
    kinds = [{}] + [dict(zip(ELL_CANDIDATES, values))
                    for values in itertools.product(*ELL_CANDIDATES.values())]
    covered = {}
    for K, aligned, kw in itertools.product((0, 1, 9, 16), (True, False),
                                            kinds):
        try:
            sh = kg.ell_shape(n, K, aligned, **kw)
        except ValueError:
            assert kw, "the default launch always fits"
            continue
        assert sh.threads % 32 == 0 and 32 <= sh.threads <= 512
        assert sh.nodes % sh.threads == 0
        assert (sh.blocks - 1) * sh.nodes < n <= sh.blocks * sh.nodes
        key = (sh.nodes, sh.threads, sh.blocks)
        if key not in covered:
            covered[key] = bool((_ell_written(sh, n) == 1).all())
        assert covered[key], sh
        assert sh.band % 4 == 0 and sh.band >= sh.nodes + 8
        assert sh.smem == (kg.ELL_HEADER_BYTES + K * sh.nodes * 4
                           + sh.stages * sh.band * 4) <= build.SMEM_MAX
        per_sm = kw.get("per_sm", 1)
        assert sh.smem <= kg.SM_SMEM // per_sm - kg.BLOCK_RESERVED_SMEM
        assert 1 <= sh.stages <= kg.ELL_MAX_STAGES
        assert sh.bulk == int(aligned and n % 4 == 0)
    for bad in ({"K": 17}, {"threads": 48}, {"nodes": 1000}, {"stages": 9},
                {"nodes": 4096, "stages": 3, "per_sm": 2},
                {"nodes": 2048, "per_sm": 4}, {"per_sm": 0}):
        K = bad.pop("K", 9)
        with pytest.raises(ValueError):
            kg.ell_shape(n, K, True, **bad)


def test_ell_launch_mirrors_the_c_side():
    """csrc/probe_gather.cu's ELL entry point takes the wrapper's
    arguments, the launch shape last in EllShape's order; its limits are
    the wrapper's; and the layout it accepts is ell_shape's."""
    src = (CSRC / "probe_gather.cu").read_text()
    kg = probe_gather
    for name in ("ELL_MAX_K", "ELL_MAX_THREADS", "ELL_MAX_STAGES",
                 "ELL_HEADER_BYTES"):
        assert f"constexpr int {name} = {getattr(kg, name)};" in src
    for mirrored in (
            "threads < 32 || threads % 32 != 0 || threads > ELL_MAX_THREADS || "
            "nodes < threads ||\n      nodes % threads != 0",
            "(bulk && !aligned) || band < 8 ||\n      band % 4 != 0",
            "((reinterpret_cast<uintptr_t>(X) | reinterpret_cast<uintptr_t>"
            "(cols)) & 15) == 0 &&\n      n % 4 == 0",
            "int64_t(blocks) != (n + nodes - 1) / nodes",
            "const int64_t offs = int64_t(K) * nodes * int64_t(sizeof(int));",
            "int64_t(smem) != ELL_HEADER_BYTES + offs + int64_t(stages) * band "
            "* int64_t(sizeof(float))",
            "const int64_t lo_a = lo & ~3, hi_a = min(n, (int64_t(hi) | 3) + 1);",
            "if (hi < 0 || hi_a - lo_a > band - 4) {",
            "if (t < stages) ring[t * band + band - 1] = NAN;"):
        assert mirrored in src, mirrored
    m = re.search(r'extern "C" int ryujin_probe_ell_gather_sum\((.*?)\)', src,
                  re.S)
    params = [p.split()[-1].lstrip("*") for p in m.group(1).split(",")]
    assert params[:7] == ["X", "cols", "out", "staged", "C", "K", "n"]
    assert params[7:-1] == list(kg.EllShape._fields)
    assert len(params) == len(
        build.PROBE_ENTRY_POINTS["ryujin_probe_ell_gather_sum"])


FORMS = (None,) + tuple(probe_pow.FORMS)


def _pow_written(sh, n, summed):
    """How often each of the n elements is written by the launch `sh`, as
    csrc/probe_pow.cu splits the work: block b, thread t, item k takes
    unit (b items + k) threads + t (a float4 vector pointwise when vec is
    4, else an element); pointwise with vec 4, the n mod 4 elements past
    the last vector go to grid threads 0 .. n mod 4 - 1."""
    units = n // sh.vec
    b, k, t = np.meshgrid(np.arange(sh.blocks), np.arange(sh.items),
                          np.arange(sh.threads), indexing="ij")
    unit = ((b * sh.items + k) * sh.threads + t).ravel()
    unit = unit[unit < units]
    idx = (unit[:, None] * sh.vec + np.arange(sh.vec)).ravel()
    if not summed and sh.vec == 4:
        idx = np.concatenate([idx, 4 * units + np.arange(n - 4 * units)])
        assert n - 4 * units <= sh.blocks * sh.threads
    return np.bincount(idx, minlength=n)


@pytest.mark.parametrize("n", [1, 3, 4, 5, 1023, 131072, 524288, 524291])
def test_pow_shape_covers_and_fits(n):
    """The pow kernels' launches, by default and over the candidates of
    tile_sweep pow, pointwise (float4 vectors from POW_VEC_MIN_N on, or
    asked for; else, and on a base that is not 16-byte aligned, the
    scalar instance) and summed: every element is
    written exactly once, no block lies wholly past n (one block when no
    unit is whole), the threads are whole warps up to the kernel's
    largest block, at most 1,024."""
    from ryujin_tpu_torch.tile_sweep import POW_CANDIDATES

    for summed in (False, True):
        cand = POW_CANDIDATES[summed]
        kinds = [(aligned, (), form) for aligned in (True, False)
                 for form in FORMS] + [
            (True, values, None)
            for values in itertools.product(*cand.values())]
        for aligned, values, form in kinds:
            sh = probe_pow.pow_shape(n, summed, aligned, *values, form=form)
            if not values:
                big = n >= probe_pow.POW_VEC_MIN_N and (summed or sh.vec == 4)
                assert sh.items == (probe_pow.POW_ITEMS_OF[summed].get(
                    form, 1) if big else 1)
            vec4 = values or n >= probe_pow.POW_VEC_MIN_N
            assert sh.vec == (4 if aligned and not summed and vec4 else 1)
            assert sh.unroll in (probe_pow.POW_UNROLLS if summed else (1,))
            largest = (probe_pow.POW_SUMMED_THREADS if summed
                       else probe_pow.POW_POINTWISE_THREADS)
            assert sh.threads % 32 == 0 and sh.threads <= largest <= 1024
            chunk = sh.threads * sh.items
            units = n // sh.vec
            assert (sh.blocks - 1) * chunk < max(units, 1) <= sh.blocks * chunk
            written = _pow_written(sh, n, summed)
            assert written.shape == (n,) and bool((written == 1).all()), sh
    for bad in ({"threads": 48}, {"threads": 1024}, {"items": 3},
                {"unroll": 2}, {"vec": 2}):
        with pytest.raises(ValueError):
            probe_pow.pow_shape(n, False, True, **bad)
    with pytest.raises(ValueError):
        probe_pow.pow_shape(n, False, False, vec=4)
    for bad in ({"threads": 512}, {"items": 4}, {"unroll": 3}, {"vec": 4}):
        with pytest.raises(ValueError):
            probe_pow.pow_shape(n, True, True, **bad)
    for bad_n in (0, probe_pow.POW_MAX_N + 1):
        with pytest.raises(ValueError):
            probe_pow.pow_shape(bad_n, True)


def test_pow_launch_mirrors_the_c_side():
    """csrc/probe_pow.cu's entry point takes the wrapper's arguments, the
    launch shape last in PowShape's order; its limits are the wrapper's;
    and the layout it accepts (pow_layout) is pow_shape's: whole warps up
    to each kernel's largest block, the items and unrolls of each form,
    float4 only on 16-byte aligned x and out, the blocks that cover the
    units."""
    src = (CSRC / "probe_pow.cu").read_text()
    for name in ("POW_MAX_TERMS", "POW_POINTWISE_THREADS",
                 "POW_SUMMED_THREADS"):
        assert f"constexpr int {name} = {getattr(probe_pow, name)};" in src
    assert probe_pow.POW_MAX_N == 1 << 30
    assert "constexpr int64_t POW_MAX_N = int64_t(1) << 30;" in src
    assert probe_pow.POW_ITEMS == {False: (1, 2, 4), True: (1, 2)}
    assert probe_pow.POW_UNROLLS == (1, 2, 4, 8)
    for mirrored in (
            "threads < 32 || threads % 32 != 0 || blocks < 1",
            "threads > POW_SUMMED_THREADS || (items != 1 && items != 2) || "
            "vec != 1",
            "(unroll != 1 && unroll != 2 && unroll != 4 && unroll != 8)",
            "R < 1 ||\n        R > POW_MAX_TERMS",
            "((uintptr_t(x) | uintptr_t(out)) & 15) == 0",
            "threads > POW_POINTWISE_THREADS || unroll != 1",
            "(vec == 1 ? items == 1 : vec == 4 && aligned && (items == 1 || "
            "items == 2 || items == 4))",
            "const int64_t units = n / vec, chunk = int64_t(threads) * items;",
            "return blocks == (units > chunk ? (units + chunk - 1) / chunk "
            ": 1);",
            "n > POW_MAX_N ||"):
        assert mirrored in src, mirrored
    m = re.search(r'extern "C" int ryujin_probe_pow\((.*?)\)', src, re.S)
    params = [p.split()[-1].lstrip("*") for p in m.group(1).split(",")]
    assert params[-6:-1] == list(probe_pow.PowShape._fields)
    assert params[:9] == ["form", "summed", "x", "carry", "shifts", "R", "b",
                          "out", "n"]
    assert len(params) == len(build.PROBE_ENTRY_POINTS["ryujin_probe_pow"])


@pytest.mark.parametrize("dtype", DTYPES)
def test_pk2_tile_fits_and_covers(dtype):
    """The stacked pk2 (2D, K = 8): the layout of pk2_stream's tile with
    the 4 half-slot lambda planes, one thread a cell and the halo of one
    cell."""
    item = torch.empty((), dtype=dtype).element_size()
    for stages in range(build.MAX_STAGES + 1):
        for shape in SHAPES[2]:
            t = pk2.tile(shape, 8, dtype, stages)
            bx, ty, tz = t.block
            assert bx == pk2.TX == 32 and tz == 1 and bx * ty <= 256
            assert t.halo == 1
            vals = 4 + 4 + 2 + 4 + stages * 6
            assert t.smem == vals * (bx + 2) * (ty + 2) * item
            assert 0 < t.smem <= build.SMEM_MAX
            _covers(t, shape, (bx, ty))
    with pytest.raises(ValueError):
        pk2.tile((165, 496), 24, dtype, 2)
    with pytest.raises(ValueError):
        pk2.tile((8, 64, 64), 26, dtype, 2)


@pytest.mark.parametrize("dtype", DTYPES)
def test_pk3_tile_fits_and_covers(dtype):
    """The stacked pk3 (2D, K = 8): the layout of pk3_stream's tile with
    one thread a cell and no flags."""
    item = torch.empty((), dtype=dtype).element_size()
    for stages in range(build.MAX_STAGES + 1):
        for shape in SHAPES[2]:
            t = pk3.tile(shape, 8, dtype, stages)
            bx, ty, groups = t.block
            assert bx == pk3.TX == 32 and groups == 1 and bx * ty <= 256
            assert t.halo == 1
            vals = 4 + 4 + stages * 6 + 4 + 2
            assert t.smem == vals * (bx + 2) * (ty + 2) * item
            assert 0 < t.smem <= build.SMEM_MAX
            _covers(t, shape, (bx, ty))
    with pytest.raises(ValueError):
        pk3.tile((165, 496), 24, dtype, 2)
    with pytest.raises(ValueError):
        pk3.tile((8, 64, 64), 26, dtype, 2)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dim,K", INSTANCES)
def test_pk_up_tile_fits_and_covers(dim, K, dtype):
    item = torch.empty((), dtype=dtype).element_size()
    C = dim + 2
    for shape in SHAPES[dim]:
        t = pk_up.tile(shape, K, dtype)
        if K == 8:  # PK4 at K = 8 keeps one thread a cell
            assert t == pk_up.tile(shape, K, dtype, last=True)
        else:
            assert t.block == (32, C, 1) and t.halo == 0
            # static arrays: P, l_sym, the live flags and U' of 32 cells
            assert t.smem == (C * K + K + C) * 32 * item + K * 32
            assert t.smem <= 48 * 1024  # static shared memory
            _covers(t, shape, (32, 1))
        # PK5: one thread a cell, 128 along x
        t5 = pk_up.tile(shape, K, dtype, last=True)
        assert t5.block == (128, 1, 1) and t5.smem == 0 and t5.halo == 0
        _covers(t5, shape, (128, 1))


def test_small_test_canvases_are_ragged():
    """The gpu tests' ragged canvases are those of SHAPES and leave partial
    tiles of pk1_stream, pk2_stream, pk3_stream and pk_up on x and y (and
    of pk1_stream and pk2_stream on z in 3D), and of the stacked pk1, pk2
    and pk3 on x and y on the K = 8 step and rectangle."""
    from test_torch_gpu import ragged_case

    for dim, refinement, ansatz in ((3, 1, None), (2, 0, None),
                                    (2, 0, "cG Q1"), (2, 3, "dG Q1")):
        sd = ragged_case(dim, ansatz)(refinement, torch.float64, "cpu")[1]
        assert tuple(sd.shape) in SHAPES[dim]
        D, H, W = build.canvas_dims(sd.shape)
        K = sd.max_degree
        assert W % pk3_stream.TX and W % pk_up.TX and H % 4
        for dtype in DTYPES:
            for t2 in (pk2_stream.tile(sd.shape, K, dtype, 2),
                       pk1_stream.tile(sd.shape, K, dtype)):
                assert W % t2.block[0] and H % t2.block[1]
                if dim == 3:
                    assert D % t2.block[2]
        if ansatz is None:
            t = pk3_stream.tile(sd.shape, K, torch.float32, 2)
            assert H % t.block[1]
        else:
            assert K == 8
            for t in (pk3.tile(sd.shape, K, torch.float32, 2),
                      pk2.tile(sd.shape, K, torch.float32, 2),
                      pk1.tile(sd.shape, K, torch.float32)):
                assert W % t.block[0] and H % t.block[1]


def test_launch_struct_mirrors_the_c_side():
    """build.Consts lists the fields of `struct Consts` (csrc/euler.cuh) in
    their order, the tile's among them; the launchers of pk1_stream,
    pk2_stream, pk3_stream and the stacked pk1, pk2 and pk3 take the shared
    bytes of the wrappers' formulas (staged.cuh holds the layouts they
    share); the entry points take the pointers ENTRY_POINTS counts; the
    sublane gather's window is the one sublane_shape() sizes; the lane
    gather's launcher takes lane_shape()'s shape; the layouts', moveaxis's
    and pk1_shape's launchers take layout_shape()'s and pk1_shape_shape()'s
    shape."""
    src = (CSRC / "euler.cuh").read_text()
    body = re.search(r"struct Consts \{(.*?)\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    names = re.findall(r"(\w+)(?:\[\w+\])?\s*[,;]", body)
    assert names == [f[0] for f in build.Consts._fields_]
    staged = (CSRC / "staged.cuh").read_text()
    assert "constexpr int TILE_TX = 32;" in staged
    assert "return u_vals(dim) + stages * stage_vals(dim) + dim + 4;" in staged
    assert "constexpr int u_vals(int dim) { return 2 * dim + 4; }" in staged
    assert "constexpr int stage_vals(int dim) { return 2 * dim + 2; }" in staged
    assert "return u_vals(dim) + 2 + stages * stage_vals(dim);" in staged
    assert "constexpr int pk1_vals(int dim) { return u_vals(dim) + 5; }" in staged
    k3 = (CSRC / "pk3_stream.cu").read_text()
    assert "pk3_vals(dim, stages) * ns * int64_t(sizeof(T)) + int64_t(ty) * TILE_TX * 4" in k3
    k2 = (CSRC / "pk2_stream.cu").read_text()
    assert "return pk2_vals(dim, stages) * ns * int64_t(sizeof(T));" in k2
    assert "int64_t(TILE_TX + 2 * h) * (ty + 2 * h) * (dim == 3 ? tz + 2 * h : 1)" in k2
    stacked = (CSRC / "pk3.cu").read_text()
    assert ("return pk3_vals(2, stages) * int64_t(TILE_TX + 2) * (ty + 2) * "
            "int64_t(sizeof(T));") in stacked
    stacked2 = (CSRC / "pk2.cu").read_text()
    assert ("return (pk2_vals(2, stages) + K2) * int64_t(TILE_TX + 2) * "
            "(ty + 2) * int64_t(sizeof(T));") in stacked2
    stacked1 = (CSRC / "pk1.cu").read_text()
    assert ("return pk1_vals(2) * int64_t(TILE_TX + 2) * (ty + 2) * "
            "int64_t(sizeof(T));") in stacked1
    k1 = (CSRC / "pk1_stream.cu").read_text()
    assert "return pk1_vals(dim) * ns * int64_t(sizeof(T));" in k1
    assert "int64_t(TILE_TX + 2 * h) * (ty + 2 * h) * (dim == 3 ? tz + 2 * h : 1)" in k1
    up = (CSRC / "pk_up.cu").read_text()
    assert "constexpr int UP_TX = 32;" in up
    gather = (CSRC / "probe_gather.cu").read_text()
    assert f"constexpr int SUBLANE_TILE = {probe_gather.SUBLANE_TILE};" in gather
    assert (f"constexpr int SUBLANE_THREADS = {probe_gather.SUBLANE_THREADS};"
            in gather)
    assert ("int64_t(smem) != int64_t(S) * SUBLANE_TILE * "
            "int64_t(sizeof(float))") in gather
    assert f"constexpr int LANE_ITEMS = {probe_gather.LANE_ITEMS};" in gather
    assert (f"constexpr int LANE_MAX_THREADS = "
            f"{probe_gather.LANE_MAX_THREADS};") in gather
    m = re.search(r'extern "C" int ryujin_probe_lane_gather\((.*?)\)', gather,
                  re.S)
    params = [p.split()[-1] for p in m.group(1).split(",")]
    assert params[-6:-1] == list(probe_gather.LaneShape._fields)
    assert len(params) == len(build.PROBE_ENTRY_POINTS[
        "ryujin_probe_lane_gather"])
    layout = (CSRC / "probe_layout3d.cu").read_text()
    assert (f"constexpr int LAYOUT_BARRIER_BYTES = "
            f"{probe_layout3d.LAYOUT_BARRIER_BYTES};") in layout
    assert ("constexpr int LAYOUT_MAX_STAGES = LAYOUT_BARRIER_BYTES / 8 - 1;"
            in layout and probe_layout3d.LAYOUT_MAX_STAGES == 128 // 8 - 1)
    assert "(tile != 64 && tile != 128)" in layout
    assert probe_layout3d.LAYOUT_TILES == (64, 128)
    for mirrored in (
            "threads != (TD * tile < 1024 ? TD * tile : 1024)",
            "rows = slide ? wz + int64_t(stages) * TD : int64_t(stages) * wz",
            "int64_t(smem) != LAYOUT_BARRIER_BYTES + rows * P * tile * "
            "int64_t(sizeof(float))",
            "segments < 1 || segments > gz || blocks != tiles * segments",
            "kernel<<<dim3(blocks / segments, segments), threads, smem,"):
        assert mirrored in layout, mirrored
    # the four kernels (full window, slide, moveaxis, pk1_shape) split the
    # z tiles of a tile so
    assert layout.count("const int t0 = gz * int(blockIdx.y) / "
                        "int(gridDim.y);") == 4
    assert layout.count("const int n = gz * int(blockIdx.y + 1) / "
                        "int(gridDim.y) - t0;") == 4
    for entry in ("ryujin_probe_layout", "ryujin_probe_window",
                  "ryujin_probe_pk1_shape"):
        args = build.PROBE_ENTRY_POINTS[entry]
        m = re.search(r'extern "C" int ' + entry + r"\((.*?)\)", layout,
                      re.S)
        params = [p.split()[-1] for p in m.group(1).split(",")]
        assert params[-7:-1] == list(probe_layout3d.LayoutShape._fields)
        assert len(params) == len(args)
    # an entry point's source: csrc/<name>.cu, the ELL kernels' ell_step.cu
    texts = [src.read_text() for src in build.sources()]
    for stem, n_ptr in build.ENTRY_POINTS.items():
        text = next(t for t in texts if f"int ryujin_{stem}_##SUFFIX(" in t)
        m = re.search(r'extern "C" int ryujin_' + stem + r"_##SUFFIX\((.*?)\)",
                      text, re.S)
        params = [p for p in m.group(1).split(",") if p.strip()]
        assert sum("void*" in p for p in params) == n_ptr + 1  # + the stream
        assert "Consts* consts" in params[-2]


def test_consts_carry_up_to_four_stage_weights():
    """build.consts passes 0 to MAX_STAGES (4, csrc/euler.cuh's) static
    stage weights, zero-filled, with 1 - their sum, and refuses more;
    every stage-taking launcher refuses n_stages above MAX_STAGES and
    picks its instance of MAX_STAGES slots above 2."""
    import types

    from ryujin_tpu_torch.equations.euler import Euler
    from ryujin_tpu_torch.solver.hyperbolic import HyperbolicModuleParams

    src = (CSRC / "euler.cuh").read_text()
    assert f"constexpr int MAX_STAGES = {build.MAX_STAGES};" in src
    assert build.MAX_STAGES == 4
    ca = types.SimpleNamespace(shape=(16, 32), K=8, measure_inv=0.5,
                               offsets=lattice_offsets(2, 1))
    eq, p = Euler(dim=2), HyperbolicModuleParams()
    for S in range(build.MAX_STAGES + 1):
        w = [0.5 - s for s in range(S)]
        c = build.consts(eq, p, ca, w)
        assert c.n_stages == S
        assert [c.w0, c.w1, c.w2, c.w3] == w + [0.0] * (4 - S)
        assert c.weight == 1.0 - sum(w)
    with pytest.raises(ValueError):
        build.consts(eq, p, ca, [0.1] * 5)
    for stem in ("pk2", "pk3", "pk2_stream", "pk3_stream"):
        text = (CSRC / f"{stem}.cu").read_text()
        assert ("consts->n_stages < 0 || consts->n_stages > MAX_STAGES"
                in text), stem
        assert "MAX_STAGES>(" in text and "consts->n_stages > 2" in text, stem


def test_tile_refuses_an_unknown_lattice():
    with pytest.raises(ValueError):
        pk3_stream.tile((8, 64, 64), 25, torch.float32, 2)
    with pytest.raises(ValueError):
        pk2_stream.tile((8, 64, 64), 25, torch.float32, 2)
    with pytest.raises(ValueError):
        pk1_stream.tile((8, 64, 64), 25, torch.float32)


def test_kernel_times_reports_the_staged_instances():
    """kernel_times reads the registers and stack of every pk1_stream (the
    staged tile and the one-thread-a-cell SEP form), pk2_stream (the
    staged tile and the one-thread-a-cell SEP form), stacked pk1, pk2 and
    pk3, pk3_stream and pk_up instance from nvcc's -Xptxas -v report, and
    its digests tell two outputs apart by a single bit."""
    from ryujin_tpu_torch import kernel_times

    names = {
        "_ZN6ryujin17pk2_stream_kernelIfLi3ELb0ELb1ENS_11FullStaticsIfEEEEvPKT_":
            "pk2_stream<f32, 3D, two-direction, dG, Full>",
        "_ZN6ryujin22pk2_stream_tile_kernelIdLi2ELb1ELb0EEEvPKT_S3_":
            "pk2_stream_tile<f64, 2D, half-slot, cG, Full>",
        "_ZN6ryujin17pk3_stream_kernelIfLi3ELb1ELb0ENS_10SepStaticsIfEEEEvPKT_":
            "pk3_stream<f32, 3D, half-slot, cG, Sep>",
        "_ZN6ryujin10pk3_kernelIfLb1EEEvPKT_S3_": "pk3<f32, dG>",
        "_ZN6ryujin17pk_up_tile_kernelIfLi3ELi26ENS_11FullStaticsIfEEEEvPKT_":
            "pk_up_tile<f32, 3D, K=26, Full>",
        "_ZN6ryujin10pk2_kernelIdLb0EEEvPKT_S3_S3_S3_": "pk2<f64, cG>",
        "_ZN6ryujin22pk1_stream_tile_kernelIfLi3ELb0EEEvPKT_S3_":
            "pk1_stream_tile<f32, 3D, two-direction, Full>",
        "_ZN6ryujin17pk1_stream_kernelIdLi3ELb1ENS_10SepStaticsIdEEEEvPKT_":
            "pk1_stream<f64, 3D, half-slot, Sep>",
        "_ZN6ryujin10pk1_kernelIfEEvPKT_S3_S3_S3_S3_PS1_S4_NS_9EqConstsIS1_EE":
            "pk1<f32>",
        "_ZN6ryujin10pk1_kernelIdEEvPKT_S3_S3_S3_S3_PS1_S4_NS_9EqConstsIS1_EE":
            "pk1<f64>",
    }
    log = "".join(
        f"ptxas info    : Function properties for {name}\n"
        f"    {8 * i} bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        f"ptxas info    : Used {100 + i} registers, used 1 barriers\n"
        for i, name in enumerate(names)
    ) + ("ptxas info    : Function properties for "
         "_ZN6ryujin12probe_kernelIfEEvPKT_\n"
         "    0 bytes stack frame\nptxas info    : Used 64 registers\n")
    seen = []
    res = kernel_times.resources(
        log, lambda kern, dim, dtype: seen.append((kern, dim)) or (256, 0))
    assert list(res) == list(names.values())
    for i, label in enumerate(names.values()):
        assert res[label]["regs"] == 100 + i and res[label]["stack"] == 8 * i
    assert ("pk3", 2) in seen and ("pk2_stream", 3) in seen
    assert ("pk2_stream_tile", 2) in seen and ("pk2", 2) in seen
    assert ("pk1_stream_tile", 3) in seen and ("pk1_stream", 3) in seen
    assert ("pk1", 2) in seen
    # the stacked pk1's launch: its tile() at K = 8, 32 x 4 threads
    assert kernel_times.launch_shape("pk1", 2, torch.float32) == (
        128, pk1.tile((64, 64), 8, torch.float32).smem)
    a = torch.arange(12, dtype=torch.float32)
    b = a.clone()
    b.view(torch.int32)[5] ^= 1
    assert kernel_times.digest((a, None, [0.75])) == kernel_times.digest((a.clone(), None, [0.75]))
    assert kernel_times.digest(a) != kernel_times.digest(b)
