"""The launch shapes of the tiled kernels, pk3_stream and pk_up, on the CPU:
each instance's tile fits the card's shared memory, stages a halo of the
lattice reach, and its grid covers every cell of the bench canvases and of
the small test canvases, ragged edges included; the C side of the
launch (the Consts struct, the entry points, the staged layout) mirrors
what the wrappers pass."""

import re

import pytest

torch = pytest.importorskip("torch")

from ryujin_tpu_torch.kernels import build, pk3_stream, pk_up  # noqa: E402
from ryujin_tpu_torch.offline.structured import lattice_offsets  # noqa: E402

CSRC = build.CSRC
DTYPES = (torch.float32, torch.float64)
# (dim, K) of every pk3_stream and pk_up instance: 2D reach 1 (the stream
# kernels on step2d's canvas, dG Q1) and reach 2 (cG / dG Q2), 3D reach 1
INSTANCES = ((2, 8), (2, 24), (3, 26))
# canvases the kernels launch on: the bench cells (chip_smoke.py setup
# lines: step2d and q2step2d, box3d and dg1box3d, cylinder3d) and the small
# canvases of chip_smoke.py phases 6b, 8b, 8c, 10b and of the gpu tests
# (the boxes at refinement 1, the dG steps at refinement 0, the cylinder at
# refinement 1 with pad_minor 32, the ragged box and step of
# test_torch_gpu.py)
SHAPES = {
    2: [(664, 2048), (176, 512), (256, 768), (165, 496)],
    3: [(72, 72, 128), (72, 40, 128), (16, 16, 128), (24, 16, 32),
        (7, 7, 16)],
}


def _covers(tile, shape, cells):
    """The grid covers the canvas, and no block lies wholly past it."""
    D, H, W = build.canvas_dims(shape)
    gx, gy, gz = tile.grid
    ty = cells[1]
    assert gx * cells[0] >= W and (gx - 1) * cells[0] < W
    assert gy * ty >= H and (gy - 1) * ty < H
    assert gz == (D if len(shape) == 3 else 1)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dim,K", INSTANCES)
def test_pk3_stream_tile_fits_and_covers(dim, K, dtype):
    reach = max(abs(v) for o in lattice_offsets(dim, build.reach_of(dim, K))
                for v in o)
    assert len(lattice_offsets(dim, reach)) == K
    item = torch.empty((), dtype=dtype).element_size()
    for stages in (0, 1, 2):
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
    tiles of pk3_stream on x and y (f32 rows of 4) and of pk_up on x."""
    from test_torch_gpu import ragged_case

    for dim, refinement in ((3, 1), (2, 0)):
        sd = ragged_case(dim)(refinement, torch.float64, "cpu")[1]
        assert tuple(sd.shape) in SHAPES[dim]
        D, H, W = build.canvas_dims(sd.shape)
        assert W % pk3_stream.TX and W % pk_up.TX and H % 4
        t = pk3_stream.tile(sd.shape, sd.max_degree, torch.float32, 2)
        assert H % t.block[1]


def test_launch_struct_mirrors_the_c_side():
    """build.Consts lists the fields of `struct Consts` (csrc/euler.cuh) in
    their order, the tile's among them; the pk3_stream launcher's shared
    bytes are the wrapper's formula; the entry points take the pointers
    ENTRY_POINTS counts."""
    src = (CSRC / "euler.cuh").read_text()
    body = re.search(r"struct Consts \{(.*?)\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    names = re.findall(r"(\w+)(?:\[\w+\])?\s*[,;]", body)
    assert names == [f[0] for f in build.Consts._fields_]
    k3 = (CSRC / "pk3_stream.cu").read_text()
    assert "pk3_vals(dim, stages) * ns * int64_t(sizeof(T)) + int64_t(ty) * PK3_TX * 4" in k3
    assert "return pk3_u_vals(dim) + stages * pk3_stage_vals(dim) + dim + 4;" in k3
    assert "constexpr int PK3_TX = 32;" in k3
    up = (CSRC / "pk_up.cu").read_text()
    assert "constexpr int UP_TX = 32;" in up
    for stem, n_ptr in build.ENTRY_POINTS.items():
        text = (CSRC / f"{stem}.cu").read_text()
        m = re.search(r'extern "C" int ryujin_' + stem + r"_##SUFFIX\((.*?)\)",
                      text, re.S)
        params = [p for p in m.group(1).split(",") if p.strip()]
        assert sum("void*" in p for p in params) == n_ptr + 1  # + the stream
        assert "Consts* consts" in params[-2]


def test_tile_refuses_an_unknown_lattice():
    with pytest.raises(ValueError):
        pk3_stream.tile((8, 64, 64), 25, torch.float32, 2)
