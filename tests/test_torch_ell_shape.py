"""The launch of ell_pk2 and ell_pk3 (kernels/ell.py ell_step_shape), the
int32 columns they read and the band table of their blocks, on the CPU:
every shape covers each row and each slot once and fits the card's shared
memory, csrc/ell_step.cu mirrors it, an impossible shape raises; the int32
columns equal cols entry for entry and are refused at 2^31 rows; and
band_widths equals a brute-force band on a small mesh."""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ryujin_tpu_torch.equations.euler import Euler  # noqa: E402
from ryujin_tpu_torch.kernels import build, ell  # noqa: E402
from ryujin_tpu_torch.offline import assembly, geometry  # noqa: E402
from ryujin_tpu_torch.offline import ell as ell_pack  # noqa: E402
from ryujin_tpu_torch.offline.mesh import Boundary  # noqa: E402
from ryujin_tpu_torch.solver import stencil  # noqa: E402
from ryujin_tpu_torch.solver.ell_step import EllStepper  # noqa: E402
from ryujin_tpu_torch.solver.hyperbolic import (  # noqa: E402
    HyperbolicModuleParams,
)

KERNELS = ("ell_pk2", "ell_pk3")


# K = 2 is 1D Q1, 8 2D Q1 (and the airfoil's longest row at refinement 0),
# 26 3D Q1; n = 1,034,753 the rows of the step at refinement 3
@pytest.mark.parametrize("n", [1, 127, 1034753])
@pytest.mark.parametrize("S", range(5))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("K", [2, 8, 26])
@pytest.mark.parametrize("dim", [1, 2, 3])
def test_ell_step_shape_covers_and_fits(dim, K, dtype, S, n):
    size = 4 if dtype == torch.float32 else 8
    for kern in KERNELS:
        sh = ell.ell_step_shape(kern, dim, K, dtype, S, n)
        assert sh.threads == sh.rows * sh.slots <= ell.ELL_THREADS
        assert 1 <= sh.slots <= K and sh.rows >= 1
        assert sh.smem == ell.ell_step_smem(kern, dim, S, sh.rows, size)
        assert sh.smem <= build.SMEM_MAX
        assert kern == "ell_pk3" or sh.slots == 1  # ell_pk2: a thread a row
        # the default rows: the most of ELL_DEFAULT's, halved, that fit
        assert sh.rows == ell.ELL_DEFAULT[kern][0] or ell.ell_step_smem(
            kern, dim, S, 2 * sh.rows, size) > build.SMEM_MAX
        # lane m of block b takes row b * rows + m: every row once, and no
        # block without one
        assert (sh.blocks - 1) * sh.rows < n <= sh.blocks * sh.rows
        if n < 4096:
            rows = (np.arange(sh.blocks)[:, None] * sh.rows
                    + np.arange(sh.rows)[None]).ravel()
            assert np.array_equal(rows[rows < n], np.arange(n))
        # lane ky takes the slots ky, ky + slots, ...: every slot once
        slots = np.concatenate([np.arange(ky, K, sh.slots)
                                for ky in range(sh.slots)])
        assert np.array_equal(np.sort(slots), np.arange(K))


@pytest.mark.parametrize("bad", [
    dict(kernel="ell_pk1"), dict(dim=4), dict(K=0), dict(n_stages=5),
    dict(threads=256), dict(rows=64, threads=32), dict(rows=512),
    dict(kernel="ell_pk2", rows=32, threads=64),
    dict(kernel="ell_pk3", dim=3, K=26, dtype=torch.float64, n_stages=4,
         rows=1024, threads=1024)])
def test_ell_step_shape_refuses(bad):
    """A shape that cannot launch raises: another kernel, a dimension or
    stage count the kernels lack, more threads than the launch bound, fewer
    threads than rows, ell_pk2 with more than a thread a row, or shared
    bytes beyond build.SMEM_MAX."""
    args = dict(kernel="ell_pk3", dim=2, K=8, dtype=torch.float32,
                n_stages=2, n=100)
    args.update(bad)
    with pytest.raises(ValueError):
        ell.ell_step_shape(**args)


def test_ell_step_mirrors_the_c_side():
    """csrc/ell_step.cu's launch bound, row values, edge terms and shared
    bytes are the wrapper's, and its launchers accept only the layout that
    ell_step_shape gives."""
    src = (build.CSRC / "ell_step.cu").read_text()
    staged = (build.CSRC / "staged.cuh").read_text()
    assert f"constexpr int ELL_THREADS = {ell.ELL_THREADS};" in src
    for mirrored in (
            "return 4 * dim + 19 + stages * stage_vals(dim);",
            "const int vals = pk3 ? ell_pk3_row_vals(dim, stages) : "
            "pk2_vals(dim, stages) + stages * (dim + 2);",
            "return int64_t(vals) * rows * size;",
            "if (B < 1 || KY < 1 || KY > c->K || c->block[2] != 1 || B * KY > "
            "ELL_THREADS) return false;",
            "if (!pk3 && KY != 1) return false;",
            "if (c->grid[0] != (int64_t(c->W) + B - 1) / B || c->grid[1] != 1 "
            "|| c->grid[2] != 1) return false;",
            "return c->smem == ell_step_smem(pk3, c->dim, c->n_stages, B, "
            "int(sizeof(T)));"):
        assert mirrored in src, mirrored
    for dim in (1, 2, 3):
        for s in range(5):
            # staged.cuh's counts, evaluated
            u = 2 * dim + 4
            sv = 2 * dim + 2
            assert ell.pk2_vals(dim, s) == u + 2 + s * sv
            assert ell.pk3_vals(dim, s) == u + s * sv + dim + 4
    assert "return u_vals(dim) + 2 + stages * stage_vals(dim);" in staged
    assert "return u_vals(dim) + stages * stage_vals(dim) + dim + 4;" in staged
    assert "constexpr int u_vals(int dim) { return 2 * dim + 4; }" in staged
    assert "constexpr int stage_vals(int dim) { return 2 * dim + 2; }" in staged
    # the entry points keep their pointer counts; ell_pk2 and ell_pk3 take
    # the columns as int32
    for name in KERNELS:
        assert re.search(rf"launch_{name}<T>\(\(const int32_t\*\)cols", src)
    assert re.search(r"launch_ell_pk1<T>\(\(const int64_t\*\)cols", src)


@pytest.fixture(scope="module")
def small():
    """A 2D Q1 rectangle at refinement 3 packed as padded ELL, and its
    stepper's stencil on the CPU."""
    mesh = geometry.rectangular_domain(
        [0.0, 0.0], [1.0, 1.0], [1, 1], refinement=3,
        boundary_conditions=[Boundary.dirichlet] * 4)
    packed = ell_pack.pack(assembly.assemble(mesh))
    stepper = EllStepper(Euler(dim=2), HyperbolicModuleParams(), packed,
                         torch.float64, "cpu")
    return packed, stepper.stencil


def test_int32_columns_equal_cols(small):
    _, st = small
    assert st.cols32.dtype == torch.int32 and st.cols32.is_contiguous()
    assert st.cols32.shape == st.cols.shape
    assert torch.equal(st.cols32.long(), st.cols)


def test_int32_columns_refuse_2_31_rows():
    stencil.check_int32_rows(2 ** 31 - 1)
    for n in (2 ** 31, 2 ** 40):
        with pytest.raises(ValueError):
            stencil.check_int32_rows(n)


@pytest.mark.parametrize("rows", [1, 3, 32, 64, 1000])
def test_band_widths_equal_brute_force(small, rows):
    _, st = small
    cols, mask = st.cols.numpy(), st.mask.numpy().copy()
    rng = np.random.default_rng(rows)
    mask[rng.random(mask.shape) < 0.2] = 0.0  # some rows lose every slot
    mask[:, 5:9] = 0.0
    K, n = cols.shape
    want = []
    for b in range(-(-n // rows)):
        c = cols[:, b * rows:(b + 1) * rows][mask[:, b * rows:(b + 1) * rows] > 0]
        want.append(int(c.max() - c.min() + 1) if c.size else 0)
    got = ell.band_widths(cols, mask, rows)
    assert got.tolist() == want
    table = ell.band_table(cols, mask, 2, 8, rows=(rows,))[rows]
    assert table["width"][-1] == max(want)
    assert table["pk3_bytes"][-1] == max(want) * ell.pk3_vals(2, 2) * 8
