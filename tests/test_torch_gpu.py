"""The CUDA kernels against their plain-torch references on the card.

Marked `gpu`: each test skips without a CUDA device (decided inside the
test, never at import).  On the card, where jax is not installed (so
tests/conftest.py is skipped):

    python -m pytest --noconftest tests/test_torch_gpu.py -q -m gpu

builds the kernels (nvcc, sm_90a) and holds three ERK33 steps through
them in float64 against the plain path on the CPU, for the three slices:
step2d (cG Q1, K = 8: pk1, pk2, pk3, pk_up) and q2step2d (cG Q2, K = 24:
pk1_stream, pk2_stream, pk3_stream, pk_up; bang-bang) at refinement 0,
and box3d (3D cG Q1, K = 26: the 3D instances of the stream kernels and
pk_up; bang-bang) on two small boxes at refinement 1, one for each
Riemann route; the dG instances of PK2 and PK3 (the incidence beta_ij
in the high-order viscosity factor): dG Q1 and dG Q2 in 2D on a small
rectangle with the step's boundary conditions, and dG Q1 in 3D on a box
for each Riemann route, as dg1box3d at small size; and the SEP instances
of the four 3D kernels (separable statics, synthesized per offset) on the
cylinder o-grid of cylinder3d at refinement 1 (two-direction route) and
the 3 x 2 x 2 box (half-slot route), the plain path on the CPU in the same
separable mode; and the measurement probes' kernels (csrc/probe_*.cu) on
small shapes against their plain versions on the card, each at its bar,
the ELL gather-sum, moveaxis, pk1_shape and the lane gather also at every
launch of their sweeps; and the padded-ELL kernels (ell_pk1, ell_pk2,
ell_pk3, ell_pk_up) on the 1D tube, the dG Q1 step, a small box and the
airfoil: three ERK33 steps against the plain path on the CPU, and each
kernel against its plain version at every stage-slot count; and the
canvases with ghost rows refreshed between kernels (the periodic
vortex, the step in 2 and 4 slabs, the periodic box) and cG Q3 (pk_up's
K = 48 instance, the stream kernels at reach 3): three ERK33 steps
against the plain path on the CPU, and the tiled kernels bit for bit
against their plain twins on the refreshed inputs.
"""

import collections
import functools

import pytest

torch = pytest.importorskip("torch")


def _three_steps_card_vs_cpu(build_case, fns, per_step, refinement=0,
                             counter="launches"):
    """Three ERK33 steps from a bumped inflow state: the kernels on the
    card against the plain path on the CPU, with the launch counts read
    from each wrapper's `counter`."""
    _, sd, _, ti_g, _ = build_case(refinement, torch.float64, "cuda")
    _, _, _, ti_c, U0 = build_case(refinement, torch.float64, "cpu")
    pos = torch.as_tensor(sd.positions.T)
    centre = torch.tensor([1.0, 0.5, 0.5][: pos.shape[0]], dtype=torch.float64)
    bump = 1.0 + 0.25 * torch.exp(
        -8.0 * torch.sum((pos - centre[:, None]) ** 2, 0)
    )
    U0 = U0.clone()
    U0[0] *= bump
    U0[-1] *= bump
    counts = [getattr(f, counter) for f in fns]
    out_g = ti_g.advance(U0.cuda(), 0.0, 3)
    torch.cuda.synchronize()
    out_c = ti_c.advance(U0, 0.0, 3)
    new = [getattr(f, counter) for f in fns]
    assert int(out_g[4]) == int(out_c[4]) == 0
    assert [b - a for a, b in zip(counts, new)] == [3 * n for n in per_step]
    real = torch.as_tensor(sd.node_mask > 0)
    torch.testing.assert_close(out_g[0].cpu()[:, real], out_c[0][:, real],
                               rtol=1e-10, atol=1e-12)
    torch.testing.assert_close(out_g[3].cpu(), out_c[3], rtol=1e-10, atol=0)


@pytest.mark.gpu
def test_kernels_on_card_match_plain_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ryujin_tpu_torch.bench import build_step2d
    from ryujin_tpu_torch.kernels import pk1, pk2, pk3, pk_up

    _three_steps_card_vs_cpu(
        build_step2d, (pk1.pk1, pk2.pk2, pk3.pk3, pk_up.pk_up), [3, 3, 3, 6]
    )


@pytest.mark.gpu
def test_q2_stream_kernels_on_card_match_plain_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ryujin_tpu_torch.bench import build_q2step2d
    from ryujin_tpu_torch.kernels import (
        pk1_stream, pk2_stream, pk3_stream, pk_up,
    )

    _three_steps_card_vs_cpu(
        build_q2step2d,
        (pk1_stream.pk1_stream, pk2_stream.pk2_stream, pk3_stream.pk3_stream,
         pk_up.pk_up),
        [3, 3, 3, 6],
    )


@pytest.mark.gpu
@pytest.mark.parametrize("subdiv,half", [((3, 2, 2), True), ((7, 4, 4), False)])
def test_box3d_kernels_on_card_match_plain_cpu(subdiv, half):
    """Both Riemann routes of the 3D kernels: the half-slot route on the
    3 x 2 x 2 box, the two-direction route on the 7 x 4 x 4 box."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ryujin_tpu_torch.bench import build_box3d
    from ryujin_tpu_torch.kernels import (
        pk1_stream, pk2_stream, pk3_stream, pk_up,
    )

    build_case = functools.partial(build_box3d, subdiv=subdiv)
    assert build_case(1, torch.float64, "cpu")[2].half == half
    _three_steps_card_vs_cpu(
        build_case,
        (pk1_stream.pk1_stream, pk2_stream.pk2_stream, pk3_stream.pk3_stream,
         pk_up.pk_up),
        [3, 3, 3, 6], refinement=1,
    )


def _dg_rectangle(ansatz):
    """A build_case of a dG ansatz on [0, 3] x [0, 1] (3 x 1 cells before
    `refinement`) with the step's boundary conditions, bang-bang."""
    from ryujin_tpu_torch import bench
    from ryujin_tpu_torch.offline.mesh import Boundary

    def build(refinement, dtype, device):
        mesh = bench.geometry.rectangular_domain(
            [0.0, 0.0], [3.0, 1.0], [3, 1], refinement,
            boundary_conditions=[Boundary.dirichlet, Boundary.do_nothing,
                                 Boundary.slip, Boundary.slip],
        )
        sd = bench.structured.pack_structured(
            bench.assembly.assemble(mesh, ansatz=ansatz), mesh
        )
        eq = bench.Euler(dim=2)
        init = bench.make_initial_state(eq, "uniform",
                                        primitive_state=(1.4, 3.0, 1.0))
        hm = bench.HyperbolicModule(eq, sd, init, dtype=dtype, device=device)
        ti = bench.TimeIntegrator(hm, "erk 33", cfl_min=0.45, cfl_max=0.9,
                                  cfl_recovery_strategy="bang bang control")
        U0 = bench.interpolate_nodal(init, sd, eq, 0.0, dtype, device)
        return eq, sd, hm, ti, U0

    return build


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["dG Q1", "dG Q2", "box half-slot",
                                  "box two-direction"])
def test_dg_kernels_on_card_match_plain_cpu(case):
    """The dG instances: dG Q1 (K = 8, pk1 / pk2 / pk3) and dG Q2 (K = 24,
    the stream forms) in 2D at refinement 3, and dG Q1 in 3D (K = 26) on
    a 3 x 2 x 2 box (half-slot route) and a 6 x 3 x 3 box (two-direction)
    at refinement 1."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ryujin_tpu_torch.bench import build_dg1box3d
    from ryujin_tpu_torch.kernels import (
        pk1, pk1_stream, pk2, pk2_stream, pk3, pk3_stream, pk_up,
    )

    if case.startswith("box"):
        half = case == "box half-slot"
        build_case = functools.partial(
            build_dg1box3d, subdiv=(3, 2, 2) if half else (6, 3, 3))
        refinement = 1
        assert build_case(1, torch.float64, "cpu")[2].half == half
    else:
        build_case, refinement = _dg_rectangle(case), 3
    stream = case != "dG Q1"
    fns = ((pk1_stream.pk1_stream, pk2_stream.pk2_stream,
            pk3_stream.pk3_stream) if stream else (pk1.pk1, pk2.pk2, pk3.pk3))
    hm = build_case(refinement, torch.float64, "cpu")[2]
    assert hm.canvas.stream == stream and hm.canvas.arrays.g_inc is not None
    _three_steps_card_vs_cpu(build_case, fns + (pk_up.pk_up,), [3, 3, 3, 6],
                             refinement=refinement)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["cylinder two-direction", "box half-slot"])
def test_sep_kernels_on_card_match_plain_cpu(case):
    """The SEP instances of pk1_stream, pk2_stream, pk3_stream and pk_up
    (3D, K = 26, separable statics) on both Riemann routes: the small
    cylinder (refinement 1, its 32-cell periodic angle packed exactly) and
    the 3 x 2 x 2 box, counted on the SEP instances' own counters."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ryujin_tpu_torch.bench import build_box3d, build_cylinder3d
    from ryujin_tpu_torch.kernels import (
        pk1_stream, pk2_stream, pk3_stream, pk_up,
    )

    if case.startswith("cylinder"):
        build_case = functools.partial(build_cylinder3d, pad_minor=32,
                                       separable=True)
    else:
        build_case = functools.partial(build_box3d, subdiv=(3, 2, 2),
                                       separable=True)
    hm = build_case(1, torch.float64, "cpu")[2]
    assert hm.half == case.endswith("half-slot")
    assert hm.canvas.arrays.separable and hm.canvas.arrays.g_cij is None
    _three_steps_card_vs_cpu(
        build_case,
        (pk1_stream.pk1_stream, pk2_stream.pk2_stream, pk3_stream.pk3_stream,
         pk_up.pk_up),
        [3, 3, 3, 6], refinement=1, counter="sep_launches",
    )


@pytest.mark.gpu
def test_probe_kernels_on_card_match_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ryujin_tpu_torch.kernels import build
    from ryujin_tpu_torch.probes import gather, held, layout3d
    from ryujin_tpu_torch.probes import pow as ppow

    pw = ppow.parser().parse_args(
        ["--H", "64", "--W", "96", "--REPS", "5", "--N", "8", "256",
         "--reps", "4", "--loop", "3"])
    row11, row12, _ = ppow.cases(pw, None, 1980)
    ga = gather.parser().parse_args(
        ["--W", "640", "--S", "300", "--L", "70", "--n", "20000"])
    la = layout3d.parser().parse_args(
        ["--P", "5", "--D", "13", "--H", "4", "--W", "40", "--CENPL", "7",
         "--MOV", "both"])
    cases = row11 + row12 + gather.cases(ga) + [
        c for part in layout3d.PARTS for c in layout3d.cases(la, part)]
    for case in cases:
        before = build.PROBE_LAUNCHES[case.instance]
        out = case.kernel()
        torch.cuda.synchronize()
        assert (build.PROBE_LAUNCHES[case.instance]
                == before + case.launches_per_call), case.name
        _, err, ok = held(case.bar, out, case.plain())
        assert ok, (case.name, err)


@pytest.mark.gpu
def test_pow_kernels_ragged_and_offset():
    """Every pow form pointwise and summed, with and without the carry,
    at ragged n (float4 by default from kernels.probe_pow.POW_VEC_MIN_N
    on) and on an offset view x[1:] (whose base is not 16-byte aligned:
    the scalar pointwise instance), by default and over the candidates of
    tile_sweep pow and the scalar launch at each block size: each result holds its bar against
    probe_pow_reference (exact for fast, Newton and x b; 4 ulp pointwise
    and rel 1e-6 summed for powf, exp2 log2 and sqrt) and equals the
    default launch bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import itertools

    import numpy as np

    from ryujin_tpu_torch.kernels import probe_pow as kp
    from ryujin_tpu_torch.probes import held
    from ryujin_tpu_torch.probes.pow import LIBM
    from ryujin_tpu_torch.tile_sweep import POW_CANDIDATES

    rng = np.random.default_rng(3)
    s = kp.shifts(0.01, 13).cuda()
    for n in (1, 3, 5, 1023, 4099, 131075, 524291):
        base = torch.from_numpy(rng.uniform(0.5, 3.0, n + 1).astype(
            np.float32)).cuda()
        carry = torch.from_numpy(rng.uniform(0.0, 40.0, n).astype(
            np.float32)).cuda()
        for off, form in itertools.product((0, 1), kp.FORMS):
            x = base[off:off + n]
            assert (x.data_ptr() % 16 == 0) == (off == 0)
            for shifts, c in ((None, None), (s, None), (s, carry)):
                summed = shifts is not None
                bar = ("exact" if form not in LIBM
                       else "rel 1e-6" if summed else "4 ulp")
                want = kp.probe_pow(x, form, 1.4, shifts, c)
                ref = kp.probe_pow_reference(x, form, 1.4, shifts, c)
                assert held(bar, want, ref)[2], (n, form, summed, c is None)
                cand = POW_CANDIDATES[summed]
                launches = list(itertools.product(*cand.values()))
                if not summed:  # the scalar instance at each block size
                    launches += [(t, 1, 1, 1) for t in cand["threads"]]
                for values in launches:
                    if off and not summed and values[-1] == 4:
                        continue  # float4 needs a 16-byte aligned base
                    shape = kp.pow_shape(n, summed, not off, *values)
                    got = kp.probe_pow(x, form, 1.4, shifts, c, shape)
                    assert torch.equal(got, want), (n, form, shape)


@pytest.mark.gpu
def test_layout_kernels_exact_at_every_launch():
    """The three layout kernels bit-equal to their plain version at every
    launch tile_sweep layouts tries, on a ragged canvas (H W = 160:
    partial tiles of 64 and 128 cells), TD = 1, 2, 3."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import itertools

    import numpy as np

    from ryujin_tpu_torch.kernels import probe_layout3d as kl
    from ryujin_tpu_torch.tile_sweep import LAYOUT_CANDIDATES

    P, D, H, W = 5, 13, 4, 40
    rng = np.random.default_rng(3)
    hz = torch.from_numpy(rng.random((D, P, H, W), dtype=np.float32)).cuda()
    hp = hz.movedim(0, 1).contiguous()
    for TD in (1, 2, 3):
        want = kl.window_sum_reference(hz, "z-major", TD)
        for layout, h in (("plane-major", hp), ("z-major", hz),
                          ("z-major-slide", hz)):
            cand = LAYOUT_CANDIDATES[
                "slide" if layout == "z-major-slide" else "full"]
            for values in itertools.product(*cand.values()):
                shape = kl.layout_shape(layout, P, D, H * W, TD,
                                        **dict(zip(cand, values)))
                got = kl.window_sum(h, layout, TD, shape)
                assert torch.equal(got, want), (layout, TD, shape)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["script", "unbanded", "ragged n",
                                  "out of range"])
def test_ell_gather_sum_exact_at_every_launch(case):
    """The ELL gather-sum bit for bit against its plain version (NaN
    where it gives NaN) at the default launch and every launch of
    tile_sweep ell, on the script's input (n = 2^20), on unbanded columns,
    at n = 2^20 + 3 (4-byte cp.async) and with columns out of range; at
    each launch the blocks the kernel counts as staged are
    ell_staged_blocks' (on the script's input at the default launch,
    every block)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import itertools

    import numpy as np

    from ryujin_tpu_torch.kernels import probe_gather as kg
    from ryujin_tpu_torch.probes import gather
    from ryujin_tpu_torch.tile_sweep import ELL_CANDIDATES

    n, K = 1 << 20, 9
    X, cols = gather.ell_inputs(n + 3 if case == "ragged n" else n, K, 12)
    if case == "unbanded":
        cols = np.random.default_rng(1).integers(0, n, (K, n)).astype(np.int32)
    if case == "out of range":
        cols[0, 0], cols[4, 9999], cols[8, n - 1] = -1, n, 2**31 - 1
    X, cols = torch.from_numpy(X).cuda(), torch.from_numpy(cols).cuda()
    want = kg.ell_gather_sum_reference(X, cols)
    shapes = [kg.ell_shape(X.shape[1], K)]
    for values in itertools.product(*ELL_CANDIDATES.values()):
        try:
            shapes.append(kg.ell_shape(X.shape[1], K, True,
                                       **dict(zip(ELL_CANDIDATES, values))))
        except ValueError:
            continue
    for shape in shapes:
        staged = torch.zeros(1, dtype=torch.int32, device="cuda")
        got = kg.ell_gather_sum(X, cols, shape, staged)
        assert torch.equal(got.isnan(), want.isnan()), (case, shape)
        assert torch.equal(got.nan_to_num(), want.nan_to_num()), (case, shape)
        assert int(staged) == kg.ell_staged_blocks(cols, shape), (case, shape)
    if case == "script":
        staged = torch.zeros(1, dtype=torch.int32, device="cuda")
        kg.ell_gather_sum(X, cols, None, staged)
        assert int(staged) == shapes[0].blocks


@pytest.mark.gpu
@pytest.mark.parametrize("TD", [1, 2, 4])
def test_moveaxis_exact_at_every_launch(TD):
    """moveaxis, MOV = 1 and 0, out and check bit for bit against the
    plain version at every launch tile_sweep moveaxis tries, at P = 24 on
    a (20, 9, 20) canvas (H W = 180: partial tiles of 64 and 128 cells)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import itertools

    import numpy as np

    from ryujin_tpu_torch.kernels import probe_layout3d as kl
    from ryujin_tpu_torch.tile_sweep import LAYOUT_CANDIDATES

    P, D, H, W = 24, 20, 9, 20
    h = torch.from_numpy(np.random.default_rng(4).random(
        (D, P, H, W), dtype=np.float32)).cuda()
    cand = LAYOUT_CANDIDATES["full"]
    for mov in (1, 0):
        want = kl.moveaxis_reference(h, TD, mov)
        for values in itertools.product(*cand.values()):
            try:
                shape = kl.layout_shape("moveaxis", P, D, H * W, TD,
                                        **dict(zip(cand, values)))
            except ValueError:
                continue
            got = kl.moveaxis(h, TD, mov, shape)
            assert all(torch.equal(a, b) for a, b in zip(got, want)), (
                mov, TD, shape)


@pytest.mark.gpu
@pytest.mark.parametrize("TD", [1, 2, 4])
def test_pk1_shape_exact_at_every_launch(TD):
    """pk1_shape, out and check bit for bit against the plain version at
    every launch tile_sweep pk1-shape tries, on a (20, 9, 20) canvas (H W
    = 180: partial tiles of 64 and 128 cells) with a centre of 78 planes
    or none and 0 to 3 windows of 5, 4 and 2 planes, OUTPL 14."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import itertools

    import numpy as np

    from ryujin_tpu_torch.kernels import build
    from ryujin_tpu_torch.kernels import probe_layout3d as kl
    from ryujin_tpu_torch.tile_sweep import LAYOUT_CANDIDATES

    D, H, W = 20, 9, 20
    rng = np.random.default_rng(6)
    cen_all = torch.from_numpy(rng.random((D, 78, H, W),
                                          dtype=np.float32)).cuda()
    wins_all = [torch.from_numpy(rng.random((D, p, H, W),
                                            dtype=np.float32)).cuda()
                for p in (5, 4, 2)]
    cand = LAYOUT_CANDIDATES["pk1_shape"]
    key = build.probe_key("pk1_shape")
    for cen_on, nwin in itertools.product((1, 0), range(4)):
        if not cen_on and not nwin:
            continue
        cen, wins = cen_all if cen_on else None, wins_all[:nwin]
        planes = tuple(h.shape[1] for h in wins)
        want = kl.pk1_shape_reference(cen, wins, TD, 14)
        before = build.PROBE_LAUNCHES[key]
        assert all(torch.equal(a, b) for a, b in zip(
            kl.pk1_shape(cen, wins, TD, 14), want)), (TD, cen_on, nwin)
        assert build.PROBE_LAUNCHES[key] == before + 1
        for values in itertools.product(*cand.values()):
            try:
                shape = kl.pk1_shape_shape(78 * cen_on, planes, D, H * W, TD,
                                           **dict(zip(cand, values)))
            except ValueError:
                continue
            got = kl.pk1_shape(cen, wins, TD, 14, shape)
            assert all(torch.equal(a, b) for a, b in zip(got, want)), (
                TD, cen_on, nwin, shape)


@pytest.mark.gpu
@pytest.mark.parametrize("W", [2048, 2047, 128, 1])
def test_lane_gather_exact_at_every_launch(W):
    """The lane gather out[p, w] = x[p, idx[p, w]] bit for bit against
    np.take_along_axis at P = 8 by default and at every launch tile_sweep
    gather tries, at the probe's W = 2048 and 128 (16-byte pieces), W =
    2047 and 1 (4-byte ones), and on a view of x one float into a buffer
    (its base not 16-byte aligned: 4-byte pieces), with an index past each
    end giving NaN."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import itertools

    import numpy as np

    from ryujin_tpu_torch.kernels import build, probe_gather
    from ryujin_tpu_torch.tile_sweep import LANE_CANDIDATES

    P = 8
    x = np.arange(P * W, dtype=np.float32).reshape(P, W)
    idx = np.random.default_rng(0).integers(0, W, size=(P, W)).astype(np.int32)
    want = np.take_along_axis(x, idx, axis=1)
    idx[0, 0], idx[-1, -1] = W, -1
    want[0, 0] = want[-1, -1] = np.nan
    xc, ic = torch.from_numpy(x).cuda(), torch.from_numpy(idx).cuda()
    key = build.probe_key("lane_gather", P, W)
    before = build.PROBE_LAUNCHES[key]
    got = probe_gather.lane_gather(xc, ic)
    assert build.PROBE_LAUNCHES[key] == before + 1
    assert np.array_equal(got.cpu().numpy(), want, equal_nan=True), W
    aligned = W % 4 == 0
    for values in itertools.product(*LANE_CANDIDATES.values()):
        shape = probe_gather.lane_shape(P, W, aligned=aligned,
                                        **dict(zip(LANE_CANDIDATES, values)))
        got = probe_gather.lane_gather(xc, ic, shape)
        assert np.array_equal(got.cpu().numpy(), want, equal_nan=True), (
            W, shape)
    flat = torch.zeros(P * W + 1, dtype=torch.float32, device="cuda")
    flat[1:] = xc.reshape(-1)
    offset = flat[1:].view(P, W)
    assert offset.data_ptr() % 16 != 0
    got = probe_gather.lane_gather(offset, ic)
    assert np.array_equal(got.cpu().numpy(), want, equal_nan=True), W


def ragged_case(dim, ansatz=None):
    """A build_case whose canvas leaves partial tiles of the tiled kernels
    (32 cells along x, 4 rows along y in f32) on x and y, packed with no
    padding of the leading axes: in 3D the 3 x 2 x 2 box (cG Q1, K = 26)
    on a (7, 7, 16) canvas at refinement 1, in 2D the step with cG Q2
    (K = 24, reach 2) on a (165, 496) canvas at refinement 0, both packed
    16 cells wide; with `ansatz` a 2D K = 8 canvas packed 8 cells wide for
    the stacked kernels: "cG Q1", the step on an (83, 248) canvas at
    refinement 0, or "dG Q1", the 3 x 1 rectangle [0, 3] x [0, 1] with the
    step's boundary conditions on an (18, 48) canvas at refinement 3."""
    from ryujin_tpu_torch import bench
    from ryujin_tpu_torch.offline.mesh import Boundary

    def build(refinement, dtype, device):
        pad_minor, margin = 16, 2
        if dim == 3:
            mesh = bench.geometry.rectangular_domain(
                [0.0, 0.0, 0.0], [3.0, 1.0, 1.0], [3, 2, 2], refinement,
                boundary_conditions=[Boundary.dirichlet, Boundary.do_nothing]
                + [Boundary.slip] * 4, dim=3,
            )
            ansatz_, margin = "cG Q1", (1, 1)
        elif ansatz == "dG Q1":
            mesh = bench.geometry.rectangular_domain(
                [0.0, 0.0], [3.0, 1.0], [3, 1], refinement,
                boundary_conditions=[Boundary.dirichlet, Boundary.do_nothing,
                                     Boundary.slip, Boundary.slip],
            )
            ansatz_, pad_minor, margin = ansatz, 8, 1
        else:
            mesh = bench.geometry.step(refinement=refinement)
            ansatz_ = ansatz or "cG Q2"
            if ansatz:
                pad_minor, margin = 8, 1
        sd = bench.structured.pack_structured(
            bench.assembly.assemble(mesh, ansatz=ansatz_), mesh,
            pad_minor=pad_minor, pad_major=1, margin=margin,
        )
        eq = bench.Euler(dim=dim)
        init = bench.make_initial_state(eq, "uniform",
                                        primitive_state=(1.4, 3.0, 1.0))
        hm = bench.HyperbolicModule(eq, sd, init, dtype=dtype, device=device)
        ti = bench.TimeIntegrator(hm, "erk 33", cfl_min=0.45, cfl_max=0.9,
                                  cfl_recovery_strategy="bang bang control")
        U0 = bench.interpolate_nodal(init, sd, eq, 0.0, dtype, device)
        return eq, sd, hm, ti, U0

    return build


def _limited_state(sd, hm, ti, U0, dt, smooth=False):
    """(U_a, U, prec): the state after three ERK33 steps through the
    kernels from the inflow with an 8:1 density and 1000:1 energy contrast
    in a ball around (1, 0.5[, 0.5]) (`smooth`: a smooth bump), so the
    limiter works, and U after one more step, prepared."""
    pos = torch.as_tensor(sd.positions.T, dtype=dt, device="cuda")
    centre = torch.tensor([1.0, 0.5, 0.5][: pos.shape[0]], dtype=dt,
                          device="cuda")[:, None]
    dist2 = torch.sum((pos - centre) ** 2, 0)
    U0 = U0.clone()
    if smooth:
        U0[0] *= 1.0 + 0.25 * torch.exp(-8.0 * dist2)
    else:
        ball = (dist2 < 0.2 ** 2) & torch.as_tensor(sd.node_mask > 0,
                                                    device="cuda")
        U0[0, ball] *= 8.0
        U0[-1, ball] *= 1000.0
    U_a, _, t_a, _, _, _ = ti.advance(U0, 0.0, 3)
    U_b = ti.advance(U_a, t_a, 1)[0]
    U, prec = hm.prepare_state_vector(U_b, 0.0)
    return U_a, U, prec


def _stage_inputs(hm, U_a, U):
    """(stage states [4, C, n], weight lists): U_a, U and two prepared
    states between them; ERK33's third, a one-slot and a zero-slot
    substep, then ERK54's substeps of 3 and 4 slots (the kernels' second
    instance)."""
    from ryujin_tpu_torch.solver.integrator import TABLEAUX

    mid = [hm.prepare_state_vector(U_a + (U - U_a) * f, 0.0)[0]
           for f in (0.5, 0.25)]
    W = TABLEAUX["erk 54"].W
    return torch.stack([U_a, U] + mid), (
        [0.75, -2.0], [0.25], [], list(W[3][:3]), list(W[4]))


def ghost_case(name):
    """A build_case(refinement, dtype, device) of a canvas with ghosts or
    at K = 48: "periodic vortex" (a y ghost band, a minor wrap; K = 8),
    "slabs 2" / "slabs 4" (the step in slabs of canvas axis 0), "periodic
    box" (3D, z and y bands, a minor wrap), "q3" (cG Q3, K = 48, on the
    2 x 1 rectangle [0, 2] x [0, 1] with dirichlet sides), "SEP
    cylinder3d" (cylinder3d with separable statics and the default
    pad_minor: a minor wrap (32, 128) at refinement 1)."""
    from ryujin_tpu_torch import bench
    from ryujin_tpu_torch.offline.mesh import Boundary

    if name == "periodic vortex":
        return bench.build_periodic_vortex
    if name == "periodic box":
        return bench.build_periodic_box3d
    if name == "SEP cylinder3d":
        return functools.partial(bench.build_cylinder3d, separable=True)

    def build(refinement, dtype, device):
        if name == "q3":
            mesh = bench.geometry.rectangular_domain(
                [0.0, 0.0], [2.0, 1.0], [2, 1], refinement + 2,
                boundary_conditions=[Boundary.dirichlet] * 4)
            data, kw = bench.assembly.assemble(mesh, ansatz="cG Q3"), {}
        else:
            mesh = bench.geometry.step(refinement=refinement)
            data = bench.assembly.assemble(mesh)
            kw = {"slabs": int(name.split()[1])}
        sd = bench.structured.pack_structured(data, mesh, **kw)
        eq = bench.Euler(dim=2)
        init = bench.make_initial_state(eq, "uniform",
                                        primitive_state=(1.4, 3.0, 1.0))
        hm = bench.HyperbolicModule(eq, sd, init, dtype=dtype, device=device)
        ti = bench.TimeIntegrator(hm, "erk 33", cfl_min=0.45, cfl_max=0.9,
                                  cfl_recovery_strategy="bang bang control")
        U0 = bench.interpolate_nodal(init, sd, eq, 0.0, dtype, device)
        return eq, sd, hm, ti, U0

    return build


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["periodic vortex", "slabs 2", "slabs 4",
                                  "periodic box", "q3", "SEP cylinder3d"])
def test_ghost_and_q3_kernels_on_card_match_plain_cpu(case):
    """Three ERK33 steps through the kernels on canvases with ghost rows
    refreshed between kernels (bands, slabs, minor wrap; the SEP instances
    on a minor wrap) and at K = 48 (pk_up's K = 48 instance, the stream
    kernels at reach 3) against the plain path on the CPU, with the launch
    counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ryujin_tpu_torch.kernels import (
        pk1, pk1_stream, pk2, pk2_stream, pk3, pk3_stream, pk_up,
    )

    if case in ("periodic vortex", "slabs 2", "slabs 4"):
        fns = (pk1.pk1, pk2.pk2, pk3.pk3, pk_up.pk_up)
    else:
        fns = (pk1_stream.pk1_stream, pk2_stream.pk2_stream,
               pk3_stream.pk3_stream, pk_up.pk_up)
    _three_steps_card_vs_cpu(ghost_case(case), fns, [3, 3, 3, 6],
                             refinement={"periodic vortex": 4,
                                         "periodic box": 1,
                                         "SEP cylinder3d": 1}.get(case, 0),
                             counter="sep_launches" if case.startswith("SEP")
                             else "launches")


def multiblock_case(name):
    """A build_case(refinement, dtype, device) of a 2D multi-block canvas:
    "amr2d" (bench.build_amr2d: side rows along the 2:1 interface, the
    two-direction route), "cylinder blocks" (six valence-6 corners as side
    rows, packed as amr2d is, the two-direction route), "annulus2d
    half-slot" (bench.build_annulus2d with sym_mb: the stacked kernels
    and the interface fixup)."""
    from ryujin_tpu_torch import bench

    if name == "amr2d":
        return bench.build_amr2d
    if name == "annulus2d half-slot":
        return functools.partial(bench.build_annulus2d, sym_mb=True)

    def build(refinement, dtype, device):
        eq = bench.Euler(dim=2)
        sd = bench.pack_amr2d(bench.geometry.cylinder(refinement=refinement,
                                                      variant="blocks"))
        init = bench.make_initial_state(eq, "uniform",
                                        primitive_state=(1.4, 3.0, 1.0))
        return (eq, sd) + bench._modules(eq, sd, init, dtype, device,
                                         "bang bang control", False)

    return build


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["amr2d", "cylinder blocks",
                                  "annulus2d half-slot"])
def test_multiblock_kernels_on_card_match_plain_cpu(case):
    """Three ERK33 steps through the kernels on 2D multi-block canvases
    (the cross-block refreshes and the side rows between kernels; the 2D
    two-direction stream instances, or the stacked kernels on the
    half-slot route) against the plain path on the CPU, with the launch
    counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ryujin_tpu_torch.kernels import (
        pk1, pk1_stream, pk2, pk2_stream, pk3, pk3_stream, pk_up,
    )

    if case.endswith("half-slot"):
        fns = (pk1.pk1, pk2.pk2, pk3.pk3, pk_up.pk_up)
    else:
        fns = (pk1_stream.pk1_stream, pk2_stream.pk2_stream,
               pk3_stream.pk3_stream, pk_up.pk_up)
    _three_steps_card_vs_cpu(multiblock_case(case), fns, [3, 3, 3, 6],
                             refinement={"amr2d": 4,
                                         "cylinder blocks": 1}.get(case, 0))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", ["ragged box", "ragged step", "cylinder",
                                  "periodic vortex", "periodic box", "q3"])
def test_tiled_kernels_bit_equal_on_card(case, dtype):
    """pk1_stream's e, pk2_stream (U_low, F, bounds) and pk3_stream (P, l,
    okp), each at 2, 1 and 0 stages and at ERK54's 3 and 4, and pk_up (U
    and l' of PK4, U of PK5) bit for bit against their plain twins on
    the card, and pk1_stream's alpha within PERF.md §2's bar (relative 1e-5 in f32,
    1e-11 in f64, on the real nodes), on the same inputs: on
    canvases with partial tiles on x and y (the ragged box, also on z for
    pk1_stream and pk2_stream, two-direction or half-slot as its module
    decides, and the
    ragged cG Q2 step) and on the cylinder at refinement 1, whose minor
    axis is its periodic angle, 32 cells, packed exactly.  The state:
    three ERK33 steps through the kernels from the inflow with an 8:1
    density and 1000:1 energy contrast in a ball (the cylinder: a smooth
    bump), so the limiter works."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ryujin_tpu_torch.bench import build_cylinder3d
    from ryujin_tpu_torch.kernels import (
        pk1_stream, pk2_stream, pk3_stream, pk_up,
    )
    from ryujin_tpu_torch.solver.hyperbolic import (
        d_from_e, d_from_lambda, tau_max_from_d,
    )

    from ryujin_tpu_torch.solver.canvas_step import refresh

    dt = getattr(torch, dtype)
    if case == "cylinder":
        _, sd, hm, ti, U0 = build_cylinder3d(1, dt, "cuda", pad_minor=32)
        assert sd.shape[-1] == 32
    elif case in ("periodic vortex", "periodic box", "q3"):
        _, sd, hm, ti, U0 = ghost_case(case)(
            {"periodic vortex": 4, "periodic box": 1, "q3": 0}[case], dt,
            "cuda")
        assert (sd.max_degree == 48) == (case == "q3")
    else:
        _, sd, hm, ti, U0 = ragged_case(3 if case == "ragged box" else 2)(
            1 if case == "ragged box" else 0, dt, "cuda")
        assert sd.shape[-1] % 32 and sd.shape[-2] % 4
    eq, p, ca = hm.eq, hm.params, hm.canvas.arrays
    st, half = ca.stencil, hm.half
    U_a, U, prec = _limited_state(sd, hm, ti, U0, dt,
                                  case in ("cylinder", "periodic vortex",
                                           "periodic box"))
    refresh(st, U, prec)
    lam, alpha = pk1_stream.pk1_stream_reference(eq, p, ca, U, prec,
                                                 half=half)
    e_k, alpha_k = pk1_stream.pk1_stream(eq, p, ca, U, prec, half=half)
    assert torch.equal(e_k, lam), (e_k - lam).abs().max()
    real = st.node_mask > 0
    alpha_rel = ((alpha_k - alpha).abs()[real].max()
                 / alpha.abs()[real].max()).item()
    assert alpha_rel <= (1e-5 if dt == torch.float32 else 1e-11), alpha_rel
    full = st.full()
    if half:
        lam = hm._lambda_fixup(lam, U, prescaled=True)
        d = d_from_lambda(full, lam, None)
    else:
        d = d_from_e(full.mask, lam, full.transpose_edge(lam))
    refresh(st, lam, alpha)
    tau = tau_max_from_d(st, d, 0.9,
                         torch.full((), float("inf"), dtype=dt, device="cuda"))
    stage_U, weights = _stage_inputs(hm, U_a, U)
    refresh(st, stage_U)
    limited = 0
    for w in weights:
        sU = stage_U[: len(w)]
        args2 = (eq, p, ca, U, prec, lam, alpha, sU, w, tau)
        U_low, F, bounds = pk2_stream.pk2_stream_reference(*args2, half=half)
        got2 = pk2_stream.pk2_stream(*args2, half=half)
        for name, a, b in zip(("U_low", "F", "bounds"), got2,
                              (U_low, F, bounds)):
            assert torch.equal(a, b), (name, len(w), (a - b).abs().max())
        refresh(st, F)
        args = (eq, p, ca, U, lam, alpha, F, U_low, bounds, sU, w, tau)
        got = pk3_stream.pk3_stream(*args, half=half)
        want = pk3_stream.pk3_stream_reference(*args, half=half)
        for name, a, b in zip(("P", "l", "okp"), got, want):
            assert torch.equal(a, b), (name, len(w), (a - b).abs().max())
        limited += int((want[1] < 1).sum())
    assert limited > 0
    P, l = want[:2]
    refresh(st, l)
    args4 = (eq, p, ca, U_low, bounds, P, l, False)
    (U4, l4), (U4_r, l4_r) = pk_up.pk_up(*args4), pk_up.pk_up_reference(*args4)
    assert torch.equal(U4, U4_r) and torch.equal(l4, l4_r)
    refresh(st, l4_r)
    args5 = (eq, p, ca, U4_r, bounds, P, l4_r, True)
    assert torch.equal(pk_up.pk_up(*args5)[0],
                       pk_up.pk_up_reference(*args5)[0])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("ansatz", ["cG Q1", "dG Q1"])
def test_stacked_pk1_on_ragged_canvas(ansatz, dtype):
    """The stacked pk1 (lambda on the half slots, alpha) against its plain
    twin on the card, on the same inputs, on the K = 8 canvases with
    partial tiles on x and y of test_stacked_pk3_on_ragged_canvas (cG Q1
    step, dG Q1 rectangle), within PERF.md §2's bar: relative 1e-5 in
    f32, 1e-11 in f64, lambda on the live half slots, alpha on the real
    nodes; masked slots hold lambda 0 and padded cells alpha 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ryujin_tpu_torch.kernels import pk1

    dt = getattr(torch, dtype)
    _, sd, hm, ti, U0 = ragged_case(2, ansatz)(
        0 if ansatz == "cG Q1" else 3, dt, "cuda")
    assert sd.shape[-1] % 32 and sd.shape[-2] % 4
    assert sd.max_degree == 8 and not hm.canvas.stream
    eq, p, ca = hm.eq, hm.params, hm.canvas.arrays
    st = ca.stencil
    _, U, prec = _limited_state(sd, hm, ti, U0, dt)
    before = pk1.pk1.launches
    lam_k, alpha_k = pk1.pk1(eq, p, ca, U, prec)
    assert pk1.pk1.launches == before + 1
    lam, alpha = pk1.pk1_reference(eq, p, ca, U, prec)
    live = torch.stack([st.live_k(k) for k in range(4)]).reshape(4, -1)
    real = (st.node_mask > 0).reshape(-1)
    bar = 1e-5 if dt == torch.float32 else 1e-11
    for name, a, b, where in (("lambda", lam_k, lam, live),
                              ("alpha", alpha_k, alpha, real)):
        assert bool(torch.isfinite(a).all()), name
        rel = ((a - b).abs()[where].max() / b.abs()[where].max()).item()
        assert rel <= bar, (name, rel)
        assert bool((a[~where] == 0).all()), name


@pytest.mark.gpu
@pytest.mark.parametrize("S", [1, 8, 1024])
def test_sublane_gather_exact_on_ragged_width(S):
    """The sublane gather out[s, l] = x[idx[s, l], l] bit for bit against
    np.take_along_axis at the probe's L = 128 and at L = 70 and 33 (not
    multiples of its 32-column tile, nor of the 4 floats of a 16-byte
    piece), S = 1, 8 and 1024, with an index past each end giving NaN."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np

    from ryujin_tpu_torch.kernels import build, probe_gather

    for L in (128, 70, 33):
        x = np.arange(S * L, dtype=np.float32).reshape(S, L)
        idx = np.random.default_rng(0).integers(0, S, size=(S, L)).astype(np.int32)
        want = np.take_along_axis(x, idx, axis=0)
        idx[0, 0], idx[-1, -1] = S, -1
        want[0, 0] = want[-1, -1] = np.nan
        key = build.probe_key("sublane_gather", S, L)
        before = build.PROBE_LAUNCHES[key]
        out = probe_gather.sublane_gather(torch.from_numpy(x).cuda(),
                                          torch.from_numpy(idx).cuda())
        assert build.PROBE_LAUNCHES[key] == before + 1
        assert np.array_equal(out.cpu().numpy(), want, equal_nan=True), (S, L)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("ansatz", ["cG Q1", "dG Q1"])
def test_stacked_pk2_on_ragged_canvas(ansatz, dtype):
    """The stacked pk2 (U_low, F, bounds at 2, 1, 0, 3 and 4 stages; cG,
    and dG Q1 with its incidence factor) against its plain twin on the card, on
    the same inputs, on the K = 8 canvases with partial tiles on x and y
    of test_stacked_pk3_on_ragged_canvas, within PERF.md §2's bar:
    relative 1e-5 in f32, 1e-11 in f64, on the real nodes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ryujin_tpu_torch.kernels import pk1, pk2
    from ryujin_tpu_torch.solver.hyperbolic import (
        d_from_lambda, tau_max_from_d,
    )

    dt = getattr(torch, dtype)
    _, sd, hm, ti, U0 = ragged_case(2, ansatz)(
        0 if ansatz == "cG Q1" else 3, dt, "cuda")
    assert sd.shape[-1] % 32 and sd.shape[-2] % 4
    assert sd.max_degree == 8 and not hm.canvas.stream
    eq, p, ca = hm.eq, hm.params, hm.canvas.arrays
    assert (ca.g_inc is not None) == (ansatz == "dG Q1")
    st = ca.stencil
    U_a, U, prec = _limited_state(sd, hm, ti, U0, dt)
    lam, alpha = pk1.pk1_reference(eq, p, ca, U, prec)
    lam = hm._lambda_fixup(lam, U, prescaled=False)
    full = st.full()
    tau = tau_max_from_d(st, d_from_lambda(full, lam, full.cmax), 0.9,
                         torch.full((), float("inf"), dtype=dt, device="cuda"))
    stage_U, weights = _stage_inputs(hm, U_a, U)
    real = st.node_mask > 0
    for w in weights:
        args = (eq, p, ca, U, prec, lam, alpha, stage_U[: len(w)], w, tau)
        for name, a, b in zip(("U_low", "F", "bounds"), pk2.pk2(*args),
                              pk2.pk2_reference(*args)):
            rel = ((a - b).abs()[:, real].max()
                   / b.abs()[:, real].max()).item()
            assert rel <= (1e-5 if dt == torch.float32 else 1e-11), (
                name, len(w), rel)
            assert bool(torch.isfinite(a).all()), (name, len(w))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("ansatz", ["cG Q1", "dG Q1"])
def test_stacked_pk3_on_ragged_canvas(ansatz, dtype):
    """The stacked pk3 (P, l, okp at 2, 1, 0, 3 and 4 stages; cG, and dG
    Q1 with its incidence factor) against its plain twin on the card, on the same
    inputs, on K = 8 canvases with partial tiles on x and y (the cG Q1
    step, the dG Q1 rectangle: ragged_case), within PERF.md §2's bars: P
    relative 1e-5 in f32, 1e-11 in f64; l 1e-4 on all but 0.01 % of the
    live edges and 5e-3 on every edge in f32, 1e-8 in f64; okp equal on
    the real nodes.  The state as in test_tiled_kernels_bit_equal_on_card,
    the limiter at work."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ryujin_tpu_torch.kernels import pk1, pk2, pk3
    from ryujin_tpu_torch.solver.hyperbolic import (
        d_from_lambda, tau_max_from_d,
    )

    dt = getattr(torch, dtype)
    f32 = dt == torch.float32
    _, sd, hm, ti, U0 = ragged_case(2, ansatz)(
        0 if ansatz == "cG Q1" else 3, dt, "cuda")
    assert sd.shape[-1] % 32 and sd.shape[-2] % 4
    assert sd.max_degree == 8 and not hm.canvas.stream
    eq, p, ca = hm.eq, hm.params, hm.canvas.arrays
    assert (ca.g_inc is not None) == (ansatz == "dG Q1")
    st = ca.stencil
    U_a, U, prec = _limited_state(sd, hm, ti, U0, dt)
    lam, alpha = pk1.pk1_reference(eq, p, ca, U, prec)
    lam = hm._lambda_fixup(lam, U, prescaled=False)
    full = st.full()
    tau = tau_max_from_d(st, d_from_lambda(full, lam, full.cmax), 0.9,
                         torch.full((), float("inf"), dtype=dt, device="cuda"))
    stage_U, weights = _stage_inputs(hm, U_a, U)
    live = st.mask > 0
    real = st.node_mask > 0
    limited = 0
    for w in weights:
        sU = stage_U[: len(w)]
        U_low, F, bounds = pk2.pk2_reference(eq, p, ca, U, prec, lam, alpha,
                                             sU, w, tau)
        args = (eq, p, ca, U, lam, alpha, F, U_low, bounds, sU, w, tau)
        (P_k, l_k, okp_k), (P, l, okp) = pk3.pk3(*args), pk3.pk3_reference(*args)
        P_rel = ((P_k - P).abs()[:, live].max() / P.abs()[:, live].max()).item()
        assert P_rel <= (1e-5 if f32 else 1e-11), (len(w), P_rel)
        l_diff = (l_k - l).abs()[live]
        assert l_diff.max().item() <= (5e-3 if f32 else 1e-8), len(w)
        if f32:
            assert int((l_diff > 1e-4).sum()) <= 1e-4 * l_diff.numel()
        assert torch.equal(okp_k[real], okp[real]), len(w)
        assert bool(torch.isfinite(P_k).all() and torch.isfinite(l_k).all())
        limited += int((l[live] < 1).sum())
    assert limited > 0


def ell_case(name):
    """bench.ell_case as a build_case: (refinement, dtype, device) ->
    (eq, packed, hm, ti, U0); "1D" the shock front's tube (K = 2), "2D dG
    Q1" the step in dG Q1, "3D" the 3 x 2 x 2 box (K = 26), the airfoil
    (irregular rows), "ragged" the cG Q1 step unpadded (16,449 rows: the
    last block of ell_pk2 and ell_pk3 ragged)."""
    from ryujin_tpu_torch import bench

    return functools.partial(bench.ell_case, name, subdiv=(3, 2, 2))


ELL_CASES = {"1D": 2, "2D dG Q1": 0, "3D": 0, "airfoil": 0, "ragged": 0}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(ELL_CASES))
def test_ell_kernels_on_card_match_plain_cpu(name):
    """Three ERK33 steps through ell_pk1, ell_pk2, ell_pk3 and ell_pk_up on
    the card against the plain path on the CPU, float64, with the launch
    counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ryujin_tpu_torch.kernels import ell

    _three_steps_card_vs_cpu(
        ell_case(name), (ell.ell_pk1, ell.ell_pk2, ell.ell_pk3, ell.ell_pk_up),
        [3, 3, 3, 6], refinement=ELL_CASES[name])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", sorted(ELL_CASES))
def test_ell_kernels_each_against_plain(name, dtype):
    """Each ELL kernel against its plain version on the card, on identical
    inputs from a state with a blast, at every stage-slot count (ERK33's
    third substep, one and no slot, ERK54's 3 and 4), at PERF.md section 2's
    bars: relative 1e-5 (f32) / 1e-11 (f64) on e, alpha, U_low, F, the
    bounds and P; absolute 1e-5 / 1e-11 on U after PK4 and PK5; in f32 l
    and l' 5e-3 on every live edge and 1e-4 on all but 0.01 % of them; in
    f64 l 1e-8 on every live edge, and l' 1e-8 on every live edge but at
    most 0.01 % of them, each of which must lie within what one ulp of one
    entry of U_next moves the plain l' there.  The kernels' pow (built
    with -fmad=false) and torch.pow round otherwise on a few arguments, and
    where psi is flat at its root that ulp of rho^gamma moves l' far: on
    this blast one edge of the 2D dG Q1 step's l' by 3.8e-8, where one ulp
    of U_next moves the plain l' by 1.8e-5 (PERF.md section 7,
    python -m ryujin_tpu_torch.limiter_rounding)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ryujin_tpu_torch import limiter_rounding
    from ryujin_tpu_torch.kernels import ell
    from ryujin_tpu_torch.solver.hyperbolic import d_from_e, tau_max_from_d

    dt = getattr(torch, dtype)
    f32 = dt == torch.float32
    rel = 1e-5 if f32 else 1e-11
    _, packed, hm, ti, U0 = ell_case(name)(ELL_CASES[name], dt, "cuda")
    eq, p, st = hm.eq, hm.params, hm.stencil
    U_a, U, prec = _limited_state(packed, hm, ti, U0, dt)
    live, real = st.mask > 0, st.node_mask > 0

    def close(a, b, where, what):
        scale = b[..., where].abs().max().item()
        d = (a - b)[..., where].abs().max().item()
        assert d <= rel * max(scale, 1e-300), (what, d, scale)

    def l_close(a, b, what, spread=None):
        """l within its bar on the live edges; an edge beyond it (at most
        0.01 % of them) within 5e-3 in f32, in f64 within spread(k, i)
        where one is given, else nowhere."""
        diff = (a - b).abs() * live
        beyond = (diff > (1e-4 if f32 else 1e-8)).nonzero().tolist()
        assert len(beyond) <= 1e-4 * int(live.sum()), (what, len(beyond))
        for k, i in beyond:
            cap = 5e-3 if f32 else spread(k, i) if spread else 0.0
            assert diff[k, i].item() <= cap, (what, k, i, diff[k, i].item())

    def ulp_spread(U_next, bounds, P, l):
        """spread(k, i): how far one ulp of one entry of U_next[:, i] moves
        the plain l' of slot k at row i."""
        l_T = st.transpose_edge(l)

        def spread(k, i):
            rest = 1.0 - torch.minimum(l[k, i], l_T[k, i])
            return limiter_rounding.ulp_spread(eq, p, bounds[:, i],
                                               U_next[:, i], rest, P[:, k, i])
        return spread

    args = (eq, p, st, U, prec)
    (e_k, a_k), (e, alpha) = ell.ell_pk1(*args), ell.ell_pk1_reference(*args)
    close(e_k, e, live, "e")
    close(a_k, alpha, real, "alpha")
    d = d_from_e(st.mask, e, st.transpose_edge(e))
    tau = tau_max_from_d(st, d, 0.9, torch.full((), float("inf"), dtype=dt,
                                                device="cuda"))
    stage_U, weights = _stage_inputs(hm, U_a, U)
    limited = 0
    for w in weights:
        sU = stage_U[: len(w)]
        args = (eq, p, st, U, prec, d, alpha, sU, w, tau)
        got, want = ell.ell_pk2(*args), ell.ell_pk2_reference(*args)
        for a, b, what in zip(got, want, ("U_low", "F", "bounds")):
            close(a, b, real, (what, len(w)))
        U_low, F, bounds = want
        args = (eq, p, st, U, d, alpha, F, U_low, bounds, sU, w, tau)
        (P_k, l_k, okp_k), (P, l, okp) = (ell.ell_pk3(*args),
                                          ell.ell_pk3_reference(*args))
        close(P_k, P, live, ("P", len(w)))
        l_close(l_k, l, ("l", len(w)))
        assert torch.equal(okp_k[real], okp[real]), len(w)
        limited += int((l[live] < 1).sum())
    for last in (False, True):
        args = (eq, p, st, U_low, bounds, P, l, last)
        (U_k, lk), (U_r, lr) = (ell.ell_pk_up(*args),
                                ell.ell_pk_up_reference(*args))
        d_U = (U_k - U_r)[:, real].abs().max().item()
        assert d_U <= (1e-5 if f32 else 1e-11), (last, d_U)
        if last:
            assert lk is None and lr is None
        else:
            l_close(lk, lr, "l'", ulp_spread(U_r, bounds, P, l))
    assert limited > 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", ["3D", "airfoil", "ragged"])
def test_ell_step_launches_bit_equal(name, dtype):
    """ell_pk1 (e, alpha), ell_pk2 (U_low, F, bounds), ell_pk3 (P, l, okp)
    and ell_pk_up (PK4: U_next, l'; PK5: U_next) at every launch of
    tile_sweep.ELL_STEP_CANDIDATES (rows and threads of a block; fewer rows
    where the shared bytes need) bit for bit against their default launch,
    ell_pk2 and ell_pk3 at every stage-slot count, on a state with a
    blast."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import itertools

    from ryujin_tpu_torch.kernels import ell
    from ryujin_tpu_torch.solver.hyperbolic import d_from_e, tau_max_from_d
    from ryujin_tpu_torch.tile_sweep import ELL_STEP_CANDIDATES

    dt = getattr(torch, dtype)
    _, packed, hm, ti, U0 = ell_case(name)(ELL_CASES[name], dt, "cuda")
    eq, p, st = hm.eq, hm.params, hm.stencil
    U_a, U, prec = _limited_state(packed, hm, ti, U0, dt)
    e, alpha = want1 = ell.ell_pk1(eq, p, st, U, prec)
    d = d_from_e(st.mask, e, st.transpose_edge(e))
    tau = tau_max_from_d(st, d, 0.9, torch.full((), float("inf"), dtype=dt,
                                                device="cuda"))
    stage_U, weights = _stage_inputs(hm, U_a, U)
    calls = [("ell_pk1", 0, False, (eq, p, st, U, prec), want1)]
    for w in weights:
        sU = stage_U[: len(w)]
        args2 = (eq, p, st, U, prec, d, alpha, sU, w, tau)
        U_low, F, bounds = want2 = ell.ell_pk2(*args2)
        args3 = (eq, p, st, U, d, alpha, F, U_low, bounds, sU, w, tau)
        P, l, _ = want3 = ell.ell_pk3(*args3)
        calls += [("ell_pk2", len(w), False, args2, want2),
                  ("ell_pk3", len(w), False, args3, want3)]
    args4 = (eq, p, st, U_low, bounds, P, l, False)
    U4, l4 = want4 = ell.ell_pk_up(*args4)
    assert bool((l4[st.mask > 0] > 0).any())
    args5 = (eq, p, st, U4, bounds, P, l4, True)
    calls += [("ell_pk_up", 0, False, args4, want4),
              ("ell_pk_up", 0, True, args5, ell.ell_pk_up(*args5))]
    launches = collections.Counter()
    for kern, S, last, args, want in calls:
        for rows, threads in itertools.product(*ELL_STEP_CANDIDATES.values()):
            try:
                shape = ell.ell_step_shape(kern, st.dim, st.K, dt, S, st.n,
                                           rows, threads, last=last)
            except ValueError:  # fewer threads than rows, or too large
                continue
            got = getattr(ell, kern)(*args, shape=shape)
            launches[kern, last] += 1
            for a, b in zip(got, want):
                assert (a is None and b is None) or torch.equal(a, b), (
                    kern, S, last, shape)
    assert min(launches.values()) >= 2 and len(launches) == 5, launches

