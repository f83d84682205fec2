"""The separable-statics substep of the PyTorch port, phase by phase, and
one ERK33 step, against the full-statics plain path and the JAX package.

On the two small canvases of tests/test_torch_sep_offline.py (the
cylinder o-grid on the two-direction route, the 3 x 2 x 2 box on the
half-slot route), f64:

- every phase (e, alpha, d, tau, U_low, F, bounds, P, l, U after PK4 and
  PK5) of the separable plain path (the kernel wrappers on CPU tensors,
  whose references read the statics through the synthesizing accessors)
  on the JAX side's inputs, against the JAX package's XLA phase functions
  (which read its stored statics) and against the port's full-statics
  plain path on the same inputs;
- one bang-bang ERK33 step through CanvasStepper (CPU tensors: every
  kernel wrapper takes its plain version, and the d / tau glue rebuilds d
  offset by offset from the synthesized mask) in both modes on the small
  cylinder, against one JAX XLA advance.

Bars: against JAX, relative 5e-11 / absolute 1e-12 as every phase test of
the port.  Separable against full: both paths do the same arithmetic on
statics that differ by the synthesis residual (measured here, 4.4e-16
and 5.0e-16 relative on the two canvases), so the bar is that residual
times SEP_GAIN = 1e3.  The phases amplified it by at most 11 when this was
written (F and alpha, each relative to its own largest entry; alpha is a
ratio of two small indicator sums), so the bar leaves a factor of 90.
The limiter's l holds under the edge-count rule of
tests/test_torch_box3d_phases.py in both comparisons.
No interpret-mode kernel runs.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from ryujin_tpu.postprocess.error import interpolate_nodal  # noqa: E402
from ryujin_tpu.solver import hyperbolic as jhyp  # noqa: E402
from ryujin_tpu.solver.integrator import TimeIntegrator as JTimeIntegrator  # noqa: E402

from ryujin_tpu_torch.kernels.pk1_stream import pk1_stream  # noqa: E402
from ryujin_tpu_torch.kernels.pk2_stream import pk2_stream  # noqa: E402
from ryujin_tpu_torch.kernels.pk3_stream import pk3_stream  # noqa: E402
from ryujin_tpu_torch.kernels.pk_up import pk_up  # noqa: E402
from ryujin_tpu_torch.kernels import (  # noqa: E402
    pk1_stream as m1, pk2_stream as m2, pk3_stream as m3, pk_up as m4,
)
from ryujin_tpu_torch.solver import hyperbolic as thyp  # noqa: E402
from ryujin_tpu_torch.solver.integrator import TimeIntegrator  # noqa: E402

from test_torch_box3d_phases import assert_l_close, jax_phases  # noqa: E402
from test_torch_fixture import assert_close, to_torch  # noqa: E402
from test_torch_sep_offline import (  # noqa: E402
    CANVASES, EQ, JEQ, K, PARAMS, residual, sep_case,
)

K2 = K // 2
WEIGHTS = [0.75, -2.0]
CFL = 0.9
SEP_GAIN = 1e3
RECOVERY = dict(cfl_min=0.45, cfl_max=0.9,
                cfl_recovery_strategy="bang bang control")


@functools.lru_cache(maxsize=None)
def initial_state(name):
    """The inflow state [5, n_pad] times a seeded bump of density and
    energy inside the domain."""
    case = sep_case(name)
    sd = case.sd
    U = np.array(interpolate_nodal(case.jinit, sd, JEQ, 0.0, jnp.float64))
    real = sd.node_mask > 0
    pos = sd.positions.T
    lo, hi = pos[:, real].min(1), pos[:, real].max(1)
    rng = np.random.default_rng(3305)
    center = rng.uniform(lo + 0.3 * (hi - lo), lo + 0.7 * (hi - lo))
    width = rng.uniform(6.0, 10.0) / np.max(hi - lo) ** 2
    bump = 1.0 + 0.3 * np.exp(
        -width * np.sum((pos - center[:, None]) ** 2, 0)
    )
    bump = np.where(real, bump, 1.0)
    U[0] *= bump
    U[-1] *= bump ** 2
    return U


@functools.lru_cache(maxsize=None)
def jax_module(name):
    case = sep_case(name)
    return jhyp.HyperbolicModule(JEQ, case.sd, case.jinit, dtype=jnp.float64)


@functools.lru_cache(maxsize=None)
def jax_ref(name):
    route = CANVASES[name][0]
    return jax_phases(sep_case(name).sd, jax_module(name),
                      initial_state(name), route)


def port_phases(hm, t, half):
    """Every phase of the port's plain path on the JAX side's inputs `t`."""
    ca, st = hm.canvas.arrays, hm.stencil
    out = {}
    out["e"], out["alpha"] = pk1_stream(EQ, PARAMS, ca, t["U"], t["prec"],
                                        half)
    if half:
        out["e_fixed"] = hm._lambda_fixup(t["e"], t["U"], prescaled=True)
    # d through the per-offset form that the separable glue sums
    out["d"] = torch.stack([m2.slot_d(st, t["e_in"], k, half)
                            for k in range(K)])
    cap = torch.tensor(float("inf"), dtype=torch.float64)
    out["tau"] = thyp.tau_max_from_row_sum(st, out["d"].sum(0), CFL, cap)
    stage_U = torch.stack([t["Ua"], t["U"]])
    out["U_low"], out["F"], out["bounds"] = pk2_stream(
        EQ, PARAMS, ca, t["U"], t["prec"], t["e_in"], t["alpha"], stage_U,
        WEIGHTS, t["tau"], half,
    )
    out["P"], out["l"], out["okp"] = pk3_stream(
        EQ, PARAMS, ca, t["U"], t["e_in"], t["alpha"], t["F"], t["U_low"],
        t["bounds"], stage_U, WEIGHTS, t["tau"], half,
    )
    out["U4"], out["l4"] = pk_up(EQ, PARAMS, ca, t["U_low"], t["bounds"],
                                 t["P"], t["l"], False)
    out["U5"], _ = pk_up(EQ, PARAMS, ca, t["U4"], t["bounds"], t["P"],
                         t["l4"], True)
    return {k: v.numpy() for k, v in out.items()}


@pytest.mark.parametrize("name", sorted(CANVASES))
def test_separable_phases(name):
    """Every phase of the separable plain path against the JAX package's
    phase functions and against the full-statics plain path, on the JAX
    side's inputs, on the canvas's Riemann route."""
    case = sep_case(name)
    half = CANVASES[name][0] == "half_slot"
    assert case.hm.half == case.hm_sep.half == half
    ref = jax_ref(name)
    t = {k: to_torch(v) for k, v in ref.items() if k != "moved"}
    before = [f.sep_launches for f in (m1.pk1_stream, m2.pk2_stream,
                                       m3.pk3_stream, m4.pk_up)]
    sep = port_phases(case.hm_sep, t, half)
    full = port_phases(case.hm, t, half)
    assert [f.sep_launches for f in (m1.pk1_stream, m2.pk2_stream,
                                     m3.pk3_stream, m4.pk_up)] == before
    sd = case.sd
    live, real = sd.mask.T > 0, sd.node_mask > 0
    e_live = live[: K2 if half else K]
    bar = SEP_GAIN * residual(case.hm_sep.stencil, sd)
    where = {"e": e_live, "e_fixed": e_live, "alpha": real, "d": None,
             "tau": None, "U_low": (slice(None), real),
             "F": (slice(None), real), "bounds": (slice(None), real),
             "P": (slice(None), live), "U4": (slice(None), real),
             "U5": (slice(None), real)}
    worst = {}
    for key, m in where.items():
        if key not in sep:
            continue
        got, other = sep[key], full[key]
        r = ref[key]
        if m is not None:
            got, other, r = got[m], other[m], r[m]
        assert_close(got, r, f"{key}: separable against JAX")
        rel = np.abs(got - other).max() / max(np.abs(other).max(), 1e-300)
        worst[key] = rel
        assert rel <= bar, f"{key}: separable against full {rel:.3e} > {bar:.3e}"
    print(f"{name}: separable against full, relative, bar {bar:.3e}: "
          + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()))
    for key in ("l", "l4"):
        assert_l_close(sep[key][live], ref[key][live], f"{key} against JAX")
        assert_l_close(sep[key][live], full[key][live], f"{key} against full")
    assert not sep["P"][:, ~live].any() and not sep["l"][~live].any()
    np.testing.assert_array_equal(sep["okp"][real], full["okp"][real])
    ok_ref = np.all(ref["success"] | ~live, axis=0)[real]
    np.testing.assert_array_equal(sep["okp"][real] > 0.5, ok_ref)
    assert 0.0 < ref["l"][live].min() < 1.0, "the limiter must work"


class CanvasSteps:
    """A HyperbolicModule whose substeps run CanvasStepper.step, the
    kernel orchestration (on CPU tensors each wrapper takes its plain
    version)."""

    def __init__(self, hm):
        self.hm, self.dtype, self.device = hm, hm.dtype, hm.device

    def prepare_state_vector(self, U, t):
        return self.hm.prepare_state_vector(U, t)

    def step(self, *args, **kwargs):
        return self.hm.canvas.step(*args, **kwargs)


@functools.lru_cache(maxsize=None)
def jax_step(name):
    out = JTimeIntegrator(jax_module(name), "erk 33", **RECOVERY).advance(
        jnp.asarray(initial_state(name)), 0.0, 1
    )
    return [np.asarray(x) for x in out]


@pytest.mark.parametrize("mode", ["full", "separable"])
def test_one_erk33_step_matches_jax(mode):
    """One bang-bang ERK33 step (CFL 0.9 / 0.45, no restart on this state)
    through CanvasStepper on the small cylinder, in each mode, against the
    JAX package's XLA advance: U, tau at 5e-11."""
    case = sep_case("cylinder")
    hm = case.hm_sep if mode == "separable" else case.hm
    assert hm.canvas.arrays.separable == (mode == "separable")
    ref = jax_step("cylinder")
    out = TimeIntegrator(CanvasSteps(hm), "erk 33", **RECOVERY).advance(
        to_torch(initial_state("cylinder")), 0.0, 1
    )
    real = case.sd.node_mask > 0
    U, prec, t, tau, restarts, warns = out
    assert_close(U.numpy()[:, real], ref[0][:, real], "U")
    assert_close(prec.numpy()[:, real], ref[1][:, real], "prec")
    assert_close(t, ref[2], "t")
    assert_close(tau, ref[3], "tau")
    assert int(restarts) == int(ref[4]) == 0
    assert int(warns) == int(ref[5]) == 0
    assert float(tau) > 0.0
    assert bool(EQ.is_admissible(U[:, torch.as_tensor(real)]).all())


def test_separable_step_on_the_minor_wrap_cylinder():
    """The small cylinder packed with the default pad_minor (its 32-cell
    angle on a 128-wide minor axis: minor_wrap (32, 128)) in separable
    mode.  The synthesized planes equal the stored ones on every cell, the
    ghost columns among them, to the factorization residual (the mask's
    live set exactly); one bang-bang ERK33 step through CanvasStepper
    from initial_state("cylinder"), placed vertex by vertex, equals the
    JAX advance on the exactly packed canvas on every vertex at 5e-11."""
    from ryujin_tpu_torch.offline.separable import _RTOL

    from test_torch_sep_offline import (
        _init, make_initial_state, t_assembly, t_geometry, t_structured,
    )

    mesh = t_geometry.cylinder(refinement=1, dim=3)
    sd = t_structured.pack_structured(t_assembly.assemble(mesh), mesh,
                                      margin=(2, 2))
    assert sd.minor_wrap == (32, 128)
    hm = thyp.HyperbolicModule(EQ, sd, _init(make_initial_state, EQ,
                                             "cylinder"),
                               params=PARAMS, dtype=torch.float64,
                               device="cpu", separable=True)
    st = hm.stencil
    assert st.separable and st.minor_wrap == sd.minor_wrap
    assert residual(st, sd) <= _RTOL
    for k in range(K):
        np.testing.assert_array_equal(st.mask_k(k).numpy(), sd.mask[:, k])
    exact = sep_case("cylinder").sd
    n2v, e2v = sd.node_to_vertex, exact.node_to_vertex
    real, e_real = np.flatnonzero(n2v >= 0), np.flatnonzero(e2v >= 0)
    order = real[np.argsort(n2v[real], kind="stable")]
    e_order = e_real[np.argsort(e2v[e_real], kind="stable")]
    np.testing.assert_array_equal(n2v[order], e2v[e_order])
    from ryujin_tpu_torch import bench

    U0 = bench.interpolate_nodal(hm.initial_state_fn, sd, EQ, 0.0,
                                 torch.float64, "cpu").numpy()
    U0[:, order] = initial_state("cylinder")[:, e_order]
    out = TimeIntegrator(CanvasSteps(hm), "erk 33", **RECOVERY).advance(
        to_torch(U0), 0.0, 1
    )
    ref = jax_step("cylinder")
    assert_close(out[0].numpy()[:, order], ref[0][:, e_order], "U")
    assert_close(out[3], ref[3], "tau")
    assert int(out[4]) == int(ref[4]) == 0
