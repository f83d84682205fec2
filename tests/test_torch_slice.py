"""The step2d slice of the PyTorch port against the JAX package: three
ERK33 steps through TimeIntegrator.advance on the shared step fixture
(tests/test_torch_fixture.py), CFL 0.9, recovery "none", float64, with
convert.py as the bridge.  Relative 5e-11 / absolute 1e-12."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from ryujin_tpu.solver.hyperbolic import (  # noqa: E402
    HyperbolicModule as JHyperbolicModule,
)
from ryujin_tpu.solver.integrator import TimeIntegrator as JTimeIntegrator  # noqa: E402

from ryujin_tpu_torch import convert  # noqa: E402
from ryujin_tpu_torch.kernels import pk1, pk2, pk3, pk_up  # noqa: E402
from ryujin_tpu_torch.solver.hyperbolic import HyperbolicModule  # noqa: E402
from ryujin_tpu_torch.solver.integrator import (  # noqa: E402
    TABLEAUX,
    TimeIntegrator,
)

from test_torch_fixture import assert_close, modules, step_case, to_torch  # noqa: E402


def test_three_erk33_steps_match_jax():
    sd, _, _, U0, _, _, _ = step_case()
    jhm, hm = modules()
    jti = JTimeIntegrator(jhm, "erk 33", cfl_min=0.9, cfl_max=0.9,
                          cfl_recovery_strategy="none")
    ref = jti.advance(jnp.asarray(U0), 0.0, 3)
    ti = TimeIntegrator(hm, "erk 33", cfl_min=0.9, cfl_max=0.9,
                        cfl_recovery_strategy="none")
    U, prec, t, tau, restarts, warns = ti.advance(
        convert.state_from_reference(U0, "cpu", torch.float64), 0.0, 3
    )
    real = sd.node_mask > 0
    assert_close(U.numpy()[:, real], np.asarray(ref[0])[:, real], "U")
    assert_close(prec.numpy()[:, real], np.asarray(ref[1])[:, real], "prec")
    assert_close(t, ref[2], "t")
    assert_close(tau, ref[3], "tau")
    assert int(warns) == int(ref[5]) == 0
    assert int(restarts) == 0
    for x in (t, tau, warns):
        assert x.shape == () and x.device.type == "cpu"


def test_f32_one_step_matches_pallas_interpret():
    """The port's plain path in float32 against the JAX package's fused
    Pallas kernels (interpret mode) in float32: one ERK33 step at the bar
    of tests/test_pallas.py:178-181 (2e-4 absolute on U, 1e-4 relative on
    tau)."""
    sd, jeq, jinit, U0, eq, params, init = step_case()
    jhm = JHyperbolicModule(jeq, sd, jinit, dtype=jnp.float32,
                            backend="pallas_interpret")
    jti = JTimeIntegrator(jhm, "erk 33", cfl_min=0.9, cfl_max=0.9,
                          cfl_recovery_strategy="none")
    ref = jti.advance(jnp.asarray(U0, jnp.float32), 0.0, 1)
    hm = HyperbolicModule(eq, sd, init, params=params, dtype=torch.float32,
                          device="cpu")
    ti = TimeIntegrator(hm, "erk 33", cfl_min=0.9, cfl_max=0.9,
                        cfl_recovery_strategy="none")
    U, _, _, tau, _, warns = ti.advance(
        convert.state_from_reference(U0, "cpu", torch.float32), 0.0, 1
    )
    real = sd.node_mask > 0
    U_ref = np.asarray(ref[0])[:, real]
    assert np.isfinite(U.numpy()[:, real]).all()
    assert np.abs(U.numpy()[:, real] - U_ref).max() < 2e-4
    assert abs(float(tau) / float(ref[3]) - 1.0) < 1e-4
    assert int(warns) == int(ref[5]) == 0


@pytest.mark.parametrize("scheme", ["erk 33", "erk 54"])
def test_canvas_stepper_matches_plain_step(scheme):
    """The kernels' orchestration (CanvasStepper: PK1, fixup, d/tau glue,
    PK2, PK3, PK4, PK5), run on CPU tensors where every wrapper takes its
    reference, against the plain phase-function substep, for the stage
    layouts of each substep of ERK33 (0-2 slots) or ERK54 (0-4 slots),
    each substep's output a stage state of the next; no kernel is
    launched."""
    _, _, _, U0, _, _, _ = step_case()
    _, hm = modules()
    tb = TABLEAUX[scheme]
    before = [f.launches for f in (pk1.pk1, pk2.pk2, pk3.pk3, pk_up.pk_up)]
    Ua, preca = hm.prepare_state_vector(to_torch(U0), 0.0)
    cap = torch.tensor(float("inf"), dtype=torch.float64)
    tau = torch.zeros((), dtype=torch.float64)
    bufs, widest = [Ua], 0
    for idx in range(tb.n_sub):
        active = [s for s in range(tb.S) if tb.W[idx][s] != 0.0]
        widest = max(widest, len(active))
        weights = [tb.W[idx][s] for s in active]
        stage_U = torch.stack([bufs[s] for s in active]) if active else None
        args = (Ua, preca, stage_U, weights, tau, 0.9, cap, idx == 0)
        U_c, tau_c, ok_c = hm.canvas.step(*args)
        U_p, tau_p, ok_p = hm.plain_step(*args)
        assert_close(U_c, U_p, f"U, stages {weights}")
        assert_close(tau_c, tau_p, f"tau, stages {weights}")
        assert bool(ok_c) and bool(ok_p)
        bufs.append(hm.prepare_state_vector(U_p, 0.0)[0])
        tau = tau_p
    assert widest == tb.S
    after = [f.launches for f in (pk1.pk1, pk2.pk2, pk3.pk3, pk_up.pk_up)]
    assert before == after


def test_step_returns_device_scalars_and_routes_cpu_to_plain():
    """TimeIntegrator.step gives (U, tau, ok) as tensors without a host
    read, and HyperbolicModule.step runs the plain path for CPU tensors."""
    _, _, _, U0, _, _, _ = step_case()
    _, hm = modules()
    ti = TimeIntegrator(hm, "erk 33", cfl_min=0.9, cfl_max=0.9,
                        cfl_recovery_strategy="none")
    U, tau, ok = ti.step(to_torch(U0), 0.0)
    assert torch.is_tensor(tau) and torch.is_tensor(ok)
    assert bool(ok) and float(tau) > 0.0
    assert torch.isfinite(U).all()
    with pytest.raises(NotImplementedError):
        TimeIntegrator(hm, "strang ssprk 33 cn")
    with pytest.raises(ValueError):
        TimeIntegrator(hm, "ssprk 44")
    with pytest.raises(NotImplementedError):
        TimeIntegrator(hm, "erk 33", cfl_recovery_strategy="adaptive")


def test_recovery_default_matches_jax():
    """TimeIntegrator's field defaults (scheme, CFL bounds, recovery) equal
    the JAX package's: a step whose limiter fails at cfl_max is redone at
    cfl_min by default in both."""
    import dataclasses

    def defaults(cls):
        return {f.name: f.default for f in dataclasses.fields(cls)
                if f.default is not dataclasses.MISSING}

    ours, theirs = defaults(TimeIntegrator), defaults(JTimeIntegrator)
    assert ours["cfl_recovery_strategy"] == "bang bang control"
    for name, value in ours.items():
        assert theirs[name] == value, name
