"""The box3d slice of the PyTorch port against the JAX package: 3D Euler,
cG Q1 (K = 26), f64, on the two small boxes of
tests/test_torch_box3d_phases.py (the half-slot Riemann route on the
3 x 2 x 2 box, the two-direction route on the 7 x 4 x 4 box):

- one ERK33 step with bang-bang recovery through TimeIntegrator.advance
  against the JAX package's advance on its XLA path (backend="xla"), U
  and tau at 5e-11, on both routes;
- the port's stream orchestration (CanvasStepper on CPU tensors, every
  kernel wrapper taking its plain version) against its plain stacked
  substep, on both routes, with no kernel launched.

No interpret-mode kernel runs (the JAX package's own
test_pallas_interpret_matches_xla_3d holds its slab kernels against the
XLA path).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from ryujin_tpu.solver.integrator import TimeIntegrator as JTimeIntegrator  # noqa: E402

from ryujin_tpu_torch.kernels import (  # noqa: E402
    pk1_stream, pk2_stream, pk3_stream, pk_up,
)
from ryujin_tpu_torch.solver.integrator import TimeIntegrator  # noqa: E402

from test_torch_box3d_phases import BOXES, box_case, jax_module  # noqa: E402
from test_torch_fixture import assert_close, to_torch  # noqa: E402

RECOVERY = dict(cfl_min=0.45, cfl_max=0.9,
                cfl_recovery_strategy="bang bang control")


@pytest.mark.parametrize("route", sorted(BOXES))
def test_one_erk33_step_matches_jax(route):
    """One step of the slice: ERK33, CFL 0.9 / 0.45, bang-bang recovery (no
    restart on this state), from the bumped inflow state."""
    sd, hm, _, U0, _ = box_case(route)
    assert hm.half == (route == "half_slot")
    ref = JTimeIntegrator(jax_module(route), "erk 33", **RECOVERY).advance(
        jnp.asarray(U0), 0.0, 1
    )
    out = TimeIntegrator(hm, "erk 33", **RECOVERY).advance(to_torch(U0), 0.0, 1)
    real = sd.node_mask > 0
    U, prec, t, tau, restarts, warns = out
    assert_close(U.numpy()[:, real], np.asarray(ref[0])[:, real], "U")
    assert_close(prec.numpy()[:, real], np.asarray(ref[1])[:, real], "prec")
    assert_close(t, ref[2], "t")
    assert_close(tau, ref[3], "tau")
    assert int(restarts) == int(ref[4]) == 0
    assert int(warns) == int(ref[5]) == 0
    assert float(tau) > 0.0
    assert bool(hm.eq.is_admissible(U[:, torch.as_tensor(real)]).all())


@pytest.mark.parametrize("route", sorted(BOXES))
def test_stream_stepper_matches_plain_step(route):
    """CanvasStepper in 3D (pk1_stream on the route's form, the fixup or
    the two-direction d, the tau glue, pk2_stream, pk3_stream, PK4, PK5)
    on CPU tensors against the plain stacked phase functions, for the
    third ERK33 substep (two stages) with tau computed in it."""
    _, hm, _, U0, _ = box_case(route)
    assert hm.canvas.stream and hm.canvas.half == (route == "half_slot")
    fns = (pk1_stream.pk1_stream, pk2_stream.pk2_stream,
           pk3_stream.pk3_stream, pk_up.pk_up)
    before = [f.launches for f in fns]
    Ua, preca = hm.prepare_state_vector(to_torch(U0), 0.0)
    Ub, prec = hm.prepare_state_vector(Ua * 1.01, 0.0)
    cap = torch.tensor(float("inf"), dtype=torch.float64)
    tau = torch.zeros((), dtype=torch.float64)
    args = (Ub, prec, torch.stack([Ua, Ub]), [0.75, -2.0], tau, 0.9, cap, True)
    U_c, tau_c, ok_c = hm.canvas.step(*args)
    U_p, tau_p, ok_p = hm.plain_step(*args)
    assert_close(U_c, U_p, "U")
    assert_close(tau_c, tau_p, "tau")
    assert bool(ok_c) and bool(ok_p)
    assert not torch.equal(U_c, Ub), "the substep must move the state"
    assert [f.launches for f in fns] == before
