"""The port's isentropic vortex drive (ryujin_tpu_torch.vortex) on the CPU
plain path, float64: ERK33 at refinement 5 (1,089 dofs) held to the bars
of tests/test_euler_vortex.py's test_vortex_l5_erk33, and the advance's
stop at t_final, which lets the drive take its steps in chunks."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from ryujin_tpu_torch.postprocess.error import interpolate_nodal  # noqa: E402
from ryujin_tpu_torch.solver.integrator import TimeIntegrator  # noqa: E402
from ryujin_tpu_torch.vortex import CFL, build_vortex, drive_vortex  # noqa: E402


def test_vortex_l5_erk33():
    run = drive_vortex(5, "erk 33", torch.float64, "cpu")
    linf, l1, l2 = run.norms
    assert run.sd.n_nodes == 1089 and run.hm.half
    assert run.t == 2.0 and run.warnings == 0 and run.steps > 0
    assert l1 < 3.6e-3, l1
    assert l2 < 9.1e-3, l2


@pytest.mark.parametrize("scheme", ["erk 33", "ssprk 33", "erk 54"])
def test_advance_stops_at_t_final(scheme):
    """Steps past t_final change nothing: steps taken one at a time until
    t reaches t_final = 0.5 equal one advance of three steps more, bit for
    bit (the convex combinations of ssprk 33 would move U by an ulp if a
    step at tau = 0 ran), with no warning; the advance counts its steps,
    and the last one ends at t_final exactly."""
    eq, _, sd, init, hm = build_vortex(3, torch.float64, "cpu")
    ti = TimeIntegrator(hm, scheme, cfl_min=CFL, cfl_max=CFL,
                        cfl_recovery_strategy="none")
    U0 = interpolate_nodal(init, sd, eq, 0.0, torch.float64, "cpu")
    t_final = 0.5
    Us, ts, steps = U0, torch.zeros((), dtype=torch.float64), 0
    while ts.item() < t_final:
        Us, precs, ts, taus, _, ws = ti.advance(Us, ts, 1, t_final)
        assert int(ws) == 0 and int(ti.steps_taken) == 1
        steps += 1
    U, prec, t, tau, _, warns = ti.advance(U0, 0.0, steps + 3, t_final)
    assert 1 < steps == int(ti.steps_taken) < 20
    assert float(t) == float(ts) == t_final
    assert int(warns) == 0
    assert torch.equal(U, Us) and torch.equal(prec, precs)
    assert torch.equal(tau, taus)
