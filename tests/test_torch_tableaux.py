"""The port's explicit tableaux against the JAX package's, float64 on the
CPU: every tableau field by field, EFFICIENCY, the errors on the schemes
that are not ported, and three steps of "erk 54" (its four stage slots)
and "ssprk 33" (its convex combinations) through TimeIntegrator.advance
on the vortex canvas at refinement 3 against the JAX package on the same
canvas (its XLA path), at the fixture's relative 5e-11 / absolute
1e-12."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from ryujin_tpu.equations.euler import Euler as JEuler  # noqa: E402
from ryujin_tpu.equations.euler_initial_states import (  # noqa: E402
    make_initial_state as j_make_initial_state,
)
from ryujin_tpu.offline import assembly, geometry, structured  # noqa: E402
from ryujin_tpu.offline.mesh import Boundary  # noqa: E402
from ryujin_tpu.postprocess.error import (  # noqa: E402
    interpolate_nodal as j_interpolate_nodal,
)
from ryujin_tpu.solver import integrator as jint  # noqa: E402
from ryujin_tpu.solver.hyperbolic import (  # noqa: E402
    HyperbolicModule as JHyperbolicModule,
)

from ryujin_tpu_torch.solver import integrator  # noqa: E402
from ryujin_tpu_torch.vortex import CFL, build_vortex  # noqa: E402

from test_torch_fixture import assert_close  # noqa: E402


def test_tableaux_equal_jax():
    assert sorted(integrator.TABLEAUX) == sorted(jint.TABLEAUX)
    for name, tb in integrator.TABLEAUX.items():
        ref = jint.TABLEAUX[name]
        for field in ("n_sub", "S", "W", "comb", "c", "eff"):
            assert getattr(tb, field) == getattr(ref, field), (name, field)
        assert [f.name for f in dataclasses.fields(tb)] == [
            f.name for f in dataclasses.fields(ref)]
    assert integrator.EFFICIENCY == jint.EFFICIENCY
    assert integrator.STRANG == jint.STRANG


def test_schemes_not_ported_raise():
    _, _, _, _, hm = build_vortex(3, torch.float64, "cpu")
    with pytest.raises(ValueError, match="unknown"):
        integrator.TimeIntegrator(hm, "erk 99")
    for scheme in ("imex 22", "imex 33"):
        with pytest.raises(NotImplementedError, match="asserts out"):
            integrator.TimeIntegrator(hm, scheme)
    for scheme in list(integrator.STRANG) + ["imex 11"]:
        with pytest.raises(NotImplementedError,
                           match="queue 1 item 7, \"Navier–Stokes\""):
            integrator.TimeIntegrator(hm, scheme)
    for scheme in integrator.TABLEAUX:
        assert integrator.TimeIntegrator(hm, scheme).efficiency == (
            jint.EFFICIENCY[scheme])


@pytest.mark.parametrize("scheme", ["erk 54", "ssprk 33"])
def test_three_steps_match_jax_on_the_vortex(scheme):
    jmesh = geometry.rectangular_domain(
        [-5, -5], [5, 5], [1, 1], refinement=3,
        boundary_conditions=[Boundary.dirichlet] * 4)
    jsd = structured.pack_structured(assembly.assemble(jmesh), jmesh,
                                     pad_minor=16)
    jeq = JEuler(dim=2)
    jinit = j_make_initial_state(jeq, "isentropic vortex", direction=[1, 1],
                                 position=[-1, -1], mach_number=1.0, beta=5.0)
    jhm = JHyperbolicModule(jeq, jsd, jinit, dtype=jnp.float64)
    jti = jint.TimeIntegrator(jhm, scheme, cfl_min=CFL, cfl_max=CFL,
                              cfl_recovery_strategy="none")
    U0 = np.array(j_interpolate_nodal(jinit, jsd, jeq, 0.0, jnp.float64))
    ref = jti.advance(jnp.asarray(U0), 0.0, 3)

    _, _, sd, _, hm = build_vortex(3, torch.float64, "cpu")
    ti = integrator.TimeIntegrator(hm, scheme, cfl_min=CFL, cfl_max=CFL,
                                   cfl_recovery_strategy="none")
    U, prec, t, tau, restarts, warns = ti.advance(torch.from_numpy(U0), 0.0,
                                                  3)
    real = sd.node_mask > 0
    assert_close(U.numpy()[:, real], np.asarray(ref[0])[:, real], "U")
    assert_close(prec.numpy()[:, real], np.asarray(ref[1])[:, real], "prec")
    assert_close(t, ref[2], "t")
    assert_close(tau, ref[3], "tau")
    assert int(warns) == int(ref[5]) == 0 and int(restarts) == 0
