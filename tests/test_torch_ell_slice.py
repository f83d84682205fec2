"""The padded-ELL slice end to end on the CPU, float64: 20 ERK33 steps of
the 1D shock front and of LeBlanc's tube at refinement 2 (101 dofs)
through the port, on its plain substep and on the ELL stepper's
orchestration (kernels/ell.py's plain versions), against the JAX
package's ELL advance at 5e-11; the isentropic vortex at refinement 3
through ELL against the port's own canvas path at rtol 1e-10; and the
integrator's restart and warning counters against the JAX package's on a
forced restart (a 1D blast at CFL 3.5 with bang-bang recovery)."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from ryujin_tpu.equations.euler import Euler as JEuler, EulerParams  # noqa: E402
from ryujin_tpu.equations.euler_initial_states import (  # noqa: E402
    make_initial_state as j_make_initial_state,
)
from ryujin_tpu.offline import (  # noqa: E402
    assembly as j_assembly, ell as j_ell, geometry as j_geometry,
)
from ryujin_tpu.postprocess.error import (  # noqa: E402
    interpolate_nodal as j_interpolate_nodal,
)
from ryujin_tpu.solver.hyperbolic import (  # noqa: E402
    HyperbolicModule as JHyperbolicModule, HyperbolicModuleParams as JParams,
)
from ryujin_tpu.solver.integrator import TimeIntegrator as JTime  # noqa: E402

from ryujin_tpu_torch import convert  # noqa: E402
from ryujin_tpu_torch.equations.euler_initial_states import (  # noqa: E402
    make_initial_state,
)
from ryujin_tpu_torch.offline import assembly, ell, geometry  # noqa: E402
from ryujin_tpu_torch.offline.mesh import Boundary  # noqa: E402
from ryujin_tpu_torch.postprocess.error import interpolate_nodal  # noqa: E402
from ryujin_tpu_torch.shocktube import CASES  # noqa: E402
from ryujin_tpu_torch.solver.hyperbolic import HyperbolicModule  # noqa: E402
from ryujin_tpu_torch.solver.integrator import TimeIntegrator  # noqa: E402
from ryujin_tpu_torch.vortex import drive_vortex  # noqa: E402

from test_torch_fixture import assert_close  # noqa: E402

STEPS = 20


class EllSteps:
    """The module with its substeps through the ELL stepper's orchestration
    (ell_pk1 .. ell_pk_up; their plain versions on the CPU)."""

    def __init__(self, hm):
        self.hm, self.dtype, self.device = hm, hm.dtype, hm.device

    def prepare_state_vector(self, U, t):
        return self.hm.prepare_state_vector(U, t)

    def step(self, *args, **kwargs):
        return self.hm.ell.step(*args, **kwargs)


def _tube(g, refinement):
    return g.rectangular_domain([0.0], [1.0], [25], refinement=refinement,
                                boundary_conditions=[Boundary.dirichlet] * 2,
                                dim=1)


@functools.lru_cache(maxsize=None)
def modules(config, gamma, position, relax, refinement=2, **state):
    """(JAX module, its packing and initial state; the port's module, its
    packing and initial state) of one 1D tube."""
    jeq = JEuler(dim=1, params=EulerParams(gamma=gamma))
    jparams = JParams(limiter_relaxation_factor=relax)
    jpacked = j_ell.pack(j_assembly.assemble(_tube(j_geometry, refinement)))
    jinit = j_make_initial_state(jeq, config, direction=[1.0],
                                 position=[position], **state)
    jhm = JHyperbolicModule(jeq, jpacked, jinit, params=jparams,
                            dtype=jnp.float64)
    eq, params = convert.params_from_reference(jeq, jparams)
    packed = ell.pack(assembly.assemble(_tube(geometry, refinement)))
    init = make_initial_state(eq, config, direction=[1.0],
                              position=[position], **state)
    hm = HyperbolicModule(eq, packed, init, params=params,
                          dtype=torch.float64, device="cpu")
    return (jhm, jpacked, jinit), (hm, packed, init)


@pytest.mark.parametrize("name", ["shock front", "leblanc"])
def test_tube_steps_match_jax(name):
    """20 ERK33 steps at the case's CFL, recovery "none": U, t and tau of
    the port (plain substep and ELL orchestration) equal the JAX ELL
    advance's at 5e-11."""
    case = CASES[name]
    (jhm, jpacked, jinit), (hm, packed, init) = modules(
        case.config, case.gamma, case.position, case.relax)
    jti = JTime(jhm, scheme="erk 33", cfl_min=case.cfl, cfl_max=case.cfl,
                cfl_recovery_strategy="none")
    U0 = j_interpolate_nodal(jinit, jpacked, jhm.eq, 0.0, jnp.float64)
    Uj, _, tj, tauj, _, warns_j = jti.advance(U0, 0.0, STEPS)
    Uj = np.asarray(Uj)
    assert int(warns_j) == 0
    real = packed.node_mask > 0
    U0_t = interpolate_nodal(init, packed, hm.eq, 0.0, torch.float64, "cpu")
    assert_close(U0_t, np.asarray(U0), f"{name}: initial state")
    for stepper in (hm, EllSteps(hm)):
        ti = TimeIntegrator(stepper, "erk 33", cfl_min=case.cfl,
                            cfl_max=case.cfl, cfl_recovery_strategy="none")
        U, _, t, tau, restarts, warns = ti.advance(U0_t, 0.0, STEPS)
        label = f"{name}, {type(stepper).__name__}"
        assert int(warns) == 0 and int(restarts) == 0, label
        assert_close(U.numpy()[:, real], Uj[:, real], f"{label}: U")
        assert_close(t, float(tj), f"{label}: t")
        assert_close(tau, float(tauj), f"{label}: tau")


def test_vortex_ell_matches_canvas():
    """The isentropic vortex at refinement 3 through ELL (two-direction
    wavespeeds, no boundary-pair fixup) equals the port's canvas path
    (half-slot route with the fixup) at rtol 1e-10 on every vertex, with
    the same steps and norms."""
    canvas = drive_vortex(3, "erk 33", torch.float64, "cpu")
    gather = drive_vortex(3, "erk 33", torch.float64, "cpu", layout="ell")
    assert canvas.hm.canvas is not None and gather.hm.ell is not None
    assert not gather.hm.half
    assert gather.steps == canvas.steps and gather.t == canvas.t == 2.0
    Uc = canvas.U.numpy()[:, canvas.sd.vertex_to_node]
    Ue = gather.U.numpy()[:, gather.sd.vertex_to_node]
    np.testing.assert_allclose(Ue, Uc, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(gather.norms, canvas.norms, rtol=1e-10)


def test_restart_counts_match_jax():
    """A 1D blast (1000:1 pressure) at cfl_max 3.5 with bang-bang recovery:
    every step fails its limiter and is redone at cfl_min 0.45.  After
    each of three step() calls the port's n_restarts and n_warnings equal
    the JAX package's."""
    blast = dict(primitive_left=(1.0, 0.0, 1000.0),
                 primitive_right=(1.0, 0.0, 1.0))
    (jhm, jpacked, jinit), (hm, packed, init) = modules(
        "contrast", 1.4, 0.5, 1.0, **{k: tuple(v) for k, v in blast.items()})
    jti = JTime(jhm, scheme="erk 33", cfl_min=0.45, cfl_max=3.5,
                cfl_recovery_strategy="bang bang control")
    ti = TimeIntegrator(hm, "erk 33", cfl_min=0.45, cfl_max=3.5,
                        cfl_recovery_strategy="bang bang control")
    assert ti.n_restarts == ti.n_warnings == 0
    Uj = j_interpolate_nodal(jinit, jpacked, jhm.eq, 0.0, jnp.float64)
    U = interpolate_nodal(init, packed, hm.eq, 0.0, torch.float64, "cpu")
    tj = t = 0.0
    for _ in range(3):
        Uj, tau_j, _ = jti.step(Uj, tj)
        U, tau, _ = ti.step(U, t)
        tj, t = tj + float(tau_j), t + float(tau)
        assert (ti.n_restarts, ti.n_warnings) == (jti.n_restarts,
                                                  jti.n_warnings)
    assert ti.n_restarts == 3
    # advance() reports its counts and leaves the step() totals alone
    out = ti.advance(U, t, 2)
    assert int(out[4]) == 2 and ti.n_restarts == 3
