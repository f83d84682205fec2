"""The q2step2d slice of the PyTorch port against the JAX package at
reach 2 (cG Q2, K = 24), float64, on the small rectangular mesh of
tests/test_ansatz_canvas.py (8 x 4 cells, 17 x 9 nodes, Dirichlet all
round; the Mach-3 step at K = 24 costs minutes in interpret mode):

- one substep with two active stages against the JAX package with
  backend="pallas_interpret", which runs its _pk1_stream, pk2_stream,
  pk3_stream and pk_up kernels in interpret mode (a whole ERK33 step
  compiles three such substeps and costs 105 s on the CPU, so the step is
  held against the XLA path);
- one ERK33 step through TimeIntegrator.advance with bang-bang recovery
  against the JAX package's;
- a blast-wave contrast at CFL 3.5, where every step fails at cfl_max
  and is redone at cfl_min: the same restarts, warnings, tau and U as the
  JAX advance;
- the port's stream orchestration (CanvasStepper on CPU tensors, every
  wrapper taking its plain version) against its plain stacked substep.

Each package builds its own StructuredData from its own offline layer.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
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
from ryujin_tpu.solver.hyperbolic import (  # noqa: E402
    HyperbolicModule as JHyperbolicModule,
    HyperbolicModuleParams as JParams,
)
from ryujin_tpu.solver.integrator import TimeIntegrator as JTimeIntegrator  # noqa: E402

from ryujin_tpu_torch import convert  # noqa: E402
from ryujin_tpu_torch.equations.euler_initial_states import (  # noqa: E402
    make_initial_state,
)
from ryujin_tpu_torch.kernels import (  # noqa: E402
    pk1_stream, pk2_stream, pk3_stream, pk_up,
)
from ryujin_tpu_torch.offline import (  # noqa: E402
    assembly as t_assembly,
    geometry as t_geometry,
    mesh as t_mesh,
    structured as t_structured,
)
from ryujin_tpu_torch.solver.hyperbolic import HyperbolicModule  # noqa: E402
from ryujin_tpu_torch.solver.integrator import TimeIntegrator  # noqa: E402

from test_torch_fixture import assert_close, to_torch  # noqa: E402

ANSATZ = "cG Q2"
REST = (1.0, 0.0, 1.0)  # (rho, u, p) of the blast case's ambient gas


@functools.lru_cache(maxsize=None)
def case(primitive=(1.4, 3.0, 1.0)):
    """(sd, jeq, jinit, U0 numpy, port hm) on the small mesh: the uniform
    state `primitive` (also the Dirichlet data) times a seeded bump."""
    box = ([0, 0], [2, 1], [2, 1], 2)
    mesh = geometry.rectangular_domain(
        *box, boundary_conditions=[Boundary.dirichlet] * 4
    )
    sd = structured.pack_structured(
        assembly.assemble(mesh, ansatz=ANSATZ), mesh
    )
    t_msh = t_geometry.rectangular_domain(
        *box, boundary_conditions=[t_mesh.Boundary.dirichlet] * 4
    )
    t_sd = t_structured.pack_structured(
        t_assembly.assemble(t_msh, ansatz=ANSATZ), t_msh
    )
    assert t_sd.reach == 2 and t_sd.max_degree == 24
    jeq = JEuler(dim=2)
    jinit = j_make_initial_state(jeq, "uniform", primitive_state=primitive)
    U = np.array(j_interpolate_nodal(jinit, sd, jeq, 0.0, jnp.float64))
    rng = np.random.default_rng(4321)
    center = rng.uniform([0.7, 0.4], [1.3, 0.6])
    width = rng.uniform(6.0, 10.0)
    bump = 1.0 + 0.25 * np.exp(
        -width * np.sum((sd.positions.T - center[:, None]) ** 2, 0)
    )
    bump = np.where(sd.node_mask > 0, bump, 1.0)
    U[0] *= bump
    U[3] *= bump
    eq, params = convert.params_from_reference(jeq, JParams())
    init = make_initial_state(eq, "uniform", primitive_state=primitive)
    hm = HyperbolicModule(eq, t_sd, init, params=params, dtype=torch.float64,
                          device="cpu")
    return sd, jeq, jinit, U, hm


def _integrators(sd, jeq, jinit, hm, backend, cfl_max):
    jhm = JHyperbolicModule(jeq, sd, jinit, dtype=jnp.float64, backend=backend)
    kw = dict(cfl_min=0.45, cfl_max=cfl_max,
              cfl_recovery_strategy="bang bang control")
    return JTimeIntegrator(jhm, "erk 33", **kw), TimeIntegrator(hm, "erk 33", **kw)


def _assert_advance_equal(out, ref, real):
    U, prec, t, tau, restarts, warns = out
    assert_close(U.numpy()[:, real], np.asarray(ref[0])[:, real], "U")
    assert_close(prec.numpy()[:, real], np.asarray(ref[1])[:, real], "prec")
    assert_close(t, ref[2], "t")
    assert_close(tau, ref[3], "tau")
    assert int(restarts) == int(ref[4]), "restarts"
    assert int(warns) == int(ref[5]), "warnings"


def test_substep_matches_pallas_interpret_stream_kernels():
    """The third ERK33 substep (stages 0.75, -2) with tau computed in it.
    Relative 1e-9 / absolute 1e-11 on U and 1e-11 on tau: the bar
    tests/test_ansatz_canvas.py holds interpret-mode Pallas to against the
    XLA path at reach 2 (measured here: 1.8e-15 on U, tau equal)."""
    sd, jeq, jinit, U0, hm = case()
    jhm = JHyperbolicModule(jeq, sd, jinit, dtype=jnp.float64,
                            backend="pallas_interpret")
    assert jhm._pallas.reach == 2
    Ua, preca = jhm.prepare_state_vector(jnp.asarray(U0), 0.0)
    cap = torch.tensor(float("inf"), dtype=torch.float64)
    zero = torch.zeros((), dtype=torch.float64)
    # a second prepared state: the first stage's output
    Ub, _, _ = hm.step(to_torch(Ua), to_torch(preca), None, [], zero, 0.9,
                       cap, compute_tau=True)
    U, prec = jhm.prepare_state_vector(jnp.asarray(Ub.numpy()), 0.0)
    sU, sP = jnp.stack([Ua, U]), jnp.stack([preca, prec])
    weights = [0.75, -2.0]
    ref = jax.jit(
        lambda U, prec, sU, sP, w: jhm.step(
            U, prec, sU, sP, w, 0.0, 0.9, jnp.inf, compute_tau=True
        )
    )(U, prec, sU, sP, jnp.asarray(weights))
    got = hm.step(to_torch(U), to_torch(prec), to_torch(sU), weights, zero,
                  0.9, cap, compute_tau=True)
    real = sd.node_mask > 0
    assert_close(got[0].numpy()[:, real], np.asarray(ref[0])[:, real], "U",
                 rtol=1e-9, atol=1e-11)
    assert_close(got[1], ref[1], "tau", rtol=1e-11)
    assert bool(got[2]) and bool(ref[2])


def test_one_erk33_step_matches_jax():
    """One step of the slice: ERK33, CFL 0.9 / 0.45, bang-bang recovery
    (no restart on this state).  Relative 5e-11 against the XLA path."""
    sd, jeq, jinit, U0, hm = case()
    jti, ti = _integrators(sd, jeq, jinit, hm, "xla", 0.9)
    ref = jti.advance(jnp.asarray(U0), 0.0, 1)
    out = ti.advance(to_torch(U0), 0.0, 1)
    _assert_advance_equal(out, ref, sd.node_mask > 0)
    assert int(out[4]) == 0 and int(out[5]) == 0 and float(out[3]) > 0.0


def test_bang_bang_restart_matches_jax():
    """A 1000:1 pressure and 8:1 density contrast at CFL 3.5: each of the
    two steps fails the limiter at cfl_max and is redone from the same
    prepared state at cfl_min 0.45.  Relative 5e-11 against the JAX XLA
    path."""
    sd, jeq, jinit, U0, hm = case(REST)
    pos = sd.positions.T
    blast = (np.sum((pos - np.array([[1.0], [0.5]])) ** 2, 0) < 0.2 ** 2) & (
        sd.node_mask > 0
    )
    U0 = U0.copy()
    U0[0, blast] *= 8.0
    U0[3, blast] *= 1000.0
    jti, ti = _integrators(sd, jeq, jinit, hm, "xla", 3.5)
    ref = jti.advance(jnp.asarray(U0), 0.0, 2)
    out = ti.advance(to_torch(U0), 0.0, 2)
    assert int(ref[4]) == 2, "the case must force a restart on every step"
    real = sd.node_mask > 0
    _assert_advance_equal(out, ref, real)
    assert int(out[5]) == 0
    assert np.isfinite(out[0].numpy()[:, real]).all()
    assert bool(hm.eq.is_admissible(out[0][:, torch.as_tensor(real)]).all())
    # without recovery the same steps run once at cfl_max and warn
    ti_none = TimeIntegrator(hm, "erk 33", cfl_min=0.45, cfl_max=3.5,
                             cfl_recovery_strategy="none")
    out_none = ti_none.advance(to_torch(U0), 0.0, 1)
    assert int(out_none[4]) == 0 and int(out_none[5]) == 1


def test_stream_stepper_matches_plain_step():
    """CanvasStepper at reach 2 (pk1_stream, prescaled fixup, d/tau glue,
    pk2_stream, pk3_stream, PK4, PK5) on CPU tensors against the plain
    stacked phase functions, for the three stage layouts of ERK33; no
    kernel is launched."""
    _, _, _, U0, hm = case()
    assert hm.canvas.stream
    fns = (pk1_stream.pk1_stream, pk2_stream.pk2_stream,
           pk3_stream.pk3_stream, pk_up.pk_up)
    before = [f.launches for f in fns]
    Ua, preca = hm.prepare_state_vector(to_torch(U0), 0.0)
    cap = torch.tensor(float("inf"), dtype=torch.float64)
    tau = torch.zeros((), dtype=torch.float64)
    Ub = None
    for weights in ([], [-1.0], [0.75, -2.0]):
        stage_U = torch.stack([Ua, Ub][: len(weights)]) if weights else None
        args = (Ua, preca, stage_U, weights, tau, 0.9, cap, not weights)
        U_c, tau_c, ok_c = hm.canvas.step(*args)
        U_p, tau_p, ok_p = hm.plain_step(*args)
        assert_close(U_c, U_p, f"U, stages {weights}")
        assert_close(tau_c, tau_p, f"tau, stages {weights}")
        assert bool(ok_c) and bool(ok_p)
        if Ub is None:
            Ub, tau = hm.prepare_state_vector(U_p, 0.0)[0], tau_p
    assert [f.launches for f in fns] == before
