"""One IDP substep of the port on the padded-ELL stencil against the JAX
package's phase functions on its gather stencil (_stencil_from_ell),
phase by phase, float64: lambda / e, alpha, d, tau, U_low, F, the bounds,
P, l, U and l' after PK4, U after PK5, at relative 5e-11.  The port runs
its ELL kernel wrappers (kernels/ell.py), which take their plain versions
on CPU tensors; each phase gets the JAX side's inputs, so a fault points
to one kernel.  Cases: 1D (LeBlanc's tube), 2D cG Q1 and dG Q1 and 3D cG
Q1 at refinement 0-2 (a Mach-3 flow with a blast), each at 2 stage slots
(ERK33's third substep) and at 4 (ERK54's fifth).  The limiter's l may
move by up to 5e-4 on 0.1 % of the edges, where psi is flat at its root
(tests/test_torch_phases.py)."""

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
from ryujin_tpu.solver import hyperbolic as jhyp  # noqa: E402

from ryujin_tpu_torch import convert  # noqa: E402
from ryujin_tpu_torch.kernels.ell import (  # noqa: E402
    ell_pk1, ell_pk2, ell_pk3, ell_pk_up,
)
from ryujin_tpu_torch.offline import assembly, ell, geometry  # noqa: E402
from ryujin_tpu_torch.offline.mesh import Boundary  # noqa: E402
from ryujin_tpu_torch.solver import hyperbolic as thyp  # noqa: E402
from ryujin_tpu_torch.solver.integrator import TABLEAUX  # noqa: E402
from ryujin_tpu_torch.solver.stencil import stencil_from_ell  # noqa: E402

from test_torch_fixture import assert_close  # noqa: E402
from test_torch_phases import assert_l_close  # noqa: E402

CFL = 0.9
# stage slots -> their static weights: ERK33's third substep, ERK54's fifth
WEIGHTS = {2: [0.75, -2.0],
           4: [w for w in TABLEAUX["erk 54"].W[4] if w != 0.0]}
WALLS = [Boundary.dirichlet, Boundary.do_nothing]

# name -> (dim, mesh builder on a geometry module, ansatz)
CASES = {
    "1D": (1, lambda g: g.rectangular_domain(
        [0.0], [1.0], [25], refinement=1,
        boundary_conditions=[Boundary.dirichlet] * 2, dim=1), "cG Q1"),
    "2D cG Q1": (2, lambda g: g.rectangular_domain(
        [0.0, 0.0], [3.0, 1.0], [6, 2], refinement=2,
        boundary_conditions=WALLS + [Boundary.slip] * 2), "cG Q1"),
    "2D dG Q1": (2, lambda g: g.rectangular_domain(
        [0.0, 0.0], [3.0, 1.0], [6, 2], refinement=1,
        boundary_conditions=WALLS + [Boundary.slip] * 2), "dG Q1"),
    "3D": (3, lambda g: g.rectangular_domain(
        [0.0, 0.0, 0.0], [3.0, 1.0, 1.0], [3, 2, 2], refinement=1,
        boundary_conditions=WALLS + [Boundary.slip] * 4, dim=3), "cG Q1"),
}


def _initial(dim, eq, make):
    """LeBlanc's tube in 1D; a uniform Mach-3 flow elsewhere."""
    if dim == 1:
        return make(eq, "leblanc", direction=[1.0], position=[0.33])
    return make(eq, "uniform", primitive_state=(1.4, 3.0, 1.0))


@functools.lru_cache(maxsize=None)
def jax_case(name):
    """(packed, JAX module, U0): the JAX package's ELL module and a state
    with a blast (8:1 density, 1000:1 energy in a ball) around (1, 0.5, 0.5)
    in 2D and 3D."""
    dim, build, ansatz = CASES[name]
    jeq = JEuler(dim=dim, params=EulerParams(
        gamma=5.0 / 3.0 if dim == 1 else 1.4))
    mesh = build(j_geometry)
    packed = j_ell.pack(j_assembly.assemble(mesh, ansatz=ansatz))
    jinit = _initial(dim, jeq, j_make_initial_state)
    jhm = jhyp.HyperbolicModule(jeq, packed, jinit, dtype=jnp.float64)
    U = np.array(j_interpolate_nodal(jinit, packed, jeq, 0.0, jnp.float64))
    if dim > 1:
        pos = packed.positions.T
        centre = np.array([1.0, 0.5, 0.5][:dim])[:, None]
        blast = (np.sum((pos - centre) ** 2, 0) < 0.3 ** 2)
        blast &= packed.node_mask > 0
        U[0, blast] *= 8.0
        U[-1, blast] *= 1000.0
    return packed, jhm, U


@functools.lru_cache(maxsize=None)
def jax_substep(name, slots):
    """Every intermediate of one JAX substep on the ELL stencil, numpy."""
    packed, jhm, U0 = jax_case(name)
    jeq, p, st = jhm.eq, jhm.params, jhm.stencil
    Ua, preca = jhm.prepare_state_vector(jnp.asarray(U0), 0.0)
    Ub, _, _ = jhm.step(
        Ua, preca, jnp.zeros((0,) + Ua.shape), jnp.zeros((0,) + preca.shape),
        jnp.zeros((0,)), 0.0, CFL, jnp.inf, compute_tau=True,
    )
    U, prec = jhm.prepare_state_vector(Ub, 0.0)
    # the stage states: U_a, U and convex combinations of the two
    stages = [Ua, U] + [jhm.prepare_state_vector(Ua + (U - Ua) * f, 0.0)[0]
                        for f in (0.5, 0.25)]
    sU = jnp.stack(stages[:slots])
    sP = jnp.stack([jhm.prepare_state_vector(s, 0.0)[1] for s in stages[:slots]])
    w = jnp.asarray(WEIGHTS[slots])
    U_j, prec_j = st.nbr(U), st.nbr(prec)
    sU_j = jnp.stack([st.nbr(sU[s]) for s in range(slots)])
    sP_j = jnp.stack([st.nbr(sP[s]) for s in range(slots)])
    ip = jhm.initial_precomputed
    ip_j = jnp.zeros((0,) + st.mask.shape)

    e, alpha = jhyp.phase_e_alpha(jeq, p, st, U, prec, U_j, prec_j)
    d = jhyp.d_from_e(st.mask, e, st.transpose_edge(e))
    tau = jhyp.tau_max_from_d(st, d, CFL, jnp.inf)
    alpha_j = st.nbr(alpha)
    U_low, F, bounds = jhyp.phase_low_order(
        jeq, p, st, U, prec, U_j, prec_j, d, alpha, alpha_j, tau,
        sU, sP, sU_j, sP_j, w, ip, ip_j,
    )
    P, l, success = jhyp.phase_p_l1(
        jeq, p, st, U, prec, U_j, prec_j, d, alpha, alpha_j, tau,
        F, st.nbr(F), st.nbr(st.m_lumped), U_low, bounds,
        sU, sP, sU_j, sP_j, w, ip, ip_j,
    )
    U4, l4 = jhyp.phase_update(
        jeq, p, st, U_low, bounds, P, l, st.transpose_edge(l), False
    )
    U5, _ = jhyp.phase_update(
        jeq, p, st, U4, bounds, P, l4, st.transpose_edge(l4), True
    )
    out = dict(U=U, prec=prec, sU=sU, e=e, alpha=alpha, d=d, tau=tau,
               U_low=U_low, F=F, bounds=bounds, P=P, l=l, success=success,
               U4=U4, l4=l4, U5=U5)
    return {k: np.asarray(v) for k, v in out.items()}


@functools.lru_cache(maxsize=None)
def port(name):
    """(eq, params, stencil) of the port on its own pack of the same mesh."""
    dim, build, ansatz = CASES[name]
    packed, jhm, _ = jax_case(name)
    eq, params = convert.params_from_reference(jhm.eq, jhm.params)
    mine = ell.pack(assembly.assemble(build(geometry), ansatz=ansatz))
    np.testing.assert_array_equal(mine.cols, packed.cols)
    return eq, params, stencil_from_ell(mine, torch.float64, "cpu")


def _t(x):
    return torch.as_tensor(np.array(x), dtype=torch.float64)


PARAMS = [(name, slots) for name in CASES for slots in (2, 4)]


@pytest.mark.parametrize("name,slots", PARAMS,
                         ids=[f"{n}-S{s}" for n, s in PARAMS])
def test_ell_phases_match_jax(name, slots):
    ref = jax_substep(name, slots)
    eq, params, st = port(name)
    live = st.mask.numpy() > 0
    real = st.node_mask.numpy() > 0
    assert (st.incidence is not None) == CASES[name][2].startswith("dG")
    t = {k: _t(v) for k, v in ref.items()}
    w = WEIGHTS[slots]

    e, alpha = ell_pk1(eq, params, st, t["U"], t["prec"])
    assert_close(e.numpy()[live], ref["e"][live], f"{name}: e")
    assert_close(alpha.numpy()[real], ref["alpha"][real], f"{name}: alpha")
    d = thyp.d_from_e(st.mask, e, st.transpose_edge(e))
    assert_close(d, ref["d"], f"{name}: d")
    cap = torch.tensor(float("inf"), dtype=torch.float64)
    assert_close(thyp.tau_max_from_d(st, d, CFL, cap), ref["tau"],
                 f"{name}: tau")

    U_low, F, bounds = ell_pk2(eq, params, st, t["U"], t["prec"], t["d"],
                               t["alpha"], t["sU"], w, t["tau"])
    for key, got in (("U_low", U_low), ("F", F), ("bounds", bounds)):
        assert_close(got.numpy()[:, real], ref[key][:, real], f"{name}: {key}")

    P, l, okp = ell_pk3(eq, params, st, t["U"], t["d"], t["alpha"], t["F"],
                        t["U_low"], t["bounds"], t["sU"], w, t["tau"])
    assert_close(P.numpy()[:, live], ref["P"][:, live], f"{name}: P")
    assert_l_close(l.numpy()[live], ref["l"][live], f"{name}: l")
    assert ref["l"][live].min() < 1.0, "the limiter must work"
    ok_ref = np.all(ref["success"] | ~live, axis=0)[real]
    np.testing.assert_array_equal(okp.numpy()[real] > 0.5, ok_ref)

    U4, l4 = ell_pk_up(eq, params, st, t["U_low"], t["bounds"], t["P"],
                       t["l"], False)
    assert_close(U4.numpy()[:, real], ref["U4"][:, real], f"{name}: U PK4")
    assert_l_close(l4.numpy()[live], ref["l4"][live], f"{name}: l' PK4")
    U5, none = ell_pk_up(eq, params, st, t["U4"], t["bounds"], t["P"],
                         t["l4"], True)
    assert none is None
    assert_close(U5.numpy()[:, real], ref["U5"][:, real], f"{name}: U PK5")
