"""The dG slice of the PyTorch port against the JAX package: Euler on a
discontinuous ansatz, whose canvas carries the incidence beta_ij on its
slots (1 across an element interface for dG Q1) and whose PK2 and PK3 take
the high-order viscosity factor max(1/2 (alpha_i + alpha_j), beta_ij)
(ryujin_tpu/solver/hyperbolic.py:924-928, 1006-1010).  Four small canvases,
packed 16 lanes wide (not the TPU's 128) with z and y margins of 2 in 3D:

- dG Q1 on the box [0, 3] x [0, 1] x [0, 1] with the box3d boundary
  conditions (inflow dirichlet, outflow do_nothing, slip walls), at
  refinement 1, K = 26, one box for each Riemann route the JAX package
  picks against max(1024, n_pad / 16) (hyperbolic.py:1307-1320):
  2 x 1 x 1 cells (128 dofs on an 8 x 8 x 16 canvas, 208 pair slots:
  half-slot) and 4 x 3 x 3 cells (2,304 dofs on 16 x 16 x 16, 1,504
  pair slots: two-direction);
- dG Q1 in 2D on [0, 2] x [0, 1], 2 x 1 cells at refinement 2 (reach 1,
  K = 8: the stacked pk1 / pk2 / pk3);
- dG Q2 in 2D on the same rectangle at refinement 1 (reach 2, K = 24: the
  2D stream forms).

Each package assembles and packs with its own offline layer; the
assembled arrays and the canvases are held equal, incidence included.
Each phase of the third ERK33 substep (weights 0.75 and -2) runs through
the port's kernel wrappers (their plain-torch references on CPU tensors)
on the JAX side's inputs, against the JAX public phase functions traced
as one program, as its XLA step runs them; on the 3D half-slot box the
port's pre-scaled e = lambda * cmax gives the d that the JAX package
builds from its raw lambda and cmax.  Then two ERK33 steps of the port's
plain path against the JAX XLA advance on the smaller box, and the port's
kernel orchestration (CanvasStepper on CPU tensors) against its plain
substep on every canvas.  float64, relative 5e-11 / absolute 1e-12; the
limiter's l under the edge-count rule of tests/test_torch_q2_phases.py.
No interpret-mode kernel runs.
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
from ryujin_tpu.solver import hyperbolic as jhyp  # noqa: E402
from ryujin_tpu.solver.integrator import (  # noqa: E402
    TimeIntegrator as JTimeIntegrator,
)

from ryujin_tpu_torch import convert  # noqa: E402
from ryujin_tpu_torch.equations.euler_initial_states import (  # noqa: E402
    make_initial_state,
)
from ryujin_tpu_torch.kernels import (  # noqa: E402
    pk1, pk1_stream, pk2, pk2_stream, pk3, pk3_stream, pk_up,
)
from ryujin_tpu_torch.offline import (  # noqa: E402
    assembly as t_assembly,
    geometry as t_geometry,
    mesh as t_mesh,
    structured as t_structured,
)
from ryujin_tpu_torch.solver import hyperbolic as thyp  # noqa: E402
from ryujin_tpu_torch.solver.hyperbolic import HyperbolicModule  # noqa: E402
from ryujin_tpu_torch.solver.integrator import TimeIntegrator  # noqa: E402

from test_torch_box3d_phases import assert_l_close  # noqa: E402
from test_torch_fixture import assert_close, to_torch  # noqa: E402
from test_torch_q2_offline import assert_same  # noqa: E402

INFLOW = (1.4, 3.0, 1.0)
WEIGHTS = [0.75, -2.0]
CFL = 0.9
RECOVERY = dict(cfl_min=0.45, cfl_max=0.9,
                cfl_recovery_strategy="bang bang control")
# name -> (dim, subdivisions, refinement, ansatz, K, reach, half-slot
# route, coupling-boundary-pair slots)
CASES = {
    "box_half_slot": (3, (2, 1, 1), 1, "dG Q1", 26, 1, True, 208),
    "box_two_direction": (3, (4, 3, 3), 1, "dG Q1", 26, 1, False, 1504),
    "rect_q1": (2, (2, 1), 2, "dG Q1", 8, 1, True, 24),
    "rect_q2": (2, (2, 1), 1, "dG Q2", 24, 2, True, 36),
}


def _assembled(pkg, name):
    """(assembled data, canvas) of case `name` by the offline layer of
    `pkg` (the JAX package's or the port's)."""
    geometry_, assembly_, structured_, boundary = pkg
    dim, subdiv, refinement, ansatz = CASES[name][:4]
    upper = [3.0, 1.0, 1.0] if dim == 3 else [2.0, 1.0]
    mesh = geometry_.rectangular_domain(
        [0.0] * dim, upper, list(subdiv), refinement=refinement,
        boundary_conditions=[boundary.dirichlet, boundary.do_nothing]
        + [boundary.slip] * (2 * dim - 2),
        dim=dim,
    )
    data = assembly_.assemble(mesh, ansatz=ansatz)
    margin = {"margin": (2, 2)} if dim == 3 else {}
    return data, structured_.pack_structured(data, mesh, pad_minor=16,
                                             **margin)


class Case:
    """Both packages' offline data and modules for one canvas, the bumped
    inflow state, and (on first use) the JAX substep's intermediates."""

    def __init__(self, name):
        self.name = name
        (self.dim, _, _, self.ansatz, self.K, self.reach, self.half,
         self.pairs) = CASES[name]
        self.data, self.sd = _assembled(
            (geometry, assembly, structured, Boundary), name)
        self.t_data, self.t_sd = _assembled(
            (t_geometry, t_assembly, t_structured, t_mesh.Boundary), name)
        self.jeq = JEuler(dim=self.dim)
        self.eq, self.params = convert.params_from_reference(
            self.jeq, jhyp.HyperbolicModuleParams())
        self.jinit = j_make_initial_state(self.jeq, "uniform",
                                          primitive_state=INFLOW)
        self.hm = HyperbolicModule(
            self.eq, self.t_sd,
            make_initial_state(self.eq, "uniform", primitive_state=INFLOW),
            params=self.params, dtype=torch.float64, device="cpu",
        )
        self.jhm = jhyp.HyperbolicModule(self.jeq, self.sd, self.jinit,
                                         dtype=jnp.float64)
        sd = self.sd
        U = np.array(j_interpolate_nodal(self.jinit, sd, self.jeq, 0.0,
                                         jnp.float64))
        rng = np.random.default_rng(4404)
        lo, hi = ([0.8, 0.35, 0.35], [1.6, 0.65, 0.65])
        center = rng.uniform(lo[: self.dim], hi[: self.dim])
        bump = 1.0 + 0.3 * np.exp(
            -rng.uniform(6.0, 10.0)
            * np.sum((sd.positions.T - center[:, None]) ** 2, 0)
        )
        bump = np.where(sd.node_mask > 0, bump, 1.0)
        U[0] *= bump
        U[-1] *= bump ** 2
        self.U0 = U
        self.live = sd.mask.T > 0
        self.real = sd.node_mask > 0
        # the second stage state: U0 with another bump
        self.U1 = U.copy()
        self.U1[:, self.real] *= 1.0 + 0.05 * np.cos(
            4.0 * sd.positions[self.real, 0])[None]
        self._ref = None

    @property
    def ref(self):
        if self._ref is None:
            self._ref = self._jax_substep()
        return self._ref

    def _jax_substep(self):
        """Every intermediate of one JAX XLA substep as numpy: the third
        ERK33 substep, whose stages are the prepared bumped state and a
        second state with another bump."""
        sd, jhm, jeq, K = self.sd, self.jhm, self.jeq, self.K
        st, p = jhm.stencil, jhm.params
        assert st.incidence is not None
        axes = tuple(range(self.dim))
        norm_c = np.linalg.norm(sd.cij, axis=-1).T.reshape((K,) + sd.shape)
        cmax = jnp.asarray(np.stack([
            np.maximum(norm_c[k], np.roll(norm_c[K - 1 - k],
                                          tuple(-o for o in off), axis=axes))
            for k, off in enumerate(map(tuple, sd.offsets))
        ]).reshape(K, -1))
        half = self.half

        @jax.jit
        def phases(U0, U1):
            Ua, preca = jhm.prepare_state_vector(U0, 0.0)
            U, prec = jhm.prepare_state_vector(U1, 0.0)
            sU, sP = jnp.stack([Ua, U]), jnp.stack([preca, prec])
            w = jnp.asarray(WEIGHTS)
            U_j, prec_j = st.nbr(U), st.nbr(prec)
            sU_j = jnp.stack([st.nbr(sU[s]) for s in range(2)])
            sP_j = jnp.stack([st.nbr(sP[s]) for s in range(2)])
            ip = jhm.initial_precomputed
            ip_j = jnp.zeros((0,) + st.mask.shape)
            out = {}
            if half:
                lam, alpha = jhyp.phase_e_alpha(jeq, p, st, U, prec, U_j,
                                                prec_j, half=True)
                lam_fixed = jhm._lambda_fixup(lam, U, prec)
                e = lam * cmax[: K // 2]
                e_fixed = jhm._lambda_fixup(e, U, prec, prescaled=True)
                d = jhyp.d_from_lambda(st, lam_fixed, st.mask)
                out.update(lam=lam, lam_fixed=lam_fixed, e_fixed=e_fixed,
                           moved=(e_fixed != e))
            else:
                e, alpha = jhyp.phase_e_alpha(jeq, p, st, U, prec, U_j,
                                              prec_j)
                e_fixed = e
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
            U4, l4 = jhyp.phase_update(jeq, p, st, U_low, bounds, P, l,
                                       st.transpose_edge(l), False)
            U5, _ = jhyp.phase_update(jeq, p, st, U4, bounds, P, l4,
                                      st.transpose_edge(l4), True)
            # where the dG factor beta_ij exceeds 1/2 (alpha_i + alpha_j)
            raised = st.incidence > 0.5 * (alpha[None] + alpha_j)
            out.update(Ua=Ua, U=U, prec=prec, e=e, e_in=e_fixed,
                       alpha=alpha, d=d, tau=tau, U_low=U_low, F=F,
                       bounds=bounds, P=P, l=l, success=success, U4=U4,
                       l4=l4, U5=U5, raised=raised)
            return out

        out = phases(jnp.asarray(self.U0), jnp.asarray(self.U1))
        return {k: np.asarray(v) for k, v in out.items()}


_BUILT = {}


def built(name):
    """Case `name`, built once per test process."""
    if name not in _BUILT:
        _BUILT[name] = Case(name)
    return _BUILT[name]


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    return built(request.param)


# ---- the host layer ---------------------------------------------------------


def test_offline_arrays_equal(case):
    """The generic dG assembly (m_ij, c_ij, the incidence beta_ij, the
    node lattice) and the canvas packing, array for array and exactly."""
    assert isinstance(case.t_sd, t_structured.StructuredData)
    assert case.t_data.ansatz == case.ansatz == case.data.ansatz
    assert case.t_data.incidence is not None
    assert case.t_data.node_lattice_index is not None
    assert_same(case.t_data, case.data, "data")
    assert_same(case.t_sd, case.sd, "sd")
    sd = case.t_sd
    assert sd.dim == case.dim and sd.max_degree == case.K
    assert sd.reach == case.reach
    assert sd.offsets == t_structured.lattice_offsets(case.dim, case.reach)
    inc = sd.incidence[sd.mask > 0]
    assert inc.max() > 0.0 and (inc == 0.0).any()
    if case.ansatz == "dG Q1":
        assert set(np.unique(inc)) == {0.0, 1.0}


def test_route_and_kernel_form(case):
    """The port decides the Riemann route as the JAX package does, from
    the same pair count and n_pad, and takes the kernel form of the
    canvas's reach and dimension; the stencil and the canvas carry the
    incidence planes."""
    hm, jhm = case.hm, case.jhm
    n_pairs = len(thyp._boundary_pair_data(case.t_sd, torch.float64,
                                           "cpu")["k"])
    assert n_pairs == case.pairs
    assert max(1024, case.sd.n_pad // 16) == 1024
    assert hm.half == jhm._sym_riemann == case.half
    assert (hm._bp is None) == (jhm._bp is None) == (not case.half)
    assert hm.canvas.stream == (case.dim == 3 or case.reach > 1)
    ca = hm.canvas.arrays
    assert ca.g_inc.shape == (case.K,) + tuple(case.sd.shape)
    np.testing.assert_array_equal(
        hm.stencil.incidence.numpy(), case.sd.incidence.T)


# ---- the phases -------------------------------------------------------------


def test_substep_phases(case):
    """PK1, the d and tau glue, PK2 (U_low, F, bounds), PK3 (P, l, okp) and
    pk_up twice, in the kernel form the stepper takes, each on the JAX
    side's inputs."""
    ref, hm = case.ref, case.hm
    eq, p, ca, st = hm.eq, hm.params, hm.canvas.arrays, hm.stencil
    live, real = case.live, case.real
    assert ref["raised"][live].any(), "the dG factor must act"
    t = {k: to_torch(v) for k, v in ref.items()
         if k not in ("moved", "raised")}
    stage_U = torch.stack([t["Ua"], t["U"]])
    if hm.canvas.stream:
        e, alpha = pk1_stream.pk1_stream(eq, p, ca, t["U"], t["prec"],
                                         case.half)
        e_live = live[: e.shape[0]]
        assert_close(e.numpy()[e_live], ref["e"][e_live], "e")
        if case.half:
            e_fixed = hm._lambda_fixup(e, t["U"], prescaled=True)
            assert_close(e_fixed.numpy()[e_live], ref["e_fixed"][e_live],
                         "e after the prescaled fixup")
            assert ref["moved"][e_live].any(), "the fixup must act"
            # the port's pre-scaled e gives the d of the JAX raw lambda
            d = thyp.d_from_lambda(st, t["e_fixed"])
        else:
            d = thyp.d_from_e(st.mask, t["e"], st.transpose_edge(t["e"]))
        run2 = functools.partial(pk2_stream.pk2_stream, half=case.half)
        run3 = functools.partial(pk3_stream.pk3_stream, half=case.half)
        e_in = t["e_in"]
    else:
        lam, alpha = pk1.pk1(eq, p, ca, t["U"], t["prec"])
        e_live = live[: lam.shape[0]]
        assert_close(lam.numpy()[e_live], ref["lam"][e_live], "lambda")
        lam_fixed = hm._lambda_fixup(t["lam"], t["U"])
        assert_close(lam_fixed.numpy()[e_live], ref["lam_fixed"][e_live],
                     "lambda after the fixup")
        d = thyp.d_from_lambda(st, t["lam_fixed"], hm.cmax)
        run2, run3, e_in = pk2.pk2, pk3.pk3, t["lam_fixed"]
    assert_close(alpha.numpy()[real], ref["alpha"][real], "alpha")
    assert_close(d, ref["d"], "d")
    cap = torch.tensor(float("inf"), dtype=torch.float64)
    assert_close(thyp.tau_max_from_d(st, d, CFL, cap), ref["tau"], "tau")

    U_low, F, bounds = run2(eq, p, ca, t["U"], t["prec"], e_in, t["alpha"],
                            stage_U, WEIGHTS, t["tau"])
    assert_close(U_low.numpy()[:, real], ref["U_low"][:, real], "U_low")
    assert_close(F.numpy()[:, real], ref["F"][:, real], "F")
    assert_close(bounds.numpy()[:, real], ref["bounds"][:, real], "bounds")

    P, l, okp = run3(eq, p, ca, t["U"], e_in, t["alpha"], t["F"],
                     t["U_low"], t["bounds"], stage_U, WEIGHTS, t["tau"])
    assert_close(P.numpy()[:, live], ref["P"][:, live], "P")
    assert_l_close(l.numpy()[live], ref["l"][live], "l")
    assert 0.0 < ref["l"][live].min() < 1.0, "the limiter must work"
    ok_ref = np.all(ref["success"] | ~live, axis=0)[real]
    np.testing.assert_array_equal(okp.numpy()[real] > 0.5, ok_ref)

    U4, l4 = pk_up.pk_up(eq, p, ca, t["U_low"], t["bounds"], t["P"], t["l"],
                         False)
    assert_close(U4.numpy()[:, real], ref["U4"][:, real], "U after PK4")
    assert_l_close(l4.numpy()[live], ref["l4"][live], "l after PK4")
    U5, _ = pk_up.pk_up(eq, p, ca, t["U4"], t["bounds"], t["P"], t["l4"],
                        True)
    assert_close(U5.numpy()[:, real], ref["U5"][:, real], "U after PK5")


def test_plain_steps_match_jax():
    """Two ERK33 steps of the port's plain path with bang-bang recovery
    against the JAX package's XLA advance, on the smaller box."""
    c = built("box_half_slot")
    ref = JTimeIntegrator(c.jhm, "erk 33", **RECOVERY).advance(
        jnp.asarray(c.U0), 0.0, 2)
    out = TimeIntegrator(c.hm, "erk 33", **RECOVERY).advance(
        to_torch(c.U0), 0.0, 2)
    U, prec, t, tau, restarts, warns = out
    assert_close(U.numpy()[:, c.real], np.asarray(ref[0])[:, c.real], "U")
    assert_close(prec.numpy()[:, c.real], np.asarray(ref[1])[:, c.real],
                 "prec")
    assert_close(t, ref[2], "t")
    assert_close(tau, ref[3], "tau")
    assert int(restarts) == int(ref[4]) == 0
    assert int(warns) == int(ref[5]) == 0
    assert bool(c.eq.is_admissible(U[:, torch.as_tensor(c.real)]).all())


def test_canvas_stepper_matches_plain_step(case):
    """CanvasStepper (the kernel wrappers on CPU tensors, which take their
    plain versions) against the plain phase-function substep, for the
    third ERK33 substep with tau computed in it, on the stage states of
    test_substep_phases; no kernel launches.  (With Ua * 1.01 as the
    second stage state, as tests/test_torch_box3d_slice.py takes it, the
    Euler flux, homogeneous of degree one, cancels in P to 0.75 % of its
    terms; on the two-direction box the two paths' summation orders then
    move 263 of 39,552 limiter edges by up to 5.1e-6, and U by 3.8e-9.)"""
    hm = case.hm
    fns = (pk1.pk1, pk2.pk2, pk3.pk3, pk1_stream.pk1_stream,
           pk2_stream.pk2_stream, pk3_stream.pk3_stream, pk_up.pk_up)
    before = [f.launches for f in fns]
    Ua, _ = hm.prepare_state_vector(to_torch(case.U0), 0.0)
    Ub, prec = hm.prepare_state_vector(to_torch(case.U1), 0.0)
    cap = torch.tensor(float("inf"), dtype=torch.float64)
    tau = torch.zeros((), dtype=torch.float64)
    args = (Ub, prec, torch.stack([Ua, Ub]), WEIGHTS, tau, CFL, cap, True)
    U_c, tau_c, ok_c = hm.canvas.step(*args)
    U_p, tau_p, ok_p = hm.plain_step(*args)
    assert_close(U_c, U_p, "U")
    assert_close(tau_c, tau_p, "tau")
    assert bool(ok_c) and bool(ok_p)
    assert not torch.equal(U_c, Ub), "the substep must move the state"
    assert [f.launches for f in fns] == before
