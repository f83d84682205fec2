"""The box3d slice of the PyTorch port against the JAX package, phase by
phase: 3D Euler, cG Q1 (K = 26) on [0, 3] x [0, 1] x [0, 1] with the
box3d boundary conditions (bench.py:60-82), packed with z and y margins
of 2 onto a 16 x 16 x 16 canvas (x padded to 16, not to the TPU's 128
lanes, which would make every array 8 times larger on the CPU), at
refinement 1 on two boxes, one for each Riemann route the JAX package
picks by the size of the coupling-boundary-pair set against
max(1024, n_pad / 16) (ryujin_tpu/solver/hyperbolic.py:1307-1320):

- 3 x 2 x 2 cells: 175 nodes, 512 pair slots against the cut-off 1,024,
  the half-slot route (pre-scaled e = lambda * cmax and the fixup);
- 7 x 4 x 4 cells: 1,215 nodes, 2,304 pair slots, the two-direction
  route (e = |c_ij| lambda on every slot, d = max(e, e_T)).

(Packed with 128 lanes, as box3d is, the cut-off is 2,048 and the routes
are the same; chip_smoke.py and tests/test_torch_gpu.py run them so.)

Each package builds its StructuredData with its own offline layer; they
are held equal array for array.  The Euler functions at dim 3 are held
against JAX on random states.  The JAX side runs its public phase
functions (hyperbolic.py:411-1104) on full [K, n] stacks, as its XLA step
does; the port runs its kernel wrappers (pk1_stream, pk2_stream,
pk3_stream, pk_up), which take their plain-torch references on CPU
tensors.  Each phase gets the JAX side's inputs, so a fault points to one
kernel.  The substep is the third one of ERK33 (two active stages,
weights 0.75 and -2) on the box3d inflow state times a seeded numpy bump.
float64, relative 5e-11 / absolute 1e-12; the limiter's l under the
edge-count rule of tests/test_torch_q2_phases.py.  No interpret-mode
kernel runs: the JAX package's own test_pallas_interpret_matches_xla_3d
holds its slab kernels against this XLA path.
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

from ryujin_tpu_torch import convert  # noqa: E402
from ryujin_tpu_torch.equations.euler_initial_states import (  # noqa: E402
    make_initial_state,
)
from ryujin_tpu_torch.kernels.pk1_stream import pk1_stream  # noqa: E402
from ryujin_tpu_torch.kernels.pk2_stream import pk2_stream  # noqa: E402
from ryujin_tpu_torch.kernels.pk3_stream import pk3_stream  # noqa: E402
from ryujin_tpu_torch.kernels.pk_up import pk_up  # noqa: E402
from ryujin_tpu_torch.offline import (  # noqa: E402
    assembly as t_assembly,
    geometry as t_geometry,
    mesh as t_mesh,
    structured as t_structured,
)
from ryujin_tpu_torch.solver import hyperbolic as thyp  # noqa: E402
from ryujin_tpu_torch.solver.hyperbolic import HyperbolicModule  # noqa: E402
from ryujin_tpu_torch.solver.stencil import check_single_block  # noqa: E402

from test_torch_fixture import assert_close, to_torch  # noqa: E402
from test_torch_q2_offline import assert_same  # noqa: E402

INFLOW = (1.4, 3.0, 1.0)
BOXES = {"half_slot": (3, 2, 2), "two_direction": (7, 4, 4)}
K, K2 = 26, 13
WEIGHTS = [0.75, -2.0]
CFL = 0.9
JEQ = JEuler(dim=3)
EQ, PARAMS = convert.params_from_reference(JEQ, jhyp.HyperbolicModuleParams())


def _packed(pkg, subdiv):
    """The box at refinement 1, assembled and packed by the offline layer
    of `pkg` (the JAX package's or the port's)."""
    geometry_, assembly_, structured_, boundary = pkg
    mesh = geometry_.rectangular_domain(
        [0.0, 0.0, 0.0], [3.0, 1.0, 1.0], list(subdiv), refinement=1,
        boundary_conditions=[boundary.dirichlet, boundary.do_nothing]
        + [boundary.slip] * 4,
        dim=3,
    )
    return structured_.pack_structured(assembly_.assemble(mesh), mesh,
                                       pad_minor=16, margin=(2, 2))


@functools.lru_cache(maxsize=None)
def box_case(route):
    """(sd of the JAX package, port HyperbolicModule on the port's own sd,
    JAX initial state, U0 numpy [5, n_pad], the port's sd): the inflow
    state times a seeded bump of density and energy."""
    subdiv = BOXES[route]
    sd = _packed((geometry, assembly, structured, Boundary), subdiv)
    t_sd = _packed((t_geometry, t_assembly, t_structured, t_mesh.Boundary),
                   subdiv)
    hm = HyperbolicModule(
        EQ, t_sd, make_initial_state(EQ, "uniform", primitive_state=INFLOW),
        params=PARAMS, dtype=torch.float64, device="cpu",
    )
    jinit = j_make_initial_state(JEQ, "uniform", primitive_state=INFLOW)
    U = np.array(j_interpolate_nodal(jinit, sd, JEQ, 0.0, jnp.float64))
    rng = np.random.default_rng(3303)
    center = rng.uniform([0.8, 0.35, 0.35], [1.6, 0.65, 0.65])
    width = rng.uniform(6.0, 10.0)
    bump = 1.0 + 0.3 * np.exp(
        -width * np.sum((sd.positions.T - center[:, None]) ** 2, 0)
    )
    bump = np.where(sd.node_mask > 0, bump, 1.0)
    U[0] *= bump
    U[-1] *= bump ** 2
    return sd, hm, jinit, U, t_sd


@functools.lru_cache(maxsize=None)
def jax_module(route):
    sd, _, jinit, _, _ = box_case(route)
    return jhyp.HyperbolicModule(JEQ, sd, jinit, dtype=jnp.float64)


# ---- the host layer and the equations at dim 3 ------------------------------


@pytest.mark.parametrize("route", sorted(BOXES))
def test_structured_data_equal(route):
    sd, _, _, _, got = box_case(route)
    assert isinstance(got, t_structured.StructuredData)
    assert got.dim == 3 and got.max_degree == K and got.reach == 1
    assert tuple(got.shape) == (16, 16, 16)
    assert got.offsets == t_structured.lattice_offsets(3, 1)
    check_single_block(got)
    assert_same(got, sd, "sd")


def _states(rng, shape):
    """Random admissible conserved 3D states [5, *shape]."""
    rho = rng.uniform(0.3, 3.0, shape)
    v = rng.uniform(-3.0, 3.0, (3,) + shape)
    p = rng.uniform(0.1, 5.0, shape)
    E = p / 0.4 + 0.5 * rho * np.sum(v * v, 0)
    return np.concatenate([rho[None], rho[None] * v, E[None]], 0)


def _unit(rng, shape):
    n = rng.normal(size=(3,) + shape)
    return n / np.linalg.norm(n, axis=0)


def test_euler_3d_state_flux_riemann_and_bcs():
    """precompute, f, flux_divergence, riemann_lambda_max and the
    boundary conditions of the box (slip, dirichlet, do_nothing) at dim 3."""
    rng = np.random.default_rng(31)
    M = 400
    Ui, Uj, dirichlet = (_states(rng, (M,)) for _ in range(3))
    n, c = _unit(rng, (M,)), rng.normal(size=(3, M))
    J = [jnp.asarray(x) for x in (Ui, Uj, n, c, dirichlet)]
    T = [torch.tensor(x) for x in (Ui, Uj, n, c, dirichlet)]
    assert_close(EQ.precompute(T[0]), JEQ.precompute(J[0], None), "precompute")
    assert_close(EQ.f(T[0]), JEQ.f(J[0]), "f")
    assert_close(EQ.flux_divergence(EQ.f(T[0]), EQ.f(T[1]), T[3]),
                 JEQ.flux_divergence(JEQ.f(J[0]), JEQ.f(J[1]), J[3]),
                 "flux_divergence")
    ref = JEQ.riemann_lambda_max(J[0], J[1], J[2],
                                 pa_i=JEQ.riemann_precompute(J[0]),
                                 pa_j=JEQ.riemann_precompute(J[1]))
    got = EQ.riemann_lambda_max(T[0], T[1], T[2],
                                pa_i=EQ.riemann_precompute(T[0]),
                                pa_j=EQ.riemann_precompute(T[1]))
    assert_close(got, ref, "lambda_max")
    for bc in (Boundary.do_nothing, Boundary.slip, Boundary.dirichlet):
        assert_close(
            EQ.apply_boundary_conditions(bc, T[0], T[2], T[4]),
            JEQ.apply_boundary_conditions(bc, J[0], J[2], J[4]),
            f"boundary id {bc}",
        )


def test_euler_3d_stream_forms_and_limiter():
    """The indicator and bounds stream forms over K = 26 offsets (the 3D
    relaxation exponent r_i = (h^d_i)^(1/2)), and the limiter on both of
    its branches."""
    rng = np.random.default_rng(32)
    M = 300
    Ui = _states(rng, (M,))
    Uj = Ui[:, None] * rng.uniform(0.8, 1.25, (1, K, M))
    x = dict(Ui=Ui, Uj=Uj, c=rng.normal(size=(3, K, M)),
             mask=(rng.uniform(size=(K, M)) < 0.8).astype(float),
             hd=rng.uniform(1e-6, 1e-2, M), d=rng.uniform(0.1, 2.0, (K, M)))

    def forms(eq, X):
        prec_i = (eq.precompute(X["Ui"], None) if eq is JEQ
                  else eq.precompute(X["Ui"]))
        prec_j = (eq.precompute(X["Uj"], None) if eq is JEQ
                  else eq.precompute(X["Uj"]))
        f_j = eq.f(X["Uj"])
        ind = eq.indicator_init(X["Ui"], prec_i)
        bst = eq.limiter_bounds_init(X["Ui"], prec_i)
        scaled = X["c"] / X["d"][None]
        left = right = None
        for k in range(K):
            li, ri = eq.indicator_accum(ind, X["Uj"][:, k], prec_j[:, k],
                                        f_j[:, :, k], X["c"][:, k],
                                        X["mask"][k])
            left = li if left is None else left + li
            right = ri if right is None else right + ri
            bst = eq.limiter_bounds_accum(bst, X["Uj"][:, k], prec_j[:, k],
                                          scaled[:, k], X["mask"][k])
        alpha = eq.indicator_finalize(ind, left, right, X["hd"], 0.7)
        bounds = eq.limiter_bounds_finalize(bst, X["hd"], 0.9)
        P = 3.0 * (X["Uj"] - X["Ui"][:, None])
        b, u = bounds[:, None], X["Ui"][:, None]
        l, s = eq.limiter_limit(b, u, P, psi0=eq.limiter_psi0(b, u))
        return left, right, alpha, bounds, l, s

    # the JAX side traced and compiled as one program (op by op it compiles
    # each of the 26 slots' slices anew)
    out = [
        jax.jit(lambda X: forms(JEQ, X))(
            {k: jnp.asarray(v) for k, v in x.items()}),
        forms(EQ, {k: torch.tensor(v) for k, v in x.items()}),
    ]
    for name, got, ref in zip(("left", "right", "alpha", "bounds", "l"),
                              out[1], out[0]):
        assert_close(got, ref, name)
    np.testing.assert_array_equal(out[1][5].numpy(), np.asarray(out[0][5]))
    l_ref = np.asarray(out[0][4])
    assert (l_ref < 1.0).any() and (l_ref == 1.0).any()


# ---- the route and the phases -------------------------------------------------


@pytest.mark.parametrize("route", sorted(BOXES))
def test_route_matches_jax(route):
    """The port decides the Riemann route as the JAX package does, from the
    same pair count and the same n_pad."""
    sd, hm, _, _, _ = box_case(route)
    jhm = jax_module(route)
    cutoff = max(1024, sd.n_pad // 16)
    n_pairs = len(thyp._boundary_pair_data(sd, torch.float64, "cpu")["k"])
    assert (n_pairs, cutoff) == ({"half_slot": 512,
                                  "two_direction": 2304}[route], 1024)
    assert hm.half == jhm._sym_riemann == (route == "half_slot")
    assert (hm._bp is None) == (jhm._bp is None) == (route != "half_slot")
    assert hm.canvas.stream and hm.canvas.half == hm.half


@functools.lru_cache(maxsize=None)
def jax_substep(route):
    """Every intermediate of one JAX XLA substep on the route's box, as
    numpy: the third ERK33 substep, whose stages are the prepared bumped
    state and a second state with another bump."""
    sd, _, _, U0, _ = box_case(route)
    return jax_phases(sd, jax_module(route), U0, route)


def jax_phases(sd, jhm, U0, route):
    """jax_substep on any 3D canvas: the JAX module `jhm` on `sd`, from the
    state U0 [5, n_pad], on the Riemann route `route`."""
    st, p = jhm.stencil, jhm.params
    Ua, preca = jhm.prepare_state_vector(jnp.asarray(U0), 0.0)
    shifted = U0.copy()
    shifted[:, sd.node_mask > 0] *= 1.0 + 0.05 * np.cos(
        4.0 * sd.positions[sd.node_mask > 0, 0]
    )[None]
    U, prec = jhm.prepare_state_vector(jnp.asarray(shifted), 0.0)
    if route == "half_slot":
        norm_c = np.linalg.norm(sd.cij, axis=-1).T.reshape((K,) + sd.shape)
        cmax = jnp.asarray(np.stack([
            np.maximum(norm_c[k], np.roll(norm_c[K - 1 - k],
                                          tuple(-o for o in off),
                                          axis=(0, 1, 2)))
            for k, off in enumerate(map(tuple, sd.offsets))
        ]).reshape(K, -1))

    @jax.jit
    def phases(Ua, preca, U, prec):
        sU, sP = jnp.stack([Ua, U]), jnp.stack([preca, prec])
        w = jnp.asarray(WEIGHTS)
        U_j, prec_j = st.nbr(U), st.nbr(prec)
        sU_j = jnp.stack([st.nbr(sU[s]) for s in range(2)])
        sP_j = jnp.stack([st.nbr(sP[s]) for s in range(2)])
        ip = jhm.initial_precomputed
        ip_j = jnp.zeros((0,) + st.mask.shape)
        out = {}
        if route == "half_slot":
            lam, alpha = jhyp.phase_e_alpha(JEQ, p, st, U, prec, U_j, prec_j,
                                            half=True)
            e = lam * cmax[:K2]
            e_fixed = jhm._lambda_fixup(e, U, prec, prescaled=True)
            d = jhyp.d_from_lambda(st, jhm._lambda_fixup(lam, U, prec),
                                   st.mask)
            out.update(e_fixed=e_fixed, moved=(e_fixed != e))
        else:
            e, alpha = jhyp.phase_e_alpha(JEQ, p, st, U, prec, U_j, prec_j)
            e_fixed = e
            d = jhyp.d_from_e(st.mask, e, st.transpose_edge(e))
        tau = jhyp.tau_max_from_d(st, d, CFL, jnp.inf)
        alpha_j = st.nbr(alpha)
        U_low, F, bounds = jhyp.phase_low_order(
            JEQ, p, st, U, prec, U_j, prec_j, d, alpha, alpha_j, tau,
            sU, sP, sU_j, sP_j, w, ip, ip_j,
        )
        P, l, success = jhyp.phase_p_l1(
            JEQ, p, st, U, prec, U_j, prec_j, d, alpha, alpha_j, tau,
            F, st.nbr(F), st.nbr(st.m_lumped), U_low, bounds,
            sU, sP, sU_j, sP_j, w, ip, ip_j,
        )
        U4, l4 = jhyp.phase_update(JEQ, p, st, U_low, bounds, P, l,
                                   st.transpose_edge(l), False)
        U5, _ = jhyp.phase_update(JEQ, p, st, U4, bounds, P, l4,
                                  st.transpose_edge(l4), True)
        out.update(Ua=Ua, U=U, prec=prec, e=e, e_in=e_fixed, alpha=alpha,
                   d=d, tau=tau, U_low=U_low, F=F, bounds=bounds, P=P, l=l,
                   success=success, U4=U4, l4=l4, U5=U5)
        return out

    out = phases(Ua, preca, U, prec)
    return {k: np.asarray(v) for k, v in out.items()}


def assert_l_close(actual, expected, err_msg):
    """The limiter's l on live edges: where psi is flat at roundoff near
    its root the accept test psi_r > 0 is decided by the last ulp of P, so
    at most 0.1 % of the edges may leave the 5e-11 bar, by at most 5e-3
    (the rule of tests/test_torch_q2_phases.py)."""
    far = ~np.isclose(actual, expected, rtol=5e-11, atol=1e-12)
    print(f"{err_msg}: {far.sum()} of {far.size} live edges off the 5e-11 "
          f"bar, at most {np.abs(actual - expected).max():.3e}")
    assert far.mean() <= 1e-3, f"{err_msg}: {far.sum()} edges differ"
    np.testing.assert_allclose(actual, expected, rtol=0, atol=5e-3,
                               err_msg=err_msg)


@pytest.mark.parametrize("route", sorted(BOXES))
def test_substep_phases(route):
    """PK1 (e, alpha), the d and tau glue, PK2 (U_low, F, bounds), PK3 (P,
    l, okp) and pk_up twice (U and l' after PK4, U after PK5), each on
    the JAX side's inputs; the JAX limiter given the port's P agrees with
    the port's l."""
    half = route == "half_slot"
    ref = jax_substep(route)
    sd, hm, _, _, _ = box_case(route)
    ca, st = hm.canvas.arrays, hm.stencil
    live, real = sd.mask.T > 0, sd.node_mask > 0
    t = {k: to_torch(v) for k, v in ref.items() if k not in ("moved",)}

    e, alpha = pk1_stream(EQ, PARAMS, ca, t["U"], t["prec"], half)
    assert e.shape[0] == (K2 if half else K)
    e_live = live[: e.shape[0]]
    assert_close(e.numpy()[e_live], ref["e"][e_live], "e")
    assert_close(alpha.numpy()[real], ref["alpha"][real], "alpha")
    assert 0.0 < ref["alpha"][real].max() <= 1.0
    if half:
        e_fixed = hm._lambda_fixup(t["e"], t["U"], prescaled=True)
        assert_close(e_fixed.numpy()[e_live], ref["e_fixed"][e_live],
                     "e after the prescaled fixup")
        assert ref["moved"][e_live].sum() > 0, "the fixup must act"
        d = thyp.d_from_lambda(st, t["e_in"])
    else:
        assert hm._bp is None
        d = thyp.d_from_e(st.mask, t["e"], st.transpose_edge(t["e"]))
    assert_close(d, ref["d"], "d")
    cap = torch.tensor(float("inf"), dtype=torch.float64)
    assert_close(thyp.tau_max_from_d(st, d, CFL, cap), ref["tau"], "tau")

    stage_U = torch.stack([t["Ua"], t["U"]])
    U_low, F, bounds = pk2_stream(
        EQ, PARAMS, ca, t["U"], t["prec"], t["e_in"], t["alpha"], stage_U,
        WEIGHTS, t["tau"], half,
    )
    assert_close(U_low.numpy()[:, real], ref["U_low"][:, real], "U_low")
    assert_close(F.numpy()[:, real], ref["F"][:, real], "F")
    assert_close(bounds.numpy()[:, real], ref["bounds"][:, real], "bounds")

    P, l, okp = pk3_stream(
        EQ, PARAMS, ca, t["U"], t["e_in"], t["alpha"], t["F"], t["U_low"],
        t["bounds"], stage_U, WEIGHTS, t["tau"], half,
    )
    assert_close(P.numpy()[:, live], ref["P"][:, live], "P")
    assert_l_close(l.numpy()[live], ref["l"][live], "l")
    assert 0.0 < ref["l"][live].min() < 1.0, "the limiter must work"
    b_j = jnp.asarray(ref["bounds"])[:, None]
    Ul_j = jnp.asarray(ref["U_low"])[:, None]
    l_jax, _ = JEQ.limiter_limit(
        b_j, Ul_j, jnp.asarray(P.numpy()),
        newton_iterations=PARAMS.limiter_newton_max_iterations,
        newton_tol=PARAMS.limiter_newton_tolerance,
        psi0=JEQ.limiter_psi0(b_j, Ul_j),
    )
    np.testing.assert_allclose(l.numpy()[live], np.asarray(l_jax)[live],
                               rtol=0, atol=1e-4)
    assert not P.numpy()[:, ~live].any() and not l.numpy()[~live].any()
    ok_ref = np.all(ref["success"] | ~live, axis=0)[real]
    np.testing.assert_array_equal(okp.numpy()[real] > 0.5, ok_ref)

    U4, l4 = pk_up(EQ, PARAMS, ca, t["U_low"], t["bounds"], t["P"], t["l"],
                   False)
    assert_close(U4.numpy()[:, real], ref["U4"][:, real], "U after PK4")
    assert_l_close(l4.numpy()[live], ref["l4"][live], "l after PK4")
    U5, _ = pk_up(EQ, PARAMS, ca, t["U4"], t["bounds"], t["P"], t["l4"],
                  True)
    assert_close(U5.numpy()[:, real], ref["U5"][:, real], "U after PK5")
