"""One IDP substep of the PyTorch port against the JAX package, phase by
phase, on the shared step fixture (tests/test_torch_fixture.py).

The JAX side runs its phase functions (solver/hyperbolic.py:411-1104) as
its XLA step does; the port runs its kernel wrappers, which take their
plain-torch references on CPU tensors.  Each phase gets the JAX side's
inputs, so a fault points to one kernel.  The substep is the third one of
ERK33 (two active stages, weights 0.75 and -2), which exercises the
stage terms of PK2 and PK3.  float64, relative 5e-11 / absolute 1e-12.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from ryujin_tpu.solver import hyperbolic as jhyp  # noqa: E402
from ryujin_tpu.solver.pallas_step import PallasStepper  # noqa: E402

from ryujin_tpu_torch.kernels.pk1 import pk1  # noqa: E402
from ryujin_tpu_torch.kernels.pk2 import pk2  # noqa: E402
from ryujin_tpu_torch.kernels.pk3 import pk3  # noqa: E402
from ryujin_tpu_torch.kernels.pk_up import pk_up  # noqa: E402
from ryujin_tpu_torch.solver import hyperbolic as thyp  # noqa: E402
from ryujin_tpu_torch.solver.canvas_step import CanvasArrays  # noqa: E402

from test_torch_fixture import (  # noqa: E402
    assert_close, modules, step_case, to_torch,
)

WEIGHTS = [0.75, -2.0]
CFL = 0.9


@functools.lru_cache(maxsize=None)
def jax_substep():
    """Every intermediate of one JAX XLA substep, as numpy arrays."""
    sd, jeq, _, U0, _, params, _ = step_case()
    jhm, _ = modules()
    st = jhm.stencil
    p = jhm.params
    Ua, preca = jhm.prepare_state_vector(jnp.asarray(U0), 0.0)
    # a second prepared state: the first stage's output
    Ub, _, _ = jhm.step(
        Ua, preca, jnp.zeros((0,) + Ua.shape), jnp.zeros((0,) + preca.shape),
        jnp.zeros((0,)), 0.0, CFL, jnp.inf, compute_tau=True,
    )
    U, prec = jhm.prepare_state_vector(Ub, 0.0)
    sU = jnp.stack([Ua, U])
    sP = jnp.stack([preca, prec])
    w = jnp.asarray(WEIGHTS)
    U_j, prec_j = st.nbr(U), st.nbr(prec)
    sU_j = jnp.stack([st.nbr(sU[s]) for s in range(2)])
    sP_j = jnp.stack([st.nbr(sP[s]) for s in range(2)])
    ip = jhm.initial_precomputed
    ip_j = jnp.zeros((0,) + st.mask.shape)

    lam, alpha = jhyp.phase_e_alpha(jeq, p, st, U, prec, U_j, prec_j, half=True)
    lam_fixed = jhm._lambda_fixup(lam, U, prec)
    d = jhyp.d_from_lambda(st, lam_fixed, st.mask)
    e, _ = jhyp.phase_e_alpha(jeq, p, st, U, prec, U_j, prec_j)
    d_two = jhyp.d_from_e(st.mask, e, st.transpose_edge(e))
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
    out = dict(
        Ua=Ua, U=U, prec=prec, lam=lam, lam_fixed=lam_fixed, alpha=alpha,
        d=d, d_two=d_two, tau=tau, U_low=U_low, F=F, bounds=bounds, P=P,
        l=l, success=success, U4=U4, l4=l4, U5=U5,
    )
    return {k: np.asarray(v) for k, v in out.items()}


def _port():
    _, _, _, _, eq, params, _ = step_case()
    _, hm = modules()
    return eq, params, hm, hm.canvas.arrays


def assert_l_close(actual, expected, err_msg):
    """The limiter's l on live edges.  l is the left end of the Newton
    bracket after two iterations; where psi is flat at roundoff near its
    root (psi(t) == 0.0 over the whole final bracket, |terms| ~ 3.5), the
    accept test psi_r > 0 is decided by the last ulp of its inputs.  Such
    an edge moves by up to the bracket width.  Measured for PK3: 69 of
    129,664 live edges (0.053%), at most 4.28e-4; 61 of them move just
    as far when the JAX limiter itself is given the port's P, which
    differs from the JAX P by 6.8e-15 relative (see
    test_pk3_l_moves_with_roundoff_of_P).  Every other edge holds the
    5e-11 bar; at most 0.1% of the edges may move, by at most 5e-4."""
    actual = actual.numpy() if torch.is_tensor(actual) else actual
    far = ~np.isclose(actual, expected, rtol=5e-11, atol=1e-12)
    assert far.mean() <= 1e-3, f"{err_msg}: {far.sum()} edges differ"
    np.testing.assert_allclose(actual, expected, rtol=0, atol=5e-4,
                               err_msg=err_msg)


def _live():
    sd = step_case()[0]
    return sd.mask.T > 0, sd.node_mask > 0


def test_canvas_arrays_match_pallas_arrays():
    """CanvasArrays.from_structured builds the statics exactly as the JAX
    PallasStepper builds PallasArrays, cmax included.  PallasArrays'
    flat node_mask / m_lumped copies are left out: the port's tau
    reduction reads the g_node planes."""
    sd, jeq, _, _, _, _, _ = step_case()
    ref = PallasStepper(jeq, jhyp.HyperbolicModuleParams(), sd,
                        dtype=jnp.float64, interpret=True).arrays
    ca = CanvasArrays.from_structured(sd, torch.float64, "cpu")
    for name in ("g_cij", "g_mask", "g_cmax", "g_mij", "g_cii", "g_node",
                 "g_lam"):
        a = getattr(ca, name).numpy()
        b = np.asarray(getattr(ref, name))
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_boundary_pair_data_matches_jax():
    """The numpy coupling-boundary-pair precompute equals the JAX one."""
    sd = step_case()[0]
    jhm, _ = modules()
    ref = jhm._bp
    got = thyp._boundary_pair_data(sd, torch.float64, "cpu")
    assert len(ref["k"]) > 0
    for key in ("k", "i", "j"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]),
                                      err_msg=key)
    for key in ("n_T", "w_fwd", "w_rev"):
        assert_close(got[key], ref[key], key)


def test_pk1_lambda_alpha_and_fixup():
    """PK1's half-slot lambda and alpha, then lambda after the
    boundary-pair fixup."""
    ref = jax_substep()
    eq, params, hm, ca = _port()
    U, prec = to_torch(ref["U"]), to_torch(ref["prec"])
    lam, alpha = pk1(eq, params, ca, U, prec)
    live, real = _live()
    K2 = lam.shape[0]
    assert_close(lam.numpy()[live[:K2]], ref["lam"][live[:K2]], "lambda")
    assert_close(alpha.numpy()[real], ref["alpha"][real], "alpha")
    lam = hm._lambda_fixup(to_torch(ref["lam"]), U)
    assert_close(lam.numpy()[live[:K2]], ref["lam_fixed"][live[:K2]],
                 "lambda after the fixup")


def test_d_tau_and_half_slot_identity():
    """d from the half-slot lambda and tau_max; the half-slot d equals the
    two-direction d = max(e_ij, e_ji) on every live edge (the symmetric
    Riemann identity plus the boundary-pair fixup)."""
    ref = jax_substep()
    _, _, hm, ca = _port()
    st = ca.stencil
    d = thyp.d_from_lambda(st, to_torch(ref["lam_fixed"]),
                           ca.g_cmax.reshape(ca.K, -1))
    assert_close(d, ref["d"], "d")
    cap = torch.tensor(float("inf"), dtype=torch.float64)
    tau = thyp.tau_max_from_d(st, d, CFL, cap)
    assert_close(tau, ref["tau"], "tau")
    assert_close(ref["d"], ref["d_two"], "JAX half-slot d vs two-direction d")
    # the port's own two-direction form on the plain stencil:
    U, prec = to_torch(ref["U"]), to_torch(ref["prec"])
    sst = hm.stencil
    e, _ = thyp.phase_e_alpha(hm.eq, hm.params, sst, U, prec, sst.nbr(U),
                              sst.nbr(prec), half=False)
    assert_close(thyp.d_from_e(sst.mask, e, sst.transpose_edge(e)), d,
                 "half-slot d vs two-direction d")


def test_pk2_low_order_F_bounds():
    ref = jax_substep()
    eq, params, _, ca = _port()
    _, real = _live()
    t = {k: to_torch(ref[k]) for k in ("U", "prec", "lam_fixed", "alpha",
                                       "Ua", "tau")}
    stage_U = torch.stack([t["Ua"], t["U"]])
    U_low, F, bounds = pk2(eq, params, ca, t["U"], t["prec"], t["lam_fixed"],
                           t["alpha"], stage_U, WEIGHTS, t["tau"])
    assert_close(U_low.numpy()[:, real], ref["U_low"][:, real], "U_low")
    assert_close(F.numpy()[:, real], ref["F"][:, real], "F")
    assert_close(bounds.numpy()[:, real], ref["bounds"][:, real], "bounds")


@functools.lru_cache(maxsize=None)
def port_pk3():
    """(P, l, okp) of the port's PK3 on the JAX substep's inputs."""
    ref = jax_substep()
    eq, params, _, ca = _port()
    t = {k: to_torch(ref[k]) for k in ("U", "lam_fixed", "alpha", "F",
                                       "U_low", "bounds", "Ua", "tau")}
    stage_U = torch.stack([t["Ua"], t["U"]])
    return pk3(eq, params, ca, t["U"], t["lam_fixed"], t["alpha"], t["F"],
               t["U_low"], t["bounds"], stage_U, WEIGHTS, t["tau"])


def test_pk3_P_l_success():
    ref = jax_substep()
    live, real = _live()
    P, l, okp = port_pk3()
    assert_close(P.numpy()[:, live], ref["P"][:, live], "P")
    assert_l_close(l.numpy()[live], ref["l"][live], "l")
    assert 0.0 < ref["l"][live].min() < 1.0, "the limiter must work"
    ok_ref = np.all(ref["success"] | ~live, axis=0)[real]
    np.testing.assert_array_equal(okp.numpy()[real] > 0.5, ok_ref)


def test_pk3_l_moves_with_roundoff_of_P():
    """Where the port's l leaves the 5e-11 bar, the limiter itself is
    decided at roundoff: the JAX limiter, given the port's P (equal to
    the JAX P within 5e-11; measured 6.8e-15 relative) and the JAX U_low
    and bounds, moves the same edges (measured: 61 of the 69).  On these
    identical inputs the port's l and the JAX limiter's differ on far
    fewer edges, by less (measured: 13 edges, at most 4.2e-5), which is
    left to their pow and operation order."""
    ref = jax_substep()
    jeq = step_case()[1]
    jp = jhyp.HyperbolicModuleParams()
    live, _ = _live()
    P, l, _ = port_pk3()
    bounds = jnp.asarray(ref["bounds"])[:, None]
    U_low = jnp.asarray(ref["U_low"])[:, None]
    l_jax, _ = jeq.limiter_limit(
        bounds, U_low, jnp.asarray(P.numpy()),
        newton_iterations=jp.limiter_newton_max_iterations,
        newton_tol=jp.limiter_newton_tolerance,
        psi0=jeq.limiter_psi0(bounds, U_low),
    )
    l_jax, l = np.asarray(l_jax)[live], l.numpy()[live]

    def moved(a, b):
        return ~np.isclose(a, b, rtol=5e-11, atol=1e-12)

    port_moved = moved(l, ref["l"][live])
    assert port_moved.sum() > 0, "no roundoff-decided edge in the fixture"
    assert moved(l_jax, ref["l"][live])[port_moved].mean() >= 0.8
    same_inputs = moved(l, l_jax)
    assert same_inputs.sum() <= port_moved.sum() // 2, same_inputs.sum()
    np.testing.assert_allclose(l, l_jax, rtol=0, atol=1e-4)


def test_pk_up_two_passes():
    """U after PK4 (with its re-limited l') and after PK5."""
    ref = jax_substep()
    eq, params, _, ca = _port()
    live, real = _live()
    t = {k: to_torch(ref[k]) for k in ("U_low", "bounds", "P", "l", "U4",
                                       "l4")}
    U4, l4 = pk_up(eq, params, ca, t["U_low"], t["bounds"], t["P"], t["l"],
                   False)
    assert_close(U4.numpy()[:, real], ref["U4"][:, real], "U after PK4")
    assert_l_close(l4.numpy()[live], ref["l4"][live], "l after PK4")
    U5, l5 = pk_up(eq, params, ca, t["U4"], t["bounds"], t["P"], t["l4"],
                   True)
    assert l5 is None
    assert_close(U5.numpy()[:, real], ref["U5"][:, real], "U after PK5")
