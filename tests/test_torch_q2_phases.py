"""One IDP substep of the PyTorch port at reach 2 (cG Q2 on the Mach-3
step at refinement 0: 184 x 512 canvas, K = 24) against the JAX package,
phase by phase.

The JAX side runs its phase functions (solver/hyperbolic.py:411-1104) on
full [K, n] stacks, as its XLA step does; the port runs its slot-streaming
kernel wrappers (pk1_stream, pk2_stream, pk3_stream) and pk_up, which take
their plain-torch references on CPU tensors.  Each phase gets the JAX
side's inputs, so a fault points to one kernel.  The substep is the third
one of ERK33 (two active stages, weights 0.75 and -2).  float64, relative
5e-11 / absolute 1e-12; the limiter's l under the edge-count rule of
tests/test_torch_phases.py (at most 0.1 % of the live edges off that bar),
with the count printed and the cap on a moved edge stated below.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from ryujin_tpu.solver import hyperbolic as jhyp  # noqa: E402

from ryujin_tpu_torch.kernels.pk1_stream import pk1_stream  # noqa: E402
from ryujin_tpu_torch.kernels.pk2_stream import pk2_stream  # noqa: E402
from ryujin_tpu_torch.kernels.pk3_stream import pk3_stream  # noqa: E402
from ryujin_tpu_torch.kernels.pk_up import pk_up  # noqa: E402
from ryujin_tpu_torch.solver import hyperbolic as thyp  # noqa: E402

from test_torch_fixture import (  # noqa: E402
    assert_close, modules, step_case, to_torch,
)

ANSATZ = "cG Q2"
WEIGHTS = [0.75, -2.0]
CFL = 0.9
K, K2 = 24, 12


@functools.lru_cache(maxsize=None)
def jax_substep():
    """Every intermediate of one JAX XLA substep at K = 24, as numpy."""
    sd, jeq, _, U0, _, _, _ = step_case(ANSATZ)
    jhm, hm = modules(ANSATZ)
    st = jhm.stencil
    p = jhm.params
    Ua, preca = jhm.prepare_state_vector(jnp.asarray(U0), 0.0)
    # a second prepared state: the first stage's output, taken from the
    # port's plain substep (cheaper than compiling the JAX step for it)
    cap = torch.tensor(float("inf"), dtype=torch.float64)
    Ub, _, _ = hm.step(
        to_torch(Ua), to_torch(preca), None, [],
        torch.zeros((), dtype=torch.float64), CFL, cap, compute_tau=True,
    )
    U, prec = jhm.prepare_state_vector(jnp.asarray(Ub.numpy()), 0.0)
    sU = jnp.stack([Ua, U])
    sP = jnp.stack([preca, prec])
    w = jnp.asarray(WEIGHTS)
    U_j, prec_j = st.nbr(U), st.nbr(prec)
    sU_j = jnp.stack([st.nbr(sU[s]) for s in range(2)])
    sP_j = jnp.stack([st.nbr(sP[s]) for s in range(2)])
    ip = jhm.initial_precomputed
    ip_j = jnp.zeros((0,) + st.mask.shape)

    # max(|c_ij|, |c_ji|) per slot, from the packed c_ij with numpy
    norm_c = np.linalg.norm(sd.cij, axis=-1).T.reshape((K,) + tuple(sd.shape))
    cmax = np.stack([
        np.maximum(norm_c[k], np.roll(norm_c[K - 1 - k],
                                      tuple(-o for o in off), axis=(0, 1)))
        for k, off in enumerate(map(tuple, sd.offsets))
    ]).reshape(K, -1)
    lam, alpha = jhyp.phase_e_alpha(jeq, p, st, U, prec, U_j, prec_j, half=True)
    lam_fixed = jhm._lambda_fixup(lam, U, prec)
    # the pre-scaled form the stream kernels carry, before and after the
    # JAX package's own prescaled fixup
    e = lam * cmax[:K2]
    e_fixed = jhm._lambda_fixup(e, U, prec, prescaled=True)
    d = jhyp.d_from_lambda(st, lam_fixed, st.mask)
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
        Ua=Ua, U=U, prec=prec, lam_fixed=lam_fixed, e=e, e_fixed=e_fixed,
        cmax=cmax, alpha=alpha, d=d, tau=tau, U_low=U_low, F=F,
        bounds=bounds, P=P, l=l, success=success, U4=U4, l4=l4, U5=U5,
    )
    return {k: np.asarray(v) for k, v in out.items()}


def assert_l_close(actual, expected, err_msg):
    """The limiter's l on live edges, under the edge-count rule: where psi
    is flat at roundoff near its root the accept test psi_r > 0 is decided
    by the last ulp of P, and such an edge moves by up to the Newton
    bracket width.  At most 0.1 % of the edges may leave the 5e-11 bar.
    Measured for PK3 at K = 24: 182 of 969,600 live edges (0.019 %), 16 of
    them by more than 5e-4, at most 2.88e-3 (all 16 on slot 11, the
    (0, -1) neighbour); the JAX limiter given the port's P (9.2e-15
    relative off its own) moves 181 of the same edges exactly as far
    (test_pk3_stream_P_l_success holds the port's l to it at 1e-4).  So a
    moved edge is capped at 5e-3, the cap chip_smoke.py applies."""
    far = ~np.isclose(actual, expected, rtol=5e-11, atol=1e-12)
    print(f"{err_msg}: {far.sum()} of {far.size} live edges off the 5e-11 "
          f"bar, at most {np.abs(actual - expected).max():.3e}")
    assert far.mean() <= 1e-3, f"{err_msg}: {far.sum()} edges differ"
    np.testing.assert_allclose(actual, expected, rtol=0, atol=5e-3,
                               err_msg=err_msg)


def _port():
    _, _, _, _, eq, params, _ = step_case(ANSATZ)
    _, hm = modules(ANSATZ)
    return eq, params, hm, hm.canvas.arrays


def _live():
    sd = step_case(ANSATZ)[0]
    return sd.mask.T > 0, sd.node_mask > 0


def test_canvas_is_reach_2_and_streams():
    """The fixture packs onto the reach-2 lattice, the stepper chooses the
    stream kernels, and the canvases' cmax equals the JAX package's."""
    ref = jax_substep()
    _, _, hm, ca = _port()
    assert ca.K == K and hm.canvas.stream
    assert max(abs(o) for off in ca.offsets for o in off) == 2
    np.testing.assert_array_equal(ca.g_cmax.reshape(K, -1).numpy(), ref["cmax"])
    assert hm._bp is not None and len(hm._bp["k"]) > 0


def test_pk1_stream_e_alpha_and_prescaled_fixup():
    """PK1's pre-scaled half-slot e = lambda * cmax and alpha, then e
    after the boundary-pair fixup in its prescaled form."""
    ref = jax_substep()
    eq, params, hm, ca = _port()
    U, prec = to_torch(ref["U"]), to_torch(ref["prec"])
    e, alpha = pk1_stream(eq, params, ca, U, prec)
    live, real = _live()
    assert e.shape[0] == K2
    assert_close(e.numpy()[live[:K2]], ref["e"][live[:K2]], "e")
    assert_close(alpha.numpy()[real], ref["alpha"][real], "alpha")
    e_fixed = hm._lambda_fixup(to_torch(ref["e"]), U, prescaled=True)
    assert_close(e_fixed.numpy()[live[:K2]], ref["e_fixed"][live[:K2]],
                 "e after the prescaled fixup")
    # ... which is the raw-lambda fixup times cmax
    assert_close(e_fixed.numpy()[live[:K2]],
                 (ref["lam_fixed"] * ref["cmax"][:K2])[live[:K2]],
                 "prescaled fixup vs raw fixup")
    moved = (ref["e_fixed"] != ref["e"])[live[:K2]].sum()
    assert moved > 0, "the fixup must act on the fixture"


def test_d_and_tau_from_prescaled_e():
    """d is the transposed read of e itself, and tau_max from it."""
    ref = jax_substep()
    _, _, _, ca = _port()
    st = ca.stencil
    d = thyp.d_from_lambda(st, to_torch(ref["e_fixed"]))
    assert_close(d, ref["d"], "d")
    cap = torch.tensor(float("inf"), dtype=torch.float64)
    assert_close(thyp.tau_max_from_d(st, d, CFL, cap), ref["tau"], "tau")


def test_pk2_stream_low_order_F_bounds():
    ref = jax_substep()
    eq, params, _, ca = _port()
    _, real = _live()
    t = {k: to_torch(ref[k]) for k in ("U", "prec", "e_fixed", "alpha", "Ua",
                                       "tau")}
    stage_U = torch.stack([t["Ua"], t["U"]])
    U_low, F, bounds = pk2_stream(
        eq, params, ca, t["U"], t["prec"], t["e_fixed"], t["alpha"], stage_U,
        WEIGHTS, t["tau"],
    )
    assert_close(U_low.numpy()[:, real], ref["U_low"][:, real], "U_low")
    assert_close(F.numpy()[:, real], ref["F"][:, real], "F")
    assert_close(bounds.numpy()[:, real], ref["bounds"][:, real], "bounds")


def test_pk3_stream_P_l_success():
    ref = jax_substep()
    eq, params, _, ca = _port()
    live, real = _live()
    t = {k: to_torch(ref[k]) for k in ("U", "e_fixed", "alpha", "F", "U_low",
                                       "bounds", "Ua", "tau")}
    stage_U = torch.stack([t["Ua"], t["U"]])
    P, l, okp = pk3_stream(
        eq, params, ca, t["U"], t["e_fixed"], t["alpha"], t["F"], t["U_low"],
        t["bounds"], stage_U, WEIGHTS, t["tau"],
    )
    assert_close(P.numpy()[:, live], ref["P"][:, live], "P")
    assert_l_close(l.numpy()[live], ref["l"][live], "l")
    assert 0.0 < ref["l"][live].min() < 1.0, "the limiter must work"
    # the edges that move are decided by the roundoff of P, not by the
    # port's limiter: the JAX limiter on the port's P agrees with the
    # port's l on every edge (measured: 10 edges differ, at most 4.2e-5)
    jeq = step_case(ANSATZ)[1]
    jp = jhyp.HyperbolicModuleParams()
    b_j = jnp.asarray(ref["bounds"])[:, None]
    Ul_j = jnp.asarray(ref["U_low"])[:, None]
    l_jax, _ = jeq.limiter_limit(
        b_j, Ul_j, jnp.asarray(P.numpy()),
        newton_iterations=jp.limiter_newton_max_iterations,
        newton_tol=jp.limiter_newton_tolerance,
        psi0=jeq.limiter_psi0(b_j, Ul_j),
    )
    np.testing.assert_allclose(l.numpy()[live], np.asarray(l_jax)[live],
                               rtol=0, atol=1e-4)
    # dead slots are written as zeros, so pk_up needs no guard
    assert not P.numpy()[:, ~live].any() and not l.numpy()[~live].any()
    ok_ref = np.all(ref["success"] | ~live, axis=0)[real]
    np.testing.assert_array_equal(okp.numpy()[real] > 0.5, ok_ref)


def test_pk_up_two_passes_at_K24():
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
