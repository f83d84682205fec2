"""The Euler equations of the PyTorch port against the JAX package on
random admissible states from a numpy seed: the Riemann solver, the
indicator, the limiter bounds, the limiter (both Newton branches) and the
boundary conditions.  float64, relative 5e-11 / absolute 1e-12."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from ryujin_tpu.equations.euler import Euler as JEuler  # noqa: E402
from ryujin_tpu.offline.mesh import Boundary  # noqa: E402

from ryujin_tpu_torch import convert  # noqa: E402
from ryujin_tpu_torch.solver.hyperbolic import HyperbolicModuleParams  # noqa: E402

from test_torch_fixture import assert_close  # noqa: E402

JEQ = JEuler(dim=2)
EQ, _ = convert.params_from_reference(JEQ, HyperbolicModuleParams())
M, K = 400, 8


def states(rng, shape):
    """Random admissible conserved states [4, *shape]."""
    rho = rng.uniform(0.3, 3.0, shape)
    v = rng.uniform(-3.0, 3.0, (2,) + shape)
    p = rng.uniform(0.1, 5.0, shape)
    E = p / 0.4 + 0.5 * rho * np.sum(v * v, 0)
    return np.concatenate([rho[None], rho[None] * v, E[None]], 0)


def both(x):
    return jnp.asarray(x), torch.tensor(x)


def test_riemann_lambda_max():
    rng = np.random.default_rng(0)
    Ui, Uj = states(rng, (M,)), states(rng, (M,))
    n = rng.normal(size=(2, M))
    n /= np.linalg.norm(n, axis=0)
    (ji, ti), (jj, tj), (jn, tn) = both(Ui), both(Uj), both(n)
    ref = JEQ.riemann_lambda_max(
        ji, jj, jn, pa_i=JEQ.riemann_precompute(ji),
        pa_j=JEQ.riemann_precompute(jj),
    )
    got = EQ.riemann_lambda_max(
        ti, tj, tn, pa_i=EQ.riemann_precompute(ti),
        pa_j=EQ.riemann_precompute(tj),
    )
    assert_close(got, ref, "lambda_max")
    # the symmetry the half-slot evaluation rests on (exact in exact
    # arithmetic; the rarefaction ratio rounds differently per direction)
    swapped = EQ.riemann_lambda_max(
        tj, ti, -tn, pa_i=EQ.riemann_precompute(tj),
        pa_j=EQ.riemann_precompute(ti),
    )
    assert_close(swapped, got.numpy(), "lambda_max(U_j, U_i, -n)")


def _stencil(rng):
    Ui = states(rng, (M,))
    # neighbours near U_i, so the indicator and bounds are not degenerate
    Uj = Ui[:, None] * rng.uniform(0.8, 1.25, (1, K, M))
    c = rng.normal(size=(2, K, M))
    mask = (rng.uniform(size=(K, M)) < 0.8).astype(float)
    hd = rng.uniform(1e-6, 1e-2, M)
    return Ui, Uj, c, mask, hd


def test_indicator_alpha_and_limiter_bounds():
    rng = np.random.default_rng(1)
    Ui, Uj, c, mask, hd = _stencil(rng)
    d = rng.uniform(0.1, 2.0, (K, M))
    J = {k: jnp.asarray(v) for k, v in dict(Ui=Ui, Uj=Uj, c=c, mask=mask,
                                              hd=hd, d=d).items()}
    T = {k: torch.tensor(np.asarray(v)) for k, v in J.items()}
    jp_i, jp_j = JEQ.precompute(J["Ui"], None), JEQ.precompute(J["Uj"], None)
    tp_i, tp_j = EQ.precompute(T["Ui"]), EQ.precompute(T["Uj"])
    assert_close(tp_j, jp_j, "precompute")
    ref = JEQ.indicator_alpha(J["Ui"], jp_i, J["Uj"], jp_j, J["c"],
                              J["mask"], J["hd"])
    got = EQ.indicator_alpha(T["Ui"], tp_i, T["Uj"], tp_j, T["c"],
                             T["mask"], T["hd"])
    assert_close(got, ref, "alpha")
    ref = JEQ.limiter_bounds(J["Ui"], jp_i, J["Uj"], jp_j,
                             J["c"] / J["d"][None], J["mask"], J["hd"])
    got = EQ.limiter_bounds(T["Ui"], tp_i, T["Uj"], tp_j,
                            T["c"] / T["d"][None], T["mask"], T["hd"])
    assert_close(got, ref, "bounds")


@pytest.mark.parametrize("scale", [1e-3, 3.0], ids=["skip_newton", "newton"])
def test_limiter_limit(scale):
    """Small updates leave psi(t_r) > 0 on every lane, so the JAX limiter
    takes its all-lanes early exit; large ones run the quadratic Newton.
    The port runs the Newton loop per lane in both cases."""
    rng = np.random.default_rng(2)
    Ui, Uj, c, mask, hd = _stencil(rng)
    jp_i, jp_j = JEQ.precompute(jnp.asarray(Ui), None), JEQ.precompute(
        jnp.asarray(Uj), None)
    bounds = np.asarray(JEQ.limiter_bounds(
        jnp.asarray(Ui), jp_i, jnp.asarray(Uj), jp_j, jnp.asarray(c),
        jnp.asarray(mask), jnp.asarray(hd),
    ))
    P = scale * (states(rng, (K, M)) - Ui[:, None])
    (jb, tb), (ju, tu), (jP, tP) = both(bounds[:, None]), both(Ui[:, None]), both(P)
    l_ref, s_ref = JEQ.limiter_limit(jb, ju, jP,
                                     psi0=JEQ.limiter_psi0(jb, ju))
    l, s = EQ.limiter_limit(tb, tu, tP, EQ.limiter_psi0(tb, tu))
    l_ref = np.asarray(l_ref)
    assert_close(l, l_ref, "l")
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))
    psi_r = EQ.limiter_psi0(tb, tu + torch.tensor(l_ref) * tP)[3]
    if scale < 1:
        assert (l_ref == 1.0).all() and bool((psi_r > 0).all())
    else:
        assert (l_ref < 1.0).mean() > 0.2 and (l_ref == 1.0).any()


def test_apply_boundary_conditions():
    rng = np.random.default_rng(3)
    U = states(rng, (M,))
    n = rng.normal(size=(2, M))
    n /= np.linalg.norm(n, axis=0)
    dirichlet = states(rng, (M,))
    for bc in (Boundary.do_nothing, Boundary.slip, Boundary.no_slip,
               Boundary.dirichlet):
        ref = JEQ.apply_boundary_conditions(
            bc, jnp.asarray(U), jnp.asarray(n), jnp.asarray(dirichlet)
        )
        got = EQ.apply_boundary_conditions(
            bc, torch.as_tensor(U), torch.as_tensor(n),
            torch.as_tensor(dirichlet),
        )
        assert_close(got, ref, f"boundary id {bc}")
    with pytest.raises(NotImplementedError):
        EQ.apply_boundary_conditions(Boundary.dynamic, torch.as_tensor(U),
                                     torch.as_tensor(n), None)
