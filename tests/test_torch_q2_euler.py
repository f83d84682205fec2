"""The slot-streaming forms of the port's Euler equations against the JAX
package's (ryujin_tpu/equations/euler.py:473-505 and :583-647) on random
admissible states from a numpy seed, K = 24 slots: one offset at a time,
the running sums and running min/max, and the finalized alpha and
bounds; and each streaming form against the port's own stacked form.
float64, relative 5e-11 / absolute 1e-12."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from test_torch_euler import EQ, JEQ, states  # noqa: E402
from test_torch_fixture import assert_close  # noqa: E402

M, K = 300, 24


def _stencil(rng):
    Ui = states(rng, (M,))
    Uj = Ui[:, None] * rng.uniform(0.8, 1.25, (1, K, M))
    c = rng.normal(size=(2, K, M))
    mask = (rng.uniform(size=(K, M)) < 0.8).astype(float)
    hd = rng.uniform(1e-6, 1e-2, M)
    d = rng.uniform(0.1, 2.0, (K, M))
    x = dict(Ui=Ui, Uj=Uj, c=c, mask=mask, hd=hd, d=d)
    return ({k: jnp.asarray(v) for k, v in x.items()},
            {k: torch.tensor(v) for k, v in x.items()})


def _prec(eq, U):
    return eq.precompute(U, None) if eq is JEQ else eq.precompute(U)


def test_indicator_stream_forms():
    J, T = _stencil(np.random.default_rng(11))
    out = []
    for eq, X, xp in ((JEQ, J, jnp), (EQ, T, torch)):
        prec_i, prec_j = _prec(eq, X["Ui"]), _prec(eq, X["Uj"])
        f_j = eq.f(X["Uj"])
        ind = eq.indicator_init(X["Ui"], prec_i)
        left = right = None
        steps = []
        for k in range(K):
            li, ri = eq.indicator_accum(
                ind, X["Uj"][:, k], prec_j[:, k], f_j[:, :, k], X["c"][:, k],
                X["mask"][k],
            )
            left = li if left is None else left + li
            right = ri if right is None else right + ri
            steps.append((li, ri))
        alpha = eq.indicator_finalize(ind, left, right, X["hd"], 0.7)
        stacked = eq.indicator_alpha(
            X["Ui"], prec_i, X["Uj"], prec_j, X["c"], X["mask"], X["hd"],
            evc_factor=0.7,
        )
        out.append((steps, left, right, alpha, stacked))
    (j_steps, j_left, j_right, j_alpha, _), (steps, left, right, alpha,
                                             stacked) = out
    for k in (0, K // 2, K - 1):
        assert_close(steps[k][0], j_steps[k][0], f"left increment {k}")
        assert_close(steps[k][1], j_steps[k][1], f"right increment {k}")
    assert_close(left, j_left, "left")
    assert_close(right, j_right, "right")
    assert_close(alpha, j_alpha, "alpha")
    assert 0.0 < float(alpha.min()) and float(alpha.max()) <= 1.0
    # alpha is a ratio of cancelling sums: the stacked form sums in
    # another order, so it agrees to the conditioning of that ratio
    assert_close(alpha, stacked.numpy(), "stream vs stacked", rtol=1e-9)


def test_limiter_bounds_stream_forms():
    J, T = _stencil(np.random.default_rng(12))
    out = []
    for eq, X, xp in ((JEQ, J, jnp), (EQ, T, torch)):
        prec_i, prec_j = _prec(eq, X["Ui"]), _prec(eq, X["Uj"])
        scaled = X["c"] / X["d"][None]
        st = eq.limiter_bounds_init(X["Ui"], prec_i)
        for k in range(K):
            st = eq.limiter_bounds_accum(
                st, X["Uj"][:, k], prec_j[:, k], scaled[:, k], X["mask"][k]
            )
        bounds = eq.limiter_bounds_finalize(st, X["hd"], 0.9)
        stacked = eq.limiter_bounds(
            X["Ui"], prec_i, X["Uj"], prec_j, scaled, X["mask"], X["hd"],
            relaxation_factor=0.9,
        )
        out.append((st, bounds, stacked))
    (j_st, j_bounds, _), (st, bounds, stacked) = out
    for key in ("rho_min", "rho_max", "s_min", "s_interp_max",
                "rho_relax_num", "k_count"):
        assert_close(st[key], j_st[key], key)
    assert_close(bounds, j_bounds, "bounds")
    assert bool((bounds[0] < bounds[1]).all())
    assert_close(bounds, stacked.numpy(), "stream vs stacked")
