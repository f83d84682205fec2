"""The shared fixture of the PyTorch port's tests, and its own check.

The fixture is the Mach-3 forward-facing step at refinement 0 with the
uniform Mach-3 inflow times a smooth numpy-seeded density/energy bump, so
the Riemann solver, the indicator and both limiter branches do real work:
cG Q1 (104 x 256 canvas, 16,449 real nodes, K = 8) by default, cG Q2
(184 x 512 canvas, 65,153 real nodes, reach 2, K = 24) on request.  The
JAX package runs its CPU reference path (backend "xla", float64 from
tests/conftest.py) on a StructuredData built by ryujin_tpu.offline; the
port runs torch float64 on the CPU on one built by its own
ryujin_tpu_torch.offline.  Both take the same parameters and state.
"""

import functools

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
from ryujin_tpu.postprocess.error import (  # noqa: E402
    interpolate_nodal as j_interpolate_nodal,
)
from ryujin_tpu.solver.hyperbolic import (  # noqa: E402
    HyperbolicModule as JHyperbolicModule,
    HyperbolicModuleParams as JParams,
)

from ryujin_tpu_torch import convert  # noqa: E402
from ryujin_tpu_torch.offline import (  # noqa: E402
    assembly as t_assembly,
    geometry as t_geometry,
    structured as t_structured,
)
from ryujin_tpu_torch.equations.euler_initial_states import (  # noqa: E402
    make_initial_state,
)
from ryujin_tpu_torch.postprocess.error import interpolate_nodal  # noqa: E402
from ryujin_tpu_torch.solver.hyperbolic import HyperbolicModule  # noqa: E402

RTOL, ATOL = 5e-11, 1e-12  # tests/test_pallas_equations.py:28
INFLOW = (1.4, 3.0, 1.0)


@functools.lru_cache(maxsize=None)
def port_sd(ansatz="cG Q1"):
    """The fixture's StructuredData from the port's own offline layer."""
    mesh = t_geometry.step(refinement=0)
    return t_structured.pack_structured(
        t_assembly.assemble(mesh, ansatz=ansatz), mesh
    )


@functools.lru_cache(maxsize=None)
def step_case(ansatz="cG Q1"):
    """(sd, jax_eq, jax_init, U0 numpy [C, n_pad], torch eq, torch params,
    torch init) of the shared fixture; sd is the JAX package's."""
    mesh = geometry.step(refinement=0)
    sd = structured.pack_structured(
        assembly.assemble(mesh, ansatz=ansatz), mesh
    )
    jeq = JEuler(dim=2)
    jinit = j_make_initial_state(jeq, "uniform", primitive_state=INFLOW)
    U = np.array(j_interpolate_nodal(jinit, sd, jeq, 0.0, jnp.float64))
    rng = np.random.default_rng(1234)
    center = rng.uniform([0.8, 0.35], [1.4, 0.65])
    width = rng.uniform(6.0, 10.0)
    pos = sd.positions.T
    bump = 1.0 + 0.25 * np.exp(-width * np.sum((pos - center[:, None]) ** 2, 0))
    bump = np.where(sd.node_mask > 0, bump, 1.0)
    U[0] *= bump
    U[3] *= bump
    eq, params = convert.params_from_reference(jeq, JParams())
    init = make_initial_state(eq, "uniform", primitive_state=INFLOW)
    return sd, jeq, jinit, U, eq, params, init


@functools.lru_cache(maxsize=None)
def modules(ansatz="cG Q1"):
    """(JAX HyperbolicModule on the XLA path, torch HyperbolicModule on
    the port's own StructuredData, on the CPU)."""
    sd, jeq, jinit, _, eq, params, init = step_case(ansatz)
    jhm = JHyperbolicModule(jeq, sd, jinit, dtype=jnp.float64)
    hm = HyperbolicModule(eq, port_sd(ansatz), init, params=params,
                          dtype=torch.float64, device="cpu")
    return jhm, hm


def to_torch(x):
    return convert.state_from_reference(np.asarray(x), "cpu", torch.float64)


def assert_close(actual, expected, err_msg="", rtol=RTOL, atol=ATOL):
    if torch.is_tensor(actual):
        actual = actual.numpy()
    np.testing.assert_allclose(
        actual, np.asarray(expected), rtol=rtol, atol=atol, err_msg=err_msg
    )


def test_fixture_state_and_prepare_match():
    """interpolate_nodal, the uniform state and prepare_state_vector (the
    scatter route of the boundary conditions + precompute) agree."""
    sd, jeq, jinit, U, eq, _, init = step_case()
    jhm, hm = modules()
    assert jhm._bc_dense is None, "the JAX side must take the scatter route"
    assert_close(
        interpolate_nodal(init, sd, eq, 0.0, torch.float64, "cpu"),
        j_interpolate_nodal(jinit, sd, jeq, 0.0, jnp.float64),
        "interpolate_nodal",
    )
    Up_j, prec_j = jhm.prepare_state_vector(jnp.asarray(U), 0.0)
    Up, prec = hm.prepare_state_vector(to_torch(U), 0.0)
    assert_close(Up, Up_j, "U after boundary conditions")
    assert_close(prec, prec_j, "precomputed [s, eta]")
