"""The port's Euler initial state library and error norms against the JAX
package's, float64 on the CPU: every LIBRARY entry in 2D and 3D at seeded
numpy points and t = 0 and 0.3 (relative 1e-13 of each component's
scale), with t also as a 0-d tensor; the Galilei wrap along (1, 1) and
(1, 2, 2); `function` with an expression of sin, exp, where, x, y and t;
and compute_error on the same state, on a cG Q1 vortex canvas and on the
cG Q2 and dG Q1 canvases of the step (relative 1e-12)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from ryujin_tpu.equations.euler import Euler as JEuler  # noqa: E402
from ryujin_tpu.equations import euler_initial_states as jeis  # noqa: E402
from ryujin_tpu.offline import assembly, geometry, structured  # noqa: E402
from ryujin_tpu.offline.mesh import Boundary  # noqa: E402
from ryujin_tpu.postprocess.error import (  # noqa: E402
    compute_error as j_compute_error,
)

from ryujin_tpu_torch.equations.euler import Euler  # noqa: E402
from ryujin_tpu_torch.equations import euler_initial_states as eis  # noqa: E402
from ryujin_tpu_torch.offline import geometry as t_geometry  # noqa: E402
from ryujin_tpu_torch.postprocess.error import compute_error  # noqa: E402
from ryujin_tpu_torch.vortex import build_vortex  # noqa: E402

from test_torch_fixture import port_sd  # noqa: E402

RTOL_STATE = 1e-13
RTOL_NORM = 1e-12

# (name, keyword arguments) with states that differ across their jumps
CASES = [
    ("isentropic vortex", {}),
    ("becker solution", {}),
    ("uniform", {}),
    ("contrast", {"primitive_right": (0.125, 0.5, 0.1)}),
    ("shock front", {}),
    ("leblanc", {}),
    ("smooth wave", {"x0": -0.5, "x1": 1.5}),
    ("ramp up", {}),
    ("rarefaction", {}),
    ("noh", {}),
    ("radial contrast", {"primitive_inner": (2.0, 0.3, 3.0), "radius": 1.0}),
    ("three state contrast", {"left_region_length": -1.0,
                              "middle_region_length": 1.5}),
    ("four state contrast", {"primitive_top_right": (0.5, 0.2, 0.1, 0.4),
                             "primitive_bottom_left": (1.1, 0.0, 0.3, 2.0)}),
    ("astro jet", {"jet_width": 1.0}),
    ("icf like", {}),
    ("function", {"density_expression": "1 + 0.2*sin(x)*exp(-t)",
                  "pressure_expression": "2 + where(y > 0, 0.5, 0.0)"}),
]
assert sorted(name for name, _ in CASES) == sorted(eis.LIBRARY)
assert sorted(eis.LIBRARY) == sorted(jeis.LIBRARY)


def points(dim, n=257):
    """Seeded points in [-2, 2]^dim, with x = 0 among them (jumps at 0)."""
    pts = np.random.default_rng(17 + dim).uniform(-2.0, 2.0, (dim, n))
    pts[:, 0] = 0.0
    return pts


def assert_states_close(got, want, msg):
    """Each component within RTOL_STATE of its largest magnitude."""
    want = np.asarray(want)
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == want.shape, msg
    for c in range(want.shape[0]):
        scale = max(np.abs(want[c]).max(), 1e-300)
        np.testing.assert_allclose(got[c], want[c], rtol=RTOL_STATE,
                                   atol=RTOL_STATE * scale,
                                   err_msg=f"{msg}, component {c}")


def in_dim(name, kw, dim):
    """kw for `dim`: the four quadrant states of "four state contrast" are
    [rho, v_1, v_2, p] by default, so in 3D they get a zero v_3."""
    if name != "four state contrast" or dim == 2:
        return kw
    kw = {f"primitive_{q}": (1.4, 0.0, 0.0, 1.0)
          for q in ("bottom_left", "bottom_right", "top_left", "top_right")
          } | kw
    return {k: v[:3] + (0.0,) + v[3:] for k, v in kw.items()}


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("name,kw", CASES, ids=[c[0] for c in CASES])
def test_library_state_matches_jax(name, kw, dim):
    pts = points(dim)
    kw = in_dim(name, kw, dim)
    fn = eis.make_initial_state(Euler(dim=dim), name, **kw)
    jfn = jeis.make_initial_state(JEuler(dim=dim), name, **kw)
    for t in (0.0, 0.3):
        want = jfn(jnp.asarray(pts), t)
        got = fn(torch.from_numpy(pts), t)
        assert got.dtype == torch.float64
        assert_states_close(got, want, f"{name}, {dim}D, t = {t}")
        # the module's Dirichlet data comes at the device time: a 0-d
        # tensor gives the same state
        got_t = fn(torch.from_numpy(pts), torch.tensor(t, dtype=torch.float64))
        assert torch.equal(got_t, got), f"{name}, {dim}D, tensor t = {t}"


@pytest.mark.parametrize("dim,direction,position", [
    (2, (1.0, 1.0), (-1.0, 0.5)),
    (3, (1.0, 2.0, 2.0), (0.3, -0.2, 0.1)),
])
def test_galilei_wrap_matches_jax(dim, direction, position):
    """A rotated, shifted vortex and a rotated moving uniform state."""
    pts = points(dim)
    for name, kw in (("isentropic vortex", {"mach_number": 1.0}),
                     ("uniform", {"primitive_state": (1.4, 3.0, 1.0)})):
        fn = eis.make_initial_state(Euler(dim=dim), name, direction=direction,
                                    position=position, **kw)
        jfn = jeis.make_initial_state(JEuler(dim=dim), name,
                                      direction=direction,
                                      position=position, **kw)
        assert_states_close(fn(torch.from_numpy(pts), 0.3),
                            jfn(jnp.asarray(pts), 0.3), f"{name}, {dim}D")


def test_function_expression_matches_jax():
    """sin, exp, where (with number branches), x, y, t and the np / jnp
    names of the functions in one expression."""
    kw = {"density_expression": "1.2 + 0.3*sin(x - t)*exp(-y*y)",
          "velocity_x_expression": "where(x > 0.5, 0.2*t, np.cos(y))",
          "velocity_y_expression": "jnp.power(abs(x), 0.5) - 1",
          "pressure_expression": "1 + 0.1*exp(t)*where(y < 0, 1.0, x*x)"}
    pts = points(2)
    fn = eis.make_initial_state(Euler(dim=2), "function", **kw)
    jfn = jeis.make_initial_state(JEuler(dim=2), "function", **kw)
    for t in (0.0, 0.3):
        assert_states_close(fn(torch.from_numpy(pts), t),
                            jfn(jnp.asarray(pts), t), f"function, t = {t}")


def test_to_primitive_state_matches_jax():
    pts = points(2)
    U = jeis.make_initial_state(JEuler(dim=2), "isentropic vortex")(
        jnp.asarray(pts), 0.0)
    got = Euler(dim=2).to_primitive_state(torch.from_numpy(np.array(U)))
    assert_states_close(got, JEuler(dim=2).to_primitive_state(U),
                        "primitive state")


def _vortex_meshes(refinement):
    """(JAX mesh, JAX canvas, port mesh, port canvas) of the vortex."""
    jmesh = geometry.rectangular_domain(
        [-5, -5], [5, 5], [1, 1], refinement=refinement,
        boundary_conditions=[Boundary.dirichlet] * 4)
    jsd = structured.pack_structured(assembly.assemble(jmesh), jmesh,
                                     pad_minor=16)
    _, mesh, sd, _, _ = build_vortex(refinement, torch.float64, "cpu")
    return jmesh, jsd, mesh, sd


def _step_meshes(ansatz):
    """The same for the step at refinement 0 with `ansatz`."""
    jmesh = geometry.step(refinement=0)
    jsd = structured.pack_structured(assembly.assemble(jmesh, ansatz=ansatz),
                                     jmesh)
    return jmesh, jsd, t_geometry.step(refinement=0), port_sd(ansatz)


@pytest.mark.parametrize("canvas", ["vortex cG Q1", "step cG Q2",
                                    "step dG Q1"])
def test_compute_error_matches_jax(canvas):
    """The same noisy vortex state on the JAX package's canvas and the
    port's, against the vortex at t = 0.3: each norm, normalized or not,
    over all components and over rho and E."""
    if canvas.startswith("vortex"):
        jmesh, jsd, mesh, sd = _vortex_meshes(3)
        where = {}
    else:
        jmesh, jsd, mesh, sd = _step_meshes(canvas.split(" ", 1)[1])
        where = {"position": (1.0, 0.5)}
    assert sd.ansatz == jsd.ansatz and sd.shape == jsd.shape
    init = eis.make_initial_state(Euler(dim=2), "isentropic vortex",
                                  direction=(1, 1), **where)
    jinit = jeis.make_initial_state(JEuler(dim=2), "isentropic vortex",
                                    direction=(1, 1), **where)
    U = np.asarray(jinit(jnp.asarray(jsd.positions.T), 0.0))
    U = U * (1.0 + 0.01 * np.random.default_rng(5).standard_normal(U.shape))
    for components in (None, ["rho", "E"]):
        for normalize in (True, False):
            want = j_compute_error(JEuler(dim=2), jmesh, jsd, U, 0.3, jinit,
                                   components=components, normalize=normalize)
            got = compute_error(Euler(dim=2), mesh, sd, torch.from_numpy(U),
                                0.3, init, components=components,
                                normalize=normalize)
            np.testing.assert_allclose(
                got, want, rtol=RTOL_NORM, atol=0.0,
                err_msg=f"{canvas}, {components}, normalize {normalize}")
