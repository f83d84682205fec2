"""The port's padded-ELL host layer against the JAX package's, bit for
bit: ell.pack (with its RCM locality order and the transposed-edge map)
on 1D, 2D cG Q1, 2D dG Q1 and 3D meshes and on the Mach-3 step at
refinement 0, read_msh on gmsh v2 and v4 files written to tmp_path, the
airfoil generator at refinement 0 (2D and its 3D extrusion), the numpy
cubic spline, the ELL device stencil against _stencil_from_ell, and the
1D initial states (galilei_wrap in dim 1)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from ryujin_tpu.equations.euler import Euler as JEuler  # noqa: E402
from ryujin_tpu.equations import euler_initial_states as jeis  # noqa: E402
from ryujin_tpu.offline import (  # noqa: E402
    assembly as j_assembly, ell as j_ell, geometry as j_geometry,
    reader as j_reader,
)
from ryujin_tpu.solver.hyperbolic import _stencil_from_ell  # noqa: E402
from ryujin_tpu.utils import cubic_spline as j_spline  # noqa: E402

from ryujin_tpu_torch.equations.euler import Euler  # noqa: E402
from ryujin_tpu_torch.equations import euler_initial_states as eis  # noqa: E402
from ryujin_tpu_torch.offline import (  # noqa: E402
    assembly, ell, geometry, reader,
)
from ryujin_tpu_torch.offline.mesh import Boundary  # noqa: E402
from ryujin_tpu_torch.solver.stencil import stencil_from_ell  # noqa: E402
from ryujin_tpu_torch.utils import cubic_spline  # noqa: E402

from test_geometry import MSH41  # noqa: E402
from test_torch_initial_states import CASES as STATE_CASES  # noqa: E402

D = [Boundary.dirichlet]

# name -> (builder taking a geometry module, ansatz)
MESHES = {
    "1D": (lambda g: g.rectangular_domain(
        [0.0], [1.0], [25], refinement=2, boundary_conditions=D * 2, dim=1),
        "cG Q1"),
    "2D cG Q1": (lambda g: g.rectangular_domain(
        [-5.0, -5.0], [5.0, 5.0], [3, 2], refinement=1,
        boundary_conditions=D * 4), "cG Q1"),
    "2D dG Q1": (lambda g: g.rectangular_domain(
        [-5.0, -5.0], [5.0, 5.0], [3, 2], refinement=1,
        boundary_conditions=D * 4), "dG Q1"),
    "3D": (lambda g: g.rectangular_domain(
        [0.0, 0.0, 0.0], [3.0, 1.0, 1.0], [3, 2, 2], refinement=0,
        boundary_conditions=[Boundary.dirichlet, Boundary.do_nothing]
        + [Boundary.slip] * 4, dim=3), "cG Q1"),
    "step": (lambda g: g.step(refinement=0), "cG Q1"),
}


def assert_same(a, b, where=""):
    """Every dataclass field of a equals b's: arrays bit for bit with their
    dtype, boundary rounds group by group, dicts of callables by their keys,
    nested dataclasses field by field, the rest by ==."""
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        msg = f"{where}{f.name}"
        if isinstance(y, np.ndarray):
            assert isinstance(x, np.ndarray) and x.dtype == y.dtype, msg
            np.testing.assert_array_equal(x, y, err_msg=msg)
        elif f.name == "boundary_rounds":
            assert len(x) == len(y), msg
            for rx, ry in zip(x, y):
                assert sorted(rx) == sorted(ry), msg
                for bc in ry:
                    assert_same(rx[bc], ry[bc], f"{msg}[{int(bc)}].")
        elif isinstance(y, dict):
            assert sorted(x) == sorted(y), msg
        elif dataclasses.is_dataclass(y):
            assert_same(x, y, f"{msg}.")
        else:
            assert x == y, msg


@pytest.mark.parametrize("name", sorted(MESHES))
def test_pack_equals_jax(name):
    """ell.pack of the port's assembly equals the JAX package's pack of
    its own, array for array: cols, c_ij, m_ij, the mask, trans, the dG
    incidence, the node arrays, the vertex maps and the boundary rounds."""
    build, ansatz = MESHES[name]
    got = ell.pack(assembly.assemble(build(geometry), ansatz=ansatz))
    want = j_ell.pack(j_assembly.assemble(build(j_geometry), ansatz=ansatz))
    assert_same(got, want)
    assert (want.incidence is not None) == ansatz.startswith("dG")
    assert want.max_degree == {"1D": 2, "3D": 26}.get(name, want.max_degree)


@pytest.mark.parametrize("name", ["1D", "2D dG Q1"])
def test_stencil_equals_jax_stencil(name):
    """stencil_from_ell lays the arrays out as _stencil_from_ell does: the
    node axis last, trans flattened over [K, n]; nbr and transpose_edge
    gather what the JAX Stencil gathers."""
    build, ansatz = MESHES[name]
    packed = j_ell.pack(j_assembly.assemble(build(j_geometry), ansatz=ansatz))
    st = stencil_from_ell(packed, torch.float64, "cpu")
    ref = _stencil_from_ell(packed, jnp.float64)
    for field in ("cols", "trans", "cij", "mij", "mask", "cii", "m_lumped",
                  "m_lumped_inv", "n_nbrs", "node_mask", "incidence"):
        a, b = getattr(st, field), getattr(ref, field)
        if b is None:
            assert a is None, field
            continue
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=field)
    assert st.cols.dtype == st.trans.dtype == torch.int64
    assert st.measure_inv == float(ref.measure_inv)
    X = np.random.default_rng(5).standard_normal((3, st.n))
    E = np.random.default_rng(6).standard_normal((2, st.K, st.n))
    np.testing.assert_array_equal(st.nbr(torch.as_tensor(X)).numpy(),
                                  np.asarray(ref.nbr(jnp.asarray(X))))
    np.testing.assert_array_equal(
        st.transpose_edge(torch.as_tensor(E)).numpy(),
        np.asarray(ref.transpose_edge(jnp.asarray(E))))


def _msh22(vertices, cells, lines):
    """A gmsh v2.2 ASCII file of quads `cells` and boundary `lines` (each
    with its physical tag)."""
    out = ["$MeshFormat", "2.2 0 8", "$EndMeshFormat", "$Nodes",
           str(len(vertices))]
    out += [f"{i + 1} {x} {y} 0" for i, (x, y) in enumerate(vertices)]
    out += ["$EndNodes", "$Elements", str(len(lines) + len(cells))]
    k = 0
    for (a, b), tag in lines:
        k += 1
        out.append(f"{k} 1 2 {tag} {tag} {a + 1} {b + 1}")
    for c in cells:
        k += 1
        out.append(f"{k} 3 2 0 1 " + " ".join(str(v + 1) for v in c))
    out.append("$EndElements")
    return "\n".join(out) + "\n"


def test_read_msh_v2_and_v4(tmp_path):
    """read_msh gives the JAX package's mesh on a gmsh v2.2 file of a 3 x 2
    quad patch with three physical boundary tags (gmsh's counter-clockwise
    node order) and on the v4.1 unit square of tests/test_geometry.py."""
    xs, ys = np.meshgrid(np.arange(4.0), np.arange(3.0) * 0.5)
    verts = np.stack([xs.ravel(), ys.ravel()], 1)
    vid = np.arange(12).reshape(3, 4)
    cells = [(vid[j, i], vid[j, i + 1], vid[j + 1, i + 1], vid[j + 1, i])
             for j in range(2) for i in range(3)]
    ring = ([(vid[0, i], vid[0, i + 1]) for i in range(3)]
            + [(vid[j, 3], vid[j + 1, 3]) for j in range(2)]
            + [(vid[2, i + 1], vid[2, i]) for i in range(3)]
            + [(vid[j + 1, 0], vid[j, 0]) for j in range(2)])
    tags = [1, 1, 1, 2, 2, 3, 3, 3, 1, 1]
    files = {"v2.msh": _msh22(verts, cells, list(zip(ring, tags))),
             "v4.msh": MSH41}
    for name, text in files.items():
        path = tmp_path / name
        path.write_text(text)
        got, want = reader.read_msh(str(path)), j_reader.read_msh(str(path))
        assert_same(got, want, f"{name}: ")
        assert got.n_cells == (6 if name == "v2.msh" else 1)


@pytest.mark.parametrize("kw", [{}, {"airfoil_type": "NACA 4412"},
                                {"dim": 3}])
def test_airfoil_equals_jax(kw):
    """geometry.airfoil at refinement 0: the mesh the JAX package builds
    (the tabulated NASA SC(2)-0714, a generated NACA profile, and the 3D
    extrusion), and its ELL packing (irregular rows: K is the largest)."""
    got = geometry.airfoil(refinement=0, **kw)
    want = j_geometry.airfoil(refinement=0, **kw)
    assert_same(got, want)
    if not kw:
        packed = ell.pack(assembly.assemble(got))
        ref = j_ell.pack(j_assembly.assemble(want))
        assert_same(packed, ref)
        deg = packed.mask[: packed.n_nodes].sum(1)
        assert deg.min() < deg.max() == packed.max_degree


def test_cubic_spline_equals_jax():
    """The numpy-only spline evaluates and differentiates as the JAX
    package's does on numpy input (clamped outside the data)."""
    x = np.linspace(0.0, 1.0, 11) ** 1.5
    y = np.cos(4.0 * x)
    q = np.random.default_rng(7).uniform(-0.2, 1.2, 301)
    a, b = cubic_spline.CubicSpline(x, y), j_spline.CubicSpline(x, y)
    np.testing.assert_array_equal(a(q), b(q))
    np.testing.assert_array_equal(a.derivative(q), b.derivative(q))


def _one_d(kw):
    """A CASES keyword set for 1D: primitive states (rho, v_1, v_2, p)
    become (rho, v_1, p)."""
    return {k: (v[0], v[1], v[3]) if k.startswith("primitive") and len(v) == 4
            else v for k, v in kw.items()}


@pytest.mark.parametrize("name,kw", STATE_CASES,
                         ids=[c[0] for c in STATE_CASES])
def test_initial_states_in_1d(name, kw):
    """Every state of the library in 1D, Galilei-shifted by a position:
    equal to the JAX package's within 1e-13 of each component's scale, or
    refused as it refuses it (the vortex and the four-state contrast need
    2D; `function` here reads only x and t)."""
    kw = _one_d(kw)
    if name == "function":
        kw = {"density_expression": "1 + 0.2*sin(x)*exp(-t)",
              "pressure_expression": "2 + where(x > 0, 0.5, 0.0)"}
    pts = np.random.default_rng(11).uniform(-2.0, 2.0, (1, 101))
    pts[0, 0] = 0.3
    kwargs = dict(direction=[1.0], position=[0.3], **kw)
    try:
        want = np.asarray(jeis.make_initial_state(JEuler(dim=1), name, **kwargs)(
            jnp.asarray(pts), 0.3))
    except ValueError as exc:
        with pytest.raises(ValueError, match=str(exc)):
            eis.make_initial_state(Euler(dim=1), name, **kwargs)
        return
    got = eis.make_initial_state(Euler(dim=1), name, **kwargs)(
        torch.as_tensor(pts), 0.3).numpy()
    assert got.shape == want.shape == (3, 101)
    for c in range(3):
        scale = max(np.abs(want[c]).max(), 1e-300)
        np.testing.assert_allclose(got[c], want[c], rtol=1e-13,
                                   atol=1e-13 * scale, err_msg=f"{c}")
    assert Euler(dim=1).component_names == JEuler(dim=1).component_names


@pytest.mark.parametrize("name", ["1D", "2D dG Q1"])
def test_compute_error_on_ell_equals_jax(name):
    """interpolate_nodal and compute_error on an ELL packing (1D rho, m, E;
    dG Q1 in 2D): the state interpolated at t = 0 against the analytic one
    at t = 0.05, equal to the JAX package's norms to 1e-12."""
    from ryujin_tpu.postprocess.error import (
        compute_error as j_compute_error, interpolate_nodal as j_interpolate,
    )
    from ryujin_tpu_torch.postprocess.error import (
        compute_error, interpolate_nodal,
    )

    build, ansatz = MESHES[name]
    dim = 1 if name == "1D" else 2
    kw = (dict(direction=[1.0], position=[0.3]) if dim == 1
          else dict(direction=[1.0, 1.0], position=[-1.0, -1.0],
                    mach_number=1.0, beta=5.0))
    state = "smooth wave" if dim == 1 else "isentropic vortex"
    if dim == 1:
        kw.update(x0=0.1, x1=0.6)
    mesh = build(geometry)
    packed = ell.pack(assembly.assemble(mesh, ansatz=ansatz))
    jmesh = build(j_geometry)
    jpacked = j_ell.pack(j_assembly.assemble(jmesh, ansatz=ansatz))
    init = eis.make_initial_state(Euler(dim=dim), state, **kw)
    jinit = jeis.make_initial_state(JEuler(dim=dim), state, **kw)
    U = interpolate_nodal(init, packed, Euler(dim=dim), 0.0, torch.float64,
                          "cpu")
    jU = j_interpolate(jinit, jpacked, JEuler(dim=dim), 0.0, jnp.float64)
    np.testing.assert_allclose(U.numpy(), np.asarray(jU), rtol=1e-13,
                               atol=1e-14)
    got = compute_error(Euler(dim=dim), mesh, packed, U, 0.05, init)
    want = j_compute_error(JEuler(dim=dim), jmesh, jpacked, np.asarray(jU),
                           0.05, jinit)
    assert min(want) > 0.0
    np.testing.assert_allclose(got, want, rtol=1e-12)
