"""The port's 2D multi-block canvas (offline/multiblock.py, the refresh maps
of solver/stencil.py, the side rows of solver/sideband.py) against the
JAX package and against the port's own padded-ELL path, float64 on the
CPU.

Meshes: the annulus at refinement 0, the disk at 1, the cylinder `blocks`
variant at 1 (six valence-6 block corners: side rows of 12 slots) and
the locally refined square of tests/test_multiblock.py:228-239 (refinement
4, refined where |x|, |y| < 2: the coarse and fine rows of the 2:1
interface are side rows, some of them transposed side-internally), each
packed with pad_minor = pad_major = 8.  The packing equals the JAX
package's, every field; a refresh leaves every ghost cell equal to its
owner and every ghost slot equal to its permuted source, as the JAX
package's refresh does; three ERK33 steps of the multi-block canvas equal
three on ELL within the JAX package's own bars (tests/test_multiblock.py:
54-79, 242-276: U within 1e-12, tau within 1e-14 relative) on each
Riemann route and through the plain path and the kernels' orchestration
(CanvasStepper on CPU tensors, each wrapper taking its plain twin); and
the AMR square's trajectory equals the JAX package's XLA path within the
repo's f64 bar across backends (tests/test_pallas_equations.py:28).
"""

import dataclasses
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
from ryujin_tpu.offline import (  # noqa: E402
    assembly as j_assembly, geometry as j_geometry,
    multiblock as j_multiblock,
)
from ryujin_tpu.offline.mesh import (  # noqa: E402
    Boundary as JBoundary, Mesh as JMesh, refine_local as j_refine_local,
)
from ryujin_tpu.postprocess.error import (  # noqa: E402
    interpolate_nodal as j_interpolate_nodal,
)
from ryujin_tpu.solver import hyperbolic as jhyp  # noqa: E402
from ryujin_tpu.solver.integrator import (  # noqa: E402
    TimeIntegrator as JTimeIntegrator,
)

from ryujin_tpu_torch import bench  # noqa: E402
from ryujin_tpu_torch.equations.euler import Euler  # noqa: E402
from ryujin_tpu_torch.equations.euler_initial_states import (  # noqa: E402
    make_initial_state,
)
from ryujin_tpu_torch.offline import (  # noqa: E402
    assembly, ell, geometry, multiblock,
)
from ryujin_tpu_torch.offline.mesh import (  # noqa: E402
    Boundary, Mesh, refine_local,
)
from ryujin_tpu_torch.solver.hyperbolic import HyperbolicModule  # noqa: E402
from ryujin_tpu_torch.solver.integrator import TimeIntegrator  # noqa: E402

from test_torch_fixture import assert_close  # noqa: E402
from test_torch_periodic import CanvasSteps  # noqa: E402

MESHES = ("annulus", "disk", "cylinder blocks", "amr")


def _mesh(name, G, B, rl):
    """Mesh `name` built by the geometry module G (Boundary B,
    refine_local rl) of either package."""
    if name == "annulus":
        return G.annulus(refinement=0)
    if name == "disk":
        return G.disk(refinement=1)
    if name == "cylinder blocks":
        return G.cylinder(refinement=1, variant="blocks")
    mesh = G.rectangular_domain([-5, -5], [5, 5], [1, 1], refinement=4,
                                boundary_conditions=[B.dirichlet] * 4)
    centers = mesh.vertices[mesh.cells].mean(axis=1)
    return rl(mesh, (np.abs(centers) < 2.0).all(axis=1))[0]


@functools.lru_cache(maxsize=None)
def packed(name):
    """(JAX StructuredData, port StructuredData, port ELL) of mesh `name`."""
    jmesh = _mesh(name, j_geometry, JBoundary, j_refine_local)
    jsd = j_multiblock.pack_multiblock(j_assembly.assemble(jmesh), jmesh,
                                       pad_minor=8, pad_major=8)
    mesh = _mesh(name, geometry, Boundary, refine_local)
    data = assembly.assemble(mesh)
    sd = multiblock.pack_multiblock(data, mesh, pad_minor=8, pad_major=8)
    return jsd, sd, ell.pack(data)


def _same(a, b, where):
    """a (the port's) equals b (the JAX package's): arrays bit for bit,
    dicts, tuples, lists and dataclasses field by field; Boundary keys
    compare by value."""
    if a is None or b is None:
        assert a is None and b is None, where
    elif dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name), f"{where}.{f.name}")
    elif isinstance(a, dict):
        ka = sorted(a, key=lambda k: (str(type(k)), int(k)
                                      if not isinstance(k, str) else k))
        kb = sorted(b, key=lambda k: (str(type(k)), int(k)
                                      if not isinstance(k, str) else k))
        assert [k if isinstance(k, str) else int(k) for k in ka] == [
            k if isinstance(k, str) else int(k) for k in kb], where
        for x, y in zip(ka, kb):
            _same(a[x], b[y], f"{where}[{x}]")
    elif isinstance(a, (list, tuple)) and not np.isscalar(a):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.shape == y.shape and x.dtype == y.dtype, where
        np.testing.assert_array_equal(x, y, err_msg=where)


@pytest.mark.parametrize("name", MESHES)
def test_pack_equals_jax(name):
    jsd, sd, _ = packed(name)
    _same(sd, jsd, name)
    assert sd.gmap_node is not None and len(sd.gmap_node[0]) > 0
    if name == "cylinder blocks":
        assert len(sd.ev_side["rows"]) == 6  # the valence-6 block corners
        assert sd.ev_side["mask"].shape[1] == 12
    if name == "amr":
        assert (sd.ev_side["trans_side"] >= 0).any()  # EV-EV edges
    # a canvas with side rows has no half-slot route
    assert (sd.sym_fixup is None) == (sd.ev_side is not None)


def _split_triangles(M, B, m):
    """A quad mesh with extraordinary vertices at a volume fraction: the
    triangles of an m x m square's triangulation, each split into three
    quads (vertices of valence 6 and 3 throughout)."""
    verts = [np.array((x, y), float) for y in range(m + 1)
             for x in range(m + 1)]
    mid = {}

    def midpoint(i, j):
        key = (min(i, j), max(i, j))
        if key not in mid:
            mid[key] = len(verts)
            verts.append(0.5 * (verts[i] + verts[j]))
        return mid[key]

    cells = []
    for y in range(m):
        for x in range(m):
            a, b = y * (m + 1) + x, y * (m + 1) + x + 1
            c, d = a + m + 1, b + m + 1
            for A, Bv, C in ((a, b, d), (a, d, c)):
                G = len(verts)
                verts.append((verts[A] + verts[Bv] + verts[C]) / 3.0)
                ab, bc, ca = midpoint(A, Bv), midpoint(Bv, C), midpoint(C, A)
                # counter-clockwise (p0, p1, p2, p3) -> deal.II (p0, p1, p3, p2)
                for p0, p1, p2, p3 in ((A, ab, G, ca), (Bv, bc, G, ab),
                                       (C, ca, G, bc)):
                    cells.append((p0, p1, p3, p2))
    V = np.array(verts)
    faces = []
    for (i, j), k in mid.items():
        for axis in (0, 1):
            if V[i, axis] == V[j, axis] and V[i, axis] in (0.0, m):
                faces += [(i, k), (k, j)]
    faces = np.array(faces, np.int64)
    return M(dim=2, vertices=V, cells=np.array(cells, np.int64),
             boundary_faces=faces,
             boundary_ids=np.full(len(faces), int(B.dirichlet), np.int32))


@pytest.mark.parametrize("name", ["cylinder blocks 0", "split triangles"])
def test_unstructured_falls_back_as_jax(name):
    """The mesh of tests/test_multiblock.py::test_truly_unstructured_falls_
    back (the cylinder blocks at refinement 0) packs as the JAX package
    packs it (both accept its 6 side rows); a mesh with side rows at a
    volume fraction raises MultiblockError in both."""
    out = []
    for G, M, B, A, P in ((j_geometry, JMesh, JBoundary, j_assembly,
                           j_multiblock),
                          (geometry, Mesh, Boundary, assembly, multiblock)):
        mesh = (G.cylinder(refinement=0, variant="blocks")
                if name.startswith("cylinder") else _split_triangles(M, B, 9))
        try:
            out.append(P.pack_multiblock(A.assemble(mesh), mesh, pad_minor=8,
                                         pad_major=8))
        except P.MultiblockError as exc:
            out.append(str(exc))
    if name == "split triangles":
        assert isinstance(out[1], str) and out[1] == out[0]
    else:
        _same(out[1], out[0], name)


def test_slabs_and_extruded_quilts_not_ported():
    _, sd, _ = packed("disk")
    mesh = _mesh("disk", geometry, Boundary, refine_local)
    with pytest.raises(NotImplementedError, match="slabs"):
        multiblock.pack_multiblock(assembly.assemble(mesh), mesh, slabs=2)
    with pytest.raises(NotImplementedError, match="extruded"):
        multiblock.pack_multiblock_extruded(None, None)
    # the stencil refuses the z-vectorized maps of an extruded quilt
    z = (np.zeros(1, np.int64),) * 2
    with pytest.raises(NotImplementedError, match="extruded"):
        HyperbolicModule(Euler(dim=2), dataclasses.replace(sd, gmap_node_z=z),
                         None, dtype=torch.float64, device="cpu")
    # a single-block canvas has no half-slot multi-block route
    with pytest.raises(ValueError, match="sym_mb"):
        HyperbolicModule(Euler(dim=2),
                         bench.build_step2d(0, torch.float64, "cpu")[1],
                         None, dtype=torch.float64, device="cpu", sym_mb=True)


@pytest.mark.parametrize("name", MESHES)
def test_refresh_matches_jax(name):
    """Node arrays: every ghost cell equals its owner; edge arrays: every
    ghost slot equals its permuted source; both equal to the JAX package's
    refresh_ghosts / refresh_edges, and in place (canvas_step.refresh) as
    out of place.  On the half-slot route's [K/2, n] lambda the half map
    refreshes every entry of the JAX package's _refresh_half but the
    interface fixup's, which the fixup writes after it."""
    from ryujin_tpu_torch.solver.canvas_step import refresh

    jsd, sd, _ = packed(name)
    hm = HyperbolicModule(Euler(dim=2), sd, None, dtype=torch.float64,
                          device="cpu")
    st = hm.stencil
    jst = jhyp.StructuredStencil.from_data(jsd, jnp.float64)
    rng = np.random.default_rng(7)
    n, K = sd.n_pad, sd.max_degree
    X = rng.standard_normal((4, n))
    got = st.refresh_ghosts(torch.as_tensor(X)).numpy()
    np.testing.assert_array_equal(got,
                                  np.asarray(jst.refresh_ghosts(jnp.asarray(X))))
    dst, src = sd.gmap_node
    np.testing.assert_array_equal(got[:, dst], got[:, src])
    owners = np.setdiff1d(np.arange(n), dst)
    np.testing.assert_array_equal(got[:, owners], X[:, owners])
    inplace = torch.as_tensor(X.copy())
    refresh(st, inplace)
    np.testing.assert_array_equal(inplace.numpy(), got)

    E = rng.standard_normal((K, n))
    got_e = st.refresh_edges(torch.as_tensor(E)).numpy()
    np.testing.assert_array_equal(
        got_e, np.asarray(jst.refresh_edges(jnp.asarray(E))))
    dst, src = sd.gmap_edge
    np.testing.assert_array_equal(got_e.reshape(-1)[dst],
                                  E.reshape(-1)[src])
    inplace = torch.as_tensor(E.copy())
    refresh(st, inplace, edges=True)
    np.testing.assert_array_equal(inplace.numpy(), got_e)

    if sd.sym_fixup is None:
        with pytest.raises(ValueError, match="half-slot"):
            st.refresh_edges(torch.as_tensor(E[: K // 2]))
        return
    L = rng.standard_normal((K // 2, n))
    got_h = st.refresh_edges(torch.as_tensor(L)).numpy().reshape(-1)
    K2n = (K // 2) * n
    keep = (dst < K2n) & (src < K2n)
    want = L.reshape(-1).copy()
    want[dst[keep]] = L.reshape(-1)[src[keep]]
    fix = sd.sym_fixup["dst"]
    want[fix] = L.reshape(-1)[fix]
    np.testing.assert_array_equal(got_h, want)


_UNIFORM = {"primitive_state": (1.4, 3.0, 1.0)}


def _bumped(U, positions):
    """tests/test_multiblock.py:25-32: density and energy times
    1 + 0.2 exp(-10 |x|^2)."""
    bump = 1.0 + 0.2 * np.exp(-10.0 * (positions ** 2).sum(1))
    U = np.array(U)
    U[0] *= bump
    U[3] *= bump
    return U


def _port_run(layout, route="two-direction", orchestration="plain", steps=3):
    """(U [C, n_pad], tau) after `steps` ERK33 steps of the port
    (tests/test_multiblock.py:35-45: CFL 0.45 / 0.9, recovery "none")."""
    eq = Euler(dim=2)
    init = make_initial_state(eq, "uniform", **_UNIFORM)
    hm = HyperbolicModule(eq, layout, init, dtype=torch.float64,
                          device="cpu", sym_mb=route == "half-slot")
    mod = CanvasSteps(hm) if orchestration == "canvas" else hm
    ti = TimeIntegrator(mod, "erk 33", cfl_min=0.45, cfl_max=0.9,
                        cfl_recovery_strategy="none")
    from ryujin_tpu_torch.postprocess.error import interpolate_nodal

    U0 = _bumped(interpolate_nodal(init, layout, eq, 0.0, torch.float64,
                                   "cpu"), np.asarray(layout.positions))
    out = ti.advance(torch.as_tensor(U0), 0.0, steps)
    assert int(out[5]) == 0
    return out[0].numpy(), float(out[3])


@functools.lru_cache(maxsize=None)
def ell_run(name):
    _, sd, packed_ell = packed(name)
    U, tau = _port_run(packed_ell)
    return U[:, packed_ell.vertex_to_node], tau


@pytest.mark.parametrize("orchestration", ["plain", "canvas"])
@pytest.mark.parametrize("route", ["two-direction", "half-slot"])
@pytest.mark.parametrize("name", MESHES)
def test_three_steps_match_ell(name, route, orchestration):
    _, sd, _ = packed(name)
    if route == "half-slot" and sd.sym_fixup is None:
        with pytest.raises(ValueError, match="no half-slot route"):
            _port_run(sd, route)
        return
    U, tau = _port_run(sd, route, orchestration)
    want, tau_want = ell_run(name)
    got = U[:, sd.vertex_to_node]
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0.0, atol=1e-12)
    assert abs(tau / tau_want - 1.0) < 1e-14


@functools.lru_cache(maxsize=None)
def jax_amr_run():
    """(U0, U after 3 ERK33 steps, tau) of the JAX package's XLA path on
    the AMR square, the two-direction route."""
    jsd, _, _ = packed("amr")
    jeq = JEuler(dim=2)
    jinit = j_make_initial_state(jeq, "uniform", **_UNIFORM)
    U0 = _bumped(j_interpolate_nodal(jinit, jsd, jeq, 0.0, jnp.float64),
                 np.asarray(jsd.positions))
    jhm = jhyp.HyperbolicModule(jeq, jsd, jinit, dtype=jnp.float64,
                                backend="xla")
    ti = JTimeIntegrator(jhm, scheme="erk 33", cfl_min=0.45, cfl_max=0.9,
                         cfl_recovery_strategy="none")
    out = ti.advance(jnp.asarray(U0), 0.0, n_steps=3)
    return U0, np.asarray(out[0]), float(out[3])


@pytest.mark.parametrize("orchestration", ["plain", "canvas"])
def test_amr_trajectory_matches_jax(orchestration):
    U0_j, want, tau_want = jax_amr_run()
    _, sd, _ = packed("amr")
    eq = Euler(dim=2)
    init = make_initial_state(eq, "uniform", **_UNIFORM)
    hm = HyperbolicModule(eq, sd, init, dtype=torch.float64, device="cpu")
    assert not hm.half and hm.sideband is not None and hm.canvas.stream
    mod = CanvasSteps(hm) if orchestration == "canvas" else hm
    ti = TimeIntegrator(mod, "erk 33", cfl_min=0.45, cfl_max=0.9,
                        cfl_recovery_strategy="none")
    out = ti.advance(torch.as_tensor(U0_j), 0.0, 3)
    real = sd.node_mask > 0
    assert_close(out[0].numpy()[:, real], want[:, real],
                 f"AMR square, {orchestration}")
    assert abs(float(out[3]) / tau_want - 1.0) < 1e-12


def test_bench_amr2d_case():
    """bench.build_amr2d at a small refinement: the multi-block canvas
    on the card's padding, the two-direction stream kernels with side
    rows; the half-slot route refused; RYUJIN_SYM_MB read from two
    values only."""
    eq, sd, hm, ti, U0 = bench.build_amr2d(4, torch.float64, "cpu")
    assert sd.shape[1] % bench.AMR_PAD_MINOR == 0
    assert sd.shape[0] % bench.AMR_PAD_MAJOR == 0
    assert hm.canvas.stream and not hm.half and hm.sideband is not None
    assert bench.CASES["amr2d"][1:] == (9, 1000,
                                        "euler2d_amr_adapted_throughput")
    with pytest.raises(ValueError, match="no half-slot route"):
        bench.build_amr2d(4, torch.float64, "cpu", sym_mb=True)
    assert bench.sym_mb_from_env({}) is False
    assert bench.sym_mb_from_env({"RYUJIN_SYM_MB": "1"}) is True
    with pytest.raises(ValueError, match="RYUJIN_SYM_MB"):
        bench.sym_mb_from_env({"RYUJIN_SYM_MB": "yes"})
