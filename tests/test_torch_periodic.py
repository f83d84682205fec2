"""The port's ghost layouts against the JAX package: the ghost refresh
(periodic ghost bands, slabs of canvas axis 0, the padded periodic minor
axis), one IDP substep phase by phase and three ERK33 steps on canvases
with ghosts, float64 on the CPU.

Cases: the fully periodic isentropic vortex at refinement 4 (a y ghost
band, minor wrap (16, 128); tests/test_pallas.py:24-67), the O-grid
cylinder at refinement 2 (minor wrap (64, 128), boundary pairs across the
angular seam; tests/test_pallas.py:184-219), a channel with slip walls in
x and y that is periodic along z (a z ghost band whose boundary pairs
cross the seam; the reference's packer refuses a rectangle periodic in one
direction only, so the channel is a 2D rectangle extruded periodically),
and the periodic box of bench.build_periodic_box3d at refinement 1 (z and
y bands, a minor wrap); both 3D canvases are packed 8 cells wide in x.
The JAX side runs its XLA canvas path (each
phase function, then TimeIntegrator.advance); the port its plain phase
functions and its kernels' orchestration (CanvasStepper on CPU tensors,
each wrapper taking its plain reference).  Bars: relative 5e-11 /
absolute 1e-12, tau within 1e-12, l as tests/test_torch_phases.py allows.
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
from ryujin_tpu.offline import (  # noqa: E402
    assembly as j_assembly, geometry as j_geometry,
    structured as j_structured,
)
from ryujin_tpu.offline.mesh import Boundary as JBoundary  # noqa: E402
from ryujin_tpu.postprocess.error import (  # noqa: E402
    interpolate_nodal as j_interpolate_nodal,
)
from ryujin_tpu.solver import hyperbolic as jhyp  # noqa: E402
from ryujin_tpu.solver.integrator import (  # noqa: E402
    TimeIntegrator as JTimeIntegrator,
)

from ryujin_tpu_torch.equations.euler import Euler  # noqa: E402
from ryujin_tpu_torch.equations.euler_initial_states import (  # noqa: E402
    make_initial_state,
)
from ryujin_tpu_torch.offline import (  # noqa: E402
    assembly, ell, geometry, structured,
)
from ryujin_tpu_torch.offline.mesh import Boundary  # noqa: E402
from ryujin_tpu_torch.offline.structured import lattice_offsets  # noqa: E402
from ryujin_tpu_torch.solver import hyperbolic as thyp  # noqa: E402
from ryujin_tpu_torch.solver.hyperbolic import HyperbolicModule  # noqa: E402
from ryujin_tpu_torch.solver.integrator import TimeIntegrator  # noqa: E402
from ryujin_tpu_torch.solver.stencil import StructuredStencil  # noqa: E402

from test_torch_fixture import assert_close, to_torch  # noqa: E402
from test_torch_phases import assert_l_close  # noqa: E402

WEIGHTS = [0.75, -2.0]
BUMP_CENTRE = {"zchannel": (1.0, 0.5, 0.9), "box": (0.5, 0.5, 0.5)}


# ---------------------------------------------------------------------------
# The refresh on hand-built layouts
# ---------------------------------------------------------------------------

# (dim, reach, canvas shape, ghosts, slab_spec, minor_wrap)
LAYOUTS = {
    "2D bands + minor wrap, reach 1": (2, 1, (32, 128), ((8, 16), None),
                                       None, (16, 128)),
    "2D bands, reach 2": (2, 2, (40, 64), ((8, 20), None), None, None),
    "2D slabs + minor wrap, reach 3": (2, 3, (80, 128), (None, None),
                                       (2, 24, 8), (40, 128)),
    "2D slabs, reach 1": (2, 1, (160, 256), (None, None), (4, 24, 8), None),
    "3D bands + minor wrap, reach 1": (3, 1, (16, 16, 128), ((2, 8), (2, 8),
                                                             None), None,
                                       (8, 128)),
    "3D slabs + band, reach 1": (3, 1, (24, 16, 32), (None, (2, 8), None),
                                 (2, 8, 2), None),
}


def _layout_stencils(name):
    """(JAX StructuredStencil, port StructuredStencil) of LAYOUTS[name]:
    the refresh reads only the layout, so the arrays are left out."""
    dim, reach, shape, ghosts, slab, wrap = LAYOUTS[name]
    offsets = lattice_offsets(dim, reach)
    nones = dict(cij=None, mij=None, mask=None, cii=None, m_lumped=None,
                 m_lumped_inv=None, n_nbrs=None, node_mask=None,
                 measure_inv=None)
    jst = jhyp.StructuredStencil(shape=shape, offsets=offsets, ghosts=ghosts,
                                 slab_spec=slab, minor_wrap=wrap, **nones)
    st = StructuredStencil(shape=shape, offsets=offsets, ghosts=ghosts,
                           slab_spec=slab, minor_wrap=wrap, **nones)
    return jst, st


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_refresh_matches_jax(name):
    """refresh_ghosts on node arrays [C, n] and on edge arrays [K, n]
    equals the JAX package's refresh_ghosts and refresh_edges (compiled: its copies are
    exact) on seeded random values, and the port's in-place form
    (canvas_step.refresh) equals both."""
    from ryujin_tpu_torch.solver.canvas_step import refresh

    jst, st = _layout_stencils(name)
    n = int(np.prod(st.shape))
    rng = np.random.default_rng(19)
    for lead in ((4,), (st.K,), (2, 3)):
        X = rng.standard_normal(lead + (n,))
        want = np.asarray(jax.jit(jst.refresh_ghosts)(jnp.asarray(X)))
        assert not np.array_equal(want, X)
        got = st.refresh_ghosts(torch.as_tensor(X))
        np.testing.assert_array_equal(got.numpy(), want)
        if len(lead) == 1 and lead[0] == st.K:
            got_e = st.refresh_ghosts(torch.as_tensor(X))
            want_e = np.asarray(jax.jit(jst.refresh_edges)(jnp.asarray(X)))
            np.testing.assert_array_equal(got_e.numpy(), want_e)
        inplace = torch.as_tensor(X.copy())
        refresh(st, inplace)
        np.testing.assert_array_equal(inplace.numpy(), want)
    # the neighbour reads refresh their input first
    X = rng.standard_normal((2, n))
    np.testing.assert_array_equal(
        st.nbr(torch.as_tensor(X)).numpy(),
        np.asarray(jax.jit(jst.nbr)(jnp.asarray(X))))
    E = rng.standard_normal((st.K, n))
    np.testing.assert_array_equal(
        st.transpose_edge(torch.as_tensor(E)).numpy(),
        np.asarray(jax.jit(jst.transpose_edge)(jnp.asarray(E))))


# ---------------------------------------------------------------------------
# The canvases with ghosts
# ---------------------------------------------------------------------------

def _mesh(name, G, B):
    if name == "vortex":
        return G.rectangular_domain([-5, -5], [5, 5], [1, 1], refinement=4,
                                    boundary_conditions=[B.periodic] * 4)
    if name == "cylinder":
        return G.cylinder(refinement=2)
    if name == "zchannel":
        base = G.rectangular_domain([0, 0], [2, 1], [2, 1], refinement=1,
                                    boundary_conditions=[B.slip] * 4)
        return G.extrude(base, 0.0, 1.0, 8, bc_minus=B.periodic,
                         bc_plus=B.periodic)
    if name == "box":
        return G.rectangular_domain([0, 0, 0], [1, 1, 1], [2, 2, 2],
                                    refinement=1,
                                    boundary_conditions=[B.periodic] * 6,
                                    dim=3)
    raise ValueError(name)


def _initial(name, mis, eq):
    if name == "vortex":
        return mis(eq, "isentropic vortex", direction=[1, 1], position=[0, 0],
                   mach_number=1.0, beta=5.0)
    if name == "cylinder":
        return mis(eq, "uniform", direction=[1, 0], position=[1, 0],
                   primitive_state=[1.4, 3.0, 1.0])
    if name == "zchannel":
        return mis(eq, "uniform", direction=[0.2, 0.1, 1.0],
                   primitive_state=[1.4, 1.0, 1.0])
    return mis(eq, "uniform", direction=[1.0, 0.5, 0.25],
               primitive_state=[1.4, 1.0, 1.0])


CFL = {"vortex": 0.3, "cylinder": 0.6, "zchannel": 0.6, "box": 0.6}
# the 3D canvases' x axis padded to 8 cells, not 128: the channel's 5
# vertices (no wrap) and the box's period 4 with a minor wrap (4, 8) keep
# their layouts on a sixteenth of the canvas
PACKING = {"zchannel": {"margin": (2, 2), "pad_minor": 8},
           "box": {"margin": (2, 2), "pad_minor": 8}}


def bumped(positions, U, centre):
    """U with its density and energy times 1 + 0.25 exp(-8 |x - centre|^2)."""
    c = np.asarray(centre)[:, None]
    bump = 1.0 + 0.25 * np.exp(-8.0 * np.sum((positions.T - c) ** 2, 0))
    U = U.copy()
    U[0] *= bump
    U[-1] *= bump
    return U


@functools.lru_cache(maxsize=None)
def case(name):
    """(JAX sd, JAX eq, JAX init, U0 [C, n], port sd, port eq, port init):
    each package's own mesh, assembly and packing."""
    kw = PACKING.get(name, {})
    jmesh = _mesh(name, j_geometry, JBoundary)
    jsd = j_structured.pack_structured(j_assembly.assemble(jmesh), jmesh,
                                       **kw)
    mesh = _mesh(name, geometry, Boundary)
    sd = structured.pack_structured(assembly.assemble(mesh), mesh, **kw)
    jeq, eq = JEuler(dim=jsd.dim), Euler(dim=sd.dim)
    jinit = _initial(name, j_make_initial_state, jeq)
    U0 = np.array(j_interpolate_nodal(jinit, jsd, jeq, 0.0, jnp.float64))
    if name in BUMP_CENTRE:
        U0 = bumped(jsd.positions, U0, BUMP_CENTRE[name])
    return jsd, jeq, jinit, U0, sd, eq, _initial(name, make_initial_state, eq)


def test_layouts_of_the_cases():
    """Each case packs the ghost layout it is here for, the same in both
    packages."""
    want = {
        "vortex": (((8, 16), None), None, (16, 128)),
        "cylinder": ((None, None), None, (64, 128)),
        "zchannel": (((2, 8), None, None), None, None),
        "box": (((2, 4), (2, 4), None), None, (4, 8)),
    }
    for name, layout in want.items():
        jsd, _, _, _, sd, _, _ = case(name)
        got = (tuple(sd.ghosts), sd.slab_spec, sd.minor_wrap)
        assert got == layout, name
        assert got == (tuple(jsd.ghosts), jsd.slab_spec, jsd.minor_wrap)
        np.testing.assert_array_equal(sd.positions, jsd.positions)


@functools.lru_cache(maxsize=None)
def jax_phases(name):
    """jax_substep of case `name`."""
    jsd, jeq, jinit, U0, _, _, _ = case(name)
    return jax_substep(jsd, jeq, jinit, U0, CFL[name])


def jax_substep(jsd, jeq, jinit, U0, cfl):
    """Every intermediate of one JAX XLA substep (the third of ERK33: two
    stages, weights 0.75 and -2) from U0, as numpy arrays, and the JAX
    module's route (True: half-slot)."""
    jhm = jhyp.HyperbolicModule(jeq, jsd, jinit, dtype=jnp.float64)
    # the 3D phases as one compiled graph (op by op they dispatch for
    # most of a minute); the 2D ones op by op, as tests/test_torch_phases.py
    # runs them, where the limiter's l is compared
    fn = functools.partial(_jax_substep, jhm, cfl)
    out = (jax.jit(fn) if jsd.dim == 3 else fn)(jnp.asarray(U0))
    return {k: np.asarray(v) for k, v in out.items()}, jhm._sym_riemann


def _jax_substep(jhm, cfl, U0):
    jeq, st, p = jhm.eq, jhm.stencil, jhm.params
    Ua, preca = jhm.prepare_state_vector(U0, 0.0)
    Ub, _, _ = jhm.step(
        Ua, preca, jnp.zeros((0,) + Ua.shape), jnp.zeros((0,) + preca.shape),
        jnp.zeros((0,)), 0.0, cfl, jnp.inf, compute_tau=True,
    )
    U, prec = jhm.prepare_state_vector(Ub, 0.0)
    sU, sP = jnp.stack([Ua, U]), jnp.stack([preca, prec])
    w = jnp.asarray(WEIGHTS)
    U_j, prec_j = st.nbr(U), st.nbr(prec)
    sU_j = jnp.stack([st.nbr(sU[s]) for s in range(2)])
    sP_j = jnp.stack([st.nbr(sP[s]) for s in range(2)])
    ip = jhm.initial_precomputed
    ip_j = jnp.zeros((0,) + st.mask.shape)
    half = jhm._sym_riemann
    lam, alpha = jhyp.phase_e_alpha(jeq, p, st, U, prec, U_j, prec_j,
                                    half=half)
    if half:
        lam_fixed = jhm._lambda_fixup(lam, U, prec)
        d = jhyp.d_from_lambda(st, lam_fixed, st.mask)
    else:
        lam_fixed = lam
        d = jhyp.d_from_e(st.mask, lam, st.transpose_edge(lam))
    tau = jhyp.tau_max_from_d(st, d, cfl, jnp.inf)
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
    return dict(Ua=Ua, U=U, prec=prec, lam=lam, lam_fixed=lam_fixed,
                alpha=alpha, d=d, tau=tau, U_low=U_low, F=F, bounds=bounds,
                P=P, l=l, U4=U4, l4=l4, U5=U5)


@functools.lru_cache(maxsize=None)
def port_module(name):
    _, _, _, _, sd, eq, init = case(name)
    return HyperbolicModule(eq, sd, init, dtype=torch.float64, device="cpu")


@functools.lru_cache(maxsize=None)
def port_phases(name):
    """port_substep of case `name`."""
    ref, half = jax_phases(name)
    return port_substep(port_module(name), ref, half, CFL[name])


def port_substep(hm, ref, half, cfl):
    """The port's plain phase functions on the refreshing stencil, each
    fed the JAX substep's inputs `ref` (so a fault points to one phase)."""
    assert hm.half == half
    eq, p, st = hm.eq, hm.params, hm.stencil.full()
    t = {k: to_torch(v) for k, v in ref.items()}
    U, prec = t["U"], t["prec"]
    U_j, prec_j = st.nbr(U), st.nbr(prec)
    sU = torch.stack([t["Ua"], U])
    sU_j = [st.nbr(sU[s]) for s in range(2)]
    lam, alpha = thyp.phase_e_alpha(eq, p, st, U, prec, U_j, prec_j,
                                    half=half)
    if half:
        lam_fixed = hm._lambda_fixup(t["lam"], U)
        d = thyp.d_from_lambda(st, t["lam_fixed"], st.cmax)
    else:
        lam_fixed = lam
        d = thyp.d_from_e(st.mask, t["lam"], st.transpose_edge(t["lam"]))
    cap = torch.tensor(float("inf"), dtype=torch.float64)
    tau = thyp.tau_max_from_d(st, t["d"], cfl, cap)
    alpha_j = st.nbr(t["alpha"])
    U_low, F, bounds = thyp.phase_low_order(
        eq, p, st, U, prec, U_j, prec_j, t["d"], t["alpha"], alpha_j,
        t["tau"], sU, sU_j, WEIGHTS,
    )
    P, l, _ = thyp.phase_p_l1(
        eq, p, st, U, U_j, t["d"], t["alpha"], alpha_j, t["tau"], t["F"],
        st.nbr(t["F"]), st.nbr(st.m_lumped), t["U_low"], t["bounds"], sU,
        sU_j, WEIGHTS,
    )
    U4, l4 = thyp.phase_update(eq, p, st, t["U_low"], t["bounds"], t["P"],
                               t["l"], st.transpose_edge(t["l"]), False)
    U5, _ = thyp.phase_update(eq, p, st, t["U4"], t["bounds"], t["P"],
                              t["l4"], st.transpose_edge(t["l4"]), True)
    return dict(lam=lam, lam_fixed=lam_fixed, alpha=alpha, d=d, tau=tau,
                U_low=U_low, F=F, bounds=bounds, P=P, l=l, U4=U4, l4=l4,
                U5=U5)


def check_phase(sd, ref, got, phase):
    """One phase of the substep on the real nodes of canvas sd (edge
    arrays on their live slots)."""
    real = sd.node_mask > 0
    live = (sd.mask.T > 0) & real[None]
    want, got = ref[phase], got[phase]
    if phase == "tau":
        assert abs(float(got) / float(want) - 1.0) < 1e-12
        return
    got = got.numpy()
    if phase == "P":
        assert_close(got[:, live], want[:, live], phase)
    elif phase in ("lam", "lam_fixed", "d", "l", "l4"):
        m = live[: got.shape[0]]
        if phase in ("l", "l4"):
            assert_l_close(got[m], want[m], phase)
        else:
            assert_close(got[m], want[m], phase)
    elif got.ndim == 1:
        assert_close(got[real], want[real], phase)
    else:
        assert_close(got[:, real], want[:, real], phase)


PHASES = ("lam", "lam_fixed", "alpha", "d", "tau", "U_low", "F", "bounds",
          "P", "l", "U4", "l4", "U5")


@pytest.mark.parametrize("phase", PHASES)
@pytest.mark.parametrize("name", ["vortex", "cylinder"])
def test_phase_matches_jax(name, phase):
    check_phase(case(name)[0], jax_phases(name)[0], port_phases(name), phase)


class CanvasSteps:
    """A HyperbolicModule whose substeps run CanvasStepper.step: the
    kernels' orchestration, with the refreshes, each wrapper on CPU
    tensors taking its plain reference."""

    def __init__(self, hm):
        self.hm, self.dtype, self.device = hm, hm.dtype, hm.device

    def prepare_state_vector(self, U, t):
        return self.hm.prepare_state_vector(U, t)

    def step(self, *args, **kwargs):
        return self.hm.canvas.step(*args, **kwargs)


def ordered_real(sd):
    """The real canvas cells ordered by vertex: comparable across
    layouts."""
    real = np.flatnonzero(sd.node_to_vertex >= 0)
    return real[np.argsort(sd.node_to_vertex[real], kind="stable")]


@functools.lru_cache(maxsize=None)
def jax_steps(name, steps=3):
    """(U [C, n_real] by vertex, tau) after `steps` ERK33 steps of the
    JAX XLA canvas path."""
    jsd, jeq, jinit, U0, _, _, _ = case(name)
    jhm = jhyp.HyperbolicModule(jeq, jsd, jinit, dtype=jnp.float64)
    jti = JTimeIntegrator(jhm, "erk 33", cfl_min=CFL[name],
                          cfl_max=CFL[name], cfl_recovery_strategy="none")
    out = jti.advance(jnp.asarray(U0), 0.0, steps)
    return np.asarray(out[0])[:, ordered_real(jsd)], float(out[3])


@functools.lru_cache(maxsize=None)
def port_steps(name, orchestration, steps=3):
    """(U [C, n_real] by vertex, tau, warnings) of the port after `steps`
    ERK33 steps: the plain path (HyperbolicModule.step), the kernels'
    orchestration (CanvasSteps), or "ell": the plain path on the ELL
    layout of the same mesh (offline/ell.pack: no ghosts), from the same
    state on every vertex."""
    _, _, _, U0, sd, eq, init = case(name)
    if orchestration == "ell":
        mesh = _mesh(name, geometry, Boundary)
        packed = ell.pack(assembly.assemble(mesh))
        cols = packed.vertex_to_node[sd.node_to_vertex[ordered_real(sd)]]
        Ue = np.array(np.broadcast_to(U0[:, :1], U0.shape[:1]
                                      + (packed.n_pad,)))
        Ue[:, cols] = U0[:, ordered_real(sd)]
        mod = HyperbolicModule(eq, packed, init, dtype=torch.float64,
                               device="cpu")
        U0 = Ue
    else:
        cols = ordered_real(sd)
        mod = port_module(name)
        if orchestration == "canvas":
            mod = CanvasSteps(mod)
    ti = TimeIntegrator(mod, "erk 33", cfl_min=CFL[name], cfl_max=CFL[name],
                        cfl_recovery_strategy="none")
    out = ti.advance(torch.as_tensor(U0), 0.0, steps)
    return out[0].numpy()[:, cols], float(out[3]), int(out[5])


@pytest.mark.parametrize("orchestration", ["plain", "canvas"])
@pytest.mark.parametrize("name", ["vortex", "cylinder"])
def test_three_steps_match_jax(name, orchestration):
    want, tau_want = jax_steps(name)
    got, tau, warns = port_steps(name, orchestration)
    assert warns == 0
    assert np.isfinite(got).all()
    assert_close(got, want, f"{name} {orchestration}")
    assert abs(tau / tau_want - 1.0) < 1e-12


@pytest.mark.parametrize("orchestration", ["plain", "canvas"])
@pytest.mark.parametrize("name", ["box", "zchannel"])
def test_three_steps_match_ell(name, orchestration):
    """The 3D canvases with ghost bands (and the box's minor wrap) against
    the ELL layout of the same mesh, which has no ghosts: the channel's
    boundary pairs cross the z seam, so the neighbour j of the half-slot
    fixup lies in a ghost band, where the port reads U at j's owner row."""
    want, tau_want, _ = port_steps(name, "ell")
    got, tau, warns = port_steps(name, orchestration)
    assert warns == 0
    assert np.isfinite(got).all()
    assert_close(got, want, f"{name} {orchestration} vs ELL")
    assert abs(tau / tau_want - 1.0) < 1e-12


@pytest.mark.parametrize("name", ["box", "zchannel"])
def test_3d_substep_matches_jax(name):
    """The substep's U after PK5, and its tau, against the JAX phase
    functions on the 3D canvases with ghosts (the box on the half-slot
    route without boundary pairs, the channel with them)."""
    ref, _ = jax_phases(name)
    got = port_phases(name)
    sd = case(name)[0]
    real = sd.node_mask > 0
    live = (sd.mask.T > 0) & real[None]
    for phase in ("lam_fixed", "d"):
        m = live[: got[phase].shape[0]]
        assert_close(got[phase].numpy()[m], ref[phase][m], phase)
    for phase in ("U_low", "F", "bounds", "U4", "U5"):
        assert_close(got[phase].numpy()[:, real], ref[phase][:, real], phase)
    assert abs(float(got["tau"]) / float(ref["tau"]) - 1.0) < 1e-12


def test_jax_fixup_reads_stale_ghosts_on_the_channel():
    """What the JAX XLA path does at the seam: its fixup gathers the
    prepared U_old at j, which on the channel lies in the z ghost band for
    36 boundary-pair slots, and its ghost rows are never refreshed there
    (interpolate_nodal leaves them at the pad state; after a step they
    hold what the update computed there, before the boundary conditions).
    Over three steps of the port (equal to JAX's to roundoff) those reads
    differ from the owner's U by up to 2.27, yet the fixup's max keeps the
    forward value on every such slot: the JAX fixup's output equals the
    port's (which reads the owner) to 5e-15 relative."""
    jsd, jeq, jinit, U0, _, _, _ = case("zchannel")
    jhm = jhyp.HyperbolicModule(jeq, jsd, jinit, dtype=jnp.float64)
    hm = port_module("zchannel")
    bp = {k: v.numpy() for k, v in hm._bp.items()}
    shape = jsd.shape
    g, P = jsd.ghosts[0]
    raw = (np.stack(np.unravel_index(bp["i"], shape), 1)
           + np.asarray(jsd.offsets)[bp["k"]]) % np.asarray(shape)
    ghost = (raw[:, 0] < g) | (raw[:, 0] >= g + P)
    assert ghost.sum() == 36
    jj = np.ravel_multi_index(tuple(raw[ghost].T), shape)
    oo = bp["j"][ghost]
    ti = TimeIntegrator(hm, "erk 33", cfl_min=CFL["zchannel"],
                        cfl_max=CFL["zchannel"], cfl_recovery_strategy="none")
    U = torch.as_tensor(U0)
    stale = 0.0
    for _ in range(3):
        Up, prec = hm.prepare_state_vector(U, 0.0)
        st = hm.stencil
        lam, _ = thyp.phase_e_alpha(hm.eq, hm.params, st, Up, prec,
                                    st.nbr(Up), st.nbr(prec))
        stale = max(stale, float((Up[:, jj] - Up[:, oo]).abs().max()))
        want = hm._lambda_fixup(lam, Up).numpy()
        got = np.asarray(jhm._lambda_fixup(jnp.asarray(lam.numpy()),
                                           jnp.asarray(Up.numpy()),
                                           jnp.asarray(prec.numpy())))
        k, i = bp["k"], bp["i"]
        np.testing.assert_allclose(got[k, i], want[k, i], rtol=5e-15, atol=0)
        U = ti.advance(U, 0.0, 1)[0]
    assert stale > 1.0, stale
