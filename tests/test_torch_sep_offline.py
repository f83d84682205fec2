"""Separable statics in the PyTorch port against the JAX package: the
factors, the packed cylinder and the synthesized planes.

Two small 3D cG Q1 canvases (K = 26), one for each Riemann route, both
extrusions along z that `separate_z` factors:

- the cylinder o-grid of bench case cylinder3d (bench.py:86-103) at
  refinement 1, packed with z and y margins of 2 and pad_minor = 32: a
  (24, 16, 32) canvas whose minor axis is the periodic angle, exactly 32
  wide (no minor_wrap), 4,896 real nodes; its boundary-pair set is above
  the cut-off, so it takes the two-direction route;
- the 3 x 2 x 2 box of tests/test_torch_box3d_phases.py (box3d's
  boundary conditions, refinement 1, pad_minor = 16): a (16, 16, 16)
  canvas on the half-slot route.

The JAX side's synthesis is reached through construction only: a
HyperbolicModule with backend "pallas_interpret" under RYUJIN_SEP=1
builds its PallasStepper with the factors (pallas_step.py:1310-1395) and
runs no kernel; its `_sep_full` / `_sep_cmax_full` (:2022-2053) are XLA
glue.  Nothing of the JAX package changes.  float64 throughout.
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
from ryujin_tpu.offline import assembly, geometry, structured  # noqa: E402
from ryujin_tpu.offline.mesh import Boundary  # noqa: E402
from ryujin_tpu.offline.separable import separate_z as j_separate_z  # noqa: E402
from ryujin_tpu.solver import hyperbolic as jhyp  # noqa: E402

from ryujin_tpu_torch import bench, convert  # noqa: E402
from ryujin_tpu_torch.equations.euler_initial_states import (  # noqa: E402
    make_initial_state,
)
from ryujin_tpu_torch.offline import (  # noqa: E402
    assembly as t_assembly,
    geometry as t_geometry,
    mesh as t_mesh,
    structured as t_structured,
)
from ryujin_tpu_torch.offline.separable import _RTOL, separate_z  # noqa: E402
from ryujin_tpu_torch.solver.hyperbolic import HyperbolicModule  # noqa: E402

from test_torch_q2_offline import assert_same  # noqa: E402

INFLOW = (1.4, 3.0, 1.0)
K = 26
JEQ = JEuler(dim=3)
EQ, PARAMS = convert.params_from_reference(JEQ, jhyp.HyperbolicModuleParams())
# canvas -> (Riemann route, canvas shape)
CANVASES = {"cylinder": ("two_direction", (24, 16, 32)),
            "box": ("half_slot", (16, 16, 16))}


def _packed(pkg, name):
    """The canvas `name` assembled and packed by the offline layer of `pkg`
    (the JAX package's or the port's)."""
    geometry_, assembly_, structured_, boundary = pkg
    if name == "cylinder":
        mesh = geometry_.cylinder(refinement=1, dim=3)
        pad = 32
    else:
        mesh = geometry_.rectangular_domain(
            [0.0, 0.0, 0.0], [3.0, 1.0, 1.0], [3, 2, 2], refinement=1,
            boundary_conditions=[boundary.dirichlet, boundary.do_nothing]
            + [boundary.slip] * 4,
            dim=3,
        )
        pad = 16
    return structured_.pack_structured(assembly_.assemble(mesh), mesh,
                                       pad_minor=pad, margin=(2, 2))


def _init(make, eq, name):
    if name == "cylinder":
        return make(eq, "uniform", direction=[1, 0, 0], position=[1, 0, 0],
                    primitive_state=INFLOW)
    return make(eq, "uniform", primitive_state=INFLOW)


@dataclasses.dataclass
class SepCase:
    sd: object  # the JAX package's StructuredData
    t_sd: object  # the port's
    jinit: object
    hm: HyperbolicModule  # full statics
    hm_sep: HyperbolicModule  # separable statics


@functools.lru_cache(maxsize=None)
def sep_case(name) -> SepCase:
    sd = _packed((geometry, assembly, structured, Boundary), name)
    t_sd = _packed((t_geometry, t_assembly, t_structured, t_mesh.Boundary),
                   name)
    init = _init(make_initial_state, EQ, name)
    hm, hm_sep = (
        HyperbolicModule(EQ, t_sd, init, params=PARAMS, dtype=torch.float64,
                         device="cpu", separable=sep)
        for sep in (False, True)
    )
    return SepCase(sd, t_sd, _init(j_make_initial_state, JEQ, name), hm,
                   hm_sep)


@functools.lru_cache(maxsize=None)
def jax_sep_stepper(name):
    """The JAX package's PallasStepper with separable statics on the JAX
    side's canvas (construction only: no kernel runs)."""
    case = sep_case(name)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RYUJIN_SEP", "1")
        jhm = jhyp.HyperbolicModule(JEQ, case.sd, case.jinit,
                                    dtype=jnp.float64,
                                    backend="pallas_interpret")
    ps = jhm._pallas
    assert ps.slab3d and ps.sep is not None
    return ps


def stored_planes(sd):
    """The stored statics of a StructuredData, planes first: c_ij [3, K, n],
    m_ij and the mask [K, n], c_ii [3, n]."""
    return (np.moveaxis(sd.cij, (-1, -2), (0, 1)), sd.mij.T, sd.mask.T,
            sd.cii.T)


def residual(st, sd):
    """The largest relative residual of the synthesis against the stored
    planes: max |f g - stored| / max |stored| over c_ij, m_ij and c_ii."""
    cij, mij, _, cii = stored_planes(sd)
    res = 0.0
    for got, ref in (
        (np.stack([st.cij_k(k).numpy() for k in range(K)], 1), cij),
        (np.stack([st.mij_k(k).numpy() for k in range(K)]), mij),
        (st.c_ii().numpy(), cii),
    ):
        res = max(res, np.abs(got - ref).max() / np.abs(ref).max())
    return res


# ---- (1) the factors and the packed cylinder --------------------------------


@pytest.mark.parametrize("name", sorted(CANVASES))
def test_packed_canvas_and_factors_equal_jax(name):
    """The port packs the canvas as the JAX package does, and its
    separate_z gives the JAX package's factors array for array."""
    case = sep_case(name)
    got, ref = case.t_sd, case.sd
    assert tuple(got.shape) == CANVASES[name][1]
    assert got.minor_wrap is None
    assert_same(got, ref, "sd")
    sep = separate_z(got)
    assert sep is not None
    assert_same(sep, j_separate_z(ref), "sep")
    if name == "cylinder":
        assert got.n_nodes == 4896
        ids = {int(b) for rnd in got.boundary_rounds for b in rnd}
        assert ids == {int(Boundary.do_nothing), int(Boundary.slip),
                       int(Boundary.dirichlet)}


# ---- (2) the synthesis ----------------------------------------------------------


def _rel(got, ref):
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


@pytest.mark.parametrize("name", sorted(CANVASES))
def test_synthesis_equals_jax_and_stored(name):
    """Every synthesized plane against the JAX package's: c_ij per
    component and the mask against _sep_full, cmax against
    _sep_cmax_full, m_ij and c_ii against the JAX side's factors (it has
    no XLA synthesis of those), each to 1e-15 relative; the live set of the
    synthesized mask is sd.mask's; and every plane is the stored one up
    to the factorization residual, which stays below separate_z's check
    (_RTOL)."""
    case = sep_case(name)
    ps = jax_sep_stepper(name)
    st = case.hm_sep.stencil
    full = case.hm.stencil
    assert st.separable and st.cij is None and st.mask is None
    ca = case.hm_sep.canvas.arrays
    g2, fz = np.asarray(ps.arrays.g_sep2[0]), np.asarray(ps.arrays.f_sepz[:, :, 0, 0]).T
    np.testing.assert_array_equal(ca.g_sep2.numpy(), g2)
    np.testing.assert_array_equal(ca.f_sepz.numpy(), fz)
    live = 0
    for k in range(K):
        for c in range(3):
            ref = np.asarray(ps._sep_full("cij", k, c)).reshape(-1)
            assert _rel(st.cij_k(k)[c].numpy(), ref) <= 1e-15, (k, c)
        raw = st.sep_plane("mask", k).numpy()
        ref = np.asarray(ps._sep_full("mask", k)).reshape(-1)
        assert _rel(raw, ref) <= 1e-15, k
        on = st.mask_k(k).numpy()
        np.testing.assert_array_equal(on, (ref > 0).astype(float))
        np.testing.assert_array_equal(on, case.sd.mask[:, k])
        live += int(on.sum())
        q = 3 * (st.offsets[k][1] + 1) + st.offsets[k][2] + 1
        ref = (fz[3 * K + k][:, None, None] * g2[27 + q]).reshape(-1)
        assert _rel(st.mij_k(k).numpy(), ref) <= 1e-15, k
        ref = np.asarray(ps._sep_cmax_full(k)).reshape(-1)
        assert _rel(st.cmax_k(k).numpy(), ref) <= 1e-15, k
        assert _rel(st.cmax_k(k).numpy(), full.cmax_k(k).numpy()) <= 1e-12
    assert live == int((case.sd.mask > 0).sum())
    for c in range(3):
        ref = (fz[5 * K + c][:, None, None] * g2[45 + c]).reshape(-1)
        assert _rel(st.c_ii()[c].numpy(), ref) <= 1e-15, c
    res = residual(st, case.sd)
    print(f"{name}: synthesis residual {res:.3e} (separate_z's check "
          f"{_RTOL:.0e}), {live} live edges")
    assert res <= _RTOL


@pytest.mark.parametrize("name", sorted(CANVASES))
def test_separable_mode_allocates_no_static_canvas(name):
    """separable=True leaves the five static stacks unallocated: the
    canvas holds the factors (48 2D fields, 133 z-profiles) beside the node
    planes, and full() synthesizes the stacks on demand."""
    case = sep_case(name)
    ca, ca_full = case.hm_sep.canvas.arrays, case.hm.canvas.arrays
    for plane in ("g_cij", "g_mask", "g_cmax", "g_mij", "g_cii"):
        assert getattr(ca, plane) is None
        assert getattr(ca_full, plane) is not None
    D, H, W = ca.shape
    assert tuple(ca.g_sep2.shape) == (48, H, W)
    assert tuple(ca.f_sepz.shape) == (133, D)
    assert ca_full.g_sep2 is None and ca_full.f_sepz is None
    full = case.hm_sep.stencil.full()
    stored = case.hm.stencil
    np.testing.assert_array_equal(full.mask.numpy(), stored.mask.numpy())
    assert _rel(full.cij.numpy(), stored.cij.numpy()) <= _RTOL


# ---- (5) misuse ------------------------------------------------------------------


def test_separable_raises_where_the_jax_package_would_not_factor():
    """separable=True on a 2D canvas, a dG canvas and a 3D canvas whose
    statics do not factor raises instead of falling back to the full
    canvases; a padded periodic minor axis (minor_wrap) is carried in
    either mode."""
    with pytest.raises(ValueError, match="3D cG"):
        bench.build_step2d(0, torch.float64, "cpu", separable=True)
    with pytest.raises(ValueError, match="3D cG"):
        bench.build_dg1box3d(1, torch.float64, "cpu", subdiv=(3, 2, 2),
                             separable=True)
    t_sd = sep_case("box").t_sd
    cij = t_sd.cij.copy()
    live = np.flatnonzero(t_sd.mask[:, 0] > 0)
    cij[live[len(live) // 2], 0] *= 1.5  # one coefficient off the product
    bent = dataclasses.replace(t_sd, cij=cij)
    assert separate_z(bent) is None
    init = _init(make_initial_state, EQ, "box")
    with pytest.raises(ValueError, match="do not factor"):
        HyperbolicModule(EQ, bent, init, dtype=torch.float64, device="cpu",
                         separable=True)
    # a padded periodic minor axis (minor_wrap) is carried in either
    # mode: its ghost columns are refreshed before every neighbour read
    for sep in (False, True):
        _, sd, hm, _, _ = bench.build_cylinder3d(1, torch.float64, "cpu",
                                                 separable=sep)
        assert sd.minor_wrap == (32, 128)
        assert hm.stencil.minor_wrap == sd.minor_wrap
        assert hm.canvas.arrays.separable == sep
