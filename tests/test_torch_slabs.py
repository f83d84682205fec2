"""Slab canvases (StructuredData.slab_spec: canvas axis 0 in uniform slabs,
each with ghost bands that a cyclic roll along the slab axis refreshes)
and the ghost-width check, float64 on the CPU.

The Mach-3 step at refinement 0 packed in 2 and 4 slabs: three ERK33 steps
of the port (its plain path and its kernels' orchestration, CanvasStepper
on CPU tensors) against the JAX package's XLA slabs path at relative
1e-12 (tests/test_pallas.py:262-310) and against the port on the plain
canvas (slabs 1); then the same with every cell outside the real rows and
their ghost copies (value_mask 0: the pad rows and the two outermost slab
bands, which hold wrapped garbage by design) set to NaN after every ghost
refresh and in every kernel output, which must leave every real node
finite and equal to the run without NaN.  Last, a ghost band narrower
than the stencil's reach raises ValueError.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from ryujin_tpu.equations.euler import Euler as JEuler  # noqa: E402
from ryujin_tpu.offline import (  # noqa: E402
    assembly as j_assembly, geometry as j_geometry,
    structured as j_structured,
)
from ryujin_tpu.postprocess.error import (  # noqa: E402
    interpolate_nodal as j_interpolate_nodal,
)
from ryujin_tpu.solver.hyperbolic import (  # noqa: E402
    HyperbolicModule as JHyperbolicModule,
)
from ryujin_tpu.solver.integrator import (  # noqa: E402
    TimeIntegrator as JTimeIntegrator,
)

from ryujin_tpu_torch.equations.euler import Euler  # noqa: E402
from ryujin_tpu_torch.offline import (  # noqa: E402
    assembly, geometry, structured,
)
from ryujin_tpu_torch.offline.mesh import Boundary  # noqa: E402
from ryujin_tpu_torch.postprocess.error import interpolate_nodal  # noqa: E402
from ryujin_tpu_torch.solver import canvas_step  # noqa: E402
from ryujin_tpu_torch.solver.hyperbolic import HyperbolicModule  # noqa: E402
from ryujin_tpu_torch.solver.integrator import TimeIntegrator  # noqa: E402

from test_torch_periodic import CanvasSteps, ordered_real  # noqa: E402

STEPS = 3
CFL = 0.4


def _j_init(x, t):
    """The inflow of tests/test_pallas.py:281-286 (JAX)."""
    one = jnp.ones_like(x[0])
    return jnp.stack([1.4 * one, 3.0 * 1.4 * one, 0 * x[0],
                      one / 0.4 + 0.5 * 1.4 * 9.0], 0)


def _init(x, t):
    one = torch.ones_like(x[0])
    return torch.stack([1.4 * one, 3.0 * 1.4 * one, 0 * x[0],
                        one / 0.4 + 0.5 * 1.4 * 9.0], 0)


def _perturbed(U, sd):
    """The layout-independent perturbation of tests/test_pallas.py:290-293,
    so that every limiter works."""
    pert = 1.0 + 0.2 * np.sin(np.asarray(sd.node_to_vertex) * 0.37)
    return U * np.where(sd.node_to_vertex >= 0, pert, 1.0)[None]


@functools.lru_cache(maxsize=None)
def port_sd(slabs):
    mesh = geometry.step(refinement=0)
    return structured.pack_structured(assembly.assemble(mesh), mesh,
                                      slabs=slabs)


@functools.lru_cache(maxsize=None)
def jax_run(slabs):
    """(U [C, n_real] by vertex, tau) of JAX's XLA path."""
    mesh = j_geometry.step(refinement=0)
    sd = j_structured.pack_structured(j_assembly.assemble(mesh), mesh,
                                      slabs=slabs)
    jeq = JEuler(dim=2)
    hm = JHyperbolicModule(jeq, sd, _j_init, dtype=jnp.float64)
    ti = JTimeIntegrator(hm, "erk 33", cfl_min=CFL, cfl_max=CFL,
                         cfl_recovery_strategy="none")
    U = np.array(j_interpolate_nodal(_j_init, sd, jeq, 0.0, jnp.float64))
    out = ti.advance(jnp.asarray(_perturbed(U, sd)), 0.0, STEPS)
    return np.asarray(out[0])[:, ordered_real(sd)], float(out[3])


def _poisoned(fn, value_mask, keep=()):
    """fn with NaN written into every output tensor [..., n] at the cells
    where value_mask is 0, but the outputs numbered in `keep` (PK3's okp:
    the kernel writes the flag on every cell, 1 off the real nodes)."""
    dead = value_mask == 0

    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        for i, t in enumerate(out if isinstance(out, tuple) else (out,)):
            if (i not in keep and torch.is_tensor(t) and t.ndim
                    and t.shape[-1] == dead.numel()):
                t[..., dead] = float("nan")
        return out

    return wrapped


@functools.lru_cache(maxsize=None)
def port_run(slabs, orchestration, poison=False):
    """(U by vertex, tau, warnings, U [C, n] on the whole canvas) of the
    port: the plain path or the kernels' orchestration, with `poison` NaN
    at the value_mask 0 cells after every refresh and in every kernel
    output."""
    sd = port_sd(slabs)
    hm = HyperbolicModule(Euler(dim=2), sd, _init, dtype=torch.float64,
                          device="cpu")
    mod = CanvasSteps(hm) if orchestration == "canvas" else hm
    ti = TimeIntegrator(mod, "erk 33", cfl_min=CFL, cfl_max=CFL,
                        cfl_recovery_strategy="none")
    U0 = torch.as_tensor(_perturbed(interpolate_nodal(
        _init, sd, hm.eq, 0.0, torch.float64, "cpu").numpy(), sd))
    saved = {}
    if poison:
        vm = hm.canvas.arrays.g_node[4].reshape(-1)
        st = hm.canvas.stencil

        def refresh(st_, *arrays, **kwargs):
            saved["refresh"](st_, *arrays, **kwargs)
            for X in arrays:
                if X is not None:
                    X[..., vm == 0] = float("nan")

        refresh.launches = 0
        saved["refresh"] = canvas_step.refresh
        names = ("pk1", "pk2", "pk3", "pk_up")
        for name in names:
            saved[name] = getattr(canvas_step, name)
            setattr(canvas_step, name, _poisoned(
                saved[name], vm, keep=(2,) if name == "pk3" else ()))
        canvas_step.refresh = refresh
        assert st.slab_spec is not None or slabs == 1
    try:
        out = ti.advance(U0, 0.0, STEPS)
    finally:
        for name, fn in saved.items():
            setattr(canvas_step, name, fn)
    return (out[0].numpy()[:, ordered_real(sd)], float(out[3]), int(out[5]),
            out[0].numpy())


@pytest.mark.parametrize("orchestration", ["plain", "canvas"])
@pytest.mark.parametrize("slabs", [2, 4])
def test_slabs_match_jax_and_the_plain_canvas(slabs, orchestration):
    sd = port_sd(slabs)
    n_sl, Ls, g = sd.slab_spec
    assert n_sl == slabs and sd.shape[0] == slabs * (Ls + 2 * g)
    got, tau, warns, _ = port_run(slabs, orchestration)
    want, tau_want = jax_run(slabs)
    assert warns == 0
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    assert abs(tau / tau_want - 1.0) <= 1e-12
    one, tau_one, _, _ = port_run(1, "plain")
    # per-cell arithmetic does not depend on the row: bit-equal
    np.testing.assert_array_equal(got, one)
    assert tau == tau_one


@pytest.mark.parametrize("slabs", [2, 4])
def test_nan_in_never_refreshed_rows_stays_out(slabs):
    """NaN in every value_mask 0 cell (the pad rows and the outermost slab
    bands) after every refresh and in every kernel output: the kernels'
    plain twins select on the mask wherever a neighbour value enters, so
    every real node stays finite and equal to the run without NaN."""
    sd = port_sd(slabs)
    vm = sd.value_mask.reshape((slabs, -1) + sd.shape[1:])
    g = sd.slab_spec[2]
    assert (vm[0, :g] == 0).all() and (vm[-1, -g:] == 0).all()
    got, tau, warns, full = port_run(slabs, "canvas", poison=True)
    want, tau_want, _, _ = port_run(slabs, "canvas")
    assert np.isnan(full).any()
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)
    assert tau == tau_want and warns == 0


def _hand_built(name):
    """A StructuredData whose ghosts are one row narrower than the reach
    (reach 1): a periodic band of 0 rows, slab bands of 0 rows, a minor
    wrap with one ghost column."""
    if name == "band":
        mesh = geometry.rectangular_domain(
            [-5, -5], [5, 5], [1, 1], refinement=2,
            boundary_conditions=[Boundary.periodic] * 4)
        sd = structured.pack_structured(assembly.assemble(mesh), mesh)
        g, P = sd.ghosts[0]
        return dataclasses.replace(sd, ghosts=((0, P), None)), "canvas axis 0"
    if name == "slab":
        sd = port_sd(2)
        n, Ls, g = sd.slab_spec
        return dataclasses.replace(sd, slab_spec=(n, Ls, 0)), "canvas axis 0"
    mesh = geometry.cylinder(refinement=2)
    sd = structured.pack_structured(assembly.assemble(mesh), mesh)
    P, W = sd.minor_wrap
    return dataclasses.replace(sd, minor_wrap=(W - 1, W)), "minor canvas axis"


@pytest.mark.parametrize("name", ["band", "slab", "minor wrap"])
def test_ghosts_narrower_than_the_reach_raise(name):
    sd, axis = _hand_built(name)
    with pytest.raises(ValueError, match=axis):
        HyperbolicModule(Euler(dim=2), sd, _init, dtype=torch.float64,
                         device="cpu")


def test_multi_block_still_refused():
    """The extruded multi-block quilt (its z-vectorized refresh maps) is
    the canvas the torch stencil still refuses."""
    sd = dataclasses.replace(port_sd(1), gmap_node_z=(np.zeros(1, np.int64),
                                                      np.zeros(1, np.int64)))
    with pytest.raises(NotImplementedError, match="extruded multi-block"):
        HyperbolicModule(Euler(dim=2), sd, _init, dtype=torch.float64,
                         device="cpu")
