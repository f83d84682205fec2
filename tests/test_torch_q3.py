"""The higher-order canvases of tests/test_ansatz_canvas.py in the port,
float64 on the CPU: cG Q3 (reach 3, K = 48) on the 2 x 1 rectangle with
dirichlet sides phase by phase against the JAX package, and three ERK33
steps of cG Q3 and of the periodic cG Q2, dG Q1 and dG Q2 canvases (ghost
bands and a minor wrap at reach 2 and 3) against JAX's XLA canvas path at
relative 1e-10 / absolute 1e-12 (test_ansatz_canvas.py:101-108), by the
port's plain path and its kernels' orchestration; and pk_up's K = 48
launch within the card's shared memory.
"""

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
from ryujin_tpu.offline.mesh import Boundary as JBoundary  # noqa: E402
from ryujin_tpu.postprocess.error import (  # noqa: E402
    interpolate_nodal as j_interpolate_nodal,
)
from ryujin_tpu.solver import hyperbolic as jhyp  # noqa: E402
from ryujin_tpu.solver.integrator import (  # noqa: E402
    TimeIntegrator as JTimeIntegrator,
)

from ryujin_tpu_torch.equations.euler import Euler  # noqa: E402
from ryujin_tpu_torch.kernels import build, pk_up  # noqa: E402
from ryujin_tpu_torch.offline import (  # noqa: E402
    assembly, geometry, structured,
)
from ryujin_tpu_torch.offline.mesh import Boundary  # noqa: E402
from ryujin_tpu_torch.solver.hyperbolic import HyperbolicModule  # noqa: E402
from ryujin_tpu_torch.solver.integrator import TimeIntegrator  # noqa: E402

from test_torch_periodic import (  # noqa: E402
    PHASES, CanvasSteps, check_phase, jax_substep, ordered_real,
    port_substep,
)

CFL = 0.3


def _mesh2d(G, B, periodic):
    """tests/test_ansatz_canvas.py:28-34 at refinement 2."""
    bcs = [B.periodic] * 4 if periodic else [B.dirichlet] * 4
    return G.rectangular_domain([0, 0], [2, 1], [2, 1], 2,
                                boundary_conditions=bcs)


def _j_init(x, t):
    """tests/test_ansatz_canvas.py:57-65 (JAX)."""
    rho = 1.0 + 0.1 * jnp.sin(2 * np.pi * x[0]) * jnp.cos(np.pi * x[1])
    return jnp.stack([rho, 0.2 * rho, -0.1 * rho, 1.0 / 0.4 + 0.5 * 0.05 * rho],
                     0)


def _init(x, t):
    rho = 1.0 + 0.1 * torch.sin(2 * np.pi * x[0]) * torch.cos(np.pi * x[1])
    return torch.stack([rho, 0.2 * rho, -0.1 * rho,
                        1.0 / 0.4 + 0.5 * 0.05 * rho], 0)


@functools.lru_cache(maxsize=None)
def case(ansatz, periodic):
    """(JAX sd, JAX eq, U0 [C, n], port sd, port module)."""
    jmesh = _mesh2d(j_geometry, JBoundary, periodic)
    jsd = j_structured.pack_structured(
        j_assembly.assemble(jmesh, ansatz=ansatz), jmesh)
    mesh = _mesh2d(geometry, Boundary, periodic)
    sd = structured.pack_structured(assembly.assemble(mesh, ansatz=ansatz),
                                    mesh)
    jeq = JEuler(dim=2)
    U0 = np.array(j_interpolate_nodal(_j_init, jsd, jeq, 0.0, jnp.float64))
    hm = HyperbolicModule(Euler(dim=2), sd, _init, dtype=torch.float64,
                          device="cpu")
    return jsd, jeq, U0, sd, hm


@functools.lru_cache(maxsize=None)
def q3_phases():
    jsd, jeq, U0, _, hm = case("cG Q3", False)
    ref, half = jax_substep(jsd, jeq, _j_init, U0, CFL)
    return ref, port_substep(hm, ref, half, CFL)


def test_q3_canvas_layout():
    jsd, _, _, sd, hm = case("cG Q3", False)
    assert sd.max_degree == 48 and sd.reach == 3 and hm.canvas.stream
    assert sd.shape == jsd.shape
    np.testing.assert_array_equal(sd.mask, jsd.mask)


@pytest.mark.parametrize("phase", PHASES)
def test_q3_phase_matches_jax(phase):
    ref, got = q3_phases()
    check_phase(case("cG Q3", False)[0], ref, got, phase)


@functools.lru_cache(maxsize=None)
def jax_steps(ansatz, periodic):
    jsd, jeq, U0, _, _ = case(ansatz, periodic)
    jhm = jhyp.HyperbolicModule(jeq, jsd, _j_init, dtype=jnp.float64)
    jti = JTimeIntegrator(jhm, "erk 33", cfl_min=CFL, cfl_max=CFL,
                          cfl_recovery_strategy="none")
    out = jti.advance(jnp.asarray(U0), 0.0, 3)
    return np.asarray(out[0])[:, ordered_real(jsd)], float(out[3])


@pytest.mark.parametrize("orchestration", ["plain", "canvas"])
@pytest.mark.parametrize("ansatz,periodic", [
    ("cG Q3", False), ("cG Q2", True), ("dG Q1", True), ("dG Q2", True),
])
def test_three_steps_match_jax(ansatz, periodic, orchestration):
    _, _, U0, sd, hm = case(ansatz, periodic)
    if periodic:
        assert any(g is not None for g in sd.ghosts)
        assert sd.minor_wrap is not None
    mod = CanvasSteps(hm) if orchestration == "canvas" else hm
    ti = TimeIntegrator(mod, "erk 33", cfl_min=CFL, cfl_max=CFL,
                        cfl_recovery_strategy="none")
    out = ti.advance(torch.as_tensor(U0), 0.0, 3)
    want, tau_want = jax_steps(ansatz, periodic)
    got = out[0].numpy()[:, ordered_real(sd)]
    assert int(out[5]) == 0
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)
    assert abs(float(out[3]) / tau_want - 1.0) < 1e-12


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pk_up_k48_tile_fits(dtype):
    """PK4's K = 48 launch: a row of 32 cells, one warp a component, its
    shared arrays (csrc/pk_up.cu pk_up_smem: P, l_sym, U' and the live
    flags) within the card's shared memory, above the 48 KB of static
    shared memory in f64, so the kernel takes them dynamically; PK5 none."""
    shape = (264, 768)
    t = pk_up.tile(shape, 48, dtype)
    item = torch.empty((), dtype=dtype).element_size()
    assert t.block == (32, 4, 1)
    assert t.smem == (4 * 48 + 48 + 4) * 32 * item + 48 * 32
    assert t.smem <= build.SMEM_MAX
    assert (t.smem > 48 * 1024) == (dtype == torch.float64)
    assert t.grid == (768 // 32, 264, 1)
    assert pk_up.tile(shape, 48, dtype, last=True).smem == 0
    assert (2, 48) in pk_up.INSTANCES
