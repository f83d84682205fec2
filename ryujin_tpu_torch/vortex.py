"""The isentropic vortex of the reference's verification suite on the
port (tests/test_euler_vortex.py:23-45, BASELINE.md).

The case: 2D Euler on [-5, 5]^2, Dirichlet data on all four sides, the
isentropic vortex moving along (1, 1) from (-1, -1) at Mach 1 with
beta 5, cG Q1, CFL 0.2, recovery "none", up to t = 2; the error norms
(L-inf, L1, L2, each normalized and summed over rho, m_1, m_2 and E) of
compute_error.  The JAX test packs the mesh as padded ELL; here it is
packed onto the structured canvas by default (K = 8, half-slot route), so
on a CUDA device the substeps run pk1, pk2, pk3 and pk_up, or, with
layout="ell", as the JAX test packs it (K = 8, two-direction route), so
they run ell_pk1, ell_pk2, ell_pk3 and ell_pk_up.  chip_smoke.py (phases
13 and 14c) runs it on the card, tests/test_torch_vortex.py on the CPU.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Optional, Tuple

import torch

from .equations.euler import Euler
from .equations.euler_initial_states import make_initial_state
from .offline import assembly, ell, geometry, structured
from .offline.mesh import Boundary
from .postprocess.error import compute_error, interpolate_nodal
from .solver.hyperbolic import HyperbolicModule
from .solver.integrator import TimeIntegrator

CFL = 0.2
T_FINAL = 2.0
PAD_MINOR = 16  # the canvas's minor axis: 48 / 80 cells at refinement 5 / 6
CHUNK = 64  # most steps a call of the advance takes
COMPONENTS = ("rho", "m_1", "m_2", "E")
# the committed reference norms at refinement 6 (4,225 dofs), (L-inf, L1,
# L2) by scheme, None where the reference's baseline file is not held:
# prm/verification/euler-isentropic_vortex-{erk33,erk22,ssprk33}.baseline
BASELINES = {
    "erk 33": (5.465e-3, 4.017e-4, 9.442e-4),
    "erk 22": (None, 3.97499e-4, None),
    "ssprk 33": (None, 4.007415406445266e-4, None),
}
# the reference's float32 plateau (BASELINE.md): L1 at refinement 8
F32_PLATEAU_L1 = 2.88e-5


LAYOUTS = ("canvas", "ell")


def build_vortex(refinement: int, dtype, device, layout: str = "canvas"):
    """(eq, mesh, sd, init, hm) of the vortex at `refinement`: the
    [-5, 5]^2 square of 2^refinement cells a side, packed onto a canvas
    whose minor axis is a multiple of PAD_MINOR (layout "canvas"), or as
    padded ELL (layout "ell"; sd is then the EllData)."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout {layout!r} is not one of {LAYOUTS}")
    eq = Euler(dim=2)
    mesh = geometry.rectangular_domain(
        [-5.0, -5.0], [5.0, 5.0], [1, 1], refinement=refinement,
        boundary_conditions=[Boundary.dirichlet] * 4,
    )
    data = assembly.assemble(mesh)
    if layout == "ell":
        sd = ell.pack(data)
    else:
        sd = structured.pack_structured(data, mesh, pad_minor=PAD_MINOR)
    init = make_initial_state(eq, "isentropic vortex", direction=[1, 1],
                              position=[-1, -1], mach_number=1.0, beta=5.0)
    hm = HyperbolicModule(eq, sd, init, dtype=dtype, device=device)
    return eq, mesh, sd, init, hm


@dataclasses.dataclass
class VortexRun:
    """One drive of the vortex: the norms, the steps the time loop took
    and those it asked for (the advance runs, and then discards, the
    steps of a chunk that start at t_final), the warnings they raised,
    the final time and state (prepared), the wall seconds of the time
    loop (device work included), and the case."""

    norms: Tuple[float, float, float]
    steps: int
    requested: int
    warnings: int
    t: float
    seconds: float
    U: torch.Tensor
    sd: object  # the StructuredData or the EllData
    hm: HyperbolicModule


def drive_vortex(refinement: int, scheme: str = "erk 33",
                 dtype=torch.float64, device="cuda",
                 steps_of: Optional[Callable] = None,
                 built=None, layout: str = "canvas") -> VortexRun:
    """The vortex up to T_FINAL through TimeIntegrator.advance in chunks
    of at most CHUNK steps, with t and tau read on the host between
    chunks: a chunk asks for one step more than the remaining time over
    the last step's advance, and the advance stops at T_FINAL inside a
    chunk (TimeIntegrator.advance).
    `steps_of(hm)` may give the integrator another stepper of the same
    module (the plain substep on the card); `built` a build_vortex result
    to reuse; `layout` the packing of a new one (build_vortex)."""
    eq, mesh, sd, init, hm = built or build_vortex(refinement, dtype, device,
                                                   layout)
    ti = TimeIntegrator(steps_of(hm) if steps_of else hm, scheme,
                        cfl_min=CFL, cfl_max=CFL,
                        cfl_recovery_strategy="none")
    U = interpolate_nodal(init, sd, eq, 0.0, dtype, device)
    t = torch.zeros((), dtype=dtype, device=device)
    # the first chunk learns tau
    n, steps, requested, warnings = 2, 0, 0, 0
    if U.is_cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    while t.item() < T_FINAL:
        U, _, t, tau, _, warns = ti.advance(U, t, n, T_FINAL)
        steps += int(ti.steps_taken)
        requested += n
        warnings += int(warns)
        left = (T_FINAL - t.item()) / max(tau.item(), 1e-300)
        n = max(1, min(CHUNK, math.ceil(left) + 1))
    seconds = time.perf_counter() - t0
    norms = compute_error(eq, mesh, sd, U, t.item(), init,
                          components=list(COMPONENTS))
    return VortexRun(norms, steps, requested, warnings, t.item(), seconds, U,
                     sd, hm)
