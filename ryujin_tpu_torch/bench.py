"""Throughput of the port on the Euler Mach-3 flows of bench.py.

    python -m ryujin_tpu_torch.bench
    BENCH_CASE=q2step2d python -m ryujin_tpu_torch.bench
    BENCH_CASE=box3d python -m ryujin_tpu_torch.bench
    BENCH_CASE=dg1box3d python -m ryujin_tpu_torch.bench
    BENCH_CASE=cylinder3d RYUJIN_SEP=1 python -m ryujin_tpu_torch.bench
    BENCH_CASE=amr2d python -m ryujin_tpu_torch.bench

Runs the five cases of bench.py and a dG form of the third on a CUDA
device, in f32 with ERK33 through the CUDA kernels:

  step2d    (default) cG Q1, refinement 3, CFL 0.9, cfl_recovery_strategy
            "none", 1500-step warmup; metric euler2d_mach3_step_throughput
  q2step2d  cG Q2 (reach-2 canvas, K = 24, the slot-streaming kernels),
            refinement 2, CFL 0.9 / 0.45 with "bang bang control",
            1000-step warmup; metric euler2d_mach3_step_cgq2
  box3d     3D, cG Q1 on the box [0, 3] x [0, 1] x [0, 1] (31 x 16 x 16
            cells, refinement 2; inflow dirichlet, outflow do_nothing, slip
            walls), a (D, H, W) canvas with K = 26 and the slot-streaming
            kernels on the two-direction Riemann route, CFL 0.9 / 0.45
            with "bang bang control", 1000-step warmup; metric
            euler3d_mach3_box_throughput
  dg1box3d  box3d with the ansatz switched to dG Q1 at refinement 1
            (507,904 dofs on the same (72, 72, 128) canvas, K = 26, the
            incidence beta_ij in PK2 / PK3, the two-direction route);
            1000-step warmup; metric euler3d_mach3_box_dgq1_throughput.
            Its host assembly takes a minute or more (numpy).
  cylinder3d  3D, cG Q1 on bench.py's cylinder (bench.py:86-103): the
            o-grid around a cylinder extruded along z, refinement 3,
            packed with z and y margins of 2 onto a (72, 40, 128) canvas
            (274,560 real nodes, K = 26) whose minor axis is the periodic
            angle, exactly 128 wide; uniform Mach-3 inflow along x,
            Galilei-shifted to x = 1; the two-direction route, CFL
            0.9 / 0.45 with "bang bang control", 1000-step warmup; metric
            euler3d_mach3_cylinder_throughput.
  amr2d     2D, cG Q1 on bench.py's locally refined square (bench.py:
            106-126): [-5, 5]^2 at refinement 9 with dirichlet on all four
            sides, the cells whose centre has |x|, |y| < 2 refined once
            more (2:1 hanging nodes along the interface), packed as a
            multi-block canvas (offline/multiblock.py: the blocks of the
            decomposition split where sparse, the coarse/fine interface
            rows as extraordinary-vertex side rows); uniform Mach-3 flow
            (1.4, 3.0, 1.0), the two-direction route, CFL 0.9 / 0.45 with
            "bang bang control", 1000-step warmup; metric
            euler2d_amr_adapted_throughput.
            Its host packing is numpy with Python loops: see the setup
            line.
  annulus2d not a case of bench.py: the annulus obstacle
            (geometry.annulus, slip walls) at refinement 3 packed as
            amr2d is, a block quilt without side rows, so that
            RYUJIN_SYM_MB=1 can time the half-slot route against the
            default two-direction one; metric
            euler2d_annulus_multiblock_throughput.

RYUJIN_SEP=1 runs a 3D cG case with separable statics (the kernels'
SEP instances; the full static canvases are not allocated), "0" (the
default) with the full canvases; any other value is refused, and so is
"1" on a case whose canvas does not factor (2D, dG).  RYUJIN_SYM_MB=1
runs a multi-block case on its half-slot route (HyperbolicModule's
sym_mb), "0" (the default) on the two-direction route; it is refused
where the canvas has no half-slot route (amr2d: its side rows).

Prints one JSON line {"metric", "value", "unit", "vs_baseline",
"statics"} (+ "reps" with BENCH_REPS > 1), where value is MQ/s = real
nodes x substeps / wall seconds / 1e6, and, on standard error, a "setup"
line with the seconds of mesh, assembly, packing and statics (the
factoring of the separable statics among them, also printed on its
own).  The same BENCH_* variables as bench.py set the sizes:
BENCH_REFINEMENT, BENCH_WARMUP (steps, so the bow shock spans the domain
and the limiter works everywhere), BENCH_STEPS (20 timed steps), and
BENCH_REPS (1).
"""

from __future__ import annotations

import json
import os
import sys
import time

import torch

import numpy as np

from .offline import assembly, ell, geometry, multiblock, structured
from .offline.mesh import Boundary, refine_local

from .equations.euler import Euler
from .equations.euler_initial_states import make_initial_state
from .postprocess.error import interpolate_nodal
from .solver.hyperbolic import HyperbolicModule
from .solver.integrator import TimeIntegrator

BASELINE_MQS = 100.0  # bench.py's north-star constant, not a measurement


def separable_from_env(environ=os.environ) -> bool:
    """RYUJIN_SEP: "1" for separable statics, "0" or unset for the full
    canvases; any other value raises ValueError."""
    value = environ.get("RYUJIN_SEP", "0")
    if value not in ("0", "1"):
        raise ValueError(f"RYUJIN_SEP={value!r}: expected '0' or '1'")
    return value == "1"


def sym_mb_from_env(environ=os.environ) -> bool:
    """RYUJIN_SYM_MB: "1" for a multi-block canvas's half-slot route, "0"
    or unset for its two-direction route; any other value raises
    ValueError."""
    value = environ.get("RYUJIN_SYM_MB", "0")
    if value not in ("0", "1"):
        raise ValueError(f"RYUJIN_SYM_MB={value!r}: expected '0' or '1'")
    return value == "1"


def _modules(eq, sd, init, dtype, device, recovery, separable, **kw):
    """(hm, ti, U0) of a case: the hyperbolic module, ERK33 at CFL
    0.9 / 0.45 with `recovery`, and the interpolated initial state."""
    hm = HyperbolicModule(eq, sd, init, dtype=dtype, device=device,
                          separable=separable, **kw)
    ti = TimeIntegrator(hm, "erk 33", cfl_min=0.45, cfl_max=0.9,
                        cfl_recovery_strategy=recovery)
    U0 = interpolate_nodal(init, sd, eq, 0.0, dtype, device)
    return hm, ti, U0


def _build_step(refinement: int, dtype, device, ansatz: str, recovery: str,
                separable: bool):
    """(eq, sd, hm, ti, U0) on the Mach-3 step: uniform inflow."""
    eq = Euler(dim=2)
    mesh = geometry.step(refinement=refinement)
    sd = structured.pack_structured(
        assembly.assemble(mesh, ansatz=ansatz), mesh
    )
    init = make_initial_state(eq, "uniform", primitive_state=(1.4, 3.0, 1.0))
    return (eq, sd) + _modules(eq, sd, init, dtype, device, recovery,
                               separable)


def build_step2d(refinement: int, dtype, device, separable: bool = False):
    """(eq, sd, hm, ti, U0) of the step2d case: cG Q1, no CFL recovery."""
    return _build_step(refinement, dtype, device, "cG Q1", "none", separable)


def build_q2step2d(refinement: int, dtype, device, ansatz: str = "cG Q2",
                   separable: bool = False):
    """(eq, sd, hm, ti, U0) of the q2step2d case: a higher-order ansatz on
    the node lattice (cG Q2: reach 2, K = 24) with bang-bang recovery."""
    return _build_step(refinement, dtype, device, ansatz, "bang bang control",
                       separable)


def build_q3step2d(refinement: int, dtype, device, separable: bool = False):
    """(eq, sd, hm, ti, U0) of the step in cG Q3 (reach 3, K = 48: the
    slot-streaming kernels and pk_up's K = 48 instance) with bang-bang
    recovery, as build_q2step2d."""
    return _build_step(refinement, dtype, device, "cG Q3",
                       "bang bang control", separable)


def build_periodic_vortex(refinement: int, dtype, device,
                          separable: bool = False):
    """(eq, sd, hm, ti, U0) of the fully periodic isentropic vortex of the
    JAX package's ghost-canvas test (tests/test_pallas.py:24-41): [-5, 5]^2
    periodic on all four sides, the vortex moving along (1, 1) from
    (0, 0), Mach 1, beta 5, cG Q1 packed with pack_structured's defaults
    (a y ghost band of 8 rows; the x period 2^refinement padded to 128
    with a minor wrap below refinement 7), ERK33 at CFL 0.3 with recovery
    "none"."""
    eq = Euler(dim=2)
    mesh = geometry.rectangular_domain(
        [-5.0, -5.0], [5.0, 5.0], [1, 1], refinement=refinement,
        boundary_conditions=[Boundary.periodic] * 4,
    )
    sd = structured.pack_structured(assembly.assemble(mesh), mesh)
    init = make_initial_state(eq, "isentropic vortex", direction=[1, 1],
                              position=[0, 0], mach_number=1.0, beta=5.0)
    hm = HyperbolicModule(eq, sd, init, dtype=dtype, device=device,
                          separable=separable)
    ti = TimeIntegrator(hm, "erk 33", cfl_min=0.3, cfl_max=0.3,
                        cfl_recovery_strategy="none")
    return eq, sd, hm, ti, interpolate_nodal(init, sd, eq, 0.0, dtype, device)


def build_periodic_box3d(refinement: int, dtype, device,
                         subdiv=(2, 2, 2), separable: bool = False):
    """(eq, sd, hm, ti, U0) of a fully periodic 3D box: [0, 1]^3 with
    `subdiv` cells before `refinement`, [Boundary.periodic] * 6, cG Q1
    packed with z and y margins of 2 (ghost bands of 2 planes and 2 rows)
    and the x period padded to 128 (a minor wrap), a uniform flow along
    (1, 0.5, 0.25) at speed 1 with its density and energy times a smooth
    bump 1 + 0.25 exp(-8 |x - (0.5, 0.5, 0.5)|^2); ERK33 at CFL 0.9 /
    0.45 with bang-bang recovery."""
    eq = Euler(dim=3)
    mesh = geometry.rectangular_domain(
        [0.0, 0.0, 0.0], [1.0, 1.0, 1.0], list(subdiv),
        refinement=refinement, boundary_conditions=[Boundary.periodic] * 6,
        dim=3,
    )
    sd = structured.pack_structured(assembly.assemble(mesh), mesh,
                                    margin=(2, 2))
    init = make_initial_state(eq, "uniform", direction=[1.0, 0.5, 0.25],
                              primitive_state=(1.4, 1.0, 1.0))
    hm, ti, U0 = _modules(eq, sd, init, dtype, device, "bang bang control",
                          separable)
    pos = torch.as_tensor(sd.positions.T, dtype=dtype, device=device)
    bump = 1.0 + 0.25 * torch.exp(-8.0 * torch.sum((pos - 0.5) ** 2, 0))
    U0[0] *= bump
    U0[-1] *= bump
    return eq, sd, hm, ti, U0


def build_box3d(refinement: int, dtype, device, subdiv=(31, 16, 16),
                ansatz: str = "cG Q1", separable: bool = False):
    """(eq, sd, hm, ti, U0) of the box3d case (bench.py:60-82): 3D Euler,
    uniform Mach-3 inflow on [0, 3] x [0, 1] x [0, 1] with `subdiv` cells
    before `refinement`, `ansatz` (cG Q1, or dG Q1 for dg1box3d) packed
    with z and y margins of 2, bang-bang recovery.  (The JAX bench packs
    with the TPU kernels' margin gate, which is not carried over.)"""
    eq = Euler(dim=3)
    mesh = box3d_mesh(refinement, subdiv)
    sd = structured.pack_structured(
        assembly.assemble(mesh, ansatz=ansatz), mesh, margin=(2, 2)
    )
    init = make_initial_state(eq, "uniform", primitive_state=(1.4, 3.0, 1.0))
    return (eq, sd) + _modules(eq, sd, init, dtype, device,
                               "bang bang control", separable)


def box3d_mesh(refinement: int, subdiv=(31, 16, 16)):
    """The box3d domain: [0, 3] x [0, 1] x [0, 1] with `subdiv` cells
    before `refinement`; inflow dirichlet, outflow do_nothing, slip
    walls."""
    return geometry.rectangular_domain(
        [0.0, 0.0, 0.0], [3.0, 1.0, 1.0], list(subdiv),
        refinement=refinement,
        boundary_conditions=[
            Boundary.dirichlet, Boundary.do_nothing,
            Boundary.slip, Boundary.slip, Boundary.slip, Boundary.slip,
        ],
        dim=3,
    )


def build_dg1box3d(refinement: int, dtype, device, subdiv=(31, 16, 16),
                   separable: bool = False):
    """(eq, sd, hm, ti, U0) of the dg1box3d case: box3d's flow, domain,
    boundary conditions, packing and recovery with the dG Q1 ansatz."""
    return build_box3d(refinement, dtype, device, subdiv, ansatz="dG Q1",
                       separable=separable)


def build_cylinder3d(refinement: int, dtype, device, pad_minor: int = 128,
                     separable: bool = False):
    """(eq, sd, hm, ti, U0) of the cylinder3d case (bench.py:86-103): 3D
    Euler, uniform Mach-3 inflow along x Galilei-shifted to x = 1, on the
    cylinder o-grid extruded along z at `refinement`, cG Q1 packed with z
    and y margins of 2, bang-bang recovery.  The minor canvas axis is the
    periodic angle: 128 cells at refinement 3, so pad_minor = 128 keeps it
    exact and the canvas's roll is the periodic wrap; at refinement 1 the
    angle has 32 cells: pad_minor = 32 packs it exactly, the default pads
    it to 128 with a minor wrap (two ghost columns)."""
    eq = Euler(dim=3)
    mesh = geometry.cylinder(refinement=refinement, dim=3)
    sd = structured.pack_structured(
        assembly.assemble(mesh), mesh, pad_minor=pad_minor, margin=(2, 2)
    )
    init = make_initial_state(
        eq, "uniform", direction=[1, 0, 0], position=[1, 0, 0],
        primitive_state=(1.4, 3.0, 1.0),
    )
    return (eq, sd) + _modules(eq, sd, init, dtype, device,
                               "bang bang control", separable)


def amr2d_mesh(refinement: int):
    """bench.py's locally refined square (bench.py:106-126): [-5, 5]^2 at
    `refinement` with dirichlet on all four sides, the cells whose centre
    has |x|, |y| < 2 refined once more (mesh.refine_local: 2:1 hanging
    nodes)."""
    mesh = geometry.rectangular_domain(
        [-5.0, -5.0], [5.0, 5.0], [1, 1], refinement=refinement,
        boundary_conditions=[Boundary.dirichlet] * 4,
    )
    centers = mesh.vertices[mesh.cells].mean(axis=1)
    mesh, _ = refine_local(mesh, (np.abs(centers) < 2.0).all(axis=1))
    return mesh


# The amr2d canvas's padding: its width is a multiple of 32 cells, the
# x extent of a tile of the staged kernels (csrc/staged.cuh TILE_TX) and
# of pk_up's rows, and its height of 8 rows; the JAX bench's 128-lane
# width (the TPU's vreg) is not carried over (ROADMAP "Not carried over").
# The shelf layout tries widths in steps of pad_minor, so the narrower
# step also packs the blocks tighter.
AMR_PAD_MINOR, AMR_PAD_MAJOR = 32, 8


def pack_amr2d(mesh, pad_minor: int = AMR_PAD_MINOR,
               pad_major: int = AMR_PAD_MAJOR):
    """The multi-block canvas of a 2D mesh as bench.py packs amr2d's: the
    mesh assembled in cG Q1, the blocks of multiblock.decompose split
    where sparse."""
    data = assembly.assemble(mesh)
    blocks = multiblock.split_sparse_blocks(multiblock.decompose(mesh))
    return multiblock.pack_multiblock(data, mesh, pad_minor=pad_minor,
                                      pad_major=pad_major, blocks=blocks)


def build_amr2d(refinement: int, dtype, device, separable: bool = False,
                sym_mb: bool = False):
    """(eq, sd, hm, ti, U0) of the amr2d case (bench.py:106-126): 2D Euler,
    uniform Mach-3 flow (1.4, 3.0, 1.0) on amr2d_mesh(refinement), cG Q1
    on its multi-block canvas, ERK33 at CFL 0.9 / 0.45 with bang-bang
    recovery (bench.py:160-165); `sym_mb` asks for the half-slot route,
    which this canvas, with side rows, does not have (ValueError)."""
    eq = Euler(dim=2)
    sd = pack_amr2d(amr2d_mesh(refinement))
    init = make_initial_state(eq, "uniform", primitive_state=(1.4, 3.0, 1.0))
    return (eq, sd) + _modules(eq, sd, init, dtype, device,
                               "bang bang control", separable, sym_mb=sym_mb)


def build_annulus2d(refinement: int, dtype, device, separable: bool = False,
                    sym_mb: bool = False):
    """(eq, sd, hm, ti, U0) of a block quilt without side rows, where a
    multi-block canvas has both Riemann routes: the annulus obstacle of
    geometry.annulus (slip walls) at `refinement`, packed as amr2d packs,
    the uniform Mach-3 flow (1.4, 3.0, 1.0), ERK33 at CFL 0.9 / 0.45 with
    bang-bang recovery; `sym_mb` the half-slot route with the interface
    fixup.  Not a case of bench.py: it times the route choice."""
    eq = Euler(dim=2)
    sd = pack_amr2d(geometry.annulus(refinement=refinement))
    init = make_initial_state(eq, "uniform", primitive_state=(1.4, 3.0, 1.0))
    return (eq, sd) + _modules(eq, sd, init, dtype, device,
                               "bang bang control", separable, sym_mb=sym_mb)


def build_ell(mesh, dtype, device, ansatz: str = "cG Q1",
              recovery: str = "bang bang control", speed: float = 3.0,
              pad_to: int = 8):
    """(eq, packed, hm, ti, U0) of `mesh` assembled in `ansatz` and packed
    as padded ELL (offline/ell.pack with `pad_to`: the gather path,
    solver/ell_step.py), the uniform inflow of density 1.4, velocity
    `speed` along x and pressure 1, ERK33 at CFL 0.9 / 0.45 with
    `recovery`."""
    eq = Euler(dim=mesh.dim)
    packed = ell.pack(assembly.assemble(mesh, ansatz=ansatz), pad_to=pad_to)
    init = make_initial_state(eq, "uniform",
                              primitive_state=(1.4, speed, 1.0))
    return (eq, packed) + _modules(eq, packed, init, dtype, device, recovery,
                                   False)


def ell_case(name: str, refinement: int, dtype, device,
             subdiv=(31, 16, 16)):
    """(eq, packed, hm, ti, U0) of a padded-ELL case, ERK33 at CFL 0.9 /
    0.45 with bang-bang recovery: "1D" the shock front's tube
    (shocktube.build_case, K = 2), "2D dG Q1" the Mach-3 step in dG Q1,
    "3D" the box3d domain with `subdiv` cells (K = 26), "airfoil" the
    airfoil (irregular rows) with its far field dirichlet, since the
    dynamic boundary is not ported, and an inflow at speed 0.8, "ragged"
    the Mach-3 step in cG Q1 packed without padding (at refinement 0,
    16,449 rows: no multiple of a block's rows)."""
    if name == "1D":
        from . import shocktube

        eq, _, packed, init, hm = shocktube.build_case(
            shocktube.CASES["shock front"], refinement, dtype, device)
        ti = TimeIntegrator(hm, "erk 33", cfl_min=0.45, cfl_max=0.9,
                            cfl_recovery_strategy="bang bang control")
        U0 = interpolate_nodal(init, packed, eq, 0.0, dtype, device)
        return eq, packed, hm, ti, U0
    if name == "2D dG Q1":
        return build_ell(geometry.step(refinement=refinement), dtype, device,
                         ansatz="dG Q1")
    if name == "3D":
        return build_ell(box3d_mesh(refinement, subdiv), dtype, device)
    if name == "ragged":
        return build_ell(geometry.step(refinement=refinement), dtype, device,
                         pad_to=1)
    if name == "airfoil":
        mesh = geometry.airfoil(refinement=refinement)
        mesh.boundary_ids[mesh.boundary_ids == Boundary.dynamic] = (
            Boundary.dirichlet)
        return build_ell(mesh, dtype, device, speed=0.8)
    raise ValueError(f"ELL case {name!r}: expected '1D', '2D dG Q1', '3D', "
                     "'airfoil' or 'ragged'")


# case -> (build_case, default refinement, default warmup steps, metric)
CASES = {
    "step2d": (build_step2d, 3, 1500, "euler2d_mach3_step_throughput"),
    "q2step2d": (build_q2step2d, 2, 1000, "euler2d_mach3_step_cgq2"),
    "box3d": (build_box3d, 2, 1000, "euler3d_mach3_box_throughput"),
    "dg1box3d": (build_dg1box3d, 1, 1000,
                 "euler3d_mach3_box_dgq1_throughput"),
    "cylinder3d": (build_cylinder3d, 3, 1000,
                   "euler3d_mach3_cylinder_throughput"),
    "amr2d": (build_amr2d, 9, 1000, "euler2d_amr_adapted_throughput"),
    "annulus2d": (build_annulus2d, 3, 1000,
                  "euler2d_annulus_multiblock_throughput"),
}


def entry(device=None):
    """(fn, example_args): one IDP substep (prepare + step) on the step
    mesh at refinement 0 in f32, as __graft_entry__.entry().  device=None
    means the card, and raises without one."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "ryujin_tpu_torch.bench.entry needs a CUDA device; pass "
                "device='cpu' to run the plain-torch path"
            )
        device = "cuda"
    dtype = torch.float32
    _, _, hm, _, U0 = build_step2d(0, dtype, device)

    def fn(U, t):
        Up, prec = hm.prepare_state_vector(U, t)
        zero = torch.zeros((), dtype=dtype, device=device)
        cap = torch.full((), float("inf"), dtype=dtype, device=device)
        return hm.step(Up, prec, None, [], zero, 0.9, cap, compute_tau=True)

    return fn, (U0, torch.zeros((), dtype=dtype, device=device))


def main():
    if not torch.cuda.is_available():
        sys.exit("ryujin_tpu_torch.bench needs a CUDA device")
    case = os.environ.get("BENCH_CASE", "step2d")
    if case not in CASES:
        sys.exit(f"BENCH_CASE={case} is not ported (only {sorted(CASES)})")
    build_case, refinement_default, warmup_default, metric = CASES[case]
    refinement = int(os.environ.get("BENCH_REFINEMENT", str(refinement_default)))
    n_steps = int(os.environ.get("BENCH_STEPS", "20"))
    warmup = int(os.environ.get("BENCH_WARMUP", str(warmup_default)))
    reps = int(os.environ.get("BENCH_REPS", "1"))
    separable = separable_from_env()
    kw = {"sym_mb": True} if sym_mb_from_env() else {}

    t0 = time.perf_counter()
    _, sd, hm, ti, U0 = build_case(refinement, torch.float32, "cuda",
                                   separable=separable, **kw)
    print(f"setup {time.perf_counter() - t0:.1f} s: {case}, canvas "
          f"{sd.shape}, {sd.n_nodes} real nodes, K = {sd.max_degree}, "
          f"{'separable' if separable else 'full'} statics (factoring "
          f"{hm.canvas.arrays.factor_seconds:.1f} s)",
          file=sys.stderr, flush=True)
    U, _, t, _, _, _ = ti.advance(U0, 0.0, max(warmup, 2))
    torch.cuda.synchronize()

    mqs_reps = []
    for _ in range(reps):
        t0 = time.perf_counter()
        ti.advance(U, t, n_steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        mqs_reps.append(sd.n_nodes * n_steps * 3 / wall / 1e6)
    mqs = mqs_reps[-1]
    rec = {
        "metric": metric,
        "value": round(mqs, 3),
        "unit": "MQ/s/chip",
        "vs_baseline": round(mqs / BASELINE_MQS, 4),
        "statics": "separable" if separable else "full",
    }
    if reps > 1:
        rec["reps"] = [round(v, 2) for v in mqs_reps]
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
