#!/usr/bin/env python3
"""Quickest proof that the PyTorch / CUDA port runs on a GPU.

    python3 chip_smoke.py            # from the root of a checkout, one card

It drives the port's five canvas paths and the padded-ELL path (phase
14), all in f32 with ERK33: step2d and
q2step2d on the Mach-3 forward-facing step (cG Q1, reach 1, K = 8: pk1,
pk2, pk3, pk_up; cG Q2, reach 2, K = 24: pk1_stream, pk2_stream,
pk3_stream, pk_up), box3d, 3D Euler on the Mach-3 box (cG Q1, K = 26:
the 3D instances of pk1_stream, pk2_stream, pk3_stream and pk_up, on the
two-direction Riemann route), and dg1box3d, the same box with dG Q1
(K = 26: the dG instances of pk2_stream and pk3_stream, which raise the
high-order viscosity factor to the incidence beta_ij), and cylinder3d,
3D Euler around the Mach-3 cylinder (the o-grid extruded along z, cG Q1,
K = 26, two-direction route) in two modes: with the full static canvases
and with separable statics, where the four 3D kernels take their SEP
instances, which synthesize c_ij, m_ij, the mask, c_ii and cmax per
offset from z-profiles and 2D fields.  Phases (each prints its own lines;
any failure exits non-zero):

1. the card (nvidia-smi name and power limit) and the kernel build from
   ryujin_tpu_torch/csrc with nvcc (one process per source, seconds taken),
   with each kernel's registers and stack, and of the tiled kernels the
   block, shared bytes and resident warps of their main-path launch;
2. step2d, refinement 3: every kernel against its plain-torch reference
   on the card, on identical inputs (after a few plain ERK33 steps so the
   bow shock has formed), error beside tolerance, each kernel's time
   beside its reference's and its bound; the stream kernels on the same
   K = 8 canvas beside pk1-pk3, and pk1 bit for bit against pk1_stream
   there (alpha equal, lambda cmax equal to e); the same comparison in
   f64; and three
   ERK33 steps through the kernels against the plain path on the CPU at
   refinement 0 in f64;
3. the step2d slice (1,034,753 real nodes, CFL 0.9, recovery "none")
   through TimeIntegrator.advance: a warmup, then a timed run with the
   launch counters reset just before it; the state must stay finite and
   admissible, tau > 0, no step may warn, and every substep must have
   launched pk1, pk2, pk3 once and pk_up twice.  MQ/s with the kernels
   and with the plain-torch substep on the card;
4. q2step2d, refinement 2: the four kernels of the reach-2 path against
   their plain-torch references on a developed state, in f32 and f64, with
   times and bounds; three ERK33 steps at refinement 0 in f64 through the
   kernels against the plain path; and two steps at cfl_max 3.5 from a
   blast contrast, where every step fails its limiter and is redone at
   cfl_min: the same restarts as the plain path, and the launch counts
   of the redone substeps;
5. the q2step2d slice (CFL 0.9 / 0.45, bang-bang recovery), with the same
   gates; restarts are printed, and every substep, redone ones included,
   must have launched pk1_stream, pk2_stream, pk3_stream once and pk_up
   twice;
6. box3d, refinement 2 (the (72, 72, 128) canvas, K = 26, two-direction
   route): the four 3D kernels against their plain-torch references on a
   state developed through the kernels, with times and bounds; 6b: both
   3D routes (the half-slot route on a 3 x 2 x 2 box, the two-direction
   route on a 7 x 4 x 4 box, refinement 1) in f32 and f64; 6c: three
   ERK33 steps with bang-bang recovery, kernels vs the plain path on the
   card, on both small boxes in f64, with the launch counts; 6d: the SEP
   instances at box3d size on the same state as their full-statics twins
   (times side by side), the synthesized mask's live edges against
   sd.mask's, and the device memory each mode's module holds;
7. the box3d slice (CFL 0.9 / 0.45, bang-bang recovery), with the gates of
   phase 5;
8. the dG Q1 box: dg1box3d's flow, domain and route at 31 x 8 x 8 cells
   before refinement 1 (DG_BOX_SUBDIV: 126,976 dofs on the (40, 40, 128)
   canvas, K = 26, two-direction route, where dg1box3d itself is 31 x 16
   x 16, 507,904 dofs on (72, 72, 128); its route and boundary-pair slot
   count printed; its kernel records carry the size under "case"): the
   four kernels of the path against their plain-torch
   references on a state developed through the kernels from a blast, in
   f32 with times and bounds and in f64; 8b: small dG boxes on both
   routes (refinement 1); 8c: the 2D dG instances (dG Q1, K = 8, stacked;
   dG Q2, K = 24, stream) on the step at refinement 0; both in f32 and
   f64; 8d: three ERK33 steps with bang-bang recovery, kernels vs the
   plain path on the card in f64, on each of those four small canvases,
   with the launch counts;
9. the slice on phase 8's dG Q1 box (CFL 0.9 / 0.45, bang-bang
   recovery), with the gates of phase 5;
10. cylinder3d, refinement 3 (the (72, 40, 128) canvas, its periodic
   angle exactly the minor axis, two-direction route; setup, route and the
   device memory of each mode printed): the four kernels with the full
   statics against their plain-torch references on the state after a few
   hundred steps through them (a developed bow shock), f32, with times and
   bounds; 10b: the SEP instances against their plain versions at that
   size in f32 (timed) and f64, and on the half-slot route on the
   3 x 2 x 2 box and on the cylinder at refinement 1, with the live-edge
   count of each synthesized mask; 10c: three ERK33 steps with bang-bang
   recovery through the SEP instances against the plain path on the card,
   f64, on those two small canvases, with the SEP instances' launch counts,
   and two steps at cfl_max 3.5 from a blast contrast that bang-bang
   recovery redoes at cfl_min (the same restarts as the plain path);
11. the cylinder3d slice with the full statics and (11b) with separable
   statics, with the gates of phase 5; in 11b every launch must be a SEP
   instance's, in 11 none;
12. the measurement probes, rows 11-14 (the counterparts of
   scripts/bench_pow.py, bench_pow_tpu.py, probe_gather.py and
   probe_dma3d.py): each probe's main (python -m
   ryujin_tpu_torch.probes.pow, .gather, .layout3d --MOV both) in-process
   at the scripts' sizes, with the launch counters reset just before and
   read just after; each holds every probe kernel against its plain
   version on the card (gathers, layout sums, the checksums of what
   pk1_shape and moveaxis stage, the fast, Newton and x b pows
   bit-equal; powf, exp2 log2 and sqrt against torch's pow, exp2, log2
   and sqrt within 4 ulp pointwise and 1e-6 relative on the sums)
   and times it with CUDA events (a warm launch, then 20, or the script's
   count, each after an L2 flush where its bytes fit in the 50 MB L2),
   with its plain version, its PyTorch call where one exists, each also
   chained (100 calls in one CUDA graph), and its
   bound (for the pows, the fewest FMA-pipe and MUFU instructions that any
   evaluation executes, from the SASS); then the pow kernels at a ragged
   n, aligned and on an offset view x[1:] (the scalar pointwise
   instance), pointwise and summed with the carry, each at its bar; the
   ELL gather-sum exactly (NaN where its plain version gives NaN) at the
   script's input, an unbanded one, n = 2^20 + 3 and with columns out of
   range, its count of blocks that staged their band equal to
   ell_staged_blocks' (at the script's input, every block); moveaxis,
   both MOV, exactly at P = 24, (20, 9, 20), TD = 1 and 4; pk1_shape
   exactly at (20, 9, 20), TD = 1 and 4, with and without its centre and
   0 to 3 windows; and the lane gather exactly at W = 2047 and on an
   unaligned view at W = 2048, NaN for an index out of range;
13. four stage slots and the isentropic vortex.  13a: the instances of
   PK2 and PK3 that take 3 and 4 stage slots (ERK54's fourth and fifth
   substeps; pk2 and pk3 on step2d's canvas, pk2_stream and pk3_stream
   on those of q2step2d, box3d, the dG Q1 box and cylinder3d with separable
   statics) against their plain versions at the sizes and on the states
   of phases 2-10 in f32, with times and bounds, then on the small
   canvases of phases 2c, 4c, 6c, 8d and 10c in f64, each followed by
   three ERK54 steps through the kernels against the plain path on the
   card with the launch counts.  13b: the isentropic vortex
   (ryujin_tpu_torch.vortex) through the kernels in f64 at refinement 6,
   ERK33, ERK22 and SSPRK33, each norm within 2 % of the reference's
   committed baselines, every substep's launches counted, and steps past
   t_final leaving the state as it was; the other explicit tableaux
   (erk 11, erk 43, erk 54, ssprk 22) at refinement 5, kernels against
   the plain path on the card to 1e-9 on each norm.  13c: the vortex in
   f32 at refinement 8 (66,049 dofs), ERK33: finite, admissible, no
   warning, L1 within twice the reference's f32 plateau (2.88e-5), with
   its wall seconds and steps;
14. the padded-ELL path (solver/ell_step.py: ell_pk1, ell_pk2, ell_pk3
   and ell_pk_up of csrc/ell_step.cu, one thread a row, the two-direction
   wavespeeds).  14a: each kernel against its plain version (the phase
   functions on the ELL stencil) on identical inputs, with the bars
   above: on the Mach-3 step at refinement 3 packed by ell.pack (1.03 M
   rows, f32, after the 200 warmup steps of 14d; timed, with bounds), and
   in f32 and f64 on developed states of the 1D shock front at refinement
   6, the step in dG Q1 at refinement 0, the box3d domain at refinement 1
   (a blast) and the airfoil at refinement 0 (irregular rows), each also
   at 3 and 4 stage slots (ERK54's weights).  14b: 3 ERK33 steps in f64
   through the kernels of each layout on the step at refinement 1: on
   every vertex ELL equals the canvas within rtol 1e-10 / atol 1e-12,
   tau within 1e-12.  14c: the rarefaction tube
   (ryujin_tpu_torch.shocktube) at refinement 6 within 8 % of the
   reference's L1 (the other three run in python -m
   ryujin_tpu_torch.shocktube), and the isentropic vortex through ELL
   (f64, refinement 6, ERK33) within 2 % of the reference's norms, each
   with its launch counts.  14d: the ELL step at refinement 3, f32: 20 timed ERK33 steps
   after 14a's state with the gates of phase 3 and the launch counts set
   to 0 just before, its MQ/s beside phase 3's canvas MQ/s;
15. canvases with ghost rows and cG Q3 (K = 48).  15a, f64, on small
   canvases (each asserted to carry its layout): the fully periodic
   isentropic vortex at refinement 4 (a y ghost band, minor_wrap (16,
   128)), the o-grid cylinder at refinement 2 (minor_wrap (64, 128)),
   cylinder3d at refinement 1 with separable statics (minor_wrap (32,
   128): the SEP instances), a periodic 3D box at refinement 1, the step
   at refinement 0 in 2 and 4 slabs, cG Q3 on the step at refinement 0,
   periodic cG Q2 and dG Q1 on a 2 x 1 rectangle: each kernel against
   its plain version on the refreshed inputs, then 3 ERK33 steps through
   the canvas kernels against the ELL kernels on the same mesh, every
   real vertex within rtol 5e-11 (1e-10 for the higher-order ansatze) /
   atol 1e-12 and tau within 1e-12; on the slab canvases also with NaN
   in every cell no refresh makes valid (value_mask 0) after each
   refresh and in each kernel output (every real node equal to the run
   without), and slabs 2 and 4 against the plain canvas at rtol 1e-12.
   15b: the periodic vortex at refinement 10 (1,048,576 nodes on a
   (1040, 1024) canvas: a y ghost band of 8 rows, the x period the
   canvas's own), 200 ERK33 steps through the kernels in f32, finite,
   admissible, no warning, each conserved total within 1e-5, MQ/s and
   the launches and ghost refreshes a substep; then its four stacked
   kernels against their plain versions at that width in f64 (the bars
   of the other f64 phases) on the state the f32 run reached and the
   state one f64 step later, and, as an account with no gate, where on
   the canvas the f32 pk1's alpha and pk2's F differ from their plain
   versions and from the plain f64 values (rows next to the y seam,
   columns next to the x wrap, elsewhere; seam_report); the step at
   refinement 3 in 4 slabs against 1 after 20 steps, f32; cG Q3 on the
   step at refinement 1, f32: its four kernels against their plain
   versions (timed, pk_up's K = 48 instance among them), then 20 timed
   steps.
Each phase prints its seconds ("[seconds]" lines).

pk_up's two launches a substep, PK4 and PK5 (`last`), are timed, bounded
and counted apart.  The stream PK1's e, the stream PK2's U_low, F and
bounds, the stream PK3's P, l and okp and pk_up's U and l' must be
bit-equal to their plain twins (l and l' in f64 where torch's limiter
rounds as the kernels do), and pk1's alpha and lambda cmax to
pk1_stream's alpha and e on step2d's canvas, beside the tolerances above.

The lines before the last are the kernels' JSON record and the card's
nvidia-smi line; the last line is {"ok": true, "device": {...}}.
Without a CUDA device the script exits non-zero and prints no result.
"""

from __future__ import annotations

import functools
import gc
import json
import subprocess
import sys
import time

import numpy as np
import torch


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


class Clock:
    """Seconds of each phase and in all, printed as each phase ends."""

    def __init__(self):
        self.start = self.last = time.perf_counter()
        self.laps = {}

    def lap(self, label: str):
        now = time.perf_counter()
        self.laps[label] = now - self.last
        print(f"  [seconds] {label}: {now - self.last:.1f} s (in all "
              f"{now - self.start:.1f} s)", flush=True)
        self.last = now


def cache_assembly():
    """Memoize offline.assembly.assemble for the rest of the run, keyed on
    the mesh's arrays and the ansatz: the script assembles the same meshes
    in several phases (the step at refinement 3 in phases 2, 14a and 15b,
    the dG Q1 step in 8c and in 14a in each precision, the small canvases
    of 2c-10c again in 13a), and the numpy assembly of an identical mesh
    is host time that checks nothing new.  The packers only read the
    assembled data."""
    import hashlib

    from ryujin_tpu_torch.offline import assembly

    assemble, cache = assembly.assemble, {}

    def cached(mesh, order_nodes=True, ansatz="cG Q1"):
        h = hashlib.blake2b(digest_size=16)
        for a in (mesh.vertices, mesh.cells, mesh.boundary_faces,
                  mesh.boundary_ids, mesh.periodic_pairs,
                  mesh.structured_index):
            if a is not None:
                h.update(repr(a.shape).encode())
                h.update(np.ascontiguousarray(a).tobytes())
        h.update(repr((mesh.dim, mesh.structured_shape, order_nodes,
                       ansatz)).encode())
        key = h.hexdigest()
        if key not in cache:
            cache[key] = assemble(mesh, order_nodes=order_nodes,
                                  ansatz=ansatz)
        return cache[key]

    assembly.assemble = cached


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


# step2d: refinement, plain ERK33 steps before the kernel comparisons,
# warmup and timed steps of the slice, plain-torch timed steps
REFINEMENT = 3
PLAIN_STEPS = 40
WARMUP = 200
STEPS = 50
PLAIN_TIMED_STEPS = 5
# q2step2d: refinement, steps through the kernels before the comparisons
# (the plain path at K = 24 is slow), warmup and timed steps of the slice,
# plain-torch timed steps
Q2_REFINEMENT = 2
Q2_DEVELOP_STEPS = 150
Q2_WARMUP = 150
Q2_STEPS = 50
Q2_PLAIN_TIMED_STEPS = 2
# box3d: refinement, steps through the kernels before the comparisons,
# warmup and timed steps of the slice, plain-torch timed steps; the small
# boxes of phase 6b/6c (subdivisions at refinement 1) and their steps
# through the kernels before the comparisons
BOX_REFINEMENT = 2
BOX_DEVELOP_STEPS = 150
BOX_WARMUP = 150
BOX_STEPS = 50
BOX_PLAIN_TIMED_STEPS = 2
SMALL_BOXES = (((3, 2, 2), True), ((7, 4, 4), False))  # (subdiv, half-slot)
SMALL_BOX_STEPS = 5
# dg1box3d (box3d with dG Q1): refinement; the small dG boxes of phase 8b
# and 8d (subdivisions at refinement 1) with their Riemann routes; the 2D
# dG ansatze of phase 8c, on the step at refinement 0
DG_BOX_REFINEMENT = 1
# the dG box is box3d's domain with 31 x 8 x 8 cells before refinement
# (the (40, 40, 128) canvas, 126,976 dofs; still the two-direction route):
# the numpy dG assembly of the bench's 31 x 16 x 16 took 107.6 s of the
# script's time
DG_BOX_SUBDIV = (31, 8, 8)
DG_BOX_LABEL = "dG Q1 box " + "x".join(map(str, DG_BOX_SUBDIV))
SMALL_DG_BOXES = (((3, 2, 2), True), ((6, 3, 3), False))
DG_STEP_ANSATZE = ("dG Q1", "dG Q2")
# cylinder3d: refinement, steps through the kernels before the
# comparisons (a developed bow shock), warmup and timed steps of the
# slice in each mode, plain-torch timed steps; the small cylinder of
# phase 10c (refinement 1, its 32-cell periodic angle packed exactly)
CYL_REFINEMENT = 3
CYL_DEVELOP_STEPS = 300
CYL_WARMUP = 150
CYL_STEPS = 50
CYL_PLAIN_TIMED_STEPS = 2
SMALL_CYL_PAD = 32
# launches per kernel timing
REPS = 20
# phase 13: ERK54's substeps of 3 and 4 stage slots; steps through the
# kernels before the f64 comparisons on the small canvases; the vortex:
# refinements of the f64 norms held to the reference's baselines (within
# VORTEX_BAR), of the f64 schemes held to the plain path (within
# VORTEX_PLAIN_BAR), and of the f32 run held to twice the reference's f32
# plateau
WIDE_SLOTS = (3, 4)
WIDE_DEVELOP_STEPS = 5
VORTEX_REFINEMENT = 6
VORTEX_SCHEMES = ("erk 33", "erk 22", "ssprk 33")
VORTEX_BAR = 0.02
VORTEX_PLAIN_REFINEMENT = 4
VORTEX_PLAIN_SCHEMES = ("erk 11", "erk 43", "erk 54", "ssprk 22")
VORTEX_PLAIN_BAR = 1e-9
VORTEX_F32_REFINEMENT = 8
# phase 14: the padded-ELL path.  14a: each kernel against its plain
# version on developed states (ERK33 steps through the kernels with
# bang-bang recovery): the 1D shock front at refinement 6, the step at
# ELL_REFINEMENT (f32 only: the full size), the step in dG Q1 at
# refinement 0, the box3d domain at refinement 1 from a blast, the airfoil
# at refinement 0; 14b: ELL against the canvas on the step at
# ELL_CANVAS_REFINEMENT, f64, ELL_CANVAS_STEPS steps; 14c: the tubes
# ELL_TUBES (the other three stay out for the script's time, python -m
# ryujin_tpu_torch.shocktube runs them: with the shock front the script
# took 722.3 s on one H100 host, above the 638.8 s it may take) and the
# ELL vortex against the reference; 14d: the step at ELL_REFINEMENT in
# f32 through the ELL kernels, ELL_WARMUP + ELL_STEPS timed steps
ELL_REFINEMENT = 3
ELL_DEVELOP_STEPS = 30
ELL_CANVAS_REFINEMENT = 1
ELL_CANVAS_STEPS = 3
ELL_WARMUP = 200
ELL_STEPS = 20
ELL_TUBES = ("rarefaction",)
# phase 15: ghost rows and K = 48.  15a: the small f64 canvases
# (GHOST_CASES) after GHOST_DEVELOP_STEPS steps through the kernels, each
# kernel against its plain version, GHOST_STEPS steps through the canvas
# kernels against the ELL kernels on the same mesh; 15b: the periodic
# vortex at PERIODIC_VORTEX_REFINEMENT in f32 for PERIODIC_VORTEX_STEPS
# steps (each conserved total within CONSERVATION_BAR), the step at
# SLAB_REFINEMENT in 4 slabs against 1 for SLAB_STEPS steps, cG Q3 at
# Q3_REFINEMENT: its kernels on a state after Q3_DEVELOP_STEPS steps, then
# Q3_STEPS timed steps
GHOST_CASES = ("periodic vortex", "cylinder", "SEP cylinder3d",
               "periodic box", "slabs 2", "slabs 4", "q3 step",
               "periodic cG Q2", "periodic dG Q1")
GHOST_DEVELOP_STEPS = 5
GHOST_STEPS = 3
PERIODIC_VORTEX_REFINEMENT = 10
PERIODIC_VORTEX_STEPS = 200
CONSERVATION_BAR = 1e-5
SLAB_REFINEMENT = 3
SLAB_STEPS = 20
Q3_REFINEMENT = 1
Q3_DEVELOP_STEPS = 30
Q3_STEPS = 20

# The limiter's l is decided at roundoff where psi is flat at its root,
# so an ulp of difference in its input state can move one edge by up to
# the Newton bracket width.  pk_up sums l_sym P in another order than
# torch.sum, so its U differs from the reference's by a few ulps and its
# re-limited l' may move such edges (f32, refinement 3: one state moved
# an edge by 1.3e-3).  So l holds "l" on all but a share "l_share" of the
# live edges, and "l_max" on every edge.
TOL_F32 = {"rel": 1e-5, "l": 1e-4, "l_share": 1e-4, "l_max": 5e-3,
           "U": 1e-5}
TOL_F64 = {"rel": 1e-11, "l": 1e-8, "l_share": 0.0, "l_max": 1e-8,
           "U": 1e-11}

# The card's peaks for the bounds (NVIDIA H100 SXM data sheet): device
# memory rate, and the float32 / float64 rates outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}

# Floating-point operations per live edge (and per stage state on it),
# counted from the device functions of csrc/euler.cuh with a
# transcendental as one operation.  2D: a flux tensor 14, a flux
# divergence 4 x 5, the two-rarefaction lambda_max with its precompute 95
# (on half the slots on the half-slot route), the indicator sums 22, the
# bounds accumulation 40, one limiter call with both Newton iterations
# 150.  3D: a flux tensor 24, a flux divergence 5 x 8, lambda_max 99, the
# indicator sums 30, the bounds 46, the limiter 154.
# The separable statics add, per live edge, one multiply for each plane
# they synthesize (PK1: c_ij 3 and the mask; PK2: the same; PK3: + m_ij;
# pk_up: the mask in each of its two loops, PK5 in its one) and, for cmax
# on the half-slot route, the transposed slot's 3 products, 6 squares, 4
# adds, 2 square roots and a max on the half slots.
SEP_EDGE_FLOPS = {"pk1_stream": 4, "pk2_stream": 4, "pk3_stream": 5,
                  "pk_up": 2, "pk_up_last": 1}
SEP_CMAX_FLOPS = 19
# the separable factors each kernel reads, by kind: (2D field planes of
# g_sep2, z-profile rows of f_sepz); solver/stencil.py has the order
SEP_ROWS = {"cij": ((0, 27), (0, 78)), "mij": ((27, 36), (78, 104)),
            "mask": ((36, 45), (104, 130)), "cii": ((45, 48), (130, 133))}
SEP_READS = {"pk1_stream": ("cij", "mask"),
             "pk2_stream": ("cij", "mask", "cii"),
             "pk3_stream": ("cij", "mij", "mask"), "pk_up": ("mask",)}
EDGE_FLOPS = {
    2: {
        "pk1": (14 + 22 + 95 / 2, 0), "pk1_stream": (14 + 22 + 95 / 2 + 0.5, 0),
        "pk2": (14 + 36 + 40, 14 + 24), "pk2_stream": (14 + 36 + 40, 14 + 24),
        "pk3": (14 + 40 + 150, 14 + 24), "pk3_stream": (14 + 40 + 150, 14 + 24),
        "pk_up": (9 + 4 + 150, 0),
        "pk_up_last": (9, 0),  # PK5: the update alone
    },
    3: {
        "pk1_stream": (24 + 30 + 99 / 2 + 0.5, 0),  # two-direction: + 99 / 2
        "pk2_stream": (24 + 60 + 46, 24 + 40),
        "pk3_stream": (24 + 65 + 154, 24 + 40),
        "pk_up": (11 + 5 + 154, 0),
        "pk_up_last": (11, 0),
    },
}
# The ELL kernels (csrc/ell_step.cu) per live edge: ell_pk1 the flux, the
# indicator sums, lambda_max on every slot and its scaling; ell_pk2, ell_pk3
# and ell_pk_up as their canvas counterparts.  1D by the same count: a flux
# tensor 6, a flux divergence 3 x 2, lambda_max 91, the indicator sums 14,
# the bounds 34, the limiter 146.
EDGE_FLOPS[1] = {
    "ell_pk1": (6 + 14 + 91 + 1, 0), "ell_pk2": (6 + 18 + 34, 6 + 9),
    "ell_pk3": (6 + 15 + 146, 6 + 9), "ell_pk_up": (7 + 3 + 146, 0),
    "ell_pk_up_last": (7, 0),
}
EDGE_FLOPS[2].update({
    "ell_pk1": (14 + 22 + 95 + 1, 0), "ell_pk2": EDGE_FLOPS[2]["pk2"],
    "ell_pk3": EDGE_FLOPS[2]["pk3"], "ell_pk_up": EDGE_FLOPS[2]["pk_up"],
    "ell_pk_up_last": EDGE_FLOPS[2]["pk_up_last"],
})
EDGE_FLOPS[3].update({
    "ell_pk1": (24 + 30 + 99 + 1, 0), "ell_pk2": EDGE_FLOPS[3]["pk2_stream"],
    "ell_pk3": EDGE_FLOPS[3]["pk3_stream"], "ell_pk_up": EDGE_FLOPS[3]["pk_up"],
    "ell_pk_up_last": EDGE_FLOPS[3]["pk_up_last"],
})
# The ELL kernels replace no TPU kernel: the JAX package runs the gather
# path in XLA, its phase functions on the Stencil of hyperbolic.py:65
ELL_SOURCE = {
    "ell_pk1": "ryujin_tpu/solver/hyperbolic.py:411",
    "ell_pk2": "ryujin_tpu/solver/hyperbolic.py:912",
    "ell_pk3": "ryujin_tpu/solver/hyperbolic.py:994",
    "ell_pk_up": "ryujin_tpu/solver/hyperbolic.py:1064",
}
# (dim, kernel, on a dG canvas) -> the TPU kernel it replaces
TPU_SOURCE = {
    (2, "pk1", False): "ryujin_tpu/solver/pallas_step.py:2676",
    (2, "pk2", False): "ryujin_tpu/solver/pallas_step.py:2841",
    (2, "pk3", False): "ryujin_tpu/solver/pallas_step.py:3044",
    (2, "pk_up", False): "ryujin_tpu/solver/pallas_step.py:3265",
    (2, "pk1_stream", False): "ryujin_tpu/solver/pallas_step.py:1904",
    (2, "pk2_stream", False): "ryujin_tpu/solver/pallas_step.py:2879",
    (2, "pk3_stream", False): "ryujin_tpu/solver/pallas_step.py:3093",
    # the 3D z-slab path, _step_slab on _tiled_call_3d_slab (:821)
    (3, "pk1_stream", False): "ryujin_tpu/solver/pallas_step.py:1904",
    (3, "pk2_stream", False): "ryujin_tpu/solver/pallas_step.py:2317",
    (3, "pk3_stream", False): "ryujin_tpu/solver/pallas_step.py:2409",
    (3, "pk_up", False): "ryujin_tpu/solver/pallas_step.py:2528",
}
# dG canvases: in 2D the same kernels, PK2 and PK3 with the incidence
# windows (g_inc); in 3D the stacked launcher _tiled_call_3d (:597, its
# pallas_call :801), which runs the _pk1_stream, pk2, pk3 and pk_up
# closures there
TPU_SOURCE.update({(2, k, True): v for (d, k, _), v in TPU_SOURCE.items()
                   if d == 2})
TPU_SOURCE.update({
    (3, k, True): "ryujin_tpu/solver/pallas_step.py:597"
    for k in ("pk1_stream", "pk2_stream", "pk3_stream", "pk_up")
})
# the SEP instances replace _SepTile, the per-offset synthesis inside the
# z-slab closures (_pk1_stream, _step_slab's pk2 / pk3)
SEP_SOURCE = "ryujin_tpu/solver/pallas_step.py:1092"


class PlainSteps:
    """A HyperbolicModule whose substeps run the plain phase functions on
    whatever device the state is on (for the plain-torch comparisons)."""

    def __init__(self, hm):
        self.hm = hm
        self.dtype = hm.dtype
        self.device = hm.device

    def prepare_state_vector(self, U, t):
        return self.hm.prepare_state_vector(U, t)

    def step(self, *args, **kwargs):
        return self.hm.plain_step(*args, **kwargs)


def time_ms(fn, reps):
    """Mean ms of `reps` back-to-back calls of fn after one warm call."""
    from ryujin_tpu_torch import probes

    fn()
    return probes.time_ms(fn, reps, flush=False)


def bound_ms(name, dim, half, inputs, outputs, mask, live_edges, n_stages,
             dtype, inc=None, indices=()):
    """(least ms, "bytes" or "operations", least ms with the mask as
    stored) for one launch: every plane the function needs read once and
    every output written once over the memory rate, against the operations
    on this run's live edges over the peak rate.  `inputs` holds only the
    planes the kernel dereferences.  The edge mask is one bit a slot, so
    the function needs ceil(K / 32) 4-byte planes of it; the kernels read
    it as K planes of the state's type, and the third value is the bound
    with the mask counted so.  `inc`, the K dG incidence planes PK2 and
    PK3 read on a dG canvas, counts the same way where it holds only 0
    and 1 (dG Q1: K bits a cell), else as stored; and one max per live
    edge.  mask=None means separable statics: the mask is among the
    factors in `inputs`, and the synthesis adds its operations.
    `indices`, gather indices held as int64, count 4 bytes an entry: the
    function needs no more, since the kernels take fewer than 2^31 rows
    (build.ell_consts)."""
    nbytes = sum(t.numel() * t.element_size() for t in inputs + outputs)
    nbytes += sum(4 * t.numel() for t in indices)
    per_edge, per_stage = EDGE_FLOPS[dim][name]
    if mask is None:
        mask_bits = mask_stored = 0
        per_edge += SEP_EDGE_FLOPS[name]
        if name == "pk1_stream" and half:
            per_edge += SEP_CMAX_FLOPS / 2
    else:
        K, n = mask.shape[0], mask[0].numel()
        mask_bits = 4 * n * -(-K // 32)
        mask_stored = mask.numel() * mask.element_size()
    if dim == 3 and name == "pk1_stream" and not half:
        per_edge += 99 / 2 + 0.5  # lambda and its scaling on every slot
    if inc is not None:
        stored = inc.numel() * inc.element_size()
        binary = bool(((inc == 0) | (inc == 1)).all())
        mask_bits += mask_bits if binary else stored
        mask_stored += stored
        per_edge += 1
    flops = live_edges * (per_edge + n_stages * per_stage)
    by_ops = flops / PEAK_FLOPS[dtype] * 1e3
    by_bytes = (nbytes + mask_bits) / PEAK_BYTES_PER_S * 1e3
    stored = max((nbytes + mask_stored) / PEAK_BYTES_PER_S * 1e3, by_ops)
    if by_bytes >= by_ops:
        return by_bytes, "bytes", stored
    return by_ops, "operations", stored


def held(name, a, b, where, kind, tol, exact=False):
    """(good, max |a - b|) of kernel output a against reference b on the
    entries where `where` (broadcast to their shape) holds, printed: max
    |a - b| / max |b| against tol["rel"] for kind "rel", max |a - b|
    against tol[kind] otherwise; kind "l" allows the share tol["l_share"]
    of entries beyond tol["l"], none beyond tol["l_max"].  With `exact`
    any difference fails as well."""
    m = where.expand(b.shape)
    a, b = a.reshape(b.shape)[m], b[m]
    diff = (a - b).abs()
    d = diff.max().item() if diff.numel() else 0.0
    finite = bool(torch.isfinite(a).all())
    extra = ""
    if kind == "rel":
        val, lim = d / max(b.abs().max().item() if b.numel() else 0.0,
                           1e-300), tol["rel"]
        good = val <= lim
    elif kind == "l":
        val, lim = d, tol["l"]
        beyond = int((diff > lim).sum())
        good = beyond <= tol["l_share"] * diff.numel() and d <= tol["l_max"]
        extra = (f"  ({beyond} of {diff.numel()} edges beyond tol, "
                 f"allowed {tol['l_share'] * diff.numel():.0f}; "
                 f"cap {tol['l_max']:.0e})")
    else:
        val, lim = d, tol[kind]
        good = val <= lim
    good &= finite
    if exact:
        good &= d == 0.0
        extra += "  (bit-equal required)"
    print(f"  {name:16s} {a.dtype} {kind}-err {val:.3e}  tol {lim:.1e}  "
          f"{'ok' if good else 'FAIL'}{extra}", flush=True)
    return good, d


def alpha_condition(hm, U, prec):
    """kappa_i [n], f64: the condition of the indicator alpha_i =
    |left - sum_c deta_c right_c| / (|left| + sum_c |deta_c right_c| +
    hd_i |eta_i|) (equations/euler.indicator_alpha) in its inputs' rounding:
    S_i over that denominator, S_i the sum of the magnitudes that each of
    its roundings scales, sum_k (|eta_j / rho_j| + |eta_i / rho_i|)
    sum_d |m_j,d c_k,d| + sum_c D_c sum_k sum_d (|f|_j + |f|_i)_c,d
    |c_k,d| over the live slots, where |f| is the flux with every term
    taken in magnitude and p as (gamma - 1)(E + |m|^2 / 2 rho), and D_c
    |deta_c| (|deta_0| + |eta_i / rho_i| for the first).  A smooth flow
    cancels the sums (sum_k c_k = 0), so kappa grows as the mesh is
    refined.  Two evaluations of alpha that each round once an operation
    differ by at most alpha_roundings(K) eps kappa_i to first order."""
    eq, st = hm.eq, hm.canvas.stencil.full()
    g = eq.params.gamma
    U, prec = U.double(), prec.double()
    c, on = st.cij.double(), st.mask > 0

    def fabs(U):
        rho_inv = 1.0 / eq.density(U)
        m = eq.momentum(U).abs()
        v = m * rho_inv[None]
        p = (g - 1.0) * (eq.total_energy(U)
                         + 0.5 * torch.sum(m * m, 0) * rho_inv)
        rows = [m]
        for a in range(eq.dim):
            comps = [m[a] * v[b] for b in range(eq.dim)]
            comps[a] = comps[a] + p
            rows.append(torch.stack(comps, 0))
        rows.append(v * (eq.total_energy(U).abs() + p)[None])
        return torch.stack(rows, 0)

    U_j, prec_j = st.nbr(U), st.nbr(prec)
    s_i = (prec[1] / eq.density(U)).abs()
    s_j = (prec_j[1] / eq.density(U_j)).abs()
    mc = torch.sum(eq.momentum(U_j).abs() * c.abs(), 0)
    left_s = torch.sum(torch.where(on, (s_j + s_i[None]) * mc, 0.0), 0)
    fa_i, fa_j = fabs(U), fabs(U_j)
    right_s = torch.sum(torch.where(
        on[None], torch.sum((fa_j + fa_i[:, :, None]) * c.abs()[None], 1),
        0.0), 1)
    d_eta = eq.harten_entropy_derivative(U)
    D = d_eta.abs()
    D[0] = D[0] + s_i
    S = left_s + torch.sum(D * right_s, 0)
    hd = (st.m_lumped * st.measure_inv).double()
    # the denominator, as indicator_alpha forms it
    d_eta = torch.cat([(d_eta[0] - prec[1] / eq.density(U))[None],
                       d_eta[1:]], 0)
    f_i, f_j = eq.f(U), eq.f(U_j)
    left = torch.sum(torch.where(on, (prec_j[1] / eq.density(U_j)
                                      - (prec[1] / eq.density(U))[None])
                                 * torch.sum(eq.momentum(U_j) * c, 0), 0.0),
                     0)
    right = torch.sum(torch.where(on[None], torch.sum(
        (f_j - f_i[:, :, None]) * c[None], 1), 0.0), 1)
    den = (left.abs() + torch.sum((d_eta * right).abs(), 0)
           + hd * prec[1].abs())
    return S / den


def alpha_roundings(K, dim=2, n_comp=4):
    """The roundings a first-order error bound of alpha counts, for each of
    two evaluations: the K-term slot sums, the dim-term dot products, the
    component sum and a few more in each term (the entropy and flux
    quotients, the entropy derivative's pow)."""
    return 2 * (K + dim + n_comp + 8)


def compare_kernels(hm, U_a, U_b, tol, reps, records=None, stream=None,
                    tag="", up_tag="", exact_l64=True, weights=(0.75, -2.0),
                    timed=None, alpha_kappa=False):
    """Each kernel of the substep against its reference on identical
    inputs.  U_a is the state entering the substep, U_b a second prepared
    state; the stage inputs are those of the third ERK33 substep (weights
    0.75, -2) unless `weights` names others: the stage states are then
    U_a, U_b and two states between them (stage_states).  `timed`, a set
    of kernel names (pk2, pk3_stream, ...), limits the timing to them.  `stream` picks the slot-streaming PK1-PK3 (default: as the
    stepper of `hm` does); the Riemann route is the module's (`hm.half`).
    With `records`, also times every kernel and its reference and fills
    records[name + tag] = {max_abs_err, ms, plain_ms, bound_ms, bound_by,
    bound_ms_mask_as_stored, source, replaces} (pk_up's name takes
    `up_tag`; its last launch, PK5, has a record of its own, the name
    followed by " last").  The stream PK1's e, the stream PK2's U_low, F
    and bounds, the stream PK3's P and okp and pk_up's U must be bit-equal
    to their plain twins,
    and so must PK3's l and PK4's l' in f32 and, unless `exact_l64` is
    False, in f64 (torch's f64 limiter differs
    from the kernels' by up to 2.5e-13 on some large states, whose calls
    pass False).  On a dG canvas PK2 and PK3 take their dG instances, which
    read the incidence planes; with separable statics every kernel takes
    its SEP instance, held against the plain version that synthesizes the
    same planes.  With `alpha_kappa` PK1's alpha is held on every real
    node to its first-order rounding bound, alpha_roundings(K) eps kappa_i
    (alpha_condition), in place of the relative bar: on a smooth flow its
    sums cancel, so its relative error grows with the mesh.  Returns False
    if any output is off its tolerance."""
    from ryujin_tpu_torch.kernels import (
        pk1, pk1_stream, pk2, pk2_stream, pk3, pk3_stream, pk_up,
    )
    from ryujin_tpu_torch.solver.hyperbolic import (
        d_from_e, d_from_lambda, tau_max_from_d,
    )

    from ryujin_tpu_torch.solver.canvas_step import refresh

    eq, p, ca = hm.eq, hm.params, hm.canvas.arrays
    if stream is None:
        stream = hm.canvas.stream
    half = hm.half
    dim = len(ca.shape)
    st = ca.stencil
    dt = U_a.dtype
    K, n = ca.K, ca.n
    U, prec = hm.prepare_state_vector(U_b, 0.0)
    weights = list(weights)
    stage_U = torch.stack(stage_states(hm, U_a, U)[: len(weights)])
    # the ghost rows of every input a kernel reads at its neighbours, as
    # CanvasStepper refreshes them (a no-op on a canvas without ghosts)
    refresh(st, U, prec, stage_U)
    real = st.node_mask > 0
    # the live edges of the real nodes: ghost rows repeat them, and the
    # rows no refresh makes valid may hold anything
    live = torch.stack([st.live_k(k) for k in range(K)]) & real[None]
    live_edges = int(live.sum())
    ok = True

    def err(name, a, b, where, kind, exact=False):
        nonlocal ok
        good, d = held(name, a, b, where, kind, tol, exact)
        ok &= good
        return d

    sfx = "_stream" if stream else ""
    n1, n2, n3 = ("pk1" + sfx + tag, "pk2" + sfx + tag, "pk3" + sfx + tag)
    nu = f"pk_up[K={K}{up_tag}]"
    nu5 = nu + " last"
    exact_l = dt == torch.float32 or exact_l64
    kw = {"half": half} if stream else {}
    mods = {"pk1": pk1, "pk2": pk2, "pk3": pk3, "pk_up": pk_up,
            "pk1_stream": pk1_stream, "pk2_stream": pk2_stream,
            "pk3_stream": pk3_stream}

    def pair(name):
        """(kernel wrapper, plain-torch reference) of kernel `name`, with
        the route's keyword for the stream forms."""
        name = name.split("[")[0]
        fk, fr = getattr(mods[name], name), getattr(mods[name], name + "_reference")
        if name.endswith("_stream"):
            return (lambda *a: fk(*a, **kw)), (lambda *a: fr(*a, **kw))
        return fk, fr

    def run(name, *args):
        fk, fr = pair(name)
        return fk(*args), fr(*args)

    errs = {}
    args1 = (eq, p, ca, U, prec)
    (lam_k, alpha_k), (lam, alpha) = run(n1, *args1)
    e_live = live[: lam.shape[0]]
    if alpha_kappa:
        kappa = alpha_condition(hm, U, prec)
        bound = (alpha_roundings(K, dim, eq.n_comp) * torch.finfo(dt).eps
                 * kappa)
        diff = (alpha_k - alpha).abs().double()
        units = (diff / bound)[real].max().item()
        good = units <= 1.0 and bool(torch.isfinite(alpha_k).all())
        print(f"  {n1} alpha    {dt} within {units:.3e} of its rounding "
              f"bound {alpha_roundings(K, dim, eq.n_comp)} eps kappa_i "
              f"(kappa_i up to {kappa[real].max().item():.3e}; max |d "
              f"alpha| {diff[real].max().item():.3e})  "
              f"{'ok' if good else 'FAIL'}", flush=True)
        ok &= good
        e_alpha = diff[real].max().item()
    else:
        e_alpha = err(f"{n1} alpha", alpha_k, alpha, real, "rel")
    errs[n1] = max(
        err(f"{n1} {'e' if stream else 'lambda'}", lam_k, lam, e_live, "rel",
            exact=stream),
        e_alpha,
    )
    full = st.full()  # the glue's d on stacks (synthesized if separable)
    if stream and not half:
        d = d_from_e(full.mask, lam, full.transpose_edge(lam))
    else:
        lam = hm._lambda_fixup(lam, U, prescaled=stream)
        d = d_from_lambda(full, lam, None if stream else full.cmax)
    del full
    refresh(st, lam, alpha)
    cap = torch.full((), float("inf"), dtype=dt, device=U.device)
    tau = tau_max_from_d(st, d, 0.9, cap)

    args2 = (eq, p, ca, U, prec, lam, alpha, stage_U, weights, tau)
    (Ul_k, F_k, b_k), (U_low, F, bounds) = run(n2, *args2)
    errs[n2] = max(
        err(f"{n2} U_low", Ul_k, U_low, real, "rel", exact=stream),
        err(f"{n2} F", F_k, F, real, "rel", exact=stream),
        err(f"{n2} bounds", b_k, bounds, real, "rel", exact=stream),
    )
    refresh(st, F)
    args3 = (eq, p, ca, U, lam, alpha, F, U_low, bounds, stage_U, weights, tau)
    (P_k, l_k, okp_k), (P, l, okp) = run(n3, *args3)
    errs[n3] = max(
        err(f"{n3} P", P_k, P, live, "rel", exact=stream),
        err(f"{n3} l", l_k, l, live, "l", exact=stream and exact_l),
    )
    n_ok = int((okp_k[real] != okp[real]).sum())
    print(f"  {n3} okp {dt} nodes differing: {n_ok}", flush=True)
    ok &= n_ok == 0

    refresh(st, l)
    args4 = (eq, p, ca, U_low, bounds, P, l, False)
    (U4_k, l4_k), (U4, l4) = run("pk_up", *args4)
    errs[nu] = max(
        err("pk4 U", U4_k, U4, real, "U", exact=True),
        err("pk4 l'", l4_k, l4, live, "l", exact=exact_l),
    )
    refresh(st, l4)
    args5 = (eq, p, ca, U4, bounds, P, l4, True)
    (U5_k, _), (U5, _) = run("pk_up", *args5)
    errs[nu5] = err("pk5 U", U5_k, U5, real, "U", exact=True)
    if records is None:
        return ok

    # the planes each launch dereferences (the edge mask apart) and those
    # it writes, for its bound.  Of g_node = (m_i, 1/m_i, n_nbrs,
    # node_mask, value_mask) PK1 reads m_i and node_mask, PK2 m_i and
    # 1/m_i, PK3 the first four; of prec = (s, eta) PK1 reads eta, PK2 s.
    # The stream forms read cmax only in PK1, only on the half slots and
    # only on the half-slot route.
    # With separable statics the static planes give way to the factor rows
    # each kernel reads (SEP_READS), the mask among them.
    node = ca.g_node

    def statics(base, *names):
        if not ca.separable:
            return [getattr(ca, name) for name in names]
        return [t for kind in SEP_READS[base]
                for t in (ca.g_sep2[slice(*SEP_ROWS[kind][0])],
                          ca.f_sepz[slice(*SEP_ROWS[kind][1])])]

    traffic = {
        n1: (statics("pk1_stream", "g_cij")
             + ([ca.g_cmax[: K // 2]]
                if stream and half and not ca.separable else [])
             + [node[[0, 3]], U, prec[1:]], [lam_k, alpha_k]),
        n2: (statics("pk2_stream", "g_cij", "g_cii")
             + [node[:2], U, prec[:1], lam, alpha, stage_U, tau]
             + ([] if stream else [ca.g_cmax]), [Ul_k, F_k, b_k]),
        n3: (statics("pk3_stream", "g_cij", "g_mij")
             + [node[:4], U, lam, alpha, F, U_low, bounds, stage_U, tau]
             + ([] if stream else [ca.g_cmax]), [P_k, l_k, okp_k]),
        nu: (statics("pk_up") + [ca.g_lam, U_low, bounds, P, l],
             [U4_k, l4_k]),
        # PK5 reads no bounds and writes no l'
        nu5: (statics("pk_up") + [ca.g_lam, U4, P, l4], [U5_k]),
    }
    calls = {n1: args1, n2: args2, n3: args3, nu: args4, nu5: args5}
    for name, a in calls.items():
        if timed is not None and name.split("[")[0] not in timed:
            continue
        fk, fr = pair(name)
        ms = time_ms(lambda: fk(*a), reps)
        plain = time_ms(lambda: fr(*a), max(reps // 4, 2))
        base = name.split("[")[0]
        pk23 = base[:3] in ("pk2", "pk3")
        least, by, stored = bound_ms(
            base + "_last" if name == nu5 else base, dim, half,
            *traffic[name], ca.g_mask, live_edges,
            len(weights) if pk23 else 0, dt, ca.g_inc if pk23 else None)
        records[name] = {"max_abs_err": errs[name], "ms": ms,
                         "plain_ms": plain, "bound_ms": least, "bound_by": by,
                         "bound_ms_mask_as_stored": stored,
                         "source": f"ryujin_tpu_torch/csrc/{base}.cu",
                         "replaces": SEP_SOURCE if ca.separable else
                         TPU_SOURCE[(dim, base, ca.g_inc is not None)]}
        print(f"  {name:12s} kernel {ms:.4f} ms   plain {plain:.4f} ms   "
              f"bound {least:.4f} ms ({by}; {stored:.4f} ms with the mask "
              f"as stored)   {100 * least / ms:.1f} % of bound", flush=True)
    return ok


def stage_states(hm, U_a, U):
    """Four stage states from the state U_a entering a substep and the
    prepared state U: U_a, U, and U_a + (U - U_a) / 2 and / 4 prepared
    (convex combinations: admissible where U_a and U are)."""
    mid = [hm.prepare_state_vector(U_a + (U - U_a) * f, 0.0)[0]
           for f in (0.5, 0.25)]
    return [U_a, U] + mid


def pk1_against_stream(hm, U_b):
    """pk1 against pk1_stream on the K = 8 canvas of `hm`, the prepared
    state of U_b: alpha bit-equal, and lambda times the half-slot cmax
    (one IEEE multiply, as pk1_stream forms e) bit-equal to e."""
    from ryujin_tpu_torch.kernels import pk1, pk1_stream

    eq, p, ca = hm.eq, hm.params, hm.canvas.arrays
    U, prec = hm.prepare_state_vector(U_b, 0.0)
    lam, alpha = pk1.pk1(eq, p, ca, U, prec)
    e, alpha_s = pk1_stream.pk1_stream(eq, p, ca, U, prec, half=hm.half)
    cmax = ca.g_cmax[: ca.K // 2].reshape(ca.K // 2, -1)
    ok = True
    for name, a, b in (("alpha", alpha, alpha_s), ("lambda cmax", lam * cmax, e)):
        good = torch.equal(a, b)
        ok &= good
        print(f"  pk1 {name} == pk1_stream {'alpha' if name == 'alpha' else 'e'}"
              f" {a.dtype}: max diff {(a - b).abs().max().item():.3e}  "
              f"{'ok' if good else 'FAIL'}  (bit-equal required)", flush=True)
    return ok


def bumped(sd, U0, blast=False):
    """U0 times a smooth density and energy bump around (1, 0.5[, 0.5]),
    or, with `blast`, with an 8:1 density and 1000:1 energy contrast in a
    ball of radius 0.2 there."""
    pos = torch.as_tensor(sd.positions.T, dtype=U0.dtype, device=U0.device)
    centre = torch.tensor([1.0, 0.5, 0.5][: pos.shape[0]], dtype=U0.dtype,
                          device=U0.device)[:, None]
    dist2 = torch.sum((pos - centre) ** 2, 0)
    U0 = U0.clone()
    if blast:
        disc = dist2 < 0.2 ** 2
        disc &= torch.as_tensor(sd.node_mask > 0, device=U0.device)
        U0[0, disc] *= 8.0
        U0[-1, disc] *= 1000.0
    else:
        bump = 1.0 + 0.25 * torch.exp(-8.0 * dist2)
        U0[0] *= bump
        U0[-1] *= bump
    return U0


def card_vs_plain_f64(ti_kernels, ti_plain, sd, U0, plain_device, steps=3,
                      blast=False, counted=None, counter="launches"):
    """`steps` steps in f64 (of ERK33 but in phase 13), the kernels on the
    card against the
    plain path, from the inflow state times a smooth bump or, with
    `blast`, with an 8:1 density and 1000:1 energy contrast in a disc
    (at a cfl_max far beyond 1 such a step fails its limiter and
    bang-bang recovery redoes it at cfl_min).  Returns True if U and tau
    agree to 1e-10 and the restart and warning counts are equal; with
    `blast` also only if a step was redone.  `counted` = (wrappers, want)
    also holds the launch counts, read from each wrapper's `counter`
    ("sep_launches" for the SEP instances), to want x substeps x (steps +
    restarts), the substeps of the integrators' scheme (ERK33: 3)."""
    from ryujin_tpu_torch.solver.integrator import TABLEAUX

    U0 = bumped(sd, U0.cpu(), blast)
    if counted:
        for fn in counted[0].values():
            setattr(fn, counter, 0)
    out_k = ti_kernels.advance(U0.cuda(), 0.0, steps)
    launches = ({k: getattr(fn, counter) for k, fn in counted[0].items()}
                if counted else {})
    out_p = ti_plain.advance(U0.to(plain_device), 0.0, steps)
    real = torch.as_tensor(sd.node_mask > 0)
    Uk, Up = out_k[0].cpu()[:, real], out_p[0].cpu()[:, real]
    rel = ((Uk - Up).abs().max() / Up.abs().max()).item()
    tau_rel = abs(out_k[3].item() / out_p[3].item() - 1.0)
    restarts = (int(out_k[4]), int(out_p[4]))
    warns = (int(out_k[5]), int(out_p[5]))
    good = (rel < 1e-10 and tau_rel < 1e-10 and restarts[0] == restarts[1]
            and warns[0] == warns[1] and bool(torch.isfinite(Uk).all()))
    if blast:
        good &= restarts[0] > 0
    extra = ""
    if counted:
        substeps = TABLEAUX[ti_kernels.scheme].n_sub * (steps + restarts[0])
        good &= all(launches[k] == w * substeps for k, w in counted[1].items())
        extra = f", launches {launches} in {substeps} substeps"
    print(f"  U rel-err {rel:.3e}, tau rel-err {tau_rel:.3e} (tol 1e-10), "
          f"restarts {restarts}, warnings {warns}{extra} "
          f"{'ok' if good else 'FAIL'}", flush=True)
    return good


# MQ/s of each slice through the kernels, by run_slice's name
SLICE_MQS = {}
# phase 8c's 2D dG steps, by ansatz, for phase 13a: (canvas, f64 module,
# f64 inflow state, the f32 states it developed through the kernels)
DG_STEP_STATES = {}


def run_slice(name, eq, sd, ti, ti_plain, U0, warmup, steps, plain_steps,
              kernels, want, card, allow_restarts, sep=False):
    """Warmup, then `steps` timed ERK33 steps through the kernels with the
    launch counters set to 0 just before and read just after; the gates;
    then the plain-torch substep timed on the card.  With `sep` the
    counts are the SEP instances' own and must make up every launch;
    without, no SEP instance may launch.  Returns the launch counts; the
    MQ/s goes to SLICE_MQS[name]."""
    print(f"{name}: slice, {warmup} warmup + {steps} timed ERK33 steps "
          "through the kernels", flush=True)
    U, _, t, _, r0, _ = ti.advance(U0, 0.0, warmup)
    torch.cuda.synchronize()
    for fn in kernels.values():
        fn.launches = fn.sep_launches = 0
    kernels["pk_up"].last_launches = 0
    t0 = time.perf_counter()
    U, _, t, tau, restarts, warns = ti.advance(U, t, steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.sep_launches if sep else fn.launches
                for k, fn in kernels.items()}
    other = {k: fn.launches - fn.sep_launches if sep else fn.sep_launches
             for k, fn in kernels.items()}
    mqs = sd.n_nodes * steps * 3 / wall / 1e6
    SLICE_MQS[name] = mqs

    real = torch.as_tensor(sd.node_mask > 0, device=U.device)
    Ur = U[:, real]
    finite = bool(torch.isfinite(Ur).all())
    admissible = bool(eq.is_admissible(Ur).all())
    tau_v, warns_v, restarts_v = tau.item(), int(warns), int(restarts)
    substeps = 3 * (steps + restarts_v)
    counts_ok = all(launches[k] == want[k] * substeps for k in want)
    counts_ok &= not any(other.values())
    print(f"  t = {t.item():.4e}, tau = {tau_v:.4e}, warnings {warns_v}, "
          f"restarts {restarts_v} (warmup {int(r0)}), finite {finite}, "
          f"admissible {admissible}, launches "
          f"{'of the SEP instances ' if sep else ''}{launches}"
          f"{', others ' + str(other) if any(other.values()) else ''}",
          flush=True)
    print(f"  kernels: {mqs:.3f} MQ/s ({wall:.3f} s for {steps} steps) "
          f"on {card}", flush=True)

    t0 = time.perf_counter()
    ti_plain.advance(U, t, plain_steps)
    torch.cuda.synchronize()
    wall_p = time.perf_counter() - t0
    mqs_p = sd.n_nodes * plain_steps * 3 / wall_p / 1e6
    print(f"  plain torch: {mqs_p:.3f} MQ/s ({wall_p:.3f} s for "
          f"{plain_steps} steps) on {card}", flush=True)

    if not (finite and admissible):
        fail(f"{name}: the slice left the admissible set")
    if not tau_v > 0.0:
        fail(f"{name}: tau = {tau_v}")
    if warns_v:
        fail(f"{name}: {warns_v} steps warned")
    if restarts_v and not allow_restarts:
        fail(f"{name}: {restarts_v} restarts without recovery")
    if not counts_ok:
        fail(f"{name}: launch counts {launches}, expected {want} x "
             f"{substeps} substeps")
    # PK5, the last of pk_up's two launches a substep, counted apart (in a
    # SEP slice every launch is a SEP instance's: `other` is 0)
    launches["pk_up last"] = kernels["pk_up"].last_launches
    return launches


def up_launches(records, name, launches):
    """Set the launches of pk_up's records `name` (PK4) and `name` + "
    last" (PK5) from run_slice's counts."""
    records[name]["launches"] = launches["pk_up"] - launches["pk_up last"]
    records[name + " last"]["launches"] = launches["pk_up last"]


def check_dg(dev, card, streamed, stacked, kept):
    """Phases 8 and 9, the dG path: the dG instances of PK2 and PK3 (the
    incidence beta_ij in the high-order viscosity factor) against their
    plain versions, and the slice on the dG Q1 box.  Returns the kernels'
    records and keeps the f32 module and states of phase 8 in `kept` for
    phase 13; fails the run on any error."""
    from ryujin_tpu_torch.bench import build_dg1box3d, build_q2step2d
    from ryujin_tpu_torch.solver.hyperbolic import (
        HyperbolicModule, _boundary_pair_data,
    )
    from ryujin_tpu_torch.solver.integrator import TimeIntegrator

    def bang_bang(steps_of):
        return TimeIntegrator(steps_of, "erk 33", cfl_min=0.45, cfl_max=0.9,
                              cfl_recovery_strategy="bang bang control")

    def in_f64(hm, sd):
        return HyperbolicModule(hm.eq, sd, hm.initial_state_fn,
                                dtype=torch.float64, device=dev)

    # ---- phase 8: the dG Q1 box's kernels against their references ---------
    print(f"phase 8: the dG Q1 box (dg1box3d's flow at {DG_BOX_SUBDIV} "
          f"cells), refinement {DG_BOX_REFINEMENT}, f32, "
          f"{BOX_DEVELOP_STEPS} ERK33 steps through the kernels from a blast "
          "contrast", flush=True)
    t0 = time.perf_counter()
    eq, sd, hm, ti, U0 = build_dg1box3d(DG_BOX_REFINEMENT, torch.float32, dev,
                                        subdiv=DG_BOX_SUBDIV)
    setup = time.perf_counter() - t0
    slots = len(_boundary_pair_data(sd, torch.float32, "cpu")["k"])
    print(f"  setup {setup:.1f} s: canvas {sd.shape}, {sd.n_nodes} real "
          f"nodes, K = {sd.max_degree}, route "
          f"{'half-slot' if hm.half else 'two-direction'} ({slots} "
          f"boundary-pair slots against the cut-off "
          f"{max(1024, sd.n_pad // 16)})", flush=True)
    if hm.half or not hm.canvas.stream or hm.canvas.arrays.g_inc is None:
        fail("the dG Q1 box did not choose the dG stream kernels on the "
             "two-direction route")
    U_a, _, t_a, _, restarts, warns = ti.advance(bumped(sd, U0, blast=True),
                                                 0.0, BOX_DEVELOP_STEPS)
    U_b, _, _, _, _, _ = ti.advance(U_a, t_a, 1)
    torch.cuda.synchronize()
    real = torch.as_tensor(sd.node_mask > 0, device=dev)
    print(f"  t = {t_a.item():.4e}, restarts {int(restarts)}, warnings "
          f"{int(warns)}", flush=True)
    if not bool(eq.is_admissible(U_a[:, real]).all()):
        fail("the dG Q1 box: the developed state is not admissible")
    records = {}
    ok = compare_kernels(hm, U_a, U_b, TOL_F32, REPS, records,
                         tag="[3D dG two-direction]", up_tag=" dG")
    case = (f"dG Q1 box {DG_BOX_SUBDIV} at refinement {DG_BOX_REFINEMENT}: "
            f"canvas {sd.shape}, {sd.n_nodes} dofs")
    for rec in records.values():
        rec["case"] = case
    kept[DG_BOX_LABEL] = (hm, U_a, U_b)
    print("phase 8a: the dG Q1 box's kernels in f64", flush=True)
    hm64 = in_f64(hm, sd)
    # torch's f64 limiter differs from the kernels' l by 3.1e-15 here
    ok &= compare_kernels(hm64, U_a.double(), U_b.double(), TOL_F64, REPS,
                          exact_l64=False)
    del hm64, U_a, U_b
    torch.cuda.empty_cache()

    print(f"phase 8b: both 3D routes on small dG boxes (refinement 1), f32 "
          f"and f64, after {SMALL_BOX_STEPS} ERK33 steps through the kernels "
          "from a bumped inflow", flush=True)
    cases = []
    for subdiv, half in SMALL_DG_BOXES:
        route = "half-slot" if half else "two-direction"
        _, sd_s, hm_s, ti_s, U0_s = build_dg1box3d(1, torch.float32, dev,
                                                   subdiv=subdiv)
        print(f"  box {subdiv}: canvas {sd_s.shape}, {sd_s.n_nodes} real "
              f"nodes, route {route}", flush=True)
        if hm_s.half != half:
            fail(f"dG box {subdiv} did not choose the {route} route")
        cases.append((f"dG box {subdiv}", sd_s, hm_s, ti_s, U0_s,
                      SMALL_BOX_STEPS, f"[3D dG {route}]", streamed,
                      half))

    print(f"phase 8c: the 2D dG instances on the step at refinement 0, f32 "
          f"and f64, after {Q2_DEVELOP_STEPS} ERK33 steps through the "
          "kernels", flush=True)
    for ansatz in DG_STEP_ANSATZE:
        t0 = time.perf_counter()
        _, sd_s, hm_s, ti_s, U0_s = build_q2step2d(0, torch.float32, dev,
                                                   ansatz=ansatz)
        print(f"  {ansatz} step: setup {time.perf_counter() - t0:.1f} s, "
              f"canvas {sd_s.shape}, {sd_s.n_nodes} real nodes, K = "
              f"{sd_s.max_degree}, {len(hm_s._bp['k'])} boundary-pair "
              f"slots, {'stream' if hm_s.canvas.stream else 'stacked'} "
              "kernels", flush=True)
        if hm_s.canvas.stream != (sd_s.max_degree > 8):
            fail(f"the {ansatz} step took the wrong kernel form")
        cases.append((f"{ansatz} step", sd_s, hm_s, ti_s, U0_s,
                      Q2_DEVELOP_STEPS, "[2D dG]",
                      streamed if hm_s.canvas.stream else stacked, True))

    small = []
    for name, sd_s, hm_s, ti_s, U0_s, steps, tag, fns, timed in cases:
        Ua_s, _, t_s, _, _, _ = ti_s.advance(bumped(sd_s, U0_s), 0.0, steps)
        Ub_s = ti_s.advance(Ua_s, t_s, 1)[0]
        print(f"  {name}, f32", flush=True)
        got = {} if timed else None
        ok &= compare_kernels(hm_s, Ua_s, Ub_s, TOL_F32, REPS, got, tag=tag)
        # the dG instances (PK2, PK3) are timed here; PK1 and pk_up are the
        # cG instances, timed in phases 2-8
        dg_names = [k for k in got or {} if k.startswith(("pk2", "pk3"))]
        hm64 = in_f64(hm_s, sd_s)
        print(f"  {name}, f64", flush=True)
        # torch's f64 limiter differs from the kernels' l by 2.5e-13 on the
        # dG Q2 step; on the other small dG canvases they are bit-equal
        ok &= compare_kernels(hm64, Ua_s.double(), Ub_s.double(), TOL_F64,
                              REPS, exact_l64=not name.startswith("dG Q2"))
        small.append((name, sd_s, hm64, U0_s.double(), fns, dg_names, got))
        if name.startswith("dG Q"):
            DG_STEP_STATES[name[: len("dG Q1")]] = (
                sd_s, hm64, U0_s.double(), Ua_s.double(), Ub_s.double())
    del cases, hm_s, ti_s
    torch.cuda.empty_cache()

    print("phase 8d: 3 ERK33 steps with bang-bang recovery, kernels vs the "
          "plain path on the card, f64, on each small dG canvas", flush=True)
    for name, sd_s, hm64, U0_s, fns, dg_names, got in small:
        print(f"  {name}", flush=True)
        ok &= card_vs_plain_f64(bang_bang(hm64), bang_bang(PlainSteps(hm64)),
                                sd_s, U0_s, dev,
                                counted=(fns, per_substep(fns)))
        for k in dg_names:
            rec = got[k]
            rec["launches"] = fns[k.split("[")[0]].launches
            records[k] = rec
    del small
    if not ok:
        fail("a dG kernel disagrees with its plain-torch reference")

    # ---- phase 9: the slice on the dG Q1 box --------------------------------
    launches = run_slice(
        f"phase 9, the dG Q1 box {DG_BOX_SUBDIV}", eq, sd, ti, bang_bang(PlainSteps(hm)), U0, BOX_WARMUP, BOX_STEPS, BOX_PLAIN_TIMED_STEPS, streamed,
        per_substep(streamed), card, allow_restarts=True,
    )
    for name in ("pk1_stream", "pk2_stream", "pk3_stream"):
        records[name + "[3D dG two-direction]"]["launches"] = launches[name]
    up_launches(records, "pk_up[K=26 dG]", launches)
    return records


def module_bytes(make):
    """(make(), device bytes its construction left allocated)."""
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    made = make()
    torch.cuda.synchronize()
    return made, torch.cuda.memory_allocated() - before


def statics_bytes(ca):
    """Bytes of the static stencil arrays a canvas holds: the five stacks
    (c_ij, the mask, cmax, m_ij, c_ii) or the separable factors."""
    return sum(t.numel() * t.element_size()
               for t in (ca.g_cij, ca.g_mask, ca.g_cmax, ca.g_mij, ca.g_cii,
                         ca.g_sep2, ca.f_sepz) if t is not None)


def live_edges_agree(label, hm, sd):
    """True if the live edges of the module's mask (synthesized with
    separable statics) are sd.mask's, edge for edge; prints the count."""
    st = hm.stencil
    mask = torch.as_tensor(sd.mask.T > 0, device=st.node_mask.device)
    same = all(bool(torch.equal(st.live_k(k), mask[k]))
               for k in range(st.K))
    count = sum(int(st.live_k(k).sum()) for k in range(st.K))
    print(f"  {label}: {count} live edges in the "
          f"{'synthesized' if hm.canvas.arrays.separable else 'stored'} "
          f"mask, sd.mask {int(mask.sum())}, edge for edge "
          f"{'equal' if same else 'DIFFERENT'}", flush=True)
    return same and count == int(mask.sum())


def check_cylinder(dev, card, streamed, kept):
    """Phases 10 and 11, cylinder3d: the 3D kernels with the full statics at
    size, their SEP instances against their plain versions on both routes
    and three f64 steps through them, and the slice in both modes.
    Returns the kernels' records and keeps the SEP module and states of
    phase 10b in `kept` for phase 13; fails the run on any error."""
    from ryujin_tpu_torch.bench import build_box3d, build_cylinder3d
    from ryujin_tpu_torch.solver.hyperbolic import (
        HyperbolicModule, _boundary_pair_data,
    )
    from ryujin_tpu_torch.solver.integrator import TimeIntegrator

    def bang_bang(steps_of, cfl_max=0.9):
        return TimeIntegrator(steps_of, "erk 33", cfl_min=0.45,
                              cfl_max=cfl_max,
                              cfl_recovery_strategy="bang bang control")

    want = per_substep(streamed)
    records = {}

    # ---- phase 10: cylinder3d with the full statics ------------------------
    print(f"phase 10: cylinder3d, refinement {CYL_REFINEMENT}, f32, full "
          f"statics, {CYL_DEVELOP_STEPS} ERK33 steps through the kernels from "
          "the uniform inflow", flush=True)
    t0 = time.perf_counter()
    eq, sd, hm, ti, U0 = build_cylinder3d(CYL_REFINEMENT, torch.float32, dev)
    setup = time.perf_counter() - t0
    slots = len(_boundary_pair_data(sd, torch.float32, "cpu")["k"])
    print(f"  setup {setup:.1f} s (assembly, packing, statics): canvas "
          f"{sd.shape}, {sd.n_nodes} real nodes, K = {sd.max_degree}, "
          f"{int((sd.mask > 0).sum())} live edges, minor_wrap "
          f"{sd.minor_wrap}, route "
          f"{'half-slot' if hm.half else 'two-direction'} ({slots} "
          f"boundary-pair slots against the cut-off "
          f"{max(1024, sd.n_pad // 16)})", flush=True)
    if hm.half or sd.minor_wrap is not None:
        fail("cylinder3d did not pack its periodic angle exactly onto the "
             "minor axis on the two-direction route")

    def module(dtype, separable):
        return HyperbolicModule(eq, sd, hm.initial_state_fn, dtype=dtype,
                                device=dev, separable=separable)

    held = {}
    for separable in (False, True):
        made, nbytes = module_bytes(lambda: module(torch.float32, separable))
        held[separable] = (nbytes, statics_bytes(made.canvas.arrays))
        if separable:
            hm_sep = made
        del made
    print(f"  device memory held by a HyperbolicModule (memory_allocated "
          f"delta), f32: full statics {held[False][0]} bytes "
          f"({held[False][1]} in the five static canvases), separable "
          f"{held[True][0]} bytes ({held[True][1]} in the factors); "
          f"separate_z {hm_sep.canvas.arrays.factor_seconds:.1f} s",
          flush=True)
    ok = live_edges_agree("cylinder3d", hm_sep, sd)
    U_a, _, t_a, _, restarts, warns = ti.advance(U0, 0.0, CYL_DEVELOP_STEPS)
    U_b, _, _, _, _, _ = ti.advance(U_a, t_a, 1)
    torch.cuda.synchronize()
    real = torch.as_tensor(sd.node_mask > 0, device=dev)
    print(f"  t = {t_a.item():.4e}, restarts {int(restarts)}, warnings "
          f"{int(warns)}, rho in [{U_a[0, real].min().item():.4f}, "
          f"{U_a[0, real].max().item():.4f}]", flush=True)
    if not bool(eq.is_admissible(U_a[:, real]).all()):
        fail("cylinder3d: the developed state is not admissible")
    ok &= compare_kernels(hm, U_a, U_b, TOL_F32, REPS, records,
                          tag="[3D two-direction, cylinder3d]",
                          up_tag=" cylinder3d")

    # ---- phase 10b: the SEP instances against their plain versions --------
    print("phase 10b: the SEP instances (separable statics) against their "
          "plain versions at cylinder3d size, f32 and f64", flush=True)
    ok &= compare_kernels(hm_sep, U_a, U_b, TOL_F32, REPS, records,
                          tag="[3D two-direction SEP]", up_tag=" SEP")
    kept["cylinder3d SEP"] = (hm_sep, U_a, U_b)
    hm64 = module(torch.float64, True)
    # torch's f64 limiter differs from the kernels' l by 1.2e-13 here
    ok &= compare_kernels(hm64, U_a.double(), U_b.double(), TOL_F64, REPS,
                          exact_l64=False)
    del hm64
    torch.cuda.empty_cache()
    print(f"  small canvases, separable statics, f32 and f64, after "
          f"{SMALL_BOX_STEPS} ERK33 steps through the kernels from a bumped "
          "inflow", flush=True)
    small = []
    for label, build_small in (
        ("box (3, 2, 2)", functools.partial(build_box3d, subdiv=(3, 2, 2))),
        ("cylinder, refinement 1", functools.partial(
            build_cylinder3d, pad_minor=SMALL_CYL_PAD)),
    ):
        for dt, tol in ((torch.float32, TOL_F32), (torch.float64, TOL_F64)):
            _, sd_s, hm_s, ti_s, U0_s = build_small(1, dt, dev, separable=True)
            route = "half-slot" if hm_s.half else "two-direction"
            print(f"  {label}: canvas {sd_s.shape}, {sd_s.n_nodes} real "
                  f"nodes, route {route}, {dt}", flush=True)
            ok &= live_edges_agree(label, hm_s, sd_s)
            Ua_s, _, t_s, _, _, _ = ti_s.advance(bumped(sd_s, U0_s), 0.0,
                                                 SMALL_BOX_STEPS)
            Ub_s = ti_s.advance(Ua_s, t_s, 1)[0]
            timed = {} if hm_s.half and dt == torch.float32 else None
            ok &= compare_kernels(hm_s, Ua_s, Ub_s, tol, REPS, timed,
                                  tag=f"[3D {route} SEP]")
            if timed:
                records.update(
                    (k, v) for k, v in timed.items() if "half-slot" in k)
            if dt == torch.float64:
                small.append((label, sd_s, hm_s, U0_s))

    # ---- phase 10c: three f64 steps through the SEP instances --------------
    print("phase 10c: 3 ERK33 steps with bang-bang recovery, the SEP "
          "instances vs the plain path on the card, separable statics, f64, "
          "both routes; then 2 steps at cfl_max 3.5 from a blast contrast, "
          "each redone at cfl_min 0.45 (3D restarts)", flush=True)
    for label, sd_s, hm_s, U0_s in small:
        print(f"  {label}, route "
              f"{'half-slot' if hm_s.half else 'two-direction'}", flush=True)
        ok &= card_vs_plain_f64(bang_bang(hm_s), bang_bang(PlainSteps(hm_s)),
                                sd_s, U0_s, dev, counted=(streamed, want),
                                counter="sep_launches")
        if hm_s.half:
            for name in ("pk1_stream", "pk2_stream", "pk3_stream"):
                records[name + "[3D half-slot SEP]"]["launches"] = (
                    streamed[name].sep_launches
                )
        ok &= card_vs_plain_f64(
            bang_bang(hm_s, 3.5), bang_bang(PlainSteps(hm_s), 3.5), sd_s,
            U0_s, dev, steps=2, blast=True, counted=(streamed, want),
            counter="sep_launches")
    del small
    if not ok:
        fail("a cylinder3d or SEP kernel disagrees with its plain-torch "
             "reference")

    # ---- phase 11: the cylinder3d slice in both modes ------------------------
    launches = run_slice(
        "phase 11, cylinder3d, full statics", eq, sd, ti,
        bang_bang(PlainSteps(hm)), U0, CYL_WARMUP, CYL_STEPS,
        CYL_PLAIN_TIMED_STEPS, streamed, want, card, allow_restarts=True,
    )
    for name in ("pk1_stream", "pk2_stream", "pk3_stream"):
        records[name + "[3D two-direction, cylinder3d]"]["launches"] = (
            launches[name])
    up_launches(records, "pk_up[K=26 cylinder3d]", launches)
    del hm, ti, U_a, U_b
    torch.cuda.empty_cache()
    launches = run_slice(
        "phase 11b, cylinder3d, separable statics", eq, sd, bang_bang(hm_sep),
        bang_bang(PlainSteps(hm_sep)), U0, CYL_WARMUP, CYL_STEPS,
        CYL_PLAIN_TIMED_STEPS, streamed, want, card, allow_restarts=True,
        sep=True,
    )
    return records, launches


def check_probes():
    """Phase 12: the probes' mains with the counters reset just before and
    read just after; the records of every probe kernel, with its launches
    in that run."""
    from ryujin_tpu_torch.kernels import build
    from ryujin_tpu_torch.probes import gather, layout3d
    from ryujin_tpu_torch.probes import pow as ppow

    t0 = time.perf_counter()
    build.PROBE_LAUNCHES.clear()
    recs = []
    for name, probe, argv in (("pow", ppow, []), ("gather", gather, []),
                              ("layout3d", layout3d, ["--MOV", "both"])):
        print(f"phase 12: python -m ryujin_tpu_torch.probes.{name} "
              f"{' '.join(argv)}".rstrip(), flush=True)
        if probe.main(argv, recs) != 0:
            fail(f"the {name} probe: a kernel missed its bar against its "
                 "plain version")
    records = {}
    for rec in recs:
        rec["launches"] = build.PROBE_LAUNCHES[rec.pop("instance")]
        if rec["launches"] < 1:
            fail(f"{rec['name']} was not launched by its probe")
        records[rec["name"]] = rec
    check_pow_ragged()
    check_ell_inputs()
    check_moveaxis_shapes()
    check_pk1_shape_shapes()
    check_lane_ragged()
    print(f"phase 12: {len(records)} probe kernels held and timed in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return records


def check_pow_ragged():
    """Phase 12, after the counts are read: the pow kernels at a ragged n
    on an offset view x[1:] (not 16-byte aligned: the scalar pointwise
    instance) and on x[:n] (float4 vectors and a tail of 3), every form
    pointwise and summed with the carry, each at its bar against the
    plain version."""
    import itertools

    import numpy as np

    from ryujin_tpu_torch.kernels import probe_pow as kp
    from ryujin_tpu_torch.probes import held
    from ryujin_tpu_torch.probes.pow import LIBM

    n = 524291
    base = torch.from_numpy(np.random.default_rng(5).uniform(
        0.5, 3.0, n + 1).astype(np.float32)).cuda()
    s = kp.shifts(0.01, 40).cuda()
    for off, form in itertools.product((0, 1), kp.FORMS):
        x = base[off:off + n]
        for shifts, carry in ((None, None), (s, base[:n])):
            bar = ("exact" if form not in LIBM
                   else "4 ulp" if shifts is None else "rel 1e-6")
            _, err, ok = held(bar, kp.probe_pow(x, form, 1.4, shifts, carry),
                              kp.probe_pow_reference(x, form, 1.4, shifts,
                                                     carry))
            if not ok:
                fail(f"probe_pow[{form}, n = {n}, offset {off}, "
                     f"{'summed' if shifts is not None else 'pointwise'}]: "
                     f"{err} against the plain version ({bar})")
    print(f"phase 12: the pow kernels hold their bars at n = {n}, aligned "
          "and on x[1:], pointwise and summed with the carry", flush=True)


def check_ell_inputs():
    """Phase 12, after the counts are read: the ELL gather-sum exactly
    against its plain version (NaN where it gives NaN) at the script's
    input, at an unbanded one (n = 2^20, columns uniform on [0, n)), at a
    ragged n (2^20 + 3, banded: 4-byte cp.async) and with a few columns
    out of range; at each the blocks the kernel counts as staged are those
    ell_staged_blocks finds, at the script's input every block."""
    import numpy as np

    from ryujin_tpu_torch.kernels import probe_gather as kg
    from ryujin_tpu_torch.probes import gather

    n, K, C = 1 << 20, 9, 12
    X, cols = gather.ell_inputs(n, K, C)
    unbanded = np.random.default_rng(1).integers(
        0, n, size=(K, n)).astype(np.int32)
    off = cols.copy()
    off[0, 0], off[3, n // 2], off[8, n - 1], off[5, 77] = -1, n, 2**31 - 1, -5
    cases = {"the script's input": (X, cols), "unbanded": (X, unbanded),
             "n = 2^20 + 3": gather.ell_inputs(n + 3, K, C),
             "columns out of range": (X, off)}
    for name, (x, c) in cases.items():
        x, c = torch.from_numpy(x).cuda(), torch.from_numpy(c).cuda()
        (counted, mirror, blocks), out = gather.ell_staged(x, c)
        want = kg.ell_gather_sum_reference(x, c)
        same = torch.equal(out.isnan(), want.isnan()) and torch.equal(
            out.nan_to_num(), want.nan_to_num())
        if not same or counted != mirror or (
                name == "the script's input" and counted != blocks):
            fail(f"ell_gather_sum, {name}: bit-equal {same}, {counted} "
                 f"blocks staged, ell_staged_blocks {mirror}, of {blocks}")
        print(f"phase 12: ell_gather_sum exact, {name}: {counted} of "
              f"{blocks} blocks staged (ell_staged_blocks {mirror})",
              flush=True)


def check_moveaxis_shapes():
    """Phase 12, after the counts are read: moveaxis, MOV = 1 and 0, out
    and check exactly against the plain version at a second shape, P = 24,
    (20, 9, 20) (H W = 180: a partial tile of 64 cells), TD = 1 and 4."""
    import numpy as np

    from ryujin_tpu_torch.kernels import probe_layout3d as kl

    h = torch.from_numpy(np.random.default_rng(4).random(
        (20, 24, 9, 20), dtype=np.float32)).cuda()
    for TD in (1, 4):
        for mov in (1, 0):
            got, want = kl.moveaxis(h, TD, mov), kl.moveaxis_reference(
                h, TD, mov)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                fail(f"moveaxis MOV = {mov}, TD = {TD}, (20, 9, 20): out or "
                     "check differs from the plain version")
    print("phase 12: moveaxis exact at P = 24, (20, 9, 20), TD = 1 and 4, "
          "MOV = 1 and 0", flush=True)


def check_pk1_shape_shapes():
    """Phase 12, after the counts are read: pk1_shape, out and check
    exactly against the plain version at a second shape, (20, 9, 20) (H W
    = 180: a partial tile of 64 cells), TD = 1 and 4, with a centre of 78
    planes and without, and 0 to 3 windows of 5, 4 and 2 planes, OUTPL
    14."""
    import itertools

    import numpy as np

    from ryujin_tpu_torch.kernels import probe_layout3d as kl

    rng = np.random.default_rng(6)
    cen = torch.from_numpy(rng.random((20, 78, 9, 20),
                                      dtype=np.float32)).cuda()
    wins = [torch.from_numpy(rng.random((20, p, 9, 20),
                                        dtype=np.float32)).cuda()
            for p in (5, 4, 2)]
    for TD, cen_on, nwin in itertools.product((1, 4), (1, 0), range(4)):
        if not cen_on and not nwin:
            continue
        c = cen if cen_on else None
        got = kl.pk1_shape(c, wins[:nwin], TD, 14)
        want = kl.pk1_shape_reference(c, wins[:nwin], TD, 14)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            fail(f"pk1_shape CEN = {cen_on}, NWIN = {nwin}, TD = {TD}, "
                 "(20, 9, 20): out or check differs from the plain version")
    print("phase 12: pk1_shape exact at (20, 9, 20), TD = 1 and 4, CEN = 0 "
          "and 1, NWIN = 0 to 3", flush=True)


def check_lane_ragged():
    """Phase 12, after the counts are read: the lane gather exactly
    against np.take_along_axis at P = 8 and a ragged W = 2047 (4-byte
    pieces), and at W = 2048 on a view one float into a buffer (its base
    not 16-byte aligned: 4-byte pieces), an index past each end giving
    NaN."""
    import numpy as np

    from ryujin_tpu_torch.kernels import probe_gather as kg

    P = 8
    for W, offset in ((2047, 0), (2048, 1)):
        x = np.arange(P * W, dtype=np.float32).reshape(P, W)
        idx = np.random.default_rng(0).integers(0, W, size=(P, W)).astype(
            np.int32)
        want = np.take_along_axis(x, idx, axis=1)
        idx[0, 0], idx[-1, -1] = W, -1
        want[0, 0] = want[-1, -1] = np.nan
        flat = torch.zeros(P * W + offset, dtype=torch.float32, device="cuda")
        flat[offset:] = torch.from_numpy(x).cuda().reshape(-1)
        got = kg.lane_gather(flat[offset:].view(P, W),
                             torch.from_numpy(idx).cuda())
        if not np.array_equal(got.cpu().numpy(), want, equal_nan=True):
            fail(f"lane_gather, P = {P}, W = {W}, offset {offset}: differs "
                 "from np.take_along_axis")
    print("phase 12: lane_gather exact at W = 2047 and on an offset view at "
          "W = 2048, NaN past each end", flush=True)


def erk54_weights(slots):
    """The static weights of ERK54's substep that passes `slots` stage
    slots (its substep of that index), as the integrator passes them."""
    from ryujin_tpu_torch.solver.integrator import TABLEAUX

    return [w for w in TABLEAUX["erk 54"].W[slots] if w != 0.0]


def check_stages(dev, streamed, stacked, kept):
    """Phase 13a: the instances of PK2 and PK3 that take 3 and 4 stage
    slots (ERK54's fourth and fifth substeps) against their plain versions:
    at the sizes of phases 2-10 in f32 on the states kept there (`kept`:
    canvas -> f32 module, the state entering a substep, a second one),
    timed beside their bounds; then on the small canvases of phases 2c, 4c,
    6c, 8d and 10c in f64, each followed by three ERK54 steps with
    bang-bang recovery, kernels vs the plain path on the card, with the
    launch counts.  Returns the records of the timed instances, their
    launches those of the ERK54 steps (the stacked ones' are set from the
    vortex, phase 13b); fails the run on any error."""
    from ryujin_tpu_torch.bench import (
        build_box3d, build_cylinder3d, build_dg1box3d, build_q2step2d,
        build_step2d,
    )
    from ryujin_tpu_torch.solver.integrator import TimeIntegrator

    records, ok = {}, True
    timed = {"pk2", "pk3", "pk2_stream", "pk3_stream"}
    print("phase 13a: PK2 and PK3 at 3 and 4 stage slots (ERK54's weights) "
          "against their plain versions, f32, at the sizes of phases 2-10",
          flush=True)
    for canvas, (hm, U_a, U_b) in kept.items():
        for slots in WIDE_SLOTS:
            print(f"  {canvas}, {slots} stage slots", flush=True)
            ok &= compare_kernels(hm, U_a, U_b, TOL_F32, REPS, records,
                                  tag=f"[S={slots} {canvas}]",
                                  weights=erk54_weights(slots), timed=timed)
    kept.clear()
    torch.cuda.empty_cache()

    print("phase 13a: the same in f64 on the small canvases, on states "
          f"developed as their phases develop them ({WIDE_DEVELOP_STEPS} "
          "ERK33 steps through the kernels from a bumped inflow; the 2D dG "
          f"steps {Q2_DEVELOP_STEPS} in f32, as phase 8c), then 3 ERK54 steps "
          "with bang-bang recovery, kernels vs the plain path on the card",
          flush=True)
    f64 = torch.float64

    def developed(built, steps):
        """The state entering a substep and a second one, after `steps`
        ERK33 steps through the kernels from the bumped inflow."""
        _, sd_s, _, ti_s, U0_s = built
        Ua_s, _, t_s, _, _, _ = ti_s.advance(bumped(sd_s, U0_s), 0.0, steps)
        return Ua_s, ti_s.advance(Ua_s, t_s, 1)[0]

    small = [
        ("step2d", None, build_step2d(0, f64, dev), stacked),
        ("q2step2d", "q2step2d", build_q2step2d(0, f64, dev), streamed),
    ]
    for subdiv, half in SMALL_BOXES:
        small.append((f"box {subdiv}", None if half else "box3d",
                      build_box3d(1, f64, dev, subdiv=subdiv), streamed))
    for subdiv, half in SMALL_DG_BOXES:
        small.append((f"dG box {subdiv}", None if half else DG_BOX_LABEL,
                       build_dg1box3d(1, f64, dev, subdiv=subdiv), streamed))
    for ansatz in DG_STEP_ANSATZE:
        # phase 8c's f64 module on its canvas
        sd_s, hm64, U0_s = DG_STEP_STATES[ansatz][:3]
        small.append((f"{ansatz} step", None, (None, sd_s, hm64, None, U0_s),
                      streamed if hm64.canvas.stream else stacked))
    small.append(("SEP box (3, 2, 2)", None,
                  build_box3d(1, f64, dev, subdiv=(3, 2, 2), separable=True),
                  streamed))
    small.append(("SEP cylinder, refinement 1", "cylinder3d SEP",
                  build_cylinder3d(1, f64, dev, pad_minor=SMALL_CYL_PAD,
                                   separable=True), streamed))
    for name, canvas, built, fns in small:
        _, sd_s, hm_s, _, U0_s = built
        sep = hm_s.canvas.arrays.separable
        if name.startswith("dG Q"):
            # the f32 states phase 8c developed
            Ua_s, Ub_s = DG_STEP_STATES[name[: len("dG Q1")]][3:]
        else:
            Ua_s, Ub_s = developed(built, WIDE_DEVELOP_STEPS)
        for slots in WIDE_SLOTS:
            print(f"  {name}, {slots} stage slots, f64", flush=True)
            # l and l' within 1e-8: torch's f64 limiter rounds otherwise
            # than the kernels' on some inputs (phases 8a, 8c, 10b), and
            # these stage slots give PK3 and PK4 new inputs (the SEP
            # cylinder's l' read 5.4e-15 at 3 slots)
            ok &= compare_kernels(hm_s, Ua_s, Ub_s, TOL_F64, REPS,
                                  weights=erk54_weights(slots),
                                  exact_l64=False)
        print(f"  {name}: 3 ERK54 steps, kernels vs plain", flush=True)
        for k in timed & fns.keys():
            fns[k].stage_launches.clear()
        counter = "sep_launches" if sep else "launches"

        def erk54(steps_of):
            return TimeIntegrator(steps_of, "erk 54", cfl_min=0.45,
                                  cfl_max=0.9,
                                  cfl_recovery_strategy="bang bang control")

        ok &= card_vs_plain_f64(erk54(hm_s), erk54(PlainSteps(hm_s)), sd_s,
                                U0_s, dev, counted=(fns, per_substep(fns)),
                                counter=counter)
        wide = {k: dict(fns[k].stage_launches) for k in timed & fns.keys()}
        print(f"  {name}: launches by stage slots {wide}", flush=True)
        for k, by_slots in wide.items():
            ok &= all(by_slots.get(slots, 0) > 0 for slots in WIDE_SLOTS)
            for slots in WIDE_SLOTS:
                rec = records.get(f"{k}[S={slots} {canvas}]")
                if rec is not None and canvas is not None:
                    rec["launches"] = by_slots.get(slots, 0)
    del small
    torch.cuda.empty_cache()
    if not ok:
        fail("a kernel at 3 or 4 stage slots disagrees with its plain "
             "version")
    return records


def check_vortex(dev, card, stacked):
    """Phases 13b and 13c: the isentropic vortex through the kernels
    (ryujin_tpu_torch.vortex) against the reference's own baselines, with
    the launch counts of every substep; the other explicit tableaux against
    the plain path on the card; float32 at refinement 8 against the
    reference's float32 plateau.  Returns {pk2, pk3: {stage slots:
    launches}} of the ERK54 run through the kernels; fails the run on any
    error."""
    from ryujin_tpu_torch.solver.integrator import TABLEAUX, TimeIntegrator
    from ryujin_tpu_torch.vortex import (
        BASELINES, F32_PLATEAU_L1, T_FINAL, build_vortex, drive_vortex,
    )

    want = per_substep(stacked)
    ok = True

    def driven(refinement, scheme, dtype, built, plain=False):
        """One drive with the launch counts set to 0 just before it and
        read just after: through the kernels every substep must have
        launched pk1, pk2, pk3 once and pk_up twice, on the plain path
        nothing."""
        nonlocal ok
        for fn in stacked.values():
            fn.launches = 0
            if hasattr(fn, "stage_launches"):
                fn.stage_launches.clear()
        run = drive_vortex(refinement, scheme, dtype, dev, built=built,
                           steps_of=PlainSteps if plain else None)
        launches = {k: fn.launches for k, fn in stacked.items()}
        substeps = TABLEAUX[scheme].n_sub * run.requested
        good = all(launches[k] == (0 if plain else w * substeps)
                   for k, w in want.items())
        real = torch.as_tensor(run.sd.node_mask > 0, device=run.U.device)
        Ur = run.U[:, real]
        good &= bool(torch.isfinite(Ur).all())
        good &= bool(run.hm.eq.is_admissible(Ur).all())
        good &= run.warnings == 0 and run.t == T_FINAL
        print(f"  {scheme:8s} {'plain ' if plain else 'kernels'} "
              f"{str(dtype):13s} refinement {refinement}: Linf "
              f"{run.norms[0]:.6e}  L1 {run.norms[1]:.6e}  L2 "
              f"{run.norms[2]:.6e}; {run.steps} steps ({run.requested} "
              f"asked), {run.warnings} warnings, {run.seconds:.2f} s wall; "
              f"launches {launches} for {substeps} substeps "
              f"{'ok' if good else 'FAIL'}", flush=True)
        ok &= good
        return run

    print(f"phase 13b: the isentropic vortex through the kernels, f64, "
          f"refinement {VORTEX_REFINEMENT}, CFL 0.2, recovery none, t = "
          f"{T_FINAL}, against the reference's baselines (within "
          f"{100 * VORTEX_BAR:.0f} %), on {card}", flush=True)
    built = build_vortex(VORTEX_REFINEMENT, torch.float64, dev)
    print(f"  canvas {built[2].shape}, {built[2].n_nodes} dofs, "
          f"{len(built[4]._bp['k'])} boundary-pair slots, route "
          f"{'half-slot' if built[4].half else 'two-direction'}, "
          f"{'stream' if built[4].canvas.stream else 'stacked'} kernels",
          flush=True)
    for scheme in VORTEX_SCHEMES:
        run = driven(VORTEX_REFINEMENT, scheme, torch.float64, built)
        for kind, got, ref in zip(("Linf", "L1", "L2"), run.norms,
                                  BASELINES[scheme]):
            if ref is None:
                continue
            rel = abs(got / ref - 1.0)
            good = rel <= VORTEX_BAR
            ok &= good
            print(f"    {kind} {got:.6e} against the reference's {ref:.6e}:"
                  f" {100 * rel:.3f} % {'ok' if good else 'FAIL'}",
                  flush=True)
        if scheme == "erk 33":
            # steps that start at t_final change nothing
            ti = TimeIntegrator(run.hm, scheme, cfl_min=0.2, cfl_max=0.2,
                                cfl_recovery_strategy="none")
            U_in = run.hm.prepare_state_vector(run.U, run.t)[0]
            U2, _, t2, _, _, warns = ti.advance(run.U, run.t, 2, T_FINAL)
            still = (torch.equal(U2, U_in) and t2.item() == run.t
                     and int(warns) == 0 and int(ti.steps_taken) == 0)
            ok &= still
            print(f"    2 more steps at t = {run.t}: state bit-equal "
                  f"{torch.equal(U2, U_in)}, t {t2.item()}, warnings "
                  f"{int(warns)}, steps taken {int(ti.steps_taken)} "
                  f"{'ok' if still else 'FAIL'}", flush=True)
    del built

    print(f"phase 13b: the other tableaux at refinement "
          f"{VORTEX_PLAIN_REFINEMENT}, f64, kernels against the plain path on "
          f"the card (within {VORTEX_PLAIN_BAR:.0e} relative on each norm)",
          flush=True)
    built = build_vortex(VORTEX_PLAIN_REFINEMENT, torch.float64, dev)
    wide = {}
    for scheme in VORTEX_PLAIN_SCHEMES:
        run_k = driven(VORTEX_PLAIN_REFINEMENT, scheme, torch.float64, built)
        if scheme == "erk 54":
            wide = {k: dict(stacked[k].stage_launches) for k in ("pk2", "pk3")}
            print(f"    launches by stage slots {wide}", flush=True)
            ok &= all(wide[k].get(slots, 0) > 0 for k in wide
                      for slots in WIDE_SLOTS)
        run_p = driven(VORTEX_PLAIN_REFINEMENT, scheme, torch.float64, built,
                       plain=True)
        rel = max(abs(a / b - 1.0) for a, b in zip(run_k.norms, run_p.norms))
        good = rel <= VORTEX_PLAIN_BAR and run_k.steps == run_p.steps
        ok &= good
        print(f"    {scheme}: kernels vs plain, norms {rel:.3e} relative, "
              f"steps {run_k.steps} / {run_p.steps} "
              f"{'ok' if good else 'FAIL'}", flush=True)
    del built

    print(f"phase 13c: the isentropic vortex through the kernels, f32, "
          f"refinement {VORTEX_F32_REFINEMENT}, ERK33", flush=True)
    built = build_vortex(VORTEX_F32_REFINEMENT, torch.float32, dev)
    run = driven(VORTEX_F32_REFINEMENT, "erk 33", torch.float32, built)
    good = run.norms[1] <= 2.0 * F32_PLATEAU_L1
    ok &= good
    print(f"    {built[2].n_nodes} dofs: L1 {run.norms[1]:.6e} beside the "
          f"reference's f32 plateau {F32_PLATEAU_L1:.2e} (gate "
          f"{2.0 * F32_PLATEAU_L1:.2e}) {'ok' if good else 'FAIL'}; "
          f"{run.steps} steps in {run.seconds:.2f} s wall on {card}",
          flush=True)
    del built
    if not ok:
        fail("the isentropic vortex missed a bar")
    return wide

ELL_KERNELS = ("ell_pk1", "ell_pk2", "ell_pk3", "ell_pk_up")


def ell_wrappers():
    """{name: wrapper} of the four ELL kernels."""
    from ryujin_tpu_torch.kernels import ell

    return {name: getattr(ell, name) for name in ELL_KERNELS}


def reset_ell_counts():
    for fn in ell_wrappers().values():
        fn.launches = 0
        if hasattr(fn, "stage_launches"):
            fn.stage_launches.clear()
    ell_wrappers()["ell_pk_up"].last_launches = 0


def ell_counts_ok(substeps, label):
    """Print the ELL launch counts; True if every substep launched ell_pk1,
    ell_pk2, ell_pk3 once and ell_pk_up twice (PK5 once)."""
    fns = ell_wrappers()
    launches = {k: fn.launches for k, fn in fns.items()}
    last = fns["ell_pk_up"].last_launches
    good = all(launches[k] == w * substeps
               for k, w in per_substep(fns).items() if k != "ell_pk_up")
    good &= launches["ell_pk_up"] == 2 * substeps and last == substeps
    print(f"  {label}: launches {launches} (PK5 {last}) in {substeps} "
          f"substeps {'ok' if good else 'FAIL'}", flush=True)
    return good


def compare_ell(hm, U_a, U_b, tol, reps=REPS, records=None, tag="",
                weights=(0.75, -2.0)):
    """Each ELL kernel against its plain version on identical inputs, as
    compare_kernels does for the canvas: U_a the state entering the
    substep, U_b a second prepared state, the stage states of the third
    ERK33 substep (or `weights`' count of stage_states).  With `records`,
    also times each kernel and its plain version and fills records[name +
    tag] with the JSON fields (pk_up's last launch, PK5, as "ell_pk_up
    last").  Returns False if any output is off its tolerance."""
    from ryujin_tpu_torch.kernels import ell
    from ryujin_tpu_torch.solver.hyperbolic import d_from_e, tau_max_from_d

    eq, p, st = hm.eq, hm.params, hm.stencil
    dt = U_a.dtype
    U, prec = hm.prepare_state_vector(U_b, 0.0)
    weights = list(weights)
    stage_U = torch.stack(stage_states(hm, U_a, U)[: len(weights)])
    real = st.node_mask > 0
    live = st.mask > 0
    live_edges = int(live.sum())
    ok = True
    errs = {}

    def err(name, a, b, where, kind):
        nonlocal ok
        good, d = held(name, a, b, where, kind, tol)
        ok &= good
        return d

    def run(name, *args):
        return (getattr(ell, name)(*args),
                getattr(ell, name + "_reference")(*args))

    args1 = (eq, p, st, U, prec)
    (e_k, a_k), (e, alpha) = run("ell_pk1", *args1)
    errs["ell_pk1"] = max(err("ell_pk1 e", e_k, e, live, "rel"),
                          err("ell_pk1 alpha", a_k, alpha, real, "rel"))
    d = d_from_e(st.mask, e, st.transpose_edge(e))
    cap = torch.full((), float("inf"), dtype=dt, device=U.device)
    tau = tau_max_from_d(st, d, 0.9, cap)
    args2 = (eq, p, st, U, prec, d, alpha, stage_U, weights, tau)
    (Ul_k, F_k, b_k), (U_low, F, bounds) = run("ell_pk2", *args2)
    errs["ell_pk2"] = max(
        err("ell_pk2 U_low", Ul_k, U_low, real, "rel"),
        err("ell_pk2 F", F_k, F, real, "rel"),
        err("ell_pk2 bounds", b_k, bounds, real, "rel"),
    )
    args3 = (eq, p, st, U, d, alpha, F, U_low, bounds, stage_U, weights, tau)
    (P_k, l_k, okp_k), (P, l, okp) = run("ell_pk3", *args3)
    errs["ell_pk3"] = max(err("ell_pk3 P", P_k, P, live, "rel"),
                          err("ell_pk3 l", l_k, l, live, "l"))
    n_ok = int((okp_k[real] != okp[real]).sum())
    print(f"  ell_pk3 okp {dt} rows differing: {n_ok}", flush=True)
    ok &= n_ok == 0
    args4 = (eq, p, st, U_low, bounds, P, l, False)
    (U4_k, l4_k), (U4, l4) = run("ell_pk_up", *args4)
    args5 = (eq, p, st, U4, bounds, P, l4, True)
    (U5_k, _), (U5, _) = run("ell_pk_up", *args5)
    errs["ell_pk_up"] = max(err("ell_pk4 U", U4_k, U4, real, "U"),
                            err("ell_pk4 l'", l4_k, l4, live, "l"))
    errs["ell_pk_up last"] = err("ell_pk5 U", U5_k, U5, real, "U")
    if records is None:
        return ok

    # the planes each launch reads and writes, for its bound: the statics,
    # of the node planes (m_i, 1/m_i, n_nbrs, node_mask) PK1 reads m_i and
    # node_mask, PK2 m_i and 1/m_i, PK3 all four, the update n_nbrs; of
    # prec = (s, eta) PK1 reads eta, PK2 s; and the gather indices (cols;
    # trans in the update), at 4 bytes an entry
    node = st.node
    traffic = {
        "ell_pk1": ([st.cij, node[[0, 3]], U, prec[1:]], [e_k, a_k]),
        "ell_pk2": ([st.cij, st.cii, node[:2], U, prec[:1], d, alpha,
                     stage_U, tau], [Ul_k, F_k, b_k]),
        "ell_pk3": ([st.cij, st.mij, node, U, d, alpha, F, U_low, bounds,
                     stage_U, tau], [P_k, l_k, okp_k]),
        "ell_pk_up": ([node[2:3], U_low, bounds, P, l], [U4_k, l4_k]),
        "ell_pk_up last": ([node[2:3], U4, P, l4], [U5_k]),
    }
    calls = {"ell_pk1": args1, "ell_pk2": args2, "ell_pk3": args3,
             "ell_pk_up": args4, "ell_pk_up last": args5}
    dim = st.dim
    for name, a in calls.items():
        base = name.split(" ")[0]
        fk = getattr(ell, base)
        fr = getattr(ell, base + "_reference")
        ms = time_ms(lambda: fk(*a), reps)
        plain = time_ms(lambda: fr(*a), max(reps // 4, 2))
        pk23 = base in ("ell_pk2", "ell_pk3")
        least, by, stored = bound_ms(
            name.replace(" ", "_"), dim, False, *traffic[name], st.mask,
            live_edges, len(weights) if pk23 else 0, dt,
            st.incidence if pk23 else None,
            indices=[st.trans if base == "ell_pk_up" else st.cols])
        # the operations bound alone: the live edges' operations (EDGE_FLOPS)
        # over the peak rate, whichever of the two binds
        per_edge, per_stage = EDGE_FLOPS[dim][name.replace(" ", "_")]
        ops = live_edges * (per_edge + int(pk23 and st.incidence is not None)
                            + (len(weights) if pk23 else 0) * per_stage)
        ops_ms = ops / PEAK_FLOPS[dt] * 1e3
        records[name + tag] = {
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain,
            "bound_ms": least, "bound_by": by,
            "bound_ms_mask_as_stored": stored, "ops_bound_ms": ops_ms,
            "source": "ryujin_tpu_torch/csrc/ell_step.cu",
            "replaces": ELL_SOURCE[base],
        }
        print(f"  {name + tag:24s} kernel {ms:.4f} ms   plain {plain:.4f} ms"
              f"   bound {least:.4f} ms ({by}; {stored:.4f} ms with the mask"
              f" as stored; operations {ops_ms:.4f} ms)   "
              f"{100 * least / ms:.1f} % of bound", flush=True)
    return ok


def ell_meshes(dtype, dev):
    """(label, eq, hm, ti, U0) of phase 14a's small ELL cases
    (bench.ell_case), each through the ELL kernels: the 1D shock front at
    refinement 6, the step in dG Q1 at refinement 0 (a bump), the box3d
    domain at refinement 1 (a blast), the airfoil at refinement 0 (a
    bump), and the step in cG Q1 at refinement 0 unpadded (a bump; its
    16,449 rows leave the last block of ell_pk2 and ell_pk3 ragged)."""
    from ryujin_tpu_torch.bench import ell_case

    for name, refinement, label, bump in (
            ("1D", 6, "1D shock front, refinement 6", None),
            ("2D dG Q1", 0, "2D dG Q1 step, refinement 0", False),
            ("3D", 1, "3D box, refinement 1, blast", True),
            ("airfoil", 0, "airfoil, refinement 0", False),
            ("ragged", 0, "2D step, refinement 0, unpadded", False)):
        eq, packed, hm, ti, U0 = ell_case(name, refinement, dtype, dev)
        if bump is not None:
            U0 = bumped(packed, U0, blast=bump)
        yield label, eq, hm, ti, U0


def ell_developed(label, eq, hm, ti, U0, steps):
    """(U_a, U_b): the state after `steps` steps through the kernels and
    one more; fails the run unless both are finite and admissible."""
    U_a, _, t_a, _, restarts, warns = ti.advance(U0, 0.0, steps)
    U_b = ti.advance(U_a, t_a, 1)[0]
    st = hm.stencil
    real = st.node_mask > 0
    K = st.K
    good = all(bool(torch.isfinite(U[:, real]).all())
               and bool(eq.is_admissible(U[:, real]).all())
               for U in (U_a, U_b))
    from ryujin_tpu_torch.kernels.ell import ell_step_shape

    rows = ell_step_shape("ell_pk3", st.dim, K, U0.dtype, 2, st.n).rows
    print(f"  {label}: {int(real.sum())} real of {st.n} rows (ell_pk3's "
          f"blocks of {rows}: {st.n % rows} in the last), K = {K}, dG "
          f"{st.incidence is not None}, {U0.dtype}, t = {t_a.item():.4e} "
          f"after {steps} steps, restarts {int(restarts)}, warnings "
          f"{int(warns)}", flush=True)
    if not good:
        fail(f"{label}: the developed state is not admissible")
    return U_a, U_b


def check_ell(dev, card, records, mqs_canvas):
    """Phase 14, the padded-ELL path; fills `records` with the ELL kernels'
    JSON records (times on the full-size step, launches of 14d's run);
    fails the run on any error."""
    from ryujin_tpu_torch import shocktube
    from ryujin_tpu_torch.bench import build_ell, build_step2d
    from ryujin_tpu_torch.offline import geometry
    from ryujin_tpu_torch.solver.integrator import TABLEAUX
    from ryujin_tpu_torch.vortex import BASELINES, drive_vortex

    ok = True
    # ---- 14a: the full-size step (f32), its state that of 14d's warmup ----
    print(f"phase 14a: the ELL kernels against their plain versions; the "
          f"step at refinement {ELL_REFINEMENT} packed by ell.pack, f32, "
          f"{ELL_WARMUP} ERK33 steps through the ELL kernels", flush=True)
    t0 = time.perf_counter()
    step = geometry.step(refinement=ELL_REFINEMENT)
    eq, sd, hm, ti, U0 = build_ell(step, torch.float32, dev, recovery="none")
    print(f"  setup {time.perf_counter() - t0:.1f} s: {sd.n_nodes} real "
          f"rows of {sd.n_pad}, K = {sd.max_degree}, "
          f"{int((hm.stencil.mask > 0).sum())} live edges, route "
          f"{'half-slot' if hm.half else 'two-direction'}", flush=True)
    if hm.ell is None or hm.half:
        fail("the step packed by ell.pack did not take the ELL stepper")
    U_w = ti.advance(U0, 0.0, ELL_WARMUP)
    U_a, t_a = U_w[0], U_w[2]
    U_b = ti.advance(U_a, t_a, 1)[0]
    torch.cuda.synchronize()
    ell_records = {}
    ok &= compare_ell(hm, U_a, U_b, TOL_F32, REPS, ell_records,
                      tag="[2D step]")
    del U_b

    for dt, tol in ((torch.float32, TOL_F32), (torch.float64, TOL_F64)):
        t0 = time.perf_counter()
        for label, eq_s, hm_s, ti_s, U0_s in ell_meshes(dt, dev):
            U_sa, U_sb = ell_developed(label, eq_s, hm_s, ti_s, U0_s,
                                       ELL_DEVELOP_STEPS)
            ok &= compare_ell(hm_s, U_sa, U_sb, tol)
            # ERK54's substeps pass 3 and 4 stage slots
            for slots in WIDE_SLOTS:
                ok &= compare_ell(hm_s, U_sa, U_sb, tol,
                                  weights=erk54_weights(slots))
            del hm_s, ti_s
            print(f"  {label}, {dt}: {time.perf_counter() - t0:.1f} s with "
                  "the setup", flush=True)
            t0 = time.perf_counter()
    if not ok:
        fail("an ELL kernel disagrees with its plain version")

    # ---- 14b: ELL against the canvas on the same mesh ----------------------
    print(f"phase 14b: ELL against the canvas, the step at refinement "
          f"{ELL_CANVAS_REFINEMENT}, f64, {ELL_CANVAS_STEPS} ERK33 steps "
          "through the kernels of each layout", flush=True)
    out = {}
    step = geometry.step(refinement=ELL_CANVAS_REFINEMENT)
    for layout, built in (
            ("canvas", build_step2d(ELL_CANVAS_REFINEMENT, torch.float64,
                                    dev)),
            ("ell", build_ell(step, torch.float64, dev, recovery="none"))):
        _, sd_l, hm_l, ti_l, U0_l = built
        res = ti_l.advance(bumped(sd_l, U0_l), 0.0, ELL_CANVAS_STEPS)
        out[layout] = (sd_l, res[0], res[3])
    (sd_c, U_c, tau_c), (sd_e, U_e, tau_e) = out["canvas"], out["ell"]
    Uc = U_c[:, torch.as_tensor(sd_c.vertex_to_node, device=dev)]
    Ue = U_e[:, torch.as_tensor(sd_e.vertex_to_node, device=dev)]
    excess = ((Ue - Uc).abs() - (1e-12 + 1e-10 * Uc.abs())).max().item()
    tau_rel = abs(tau_e.item() / tau_c.item() - 1.0)
    good = excess <= 0.0 and tau_rel <= 1e-12
    ok &= good
    print(f"  {Uc.shape[1]} vertices: max |U_ell - U_canvas| "
          f"{(Ue - Uc).abs().max().item():.3e}, beyond rtol 1e-10 / atol "
          f"1e-12 by {excess:.3e}; tau {tau_e.item():.15e} against "
          f"{tau_c.item():.15e}, rel {tau_rel:.3e} (tol 1e-12) "
          f"{'ok' if good else 'FAIL'}", flush=True)
    del out, U_c, U_e, Uc, Ue

    # ---- 14c: the shock tubes and the vortex through ELL --------------------
    for name in ELL_TUBES:
        case = shocktube.CASES[name]
        print(f"phase 14c: the {name} shock tube through the ELL kernels, "
              f"f64, refinement {shocktube.REFINEMENT}, against the "
              f"reference's L1 (within {100 * case.bar:.0f} %)", flush=True)
        reset_ell_counts()
        run = shocktube.drive(case, shocktube.REFINEMENT, torch.float64, dev)
        good = (run.rel(case) <= case.bar and run.warnings == 0
                and run.t == case.t_final)
        good &= ell_counts_ok(3 * run.requested, name)
        ok &= good
        print(f"  Linf {run.norms[0]:.6e}  L1 {run.norms[1]:.6e}  L2 "
              f"{run.norms[2]:.6e}; reference L1 {case.l1:.6e}: "
              f"{100 * (run.norms[1] / case.l1 - 1.0):+.3f} %; {run.steps} "
              f"steps, {run.warnings} warnings, {run.seconds:.2f} s wall on "
              f"{card} {'ok' if good else 'FAIL'}", flush=True)
    print(f"phase 14c: the isentropic vortex through the ELL kernels, f64, "
          f"refinement {VORTEX_REFINEMENT}, ERK33, against the reference's "
          f"baselines (within {100 * VORTEX_BAR:.0f} %)", flush=True)
    reset_ell_counts()
    run = drive_vortex(VORTEX_REFINEMENT, "erk 33", torch.float64, dev,
                       layout="ell")
    good = run.hm.ell is not None and run.warnings == 0
    good &= ell_counts_ok(TABLEAUX["erk 33"].n_sub * run.requested, "vortex")
    for kind, got, ref in zip(("Linf", "L1", "L2"), run.norms,
                              BASELINES["erk 33"]):
        rel = abs(got / ref - 1.0)
        good &= rel <= VORTEX_BAR
        print(f"    {kind} {got:.6e} against the reference's {ref:.6e}: "
              f"{100 * rel:.3f} %", flush=True)
    print(f"  {run.steps} steps, {run.seconds:.2f} s wall "
          f"{'ok' if good else 'FAIL'}", flush=True)
    ok &= good
    del run
    if not ok:
        fail("the ELL path missed a bar")

    # ---- 14d: the full-size ELL step through the kernels ------------------
    print(f"phase 14d: the step at refinement {ELL_REFINEMENT} packed by "
          f"ell.pack, f32, {ELL_STEPS} timed ERK33 steps through the ELL "
          "kernels", flush=True)
    torch.cuda.synchronize()
    reset_ell_counts()
    t0 = time.perf_counter()
    U, _, t, tau, restarts, warns = ti.advance(U_a, t_a, ELL_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    mqs = sd.n_nodes * ELL_STEPS * 3 / wall / 1e6
    launches = {k: fn.launches for k, fn in ell_wrappers().items()}
    last = ell_wrappers()["ell_pk_up"].last_launches
    real = torch.as_tensor(sd.node_mask > 0, device=dev)
    Ur = U[:, real]
    good = bool(torch.isfinite(Ur).all()) and bool(eq.is_admissible(Ur).all())
    good &= tau.item() > 0.0 and int(warns) == 0 and int(restarts) == 0
    good &= ell_counts_ok(3 * ELL_STEPS, "14d")
    print(f"  t = {t.item():.4e}, tau = {tau.item():.4e}, warnings "
          f"{int(warns)}, finite and admissible {good}", flush=True)
    print(f"  ELL kernels: {mqs:.3f} MQ/s ({wall:.3f} s for {ELL_STEPS} "
          f"steps); the canvas kernels on the same mesh (phase 3): "
          f"{mqs_canvas:.3f} MQ/s; on {card}", flush=True)
    if not good:
        fail("the ELL step missed a gate")
    for name, rec in ell_records.items():
        base = name.split("[")[0]
        if base == "ell_pk_up last":
            rec["launches"] = last
        elif base == "ell_pk_up":
            rec["launches"] = launches["ell_pk_up"] - last
        else:
            rec["launches"] = launches[base]
    records.update(ell_records)


def ghost_case(name, dtype, dev):
    """Case `name` of phase 15a on the canvas and on the ELL layout of the
    same assembly: {"sd", "hm", "ti", "U0", "ell", "hm_e", "ti_e", "U0_e",
    "cols", "rtol", "layout"}, cols the ELL rows of the canvas's real nodes
    in node_to_vertex order, rtol the bar of the canvas against ELL (the
    JAX tests': 5e-11, 1e-10 for the higher-order ansatze), layout what the
    canvas must carry."""
    from ryujin_tpu_torch import bench
    from ryujin_tpu_torch.offline.mesh import Boundary
    from ryujin_tpu_torch.offline.separable import separate_z

    G, P = bench.geometry, Boundary.periodic
    eq = bench.Euler(dim=2)
    ansatz, kw, cfl, recovery, bump = "cG Q1", {}, 0.9, "bang bang control", True
    uniform = {"primitive_state": (1.4, 3.0, 1.0)}
    init = None
    if name == "periodic vortex":
        # tests/test_pallas.py:24-41
        mesh = G.rectangular_domain([-5, -5], [5, 5], [1, 1], refinement=4,
                                    boundary_conditions=[P] * 4)
        init = bench.make_initial_state(
            eq, "isentropic vortex", direction=[1, 1], position=[0, 0],
            mach_number=1.0, beta=5.0)
        cfl, recovery, bump = 0.3, "none", False
        layout = (((8, 16), None), None, (16, 128))
    elif name == "cylinder":
        # tests/test_pallas.py:184-219
        mesh = G.cylinder(refinement=2)
        init = bench.make_initial_state(eq, "uniform", direction=[1, 0],
                                        position=[1, 0], **uniform)
        cfl, recovery = 0.6, "none"
        layout = ((None, None), None, (64, 128))
    elif name == "SEP cylinder3d":
        # bench.build_cylinder3d at refinement 1 with the default pad_minor,
        # separable statics: the SEP instances read the ghost columns'
        # synthesized statics
        eq = bench.Euler(dim=3)
        mesh = G.cylinder(refinement=1, dim=3)
        kw = {"margin": (2, 2)}
        init = bench.make_initial_state(eq, "uniform", direction=[1, 0, 0],
                                        position=[1, 0, 0], **uniform)
        layout = ((None, None, None), None, (32, 128))
    elif name == "periodic box":
        eq = bench.Euler(dim=3)
        mesh = G.rectangular_domain([0.0] * 3, [1.0] * 3, [2, 2, 2],
                                    refinement=1, boundary_conditions=[P] * 6,
                                    dim=3)
        kw = {"margin": (2, 2)}
        init = bench.make_initial_state(eq, "uniform",
                                        direction=[1.0, 0.5, 0.25],
                                        primitive_state=(1.4, 1.0, 1.0))
        layout = (((2, 4), (2, 4), None), None, (4, 128))
    elif name.startswith("slabs"):
        # bench.build_step2d's flow, as the plain canvas it is held to
        mesh = G.step(refinement=0)
        slabs = int(name.split()[1])
        kw, recovery = {"slabs": slabs}, "none"
        layout = ((None, None), (slabs, 96 // slabs, 8), None)
    elif name == "q3 step":
        mesh, ansatz = G.step(refinement=0), "cG Q3"
        layout = ((None, None), None, None)
    else:
        # tests/test_ansatz_canvas.py:28-34, 57-65
        mesh = G.rectangular_domain([0, 0], [2, 1], [2, 1], 2,
                                    boundary_conditions=[P] * 4)
        ansatz = name.split(maxsplit=1)[1]
        cfl, recovery, bump = 0.3, "none", False

        def init(x, t):
            rho = 1.0 + 0.1 * torch.sin(2 * torch.pi * x[0]) * torch.cos(
                torch.pi * x[1])
            return torch.stack([rho, 0.2 * rho, -0.1 * rho,
                                1.0 / 0.4 + 0.5 * 0.05 * rho], 0)

        layout = None  # ghost bands and a minor wrap: checked below
    if init is None:
        init = bench.make_initial_state(eq, "uniform", **uniform)
    data = bench.assembly.assemble(mesh, ansatz=ansatz)
    sd = bench.structured.pack_structured(data, mesh, **kw)
    packed = bench.ell.pack(data)
    got = (tuple(sd.ghosts), sd.slab_spec, sd.minor_wrap)
    if layout is None:
        good = sd.ghosts[0] is not None and sd.minor_wrap is not None
    else:
        good = got == layout
    if not good:
        fail(f"phase 15a {name}: canvas layout {got}, expected {layout}")
    if name.startswith("SEP") and not separate_z(sd):
        fail(f"phase 15a {name}: the statics do not factor")
    out = {"sd": sd, "ell": packed, "layout": got,
           "rtol": 5e-11 if ansatz == "cG Q1" else 1e-10}
    for key, packing in (("", sd), ("_e", packed)):
        hm = bench.HyperbolicModule(eq, packing, init, dtype=dtype,
                                    device=dev,
                                    separable=(name.startswith("SEP")
                                               and not key))
        ti = bench.TimeIntegrator(hm, "erk 33", cfl_min=min(cfl, 0.45),
                                  cfl_max=cfl,
                                  cfl_recovery_strategy=recovery)
        U0 = bench.interpolate_nodal(init, packing, eq, 0.0, dtype, dev)
        if bump:
            U0 = bumped(packing, U0)
        out.update({"hm" + key: hm, "ti" + key: ti, "U0" + key: U0})
    real = np.flatnonzero(sd.node_to_vertex >= 0)
    out["real"] = real
    out["cols"] = packed.vertex_to_node[sd.node_to_vertex[real]]
    return out


class poisoned_rows:
    """Within the block, NaN at every cell of hm's canvas whose value_mask
    is 0 (the pad rows and the outermost slab bands, which no refresh
    makes valid) in every array after each ghost refresh and in every
    kernel output but PK3's okp (the kernels write it on every cell, 1 off
    the real nodes): the canvas kernels' inputs carry NaN in the rows no
    real node reads through a live slot."""

    NAMES = ("pk1", "pk2", "pk3", "pk_up", "pk1_stream", "pk2_stream",
             "pk3_stream")

    def __init__(self, hm):
        self.dead = hm.canvas.arrays.g_node[4].reshape(-1) == 0

    def __enter__(self):
        from ryujin_tpu_torch.solver import canvas_step

        self.saved = {name: getattr(canvas_step, name)
                      for name in self.NAMES + ("refresh",)}
        dead, saved = self.dead, self.saved

        def refresh(st, *arrays):
            saved["refresh"](st, *arrays)
            for X in arrays:
                if X is not None:
                    X[..., dead] = float("nan")

        def wrap(name):
            fn = saved[name]

            def wrapped(*args, **kwargs):
                out = fn(*args, **kwargs)
                for i, t in enumerate(out if isinstance(out, tuple)
                                      else (out,)):
                    if (torch.is_tensor(t) and t.ndim
                            and t.shape[-1] == dead.numel()
                            and not (name.startswith("pk3") and i == 2)):
                        t[..., dead] = float("nan")
                return out

            return wrapped

        refresh.launches = saved["refresh"].launches
        for name in self.NAMES:
            setattr(canvas_step, name, wrap(name))
        canvas_step.refresh = refresh
        return self

    def __exit__(self, *exc):
        from ryujin_tpu_torch.solver import canvas_step

        self.saved["refresh"].launches = canvas_step.refresh.launches
        for name, fn in self.saved.items():
            setattr(canvas_step, name, fn)
        return False


def canvas_vs_ell(c, steps, poison=False):
    """(good, U by vertex, tau): `steps` ERK33 steps through the canvas
    kernels and through the ELL kernels from the same state, every real
    vertex within c["rtol"] / 1e-12 and tau within 1e-12."""
    sd = c["sd"]
    if poison:
        with poisoned_rows(c["hm"]):
            out = c["ti"].advance(c["U0"], 0.0, steps)
    else:
        out = c["ti"].advance(c["U0"], 0.0, steps)
    out_e = c["ti_e"].advance(c["U0_e"], 0.0, steps)
    U = out[0][:, torch.as_tensor(c["real"], device=out[0].device)].cpu()
    U_e = out_e[0][:, torch.as_tensor(c["cols"], device=out[0].device)].cpu()
    finite = bool(torch.isfinite(U).all())
    good = finite and torch.allclose(U, U_e, rtol=c["rtol"], atol=1e-12)
    d = (U - U_e).abs().max().item()
    tau_rel = abs(out[3].item() / out_e[3].item() - 1.0)
    good &= tau_rel < 1e-12 and int(out[5]) == int(out_e[5])
    order = np.argsort(sd.node_to_vertex[c["real"]], kind="stable")
    print(f"  {steps} ERK33 steps, canvas kernels{' (NaN rows)' if poison else ''}"
          f" vs ELL kernels: max |dU| {d:.3e} (rtol {c['rtol']:.0e}, atol "
          f"1e-12), tau rel-err {tau_rel:.3e}, warnings {int(out[5])}, "
          f"finite {finite}  {'ok' if good else 'FAIL'}", flush=True)
    return good, U[:, order], out[3].item()


def seam_report(hm, U_a, U_b, hm64=None):
    """Where on the periodic vortex's canvas the stacked PK1's alpha and
    PK2's F differ from their plain versions, in hm's precision: an
    account, not a gate.  For each it prints the largest difference,
    relative to the largest |value| of each component, on the real rows
    within the reach of the y seam (they read the ghost band), on the
    other real nodes within the reach of the x wrap, and on the rest; for
    alpha also in units of its rounding bound (alpha_roundings(K) eps
    kappa_i, alpha_condition) and the largest kappa_i of each region; and
    the canvas cell of the largest difference.  With hm64 (f64 statics of
    the same canvas) also the kernel's and the plain version's distance
    from the plain version in f64 on the same inputs, upcast.  U_a and U_b
    are states as compare_kernels takes them."""
    from ryujin_tpu_torch.kernels import pk1, pk2
    from ryujin_tpu_torch.solver.canvas_step import refresh
    from ryujin_tpu_torch.solver.hyperbolic import (
        d_from_lambda, tau_max_from_d,
    )

    eq, p, ca = hm.eq, hm.params, hm.canvas.arrays
    st = ca.stencil
    (H, W), r, K = ca.shape, st.reach, ca.K
    g, P = ca.ghosts[0]
    weights = [0.75, -2.0]
    U, prec = hm.prepare_state_vector(U_b, 0.0)
    stage_U = torch.stack(stage_states(hm, U_a, U)[:2])
    refresh(st, U, prec, stage_U)
    lam_k, alpha_k = pk1.pk1(eq, p, ca, U, prec)
    out = {"pk1 alpha": [alpha_k, pk1.pk1_reference(eq, p, ca, U, prec)[1]]}
    lam = hm._lambda_fixup(lam_k, U)
    full = st.full()
    d = d_from_lambda(full, lam, full.cmax)
    refresh(st, lam, alpha_k)
    cap = torch.full((), float("inf"), dtype=U.dtype, device=U.device)
    tau = tau_max_from_d(st, d, 0.9, cap)
    args = (U, prec, lam, alpha_k, stage_U, weights, tau)
    out["pk2 F"] = [pk2.pk2(eq, p, ca, *args)[1],
                    pk2.pk2_reference(eq, p, ca, *args)[1]]
    if hm64 is not None:
        ca64 = hm64.canvas.arrays
        up = [x.double() if torch.is_tensor(x) else x for x in args]
        out["pk1 alpha"].append(
            pk1.pk1_reference(eq, p, ca64, up[0], up[1])[1])
        out["pk2 F"].append(pk2.pk2_reference(eq, p, ca64, *up)[1])
    kappa = alpha_condition(hm, U, prec).reshape(H, W)
    bound = (alpha_roundings(K, 2, eq.n_comp) * torch.finfo(U.dtype).eps
             * kappa)
    real = (st.node_mask > 0).reshape(H, W)
    rows = torch.arange(H, device=U.device)[:, None]
    cols = torch.arange(W, device=U.device)[None, :]
    seam = real & ((rows < g + r) | (rows >= g + P - r))
    Px = ca.minor_wrap[0] if ca.minor_wrap is not None else W
    wrap = real & ~seam & ((cols < r) | ((cols >= Px - r) & (cols < Px)))
    regions = (("y seam", seam), ("x wrap", wrap),
               ("elsewhere", real & ~seam & ~wrap))

    def by_region(x, fmt=".3e"):
        return ", ".join(f"{rn} {x[m].max().item():{fmt}}"
                         for rn, m in regions)

    print(f"  {U.dtype}, real rows {g}..{g + P - 1}, reach {r}: kappa_i "
          f"{by_region(kappa)}", flush=True)
    for name, vals in out.items():
        vals = [x.double().reshape(-1, H, W) for x in vals]
        scale = vals[-1].abs().amax(dim=(1, 2), keepdim=True).clamp_min(
            1e-300)
        pairs = [("kernel-plain", vals[0], vals[1])]
        if len(vals) == 3:
            pairs += [("kernel-f64", vals[0], vals[2]),
                      ("plain-f64", vals[1], vals[2])]
        parts = []
        for label, a, b in pairs:
            parts.append(f"{label}: " + by_region(
                ((a - b).abs() / scale).amax(0)))
            if name == "pk1 alpha":
                parts.append(f"{label} in rounding bounds: " + by_region(
                    (a - b).abs()[0] / bound))
        dm = ((vals[0] - vals[1]).abs() / scale).amax(0).masked_fill(~real, 0)
        row, col = divmod(int(dm.argmax()), W)
        print(f"  {name} {U.dtype}, where it differs: " + "; ".join(parts)
              + f"; the largest kernel-plain at canvas cell ({row}, {col})",
              flush=True)


def check_periodic_vortex(dev, card, stacked, clock):
    """Phase 15b's periodic vortex at PERIODIC_VORTEX_REFINEMENT: the f32
    run through the kernels with its gates, then the kernels against their
    plain versions at that width in f64 and seam_report's account; fails
    the run on any error."""
    from ryujin_tpu_torch import bench
    from ryujin_tpu_torch.solver import canvas_step
    from ryujin_tpu_torch.solver.integrator import TimeIntegrator

    f64, f32 = torch.float64, torch.float32
    print(f"phase 15b: the periodic vortex at refinement "
          f"{PERIODIC_VORTEX_REFINEMENT}, f32, {PERIODIC_VORTEX_STEPS} ERK33 "
          "steps through the kernels", flush=True)
    t0 = time.perf_counter()
    eq, sd, hm, ti, U0 = bench.build_periodic_vortex(
        PERIODIC_VORTEX_REFINEMENT, f32, dev)
    print(f"  setup {time.perf_counter() - t0:.1f} s: canvas {sd.shape}, "
          f"{sd.n_nodes} real nodes, ghosts {sd.ghosts}, minor_wrap "
          f"{sd.minor_wrap}", flush=True)
    if sd.ghosts[0] is None:
        fail("phase 15b: the periodic vortex has no y ghost band")
    real = torch.as_tensor(sd.node_mask > 0, device=dev)
    m_i = hm.canvas.arrays.g_node[0].reshape(-1)[real].double()

    def totals(U):
        return (U[:, real].double() * m_i).sum(1)

    for fn in stacked.values():
        fn.launches = 0
    stacked["pk_up"].last_launches = 0
    canvas_step.refresh.launches = 0
    T0 = totals(hm.prepare_state_vector(U0, 0.0)[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    U, _, t, tau, restarts, warns = ti.advance(U0, 0.0, PERIODIC_VORTEX_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in stacked.items()}
    launches["pk_up last"] = stacked["pk_up"].last_launches
    refreshes = canvas_step.refresh.launches
    substeps = 3 * PERIODIC_VORTEX_STEPS
    T1 = totals(U)
    drift = ((T1 - T0).abs() / T0.abs()).max().item()
    Ur = U[:, real]
    finite = bool(torch.isfinite(Ur).all())
    admissible = bool(eq.is_admissible(Ur).all())
    mqs = sd.n_nodes * substeps / wall / 1e6
    print(f"  t = {t.item():.4e}, tau = {tau.item():.4e}, warnings "
          f"{int(warns)}, restarts {int(restarts)}, finite {finite}, "
          f"admissible {admissible}; conserved totals' largest relative "
          f"change {drift:.3e} (bar {CONSERVATION_BAR:.0e})", flush=True)
    print(f"  kernels: {mqs:.3f} MQ/s ({wall:.3f} s for "
          f"{PERIODIC_VORTEX_STEPS} steps) on {card}; launches a substep: "
          f"{ {k: v / substeps for k, v in launches.items()} }, ghost "
          f"refreshes {refreshes / substeps:.3f}", flush=True)
    want = {"pk1": 1, "pk2": 1, "pk3": 1, "pk_up": 2}
    if not (finite and admissible) or int(warns) or int(restarts):
        fail("phase 15b: the periodic vortex left the admissible set or "
             "warned")
    if drift > CONSERVATION_BAR:
        fail(f"phase 15b: a conserved total moved by {drift:.3e}")
    if any(launches[k] != w * substeps for k, w in want.items()):
        fail(f"phase 15b: launch counts {launches} in {substeps} substeps")
    if not refreshes:
        fail("phase 15b: no ghost refresh on the periodic vortex")
    # the stacked kernels against their plain versions on this canvas (a y
    # ghost band, the x period native to the canvas), in f64 on the state
    # the f32 run reached and the state one f64 step later
    print("phase 15b: the periodic vortex's kernels against their plain "
          f"versions at refinement {PERIODIC_VORTEX_REFINEMENT}, f64, on the "
          f"state after the {PERIODIC_VORTEX_STEPS} steps", flush=True)
    hm64 = bench.HyperbolicModule(eq, sd, hm.initial_state_fn, dtype=f64,
                                  device=dev)
    ti64 = TimeIntegrator(hm64, "erk 33", cfl_min=0.3, cfl_max=0.3,
                          cfl_recovery_strategy="none")
    U_a = U.double()
    U_b = ti64.advance(U_a, t.double(), 1)[0]
    seam_report(hm, U_a.float(), U_b.float(), hm64)
    seam_report(hm64, U_a, U_b)
    if not compare_kernels(hm64, U_a, U_b, TOL_F64, 2, exact_l64=False,
                           alpha_kappa=True):
        fail("phase 15b: a kernel disagrees with its plain version on the "
             "periodic vortex at full width")
    del hm, hm64, ti, ti64, U, U0, U_a, U_b
    torch.cuda.empty_cache()
    clock.lap("phase 15b, the periodic vortex")



def check_ghosts(dev, card, records, streamed, stacked, clock):
    """Phase 15: canvases with ghost rows (periodic ghost bands, the padded
    periodic minor axis, slabs of canvas axis 0) and cG Q3 (K = 48) through
    the canvas kernels.  Fills `records` with the K = 48 instances; fails
    the run on any error."""
    from ryujin_tpu_torch import bench
    from ryujin_tpu_torch.solver.integrator import TimeIntegrator

    f64, f32 = torch.float64, torch.float32
    ok = True
    print("phase 15a: canvases with ghost rows and cG Q3, f64: each kernel "
          "against its plain version on the refreshed inputs, then "
          f"{GHOST_STEPS} ERK33 steps through the canvas kernels against the "
          "ELL kernels on the same mesh", flush=True)
    slab_runs = {}
    for name in GHOST_CASES:
        t0 = time.perf_counter()
        c = ghost_case(name, f64, dev)
        sd, hm, ti = c["sd"], c["hm"], c["ti"]
        print(f"  {name}: canvas {sd.shape}, {sd.n_nodes} real nodes, K = "
              f"{sd.max_degree}, (ghosts, slab_spec, minor_wrap) "
              f"{c['layout']}, {'stream' if hm.canvas.stream else 'stacked'} "
              f"kernels, route {'half-slot' if hm.half else 'two-direction'}"
              f", setup {time.perf_counter() - t0:.1f} s", flush=True)
        poison = name.startswith("slabs")
        U_a, _, t_a, _, _, _ = ti.advance(c["U0"], 0.0, GHOST_DEVELOP_STEPS)
        U_b = ti.advance(U_a, t_a, 1)[0]
        if poison:
            with poisoned_rows(hm):
                ok &= compare_kernels(hm, U_a, U_b, TOL_F64, 2,
                                      exact_l64=False)
        else:
            ok &= compare_kernels(hm, U_a, U_b, TOL_F64, 2, exact_l64=False)
        good, U, tau = canvas_vs_ell(c, GHOST_STEPS)
        ok &= good
        if poison:
            good_p, U_p, tau_p = canvas_vs_ell(c, GHOST_STEPS, poison=True)
            same = torch.equal(U_p, U) and tau_p == tau
            print(f"  NaN in the never-refreshed rows: every real node equal "
                  f"to the run without  {'ok' if same else 'FAIL'}",
                  flush=True)
            ok &= good_p and same
            slab_runs[name] = (U, tau)
    # slabs 2 and 4 against the plain canvas (tests/test_pallas.py:304-310)
    _, sd1, hm1, ti1, U01 = bench.build_step2d(0, f64, dev)
    out1 = ti1.advance(bumped(sd1, U01), 0.0, GHOST_STEPS)
    real1 = np.flatnonzero(sd1.node_to_vertex >= 0)
    order1 = real1[np.argsort(sd1.node_to_vertex[real1], kind="stable")]
    U1 = out1[0][:, torch.as_tensor(order1, device=dev)].cpu()
    for name, (U, tau) in slab_runs.items():
        d = (U - U1).abs().max().item()
        good = torch.allclose(U, U1, rtol=1e-12, atol=0)
        good &= abs(tau / out1[3].item() - 1.0) <= 1e-12
        print(f"  {name} against slabs 1: max |dU| {d:.3e} (rtol 1e-12; "
              f"{'bit-equal' if d == 0 else 'not bit-equal'})  "
              f"{'ok' if good else 'FAIL'}", flush=True)
        ok &= good
    if not ok:
        fail("phase 15a: a canvas with ghost rows or at K = 48 disagrees")
    clock.lap("phase 15a")

    check_periodic_vortex(dev, card, stacked, clock)

    print(f"phase 15b: the step at refinement {SLAB_REFINEMENT} in 4 slabs "
          f"against 1, f32, {SLAB_STEPS} ERK33 steps through the kernels",
          flush=True)
    mesh = bench.geometry.step(refinement=SLAB_REFINEMENT)
    data = bench.assembly.assemble(mesh)
    eq = bench.Euler(dim=2)
    init = bench.make_initial_state(eq, "uniform",
                                    primitive_state=(1.4, 3.0, 1.0))
    by_vertex = {}
    for slabs in (1, 4):
        sd = bench.structured.pack_structured(data, mesh, slabs=slabs)
        hm = bench.HyperbolicModule(eq, sd, init, dtype=f32, device=dev)
        ti = bench.TimeIntegrator(hm, "erk 33", cfl_min=0.9, cfl_max=0.9,
                                  cfl_recovery_strategy="none")
        U0 = bench.interpolate_nodal(init, sd, eq, 0.0, f32, dev)
        out = ti.advance(U0, 0.0, SLAB_STEPS)
        realv = np.flatnonzero(sd.node_to_vertex >= 0)
        order = realv[np.argsort(sd.node_to_vertex[realv], kind="stable")]
        by_vertex[slabs] = (out[0][:, torch.as_tensor(order, device=dev)],
                            out[3].item(), int(out[5]), sd.shape,
                            sd.slab_spec)
    (U1, tau1, w1, s1, _), (U4, tau4, w4, s4, spec) = (by_vertex[1],
                                                      by_vertex[4])
    d = (U4 - U1).abs().max().item()
    good = (bool(torch.isfinite(U4).all()) and tau4 == tau1 and w1 == w4 == 0
            and d <= 1e-12 * U1.abs().max().item())
    print(f"  canvas {s1} and {s4} (slab_spec {spec}): max |dU| {d:.3e} "
          f"(relative bar 1e-12; {'bit-equal' if d == 0 else 'not bit-equal'}"
          f"), tau {tau4:.6e} vs {tau1:.6e}  {'ok' if good else 'FAIL'}",
          flush=True)
    if not good:
        fail("phase 15b: 4 slabs disagree with 1")
    del by_vertex, U1, U4, hm, ti, data
    torch.cuda.empty_cache()
    clock.lap("phase 15b, slabs")

    print(f"phase 15b: cG Q3 (K = 48) on the step at refinement "
          f"{Q3_REFINEMENT}, f32, {Q3_DEVELOP_STEPS} ERK33 steps through the "
          "kernels", flush=True)
    t0 = time.perf_counter()
    eq, sd, hm, ti, U0 = bench.build_q3step2d(Q3_REFINEMENT, f32, dev)
    print(f"  setup {time.perf_counter() - t0:.1f} s: canvas {sd.shape}, "
          f"{sd.n_nodes} dofs, K = {sd.max_degree}, route "
          f"{'half-slot' if hm.half else 'two-direction'}", flush=True)
    if sd.max_degree != 48 or not hm.canvas.stream:
        fail("phase 15b: cG Q3 did not take the K = 48 stream path")
    U_a, _, t_a, _, _, _ = ti.advance(U0, 0.0, Q3_DEVELOP_STEPS)
    U_b = ti.advance(U_a, t_a, 1)[0]
    recs = {}
    if not compare_kernels(hm, U_a, U_b, TOL_F32, REPS, recs, tag="[K=48]"):
        fail("phase 15b: a K = 48 kernel disagrees with its plain version")
    want = {"pk1_stream": 1, "pk2_stream": 1, "pk3_stream": 1, "pk_up": 2}
    launches = run_slice(
        "phase 15b, q3step2d", eq, sd, ti,
        TimeIntegrator(PlainSteps(hm), "erk 33", cfl_min=0.45, cfl_max=0.9,
                       cfl_recovery_strategy="bang bang control"),
        U_a, 1, Q3_STEPS, 1, streamed, want, card, allow_restarts=True)
    for name in ("pk1_stream", "pk2_stream", "pk3_stream"):
        recs[name + "[K=48]"]["launches"] = launches[name]
    up_launches(recs, "pk_up[K=48]", launches)
    records.update(recs)


def per_substep(fns):
    """Launches per substep of each wrapper in `fns`: PK1-PK3 once,
    pk_up twice."""
    return {k: 2 if k == "pk_up" else 1 for k in fns}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); nothing to check", flush=True)
        sys.exit(1)
    from ryujin_tpu_torch.bench import (
        build_box3d, build_q2step2d, build_step2d,
    )
    from ryujin_tpu_torch.kernels import (
        build, pk1, pk1_stream, pk2, pk2_stream, pk3, pk3_stream, pk_up,
    )
    from ryujin_tpu_torch.solver.hyperbolic import HyperbolicModule
    from ryujin_tpu_torch.solver.integrator import TimeIntegrator

    t_start = time.perf_counter()
    clock = Clock()
    cache_assembly()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    def plain_integrator(hm, recovery):
        return TimeIntegrator(PlainSteps(hm), "erk 33", cfl_min=0.45,
                              cfl_max=0.9, cfl_recovery_strategy=recovery)

    # the f32 module and states of phases 2-10, for phase 13a
    kept = {}

    # ---- phase 1: card + build -------------------------------------------
    card = smi_line()
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    so = build.build()
    build.library()
    print(f"build: {so.name} in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {build.GENCODE}, {len(build.sources())} sources in "
          "parallel)", flush=True)
    for line in so.with_suffix(".so.log").read_text().splitlines():
        if "Compiling entry function" in line:
            # the mangled name carries the kernel, its type and K
            name = line.split(chr(39))[1]
            sep = " (SEP)" if "SepStatics" in name else ""
            print(f"  ptxas: {name[:44]}{sep}", flush=True)
        elif "registers" in line or "spill" in line.lower():
            print(f"  ptxas:   {line.replace('ptxas info    :', '').strip()}",
                  flush=True)
    from ryujin_tpu_torch import kernel_times

    for label, r in kernel_times.resources(
            so.with_suffix(".so.log").read_text(),
            kernel_times.launch_shape).items():
        print(f"  resources: {label}: {r['regs']} registers, {r['stack']} B "
              f"stack, {r['threads']} threads, {r['smem']} B shared, "
              f"{r['warps']} resident warps an SM", flush=True)

    clock.lap("phase 1, card and build")

    # ---- phase 2: step2d kernels against their references ------------------
    print(f"phase 2: step2d, refinement {REFINEMENT}, f32, "
          f"{PLAIN_STEPS} plain ERK33 steps", flush=True)
    t0 = time.perf_counter()
    eq, sd, hm, ti, U0 = build_step2d(REFINEMENT, torch.float32, dev)
    print(f"  setup {time.perf_counter() - t0:.1f} s: canvas {sd.shape}, "
          f"{sd.n_nodes} real nodes, K = {sd.max_degree}", flush=True)
    ti_plain = plain_integrator(hm, "none")
    U_a, _, t_a, _, _, warns = ti_plain.advance(U0, 0.0, PLAIN_STEPS)
    U_b, _, _, _, _, _ = ti_plain.advance(U_a, t_a, 1)
    torch.cuda.synchronize()
    print(f"  t = {t_a.item():.4e}, warnings {int(warns)}", flush=True)
    records = {}
    ok = compare_kernels(hm, U_a, U_b, TOL_F32, REPS, records)
    kept["step2d"] = (hm, U_a, U_b)

    print("phase 2a: the stream kernels on the same K = 8 canvas", flush=True)
    records_k8 = {}
    ok &= compare_kernels(hm, U_a, U_b, TOL_F32, REPS, records_k8,
                          stream=True)
    ok &= pk1_against_stream(hm, U_b)

    print("phase 2b: step2d kernels in f64", flush=True)
    hm64 = HyperbolicModule(eq, sd, hm.initial_state_fn,
                            dtype=torch.float64, device=dev)
    ok &= compare_kernels(hm64, U_a.double(), U_b.double(), TOL_F64, REPS)
    del hm64

    print("phase 2c: 3 ERK33 steps, kernels on the card vs plain on the "
          "CPU, refinement 0, f64", flush=True)
    _, sd0, _, ti_g, _ = build_step2d(0, torch.float64, dev)
    _, _, _, ti_c, U0_c = build_step2d(0, torch.float64, "cpu")
    ok &= card_vs_plain_f64(ti_g, ti_c, sd0, U0_c, "cpu")
    if not ok:
        fail("a step2d kernel disagrees with its plain-torch reference")

    clock.lap("phase 2")

    # ---- phase 3: the step2d slice -------------------------------------------
    stacked = {"pk1": pk1.pk1, "pk2": pk2.pk2, "pk3": pk3.pk3,
               "pk_up": pk_up.pk_up}
    want = {"pk1": 1, "pk2": 1, "pk3": 1, "pk_up": 2}
    launches = run_slice("phase 3, step2d", eq, sd, ti, ti_plain, U0, WARMUP,
                         STEPS, PLAIN_TIMED_STEPS, stacked, want, card,
                         allow_restarts=False)
    for name in ("pk1", "pk2", "pk3"):
        records[name]["launches"] = launches[name]
    up_launches(records, "pk_up[K=8]", launches)
    del hm, ti, ti_plain, U_a, U_b, U0
    torch.cuda.empty_cache()

    clock.lap("phase 3")

    # ---- phase 4: q2step2d kernels against their references ------------------
    print(f"phase 4: q2step2d (cG Q2), refinement {Q2_REFINEMENT}, f32, "
          f"{Q2_DEVELOP_STEPS} ERK33 steps through the kernels", flush=True)
    t0 = time.perf_counter()
    eq, sd, hm, ti, U0 = build_q2step2d(Q2_REFINEMENT, torch.float32, dev)
    print(f"  setup {time.perf_counter() - t0:.1f} s: canvas {sd.shape}, "
          f"{sd.n_nodes} real nodes, K = {sd.max_degree}, "
          f"{len(hm._bp['k'])} boundary-pair slots", flush=True)
    if not hm.canvas.stream:
        fail("q2step2d did not choose the stream kernels")
    U_a, _, t_a, _, restarts, warns = ti.advance(U0, 0.0, Q2_DEVELOP_STEPS)
    U_b, _, _, _, _, _ = ti.advance(U_a, t_a, 1)
    torch.cuda.synchronize()
    real = torch.as_tensor(sd.node_mask > 0, device=dev)
    print(f"  t = {t_a.item():.4e}, restarts {int(restarts)}, warnings "
          f"{int(warns)}", flush=True)
    if not bool(eq.is_admissible(U_a[:, real]).all()):
        fail("q2step2d: the developed state is not admissible")
    records_q2 = {}
    ok = compare_kernels(hm, U_a, U_b, TOL_F32, REPS, records_q2)
    kept["q2step2d"] = (hm, U_a, U_b)

    print("phase 4b: q2step2d kernels in f64", flush=True)
    hm64 = HyperbolicModule(eq, sd, hm.initial_state_fn,
                            dtype=torch.float64, device=dev)
    ok &= compare_kernels(hm64, U_a.double(), U_b.double(), TOL_F64, REPS)
    del hm64
    torch.cuda.empty_cache()

    print("phase 4c: 3 ERK33 steps with bang-bang recovery, kernels vs the "
          "plain path on the card, cG Q2, refinement 0, f64", flush=True)
    _, sd0, hm0, ti_g, U0_g = build_q2step2d(0, torch.float64, dev)
    ok &= card_vs_plain_f64(
        ti_g, plain_integrator(hm0, "bang bang control"), sd0, U0_g, dev
    )

    print("phase 4d: 2 ERK33 steps at cfl_max 3.5 from a blast contrast, "
          "every step redone at cfl_min 0.45: kernels vs the plain path on "
          "the card, cG Q2, refinement 0, f64", flush=True)
    streamed = {"pk1_stream": pk1_stream.pk1_stream,
                "pk2_stream": pk2_stream.pk2_stream,
                "pk3_stream": pk3_stream.pk3_stream, "pk_up": pk_up.pk_up}
    want = {"pk1_stream": 1, "pk2_stream": 1, "pk3_stream": 1, "pk_up": 2}

    def redoing(steps_of):
        return TimeIntegrator(steps_of, "erk 33", cfl_min=0.45, cfl_max=3.5,
                              cfl_recovery_strategy="bang bang control")

    ok &= card_vs_plain_f64(redoing(hm0), redoing(PlainSteps(hm0)), sd0, U0_g,
                            dev, steps=2, blast=True, counted=(streamed, want))
    del hm0, ti_g, U0_g
    if not ok:
        fail("a q2step2d kernel disagrees with its plain-torch reference")

    clock.lap("phase 4")

    # ---- phase 5: the q2step2d slice -------------------------------------------
    launches = run_slice(
        "phase 5, q2step2d", eq, sd, ti,
        plain_integrator(hm, "bang bang control"), U0, Q2_WARMUP, Q2_STEPS,
        Q2_PLAIN_TIMED_STEPS, streamed, want, card, allow_restarts=True,
    )
    for name in ("pk1_stream", "pk2_stream", "pk3_stream"):
        records_q2[name]["launches"] = launches[name]
    up_launches(records_q2, "pk_up[K=24]", launches)
    records.update(records_q2)
    del hm, ti, U_a, U_b, U0
    torch.cuda.empty_cache()

    clock.lap("phase 5")

    # ---- phase 6: box3d kernels against their references ---------------------
    # The box3d flow is uniform and stays so (a steady state of its
    # boundary conditions), which leaves the limiter idle; the kernels are
    # compared on a state developed from a blast in the box instead.
    print(f"phase 6: box3d, refinement {BOX_REFINEMENT}, f32, "
          f"{BOX_DEVELOP_STEPS} ERK33 steps through the kernels from a blast "
          "contrast", flush=True)
    t0 = time.perf_counter()
    eq, sd, hm, ti, U0 = build_box3d(BOX_REFINEMENT, torch.float32, dev)
    print(f"  setup {time.perf_counter() - t0:.1f} s: canvas {sd.shape}, "
          f"{sd.n_nodes} real nodes, K = {sd.max_degree}, route "
          f"{'half-slot' if hm.half else 'two-direction'}", flush=True)
    if hm.half or not hm.canvas.stream:
        fail("box3d did not choose the stream kernels on the two-direction "
             "route")
    U_a, _, t_a, _, restarts, warns = ti.advance(bumped(sd, U0, blast=True),
                                                 0.0, BOX_DEVELOP_STEPS)
    U_b, _, _, _, _, _ = ti.advance(U_a, t_a, 1)
    torch.cuda.synchronize()
    real = torch.as_tensor(sd.node_mask > 0, device=dev)
    print(f"  t = {t_a.item():.4e}, restarts {int(restarts)}, warnings "
          f"{int(warns)}", flush=True)
    if not bool(eq.is_admissible(U_a[:, real]).all()):
        fail("box3d: the developed state is not admissible")
    records_3d = {}
    ok = compare_kernels(hm, U_a, U_b, TOL_F32, REPS, records_3d,
                         tag="[3D two-direction]")
    kept["box3d"] = (hm, U_a, U_b)

    print("phase 6d: the SEP instances at box3d size (separable statics) "
          "against their plain versions, on the same state as their "
          "full-statics twins above", flush=True)
    hm_sep, sep_bytes = module_bytes(lambda: HyperbolicModule(
        eq, sd, hm.initial_state_fn, dtype=torch.float32, device=dev,
        separable=True))
    full_bytes = module_bytes(lambda: HyperbolicModule(
        eq, sd, hm.initial_state_fn, dtype=torch.float32, device=dev))[1]
    print(f"  device memory held by a HyperbolicModule, f32: full statics "
          f"{full_bytes} bytes ({statics_bytes(hm.canvas.arrays)} in the five "
          f"static canvases), separable {sep_bytes} bytes "
          f"({statics_bytes(hm_sep.canvas.arrays)} in the factors); "
          f"separate_z {hm_sep.canvas.arrays.factor_seconds:.1f} s",
          flush=True)
    ok &= live_edges_agree("box3d", hm_sep, sd)
    ok &= compare_kernels(hm_sep, U_a, U_b, TOL_F32, REPS, records_3d,
                          tag="[3D two-direction SEP, box3d]",
                          up_tag=" SEP box3d")
    del U_a, U_b, hm_sep
    torch.cuda.empty_cache()

    print(f"phase 6b: both 3D routes on small boxes (refinement 1), f32 and "
          f"f64, after {SMALL_BOX_STEPS} ERK33 steps through the kernels from "
          "a bumped inflow", flush=True)
    small = {}
    for subdiv, half in SMALL_BOXES:
        route = "half-slot" if half else "two-direction"
        for dt, tol in ((torch.float32, TOL_F32), (torch.float64, TOL_F64)):
            _, sd_s, hm_s, ti_s, U0_s = build_box3d(1, dt, dev, subdiv=subdiv)
            print(f"  box {subdiv}: canvas {sd_s.shape}, {sd_s.n_nodes} real "
                  f"nodes, route {route}, {dt}", flush=True)
            if hm_s.half != half:
                fail(f"box {subdiv} did not choose the {route} route")
            Ua_s, _, t_s, _, _, _ = ti_s.advance(bumped(sd_s, U0_s), 0.0,
                                                 SMALL_BOX_STEPS)
            Ub_s = ti_s.advance(Ua_s, t_s, 1)[0]
            # the half-slot instances of PK1-PK3 are timed here; pk_up
            # (one instance for both routes) keeps its box3d record
            timed = {} if half and dt == torch.float32 else None
            ok &= compare_kernels(hm_s, Ua_s, Ub_s, tol, REPS, timed,
                                  tag=f"[3D {route}]")
            if timed:
                records_3d.update(
                    (k, v) for k, v in timed.items() if "half-slot" in k
                )
            if dt == torch.float64:
                small[subdiv] = (sd_s, hm_s, U0_s)

    print("phase 6c: 3 ERK33 steps with bang-bang recovery, kernels vs the "
          "plain path on the card, both small boxes, f64", flush=True)
    for subdiv, half in SMALL_BOXES:
        sd_s, hm_s, U0_s = small[subdiv]
        print(f"  box {subdiv}, route "
              f"{'half-slot' if half else 'two-direction'}", flush=True)
        ti_k = TimeIntegrator(hm_s, "erk 33", cfl_min=0.45, cfl_max=0.9,
                              cfl_recovery_strategy="bang bang control")
        ok &= card_vs_plain_f64(
            ti_k, plain_integrator(hm_s, "bang bang control"), sd_s, U0_s,
            dev, counted=(streamed, want),
        )
        if half:
            for name in ("pk1_stream", "pk2_stream", "pk3_stream"):
                records_3d[name + "[3D half-slot]"]["launches"] = (
                    streamed[name].launches
                )
    del small
    if not ok:
        fail("a 3D kernel disagrees with its plain-torch reference")

    clock.lap("phase 6")

    # ---- phase 7: the box3d slice ----------------------------------------------
    launches = run_slice(
        "phase 7, box3d", eq, sd, ti,
        plain_integrator(hm, "bang bang control"), U0, BOX_WARMUP, BOX_STEPS,
        BOX_PLAIN_TIMED_STEPS, streamed, want, card, allow_restarts=True,
    )
    for name in ("pk1_stream", "pk2_stream", "pk3_stream"):
        records_3d[name + "[3D two-direction]"]["launches"] = launches[name]
    up_launches(records_3d, "pk_up[K=26]", launches)
    records.update(records_3d)
    del hm, ti, U0
    torch.cuda.empty_cache()

    clock.lap("phase 7")
    records.update(check_dg(dev, card, streamed, stacked, kept))
    clock.lap("phases 8-9")
    cyl_records, launches = check_cylinder(dev, card, streamed, kept)
    records.update(cyl_records)
    clock.lap("phases 10-11")
    # the SEP instances' launches on the main path: the separable
    # cylinder3d slice (the box3d-size records are the same instances)
    for name, rec in records.items():
        if "two-direction SEP" in name:
            rec["launches"] = launches[name.split("[")[0]]
    for name in ("pk_up[K=26 SEP]", "pk_up[K=26 SEP box3d]"):
        up_launches(records, name, launches)

    # ---- phase 12: the measurement probes (rows 11-14) ------------------------
    records.update(check_probes())
    clock.lap("phase 12")

    # ---- phase 13: four stage slots, and the isentropic vortex -------------
    records.update(check_stages(dev, streamed, stacked, kept))
    clock.lap("phase 13a")
    # the stacked PK2 and PK3 at 3 and 4 slots: launches of the vortex's
    # ERK54 run, the path of this phase
    for name, by_slots in check_vortex(dev, card, stacked).items():
        for slots in WIDE_SLOTS:
            records[f"{name}[S={slots} step2d]"]["launches"] = by_slots[slots]

    # ---- phase 14: the padded-ELL path ---------------------------------------
    clock.lap("phases 13b-13c")
    check_ell(dev, card, records, SLICE_MQS["phase 3, step2d"])
    clock.lap("phase 14")
    del kept
    gc.collect()
    torch.cuda.empty_cache()

    # ---- phase 15: ghost rows and K = 48 --------------------------------------
    check_ghosts(dev, card, records, streamed, stacked, clock)
    clock.lap("phase 15b, cG Q3")
    print(f"chip_smoke: every phase passed, {time.perf_counter() - t_start:.1f}"
          " s in all", flush=True)

    # no single PyTorch call computes any of the stencil phases: their
    # library_ms is null; each probe record carries its own
    print(json.dumps({"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": rec["source"],
            "replaces": rec["replaces"],
            "launches": rec["launches"],
            "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"],
            "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"],
            "library_ms": rec.get("library_ms"),
            **{k: rec[k] for k in ("bound_ms_mask_as_stored", "bar", "chain",
                                   "chain_ms", "library_chain_ms")
               if rec.get(k) is not None},
        }
        for name, rec in records.items()
    ]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
