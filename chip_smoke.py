#!/usr/bin/env python3
"""Quickest proof that the PyTorch / CUDA port runs on a GPU.

    python3 chip_smoke.py            # from the root of a checkout, one card

It drives the port's two paths on the Mach-3 forward-facing step, both in
f32 with ERK33: step2d (cG Q1, reach 1, K = 8: pk1, pk2, pk3, pk_up) and
q2step2d (cG Q2, reach 2, K = 24: pk1_stream, pk2_stream, pk3_stream,
pk_up).  Phases (each prints its own lines; any failure exits non-zero):

1. the card (nvidia-smi name and power limit) and the kernel build from
   ryujin_tpu_torch/csrc with nvcc (one process per source, seconds taken);
2. step2d, refinement 3: every kernel against its plain-torch reference
   on the card, on identical inputs (after a few plain ERK33 steps so the
   bow shock has formed), error beside tolerance, each kernel's time
   beside its reference's and its bound; the stream kernels on the same
   K = 8 canvas beside pk1-pk3; the same comparison in f64; and three
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
   twice.

The lines before the last are the kernels' JSON record and the card's
nvidia-smi line; the last line is {"ok": true, "device": {...}}.
Without a CUDA device the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


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
# launches per kernel timing
REPS = 20

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
# transcendental as one operation: a flux tensor 14, a flux divergence
# 4 x 5, the two-rarefaction lambda_max with its precompute 95 (on half
# the slots), the indicator sums 22, the bounds accumulation 40, one
# limiter call with both Newton iterations 150.
EDGE_FLOPS = {
    "pk1": (14 + 22 + 95 / 2, 0), "pk1_stream": (14 + 22 + 95 / 2 + 0.5, 0),
    "pk2": (14 + 36 + 40, 14 + 24), "pk2_stream": (14 + 36 + 40, 14 + 24),
    "pk3": (14 + 40 + 150, 14 + 24), "pk3_stream": (14 + 40 + 150, 14 + 24),
    "pk_up": (9 + 4 + 150, 0),
}
TPU_SOURCE = {
    "pk1": "ryujin_tpu/solver/pallas_step.py:2676",
    "pk2": "ryujin_tpu/solver/pallas_step.py:2841",
    "pk3": "ryujin_tpu/solver/pallas_step.py:3044",
    "pk_up": "ryujin_tpu/solver/pallas_step.py:3265",
    "pk1_stream": "ryujin_tpu/solver/pallas_step.py:1904",
    "pk2_stream": "ryujin_tpu/solver/pallas_step.py:2879",
    "pk3_stream": "ryujin_tpu/solver/pallas_step.py:3093",
}


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
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(name, inputs, outputs, mask, live_edges, n_stages, dtype):
    """(least ms, "bytes" or "operations", least ms with the mask as
    stored) for one launch: every plane the function needs read once and
    every output written once over the memory rate, against the operations
    on this run's live edges over the peak rate.  `inputs` holds only the
    planes the kernel dereferences.  The edge mask is one bit a slot, so
    the function needs ceil(K / 32) 4-byte planes of it; the kernels read
    it as K planes of the state's type, and the third value is the bound
    with the mask counted so."""
    nbytes = sum(t.numel() * t.element_size() for t in inputs + outputs)
    K, n = mask.shape[0], mask[0].numel()
    mask_bits = 4 * n * -(-K // 32)
    mask_stored = mask.numel() * mask.element_size()
    per_edge, per_stage = EDGE_FLOPS[name]
    flops = live_edges * (per_edge + n_stages * per_stage)
    by_ops = flops / PEAK_FLOPS[dtype] * 1e3
    by_bytes = (nbytes + mask_bits) / PEAK_BYTES_PER_S * 1e3
    stored = max((nbytes + mask_stored) / PEAK_BYTES_PER_S * 1e3, by_ops)
    if by_bytes >= by_ops:
        return by_bytes, "bytes", stored
    return by_ops, "operations", stored


def compare_kernels(hm, U_a, U_b, tol, reps, records=None, stream=None):
    """Each kernel of the substep against its reference on identical
    inputs.  U_a is the state entering the substep, U_b a second prepared
    state; the stage inputs are those of the third ERK33 substep (weights
    0.75, -2).  `stream` picks the slot-streaming PK1-PK3 (default: as the
    stepper of `hm` does).  With `records`, also times every kernel and
    its reference and fills records[name] = {max_abs_err, ms, plain_ms,
    bound_ms, bound_by, bound_ms_mask_as_stored}.  Returns False if any
    output is off its tolerance."""
    from ryujin_tpu_torch.kernels import (
        pk1, pk1_stream, pk2, pk2_stream, pk3, pk3_stream, pk_up,
    )
    from ryujin_tpu_torch.solver.hyperbolic import d_from_lambda, tau_max_from_d

    eq, p, ca = hm.eq, hm.params, hm.canvas.arrays
    if stream is None:
        stream = hm.canvas.stream
    st = ca.stencil
    dt = U_a.dtype
    K, n = ca.K, ca.n
    U, prec = hm.prepare_state_vector(U_b, 0.0)
    stage_U = torch.stack([U_a, U])
    weights = [0.75, -2.0]
    real = st.node_mask > 0
    live = st.mask > 0
    live_edges = int(live.sum())
    ok = True

    def err(name, a, b, where, kind):
        """Error of kernel output a against reference b on the entries
        where `where` (broadcast to their shape) holds: max |a - b| /
        max |b| for kind "rel", max |a - b| otherwise; kind "l" allows
        the share tol["l_share"] of entries beyond tol["l"]."""
        nonlocal ok
        m = where.expand(b.shape)
        a, b = a.reshape(b.shape)[m], b[m]
        diff = (a - b).abs()
        d = diff.max().item()
        finite = bool(torch.isfinite(a).all())
        extra = ""
        if kind == "rel":
            val, lim = d / max(b.abs().max().item(), 1e-300), tol["rel"]
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
        ok &= good
        print(f"  {name:16s} {dt} {kind}-err {val:.3e}  tol {lim:.1e}  "
              f"{'ok' if good else 'FAIL'}{extra}", flush=True)
        return d

    sfx = "_stream" if stream else ""
    n1, n2, n3, nu = "pk1" + sfx, "pk2" + sfx, "pk3" + sfx, f"pk_up[K={K}]"
    mods = {"pk1": pk1, "pk2": pk2, "pk3": pk3, "pk_up": pk_up,
            "pk1_stream": pk1_stream, "pk2_stream": pk2_stream,
            "pk3_stream": pk3_stream}

    def pair(name):
        """(kernel wrapper, plain-torch reference) of kernel `name`."""
        name = name.split("[")[0]
        return getattr(mods[name], name), getattr(mods[name], name + "_reference")

    def run(name, *args):
        fk, fr = pair(name)
        return fk(*args), fr(*args)

    errs = {}
    args1 = (eq, p, ca, U, prec)
    (lam_k, alpha_k), (lam, alpha) = run(n1, *args1)
    half_live = live[: K // 2]
    errs[n1] = max(
        err(f"{n1} {'e' if stream else 'lambda'}", lam_k, lam, half_live, "rel"),
        err(f"{n1} alpha", alpha_k, alpha, real, "rel"),
    )
    lam = hm._lambda_fixup(lam, U, prescaled=stream)
    d = d_from_lambda(st, lam, None if stream else ca.g_cmax.reshape(K, -1))
    cap = torch.full((), float("inf"), dtype=dt, device=U.device)
    tau = tau_max_from_d(st, d, 0.9, cap)

    args2 = (eq, p, ca, U, prec, lam, alpha, stage_U, weights, tau)
    (Ul_k, F_k, b_k), (U_low, F, bounds) = run(n2, *args2)
    errs[n2] = max(
        err(f"{n2} U_low", Ul_k, U_low, real, "rel"),
        err(f"{n2} F", F_k, F, real, "rel"),
        err(f"{n2} bounds", b_k, bounds, real, "rel"),
    )
    args3 = (eq, p, ca, U, lam, alpha, F, U_low, bounds, stage_U, weights, tau)
    (P_k, l_k, okp_k), (P, l, okp) = run(n3, *args3)
    errs[n3] = max(
        err(f"{n3} P", P_k, P, live, "rel"),
        err(f"{n3} l", l_k, l, live, "l"),
    )
    n_ok = int((okp_k[real] != okp[real]).sum())
    print(f"  {n3} okp {dt} nodes differing: {n_ok}", flush=True)
    ok &= n_ok == 0

    args4 = (eq, p, ca, U_low, bounds, P, l, False)
    (U4_k, l4_k), (U4, l4) = run("pk_up", *args4)
    args5 = (eq, p, ca, U4, bounds, P, l4, True)
    (U5_k, _), (U5, _) = run("pk_up", *args5)
    errs[nu] = max(
        err("pk4 U", U4_k, U4, real, "U"),
        err("pk4 l'", l4_k, l4, live, "l"),
        err("pk5 U", U5_k, U5, real, "U"),
    )
    if records is None:
        return ok

    # the planes each launch dereferences (the edge mask apart) and those
    # it writes, for its bound.  Of g_node = (m_i, 1/m_i, n_nbrs,
    # node_mask, value_mask) PK1 reads m_i and node_mask, PK2 m_i and
    # 1/m_i, PK3 the first four; of prec = (s, eta) PK1 reads eta, PK2 s.
    # The stream forms read cmax only in PK1 and only on the half slots.
    node = ca.g_node
    traffic = {
        n1: ([ca.g_cij, node[[0, 3]], U, prec[1:]]
             + ([ca.g_cmax[: K // 2]] if stream else []), [lam_k, alpha_k]),
        n2: ([ca.g_cij, ca.g_cii, node[:2], U, prec[:1], lam, alpha, stage_U,
              tau] + ([] if stream else [ca.g_cmax]), [Ul_k, F_k, b_k]),
        n3: ([ca.g_cij, ca.g_mij, node[:4], U, lam, alpha, F, U_low, bounds,
              stage_U, tau] + ([] if stream else [ca.g_cmax]),
             [P_k, l_k, okp_k]),
        nu: ([ca.g_lam, U_low, bounds, P, l], [U4_k, l4_k]),
    }
    calls = {n1: args1, n2: args2, n3: args3, nu: args4}
    for name, a in calls.items():
        fk, fr = pair(name)
        ms = time_ms(lambda: fk(*a), reps)
        plain = time_ms(lambda: fr(*a), max(reps // 4, 2))
        base = name.split("[")[0]
        least, by, stored = bound_ms(
            base, *traffic[name], ca.g_mask, live_edges,
            len(weights) if base[:3] in ("pk2", "pk3") else 0, dt)
        records[name] = {"max_abs_err": errs[name], "ms": ms,
                         "plain_ms": plain, "bound_ms": least, "bound_by": by,
                         "bound_ms_mask_as_stored": stored}
        print(f"  {name:12s} kernel {ms:.4f} ms   plain {plain:.4f} ms   "
              f"bound {least:.4f} ms ({by}; {stored:.4f} ms with the mask "
              f"as stored)   {100 * least / ms:.1f} % of bound", flush=True)
    return ok


def card_vs_plain_f64(ti_kernels, ti_plain, sd, U0, plain_device, steps=3,
                      blast=False, counted=None):
    """`steps` ERK33 steps in f64, the kernels on the card against the
    plain path, from the inflow state times a smooth bump or, with
    `blast`, with an 8:1 density and 1000:1 energy contrast in a disc
    (at a cfl_max far beyond 1 such a step fails its limiter and
    bang-bang recovery redoes it at cfl_min).  Returns True if U and tau
    agree to 1e-10 and the restart and warning counts are equal; with
    `blast` also only if a step was redone.  `counted` = (wrappers, want)
    also holds the launch counts to want x 3 x (steps + restarts)."""
    pos = torch.as_tensor(sd.positions.T, dtype=torch.float64)
    centre = torch.tensor([[1.0], [0.5]], dtype=torch.float64)
    dist2 = torch.sum((pos - centre) ** 2, 0)
    U0 = U0.cpu().clone()
    if blast:
        disc = (dist2 < 0.2 ** 2) & torch.as_tensor(sd.node_mask > 0)
        U0[0, disc] *= 8.0
        U0[3, disc] *= 1000.0
    else:
        bump = 1.0 + 0.25 * torch.exp(-8.0 * dist2)
        U0[0] *= bump
        U0[3] *= bump
    if counted:
        for fn in counted[0].values():
            fn.launches = 0
    out_k = ti_kernels.advance(U0.cuda(), 0.0, steps)
    launches = {k: fn.launches for k, fn in counted[0].items()} if counted else {}
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
        substeps = 3 * (steps + restarts[0])
        good &= all(launches[k] == w * substeps for k, w in counted[1].items())
        extra = f", launches {launches} in {substeps} substeps"
    print(f"  U rel-err {rel:.3e}, tau rel-err {tau_rel:.3e} (tol 1e-10), "
          f"restarts {restarts}, warnings {warns}{extra} "
          f"{'ok' if good else 'FAIL'}", flush=True)
    return good


def run_slice(name, eq, sd, ti, ti_plain, U0, warmup, steps, plain_steps,
              kernels, want, card, allow_restarts):
    """Warmup, then `steps` timed ERK33 steps through the kernels with the
    launch counters set to 0 just before and read just after; the gates;
    then the plain-torch substep timed on the card.  Returns the launch
    counts."""
    print(f"{name}: slice, {warmup} warmup + {steps} timed ERK33 steps "
          "through the kernels", flush=True)
    U, _, t, _, r0, _ = ti.advance(U0, 0.0, warmup)
    torch.cuda.synchronize()
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    U, _, t, tau, restarts, warns = ti.advance(U, t, steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in kernels.items()}
    mqs = sd.n_nodes * steps * 3 / wall / 1e6

    real = torch.as_tensor(sd.node_mask > 0, device=U.device)
    Ur = U[:, real]
    finite = bool(torch.isfinite(Ur).all())
    admissible = bool(eq.is_admissible(Ur).all())
    tau_v, warns_v, restarts_v = tau.item(), int(warns), int(restarts)
    substeps = 3 * (steps + restarts_v)
    counts_ok = all(launches[k] == want[k] * substeps for k in want)
    print(f"  t = {t.item():.4e}, tau = {tau_v:.4e}, warnings {warns_v}, "
          f"restarts {restarts_v} (warmup {int(r0)}), finite {finite}, "
          f"admissible {admissible}, launches {launches}", flush=True)
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
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); nothing to check", flush=True)
        sys.exit(1)
    from ryujin_tpu_torch.bench import build_q2step2d, build_step2d
    from ryujin_tpu_torch.kernels import (
        build, pk1, pk1_stream, pk2, pk2_stream, pk3, pk3_stream, pk_up,
    )
    from ryujin_tpu_torch.solver.hyperbolic import HyperbolicModule
    from ryujin_tpu_torch.solver.integrator import TimeIntegrator

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    def plain_integrator(hm, recovery):
        return TimeIntegrator(PlainSteps(hm), "erk 33", cfl_min=0.45,
                              cfl_max=0.9, cfl_recovery_strategy=recovery)

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
            print(f"  ptxas: {line.split(chr(39))[1][:44]}", flush=True)
        elif "registers" in line or "spill" in line.lower():
            print(f"  ptxas:   {line.replace('ptxas info    :', '').strip()}",
                  flush=True)

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

    print("phase 2a: the stream kernels on the same K = 8 canvas", flush=True)
    records_k8 = {}
    ok &= compare_kernels(hm, U_a, U_b, TOL_F32, REPS, records_k8,
                          stream=True)

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

    # ---- phase 3: the step2d slice -------------------------------------------
    stacked = {"pk1": pk1.pk1, "pk2": pk2.pk2, "pk3": pk3.pk3,
               "pk_up": pk_up.pk_up}
    want = {"pk1": 1, "pk2": 1, "pk3": 1, "pk_up": 2}
    launches = run_slice("phase 3, step2d", eq, sd, ti, ti_plain, U0, WARMUP,
                         STEPS, PLAIN_TIMED_STEPS, stacked, want, card,
                         allow_restarts=False)
    for name in ("pk1", "pk2", "pk3"):
        records[name]["launches"] = launches[name]
    records["pk_up[K=8]"]["launches"] = launches["pk_up"]
    del hm, ti, ti_plain, U_a, U_b, U0
    torch.cuda.empty_cache()

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

    # ---- phase 5: the q2step2d slice -------------------------------------------
    launches = run_slice(
        "phase 5, q2step2d", eq, sd, ti,
        plain_integrator(hm, "bang bang control"), U0, Q2_WARMUP, Q2_STEPS,
        Q2_PLAIN_TIMED_STEPS, streamed, want, card, allow_restarts=True,
    )
    for name in ("pk1_stream", "pk2_stream", "pk3_stream"):
        records_q2[name]["launches"] = launches[name]
    records_q2["pk_up[K=24]"]["launches"] = launches["pk_up"]
    records.update(records_q2)

    print(json.dumps({"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": f"ryujin_tpu_torch/csrc/{name.split('[')[0]}.cu",
            "replaces": TPU_SOURCE[name.split("[")[0]],
            "launches": rec["launches"],
            "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"],
            "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"],
            "bound_ms_mask_as_stored": rec["bound_ms_mask_as_stored"],
            # no single PyTorch call computes any of these stencil phases
            "library_ms": None,
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
