#!/usr/bin/env python3
"""Quickest proof that the PyTorch / CUDA port runs on a GPU.

    python3 chip_smoke.py            # from the root of a checkout, one card

Phases (each prints its own lines; any failure exits non-zero):

1. the card (nvidia-smi name and power limit) and the kernel build from
   ryujin_tpu_torch/csrc with nvcc (seconds taken);
2. every kernel against its plain-torch reference on the card, on
   identical inputs at the step2d shapes (refinement 3, f32, after a few
   plain ERK33 steps so the bow shock has formed), error beside tolerance,
   plus each kernel's time beside its reference's; the same comparison in
   f64, and three ERK33 steps through the kernels against the plain path
   on the CPU at refinement 0 in f64;
3. the slice: step2d at refinement 3 (1,034,753 real nodes), f32, ERK33,
   CFL 0.9, recovery "none", through TimeIntegrator.advance: a warmup,
   then a timed run with the launch counters reset just before it; the
   state must stay finite and admissible, tau > 0, no step may warn, and
   every substep must have launched PK1, PK2, PK3 once and pk_up twice.
   MQ/s with the kernels and with the plain-torch substep on the card.

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


# the step2d sizes: refinement 3, plain ERK33 steps before the kernel
# comparisons, warmup and timed steps of the slice, plain-torch timed
# steps, and launches per kernel timing
REFINEMENT = 3
PLAIN_STEPS = 100
WARMUP = 300
STEPS = 100
PLAIN_TIMED_STEPS = 10
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


def compare_kernels(hm, U_a, U_b, tol, reps, records=None):
    """Each kernel against its reference on identical inputs.  U_a is the
    state entering the substep, U_b a second prepared state; the stage
    inputs are those of the third ERK33 substep (weights 0.75, -2).
    Returns False if any output is off its tolerance."""
    from ryujin_tpu_torch.kernels import pk1, pk2, pk3, pk_up
    from ryujin_tpu_torch.solver.hyperbolic import d_from_lambda, tau_max_from_d

    eq, p, ca = hm.eq, hm.params, hm.canvas.arrays
    st = ca.stencil
    dt = U_a.dtype
    K, n = ca.K, ca.n
    U, prec = hm.prepare_state_vector(U_b, 0.0)
    stage_U = torch.stack([U_a, U])
    weights = [0.75, -2.0]
    real = st.node_mask > 0
    live = st.mask > 0
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
        print(f"  {name:12s} {dt} {kind}-err {val:.3e}  tol {lim:.1e}  "
              f"{'ok' if good else 'FAIL'}{extra}", flush=True)
        return d

    mods = {"pk1": pk1, "pk2": pk2, "pk3": pk3, "pk_up": pk_up}

    def pair(name):
        """(kernel wrapper, plain-torch reference) of kernel `name`."""
        return getattr(mods[name], name), getattr(mods[name], name + "_reference")

    def run(name, *args):
        fk, fr = pair(name)
        return fk(*args), fr(*args)

    errs, times = {}, {}
    args1 = (eq, p, ca, U, prec)
    (lam_k, alpha_k), (lam, alpha) = run("pk1", *args1)
    half_live = live[: K // 2]
    errs["pk1"] = max(
        err("pk1 lambda", lam_k, lam, half_live, "rel"),
        err("pk1 alpha", alpha_k, alpha, real, "rel"),
    )
    lam = hm._lambda_fixup(lam, U)
    d = d_from_lambda(st, lam, ca.g_cmax.reshape(K, -1))
    cap = torch.full((), float("inf"), dtype=dt, device=U.device)
    tau = tau_max_from_d(st, d, 0.9, cap)

    args2 = (eq, p, ca, U, prec, lam, alpha, stage_U, weights, tau)
    (Ul_k, F_k, b_k), (U_low, F, bounds) = run("pk2", *args2)
    errs["pk2"] = max(
        err("pk2 U_low", Ul_k, U_low, real, "rel"),
        err("pk2 F", F_k, F, real, "rel"),
        err("pk2 bounds", b_k, bounds, real, "rel"),
    )
    args3 = (eq, p, ca, U, lam, alpha, F, U_low, bounds, stage_U, weights, tau)
    (P_k, l_k, okp_k), (P, l, okp) = run("pk3", *args3)
    errs["pk3"] = max(
        err("pk3 P", P_k, P, live, "rel"),
        err("pk3 l", l_k, l, live, "l"),
    )
    n_ok = int((okp_k[real] != okp[real]).sum())
    print(f"  pk3 okp      {dt} nodes differing: {n_ok}", flush=True)
    ok &= n_ok == 0

    args4 = (eq, p, ca, U_low, bounds, P, l, False)
    (U4_k, l4_k), (U4, l4) = run("pk_up", *args4)
    args5 = (eq, p, ca, U4, bounds, P, l4, True)
    (U5_k, _), (U5, _) = run("pk_up", *args5)
    errs["pk_up"] = max(
        err("pk4 U", U4_k, U4, real, "U"),
        err("pk4 l'", l4_k, l4, live, "l"),
        err("pk5 U", U5_k, U5, real, "U"),
    )
    if records is not None:
        calls = {"pk1": args1, "pk2": args2, "pk3": args3, "pk_up": args4}
        for name, a in calls.items():
            fk, fr = pair(name)
            times[name] = (time_ms(lambda: fk(*a), reps),
                           time_ms(lambda: fr(*a), max(reps // 4, 2)))
            print(f"  {name:6s} kernel {times[name][0]:.4f} ms   plain "
                  f"{times[name][1]:.4f} ms", flush=True)
        records.update({k: (errs[k],) + times[k] for k in errs})
    return ok


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); nothing to check", flush=True)
        sys.exit(1)
    from ryujin_tpu_torch.bench import build_step2d
    from ryujin_tpu_torch.kernels import build, pk1, pk2, pk3, pk_up

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ---- phase 1: card + build -------------------------------------------
    card = smi_line()
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    so = build.build()
    build.library()
    print(f"build: {so.name} in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {build.GENCODE})", flush=True)
    for line in so.with_suffix(".so.log").read_text().splitlines():
        if "registers" in line or "spill" in line.lower():
            print(f"  ptxas: {line.strip()}", flush=True)

    # ---- phase 2: kernels against their references -------------------------
    print(f"phase 2: step refinement {REFINEMENT}, f32, "
          f"{PLAIN_STEPS} plain ERK33 steps", flush=True)
    t0 = time.perf_counter()
    eq, sd, hm, ti, U0 = build_step2d(REFINEMENT, torch.float32, dev)
    print(f"  setup {time.perf_counter() - t0:.1f} s: canvas {sd.shape}, "
          f"{sd.n_nodes} real nodes", flush=True)
    from ryujin_tpu_torch.solver.hyperbolic import HyperbolicModule
    from ryujin_tpu_torch.solver.integrator import TimeIntegrator

    ti_plain = TimeIntegrator(PlainSteps(hm), "erk 33", cfl_min=0.45,
                              cfl_max=0.9, cfl_recovery_strategy="none")
    U_a, _, t_a, _, _, warns = ti_plain.advance(U0, 0.0, PLAIN_STEPS)
    U_b, _, _, _, _, _ = ti_plain.advance(U_a, t_a, 1)
    torch.cuda.synchronize()
    print(f"  t = {t_a.item():.4e}, warnings {int(warns)}", flush=True)
    records = {}
    ok = compare_kernels(hm, U_a, U_b, TOL_F32, REPS, records)

    print("phase 2b: the same in f64", flush=True)
    hm64 = HyperbolicModule(eq, sd, hm.initial_state_fn,
                            dtype=torch.float64, device=dev)
    ok &= compare_kernels(hm64, U_a.double(), U_b.double(), TOL_F64,
                          REPS)
    del hm64

    print("phase 2c: 3 ERK33 steps, kernels on the card vs plain on the "
          "CPU, refinement 0, f64", flush=True)
    _, sd0, _, ti_g, _ = build_step2d(0, torch.float64, dev)
    _, _, _, ti_c, U0_c = build_step2d(0, torch.float64, "cpu")
    pos = torch.as_tensor(sd0.positions.T, dtype=torch.float64)
    bump = 1.0 + 0.25 * torch.exp(
        -8.0 * torch.sum((pos - torch.tensor([[1.0], [0.5]],
                                             dtype=torch.float64)) ** 2, 0)
    )
    U0_c = U0_c.clone()
    U0_c[0] *= bump
    U0_c[3] *= bump
    out_g = ti_g.advance(U0_c.to(dev), 0.0, 3)
    out_c = ti_c.advance(U0_c, 0.0, 3)
    real0 = torch.as_tensor(sd0.node_mask > 0)
    Ug, Uc = out_g[0].cpu()[:, real0], out_c[0][:, real0]
    rel = ((Ug - Uc).abs().max() / Uc.abs().max()).item()
    tau_rel = abs(out_g[3].item() / out_c[3].item() - 1.0)
    good = rel < 1e-10 and tau_rel < 1e-10 and bool(torch.isfinite(Ug).all())
    print(f"  U rel-err {rel:.3e}, tau rel-err {tau_rel:.3e} (tol 1e-10) "
          f"{'ok' if good else 'FAIL'}", flush=True)
    ok &= good
    if not ok:
        fail("a kernel disagrees with its plain-torch reference")

    # ---- phase 3: the slice -------------------------------------------------
    print(f"phase 3: slice, {WARMUP} warmup + {STEPS} timed ERK33 "
          "steps through the kernels", flush=True)
    U, _, t, _, _, _ = ti.advance(U0, 0.0, WARMUP)
    torch.cuda.synchronize()
    kernels = {"pk1": pk1.pk1, "pk2": pk2.pk2, "pk3": pk3.pk3,
               "pk_up": pk_up.pk_up}
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    U, _, t, tau, _, warns = ti.advance(U, t, STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}
    mqs = sd.n_nodes * STEPS * 3 / wall / 1e6

    real = torch.as_tensor(sd.node_mask > 0, device=dev)
    Ur = U[:, real]
    finite = bool(torch.isfinite(Ur).all())
    admissible = bool(eq.is_admissible(Ur).all())
    tau_v, warns_v = tau.item(), int(warns)
    want = {"pk1": 3, "pk2": 3, "pk3": 3, "pk_up": 6}
    counts_ok = all(launches[k] == want[k] * STEPS for k in want)
    print(f"  t = {t.item():.4e}, tau = {tau_v:.4e}, warnings {warns_v}, "
          f"finite {finite}, admissible {admissible}, launches {launches}",
          flush=True)
    print(f"  kernels: {mqs:.3f} MQ/s ({wall:.3f} s for {STEPS} steps) "
          f"on {card}", flush=True)

    t0 = time.perf_counter()
    ti_plain.advance(U, t, PLAIN_TIMED_STEPS)
    torch.cuda.synchronize()
    wall_p = time.perf_counter() - t0
    mqs_p = sd.n_nodes * PLAIN_TIMED_STEPS * 3 / wall_p / 1e6
    print(f"  plain torch: {mqs_p:.3f} MQ/s ({wall_p:.3f} s for "
          f"{PLAIN_TIMED_STEPS} steps) on {card}", flush=True)

    if not (finite and admissible):
        fail("the slice left the admissible set")
    if not tau_v > 0.0:
        fail(f"tau = {tau_v}")
    if warns_v:
        fail(f"{warns_v} steps warned")
    if not counts_ok:
        fail(f"launch counts {launches}, expected {want} x {STEPS}")

    sources = {
        "pk1": ("ryujin_tpu/solver/pallas_step.py:2676", "pk1.cu"),
        "pk2": ("ryujin_tpu/solver/pallas_step.py:2841", "pk2.cu"),
        "pk3": ("ryujin_tpu/solver/pallas_step.py:3044", "pk3.cu"),
        "pk_up": ("ryujin_tpu/solver/pallas_step.py:3265", "pk_up.cu"),
    }
    print(json.dumps({"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": f"ryujin_tpu_torch/csrc/{sources[name][1]}",
            "replaces": sources[name][0],
            "launches": launches[name],
            "max_abs_err": records[name][0],
            "ms": records[name][1],
            "plain_ms": records[name][2],
        }
        for name in kernels
    ]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
