"""Why ell_pk_up's f64 l' can leave its plain version on an edge: the
kernels' pow and torch.pow round otherwise on a few arguments, and where
psi is flat at its root one ulp of rho^gamma moves the limiter's second
Newton step far.

    python -m ryujin_tpu_torch.limiter_rounding      # on a CUDA device

1. Builds pow(x, gamma) in f64 with the kernels' nvcc flags (-O3
   -fmad=false, kernels/build.compile_command) and with -fmad=true, and
   counts the arguments, of 2^26 uniform in [0.05, 20.05], on which each
   rounds otherwise than torch.pow.
2. On the state of tests/test_torch_gpu.py's
   test_ell_kernels_each_against_plain for the 2D dG Q1 step in f64 (three
   ERK33 steps from a blast, ERK54's 4-slot substep), runs ell_pk_up and
   its plain version.  On every edge whose l' differs by more than 1e-12
   it prints the kernel's l', the plain l', the plain l' with torch.pow
   swapped for the kernels' pow, and how far one ulp of one entry of
   U_next moves the plain l'.

Prints the card's nvidia-smi name and power limit first; exits 1 without
a CUDA device.
"""

from __future__ import annotations

import ctypes
import math
import subprocess
import sys
from unittest import mock

import torch

from .kernels import build

POW_SOURCE = r"""
#include <cstdint>
__global__ void pow_kernel(const double* x, double g, double* y, int64_t n) {
  const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) y[i] = pow(x[i], g);
}
extern "C" int probe_pow_f64(const double* x, double g, double* y, int64_t n) {
  if (n > 0) pow_kernel<<<int((n + 255) / 256), 256>>>(x, g, y, n);
  return int(cudaDeviceSynchronize());
}
"""


def pow_library(fmad: bool) -> ctypes.CDLL:
    """POW_SOURCE built for the card with -fmad=`fmad` and the kernels'
    other code flags."""
    flags = build.compile_command(build.CSRC / "x.cu",
                                  build.BUILD_DIR / "x.o")
    assert "-fmad=false" in flags and "-O3" in flags
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = build.BUILD_DIR / "limiter_rounding_pow.cu"
    src.write_text(POW_SOURCE)
    fmad = str(fmad).lower()
    so = build.BUILD_DIR / f"limiter_rounding_pow_fmad_{fmad}.so"
    subprocess.run(
        [build.nvcc(), "-gencode", build.GENCODE, "-std=c++17", "-O3",
         f"-fmad={fmad}", "-shared", "-Xcompiler", "-fPIC",
         "-o", str(so), str(src)], check=True, capture_output=True, text=True,
    )
    return ctypes.CDLL(str(so))


def library_pow(lib: ctypes.CDLL):
    """torch.pow(x, g) for f64 CUDA tensors and a float g, through `lib`."""
    def pow_(x, g):
        x = x.contiguous()
        y = torch.empty_like(x)
        rc = lib.probe_pow_f64(
            ctypes.c_void_p(x.data_ptr()), ctypes.c_double(g),
            ctypes.c_void_p(y.data_ptr()), ctypes.c_int64(x.numel()))
        if rc != 0:
            raise RuntimeError(f"probe_pow_f64: CUDA error {rc}")
        return y
    return pow_


def blast_state(dtype, dev):
    """(hm, U_a, U, prec): the 2D dG Q1 step at refinement 0 after three
    ERK33 steps through the kernels from the inflow with an 8:1 density and
    1000:1 energy contrast in a ball of radius 0.2 around (1, 0.5), and U
    after one more step, prepared, with its precomputed values (the gpu
    test's _limited_state)."""
    from .bench import ell_case

    _, packed, hm, ti, U0 = ell_case("2D dG Q1", 0, dtype, dev)
    pos = torch.as_tensor(packed.positions.T, dtype=dtype, device=dev)
    centre = torch.tensor([1.0, 0.5], dtype=dtype, device=dev)[:, None]
    ball = (torch.sum((pos - centre) ** 2, 0) < 0.2 ** 2) & torch.as_tensor(
        packed.node_mask > 0, device=dev)
    U0 = U0.clone()
    U0[0, ball] *= 8.0
    U0[-1, ball] *= 1000.0
    U_a, _, t_a, _, _, _ = ti.advance(U0, 0.0, 3)
    U, prec = hm.prepare_state_vector(ti.advance(U_a, t_a, 1)[0], 0.0)
    return hm, U_a, U, prec


def pk_up_inputs(hm, U_a, U, prec):
    """(U_low, bounds, P, l) of ERK54's 4-slot substep on U, the plain
    versions' (the gpu test's stage states: U_a, U and two prepared states
    between them)."""
    from .kernels import ell
    from .solver.hyperbolic import d_from_e, tau_max_from_d
    from .solver.integrator import TABLEAUX

    eq, p, st = hm.eq, hm.params, hm.stencil
    e, alpha = ell.ell_pk1_reference(eq, p, st, U, prec)
    d = d_from_e(st.mask, e, st.transpose_edge(e))
    tau = tau_max_from_d(st, d, 0.9, torch.full((), math.inf, dtype=U.dtype,
                                                 device=U.device))
    mid = [hm.prepare_state_vector(U_a + (U - U_a) * f, 0.0)[0]
           for f in (0.5, 0.25)]
    stage_U = torch.stack([U_a, U] + mid)
    w = list(TABLEAUX["erk 54"].W[4])
    U_low, F, bounds = ell.ell_pk2_reference(eq, p, st, U, prec, d, alpha,
                                             stage_U, w, tau)
    P, l, _ = ell.ell_pk3_reference(eq, p, st, U, d, alpha, F, U_low, bounds,
                                    stage_U, w, tau)
    return U_low, bounds, P, l


def edge_l(eq, p, bounds, u, rest, Pk):
    """The plain l' of one edge: rest * limiter_limit on [C, 1] slices."""
    b = bounds[:, None]
    l2, _ = eq.limiter_limit(
        b, u[:, None], (rest * Pk)[:, None], eq.limiter_psi0(b, u[:, None]),
        newton_iterations=p.limiter_newton_max_iterations,
        newton_tol=p.limiter_newton_tolerance,
    )
    return (rest * l2[0]).item()


def ulp_spread(eq, p, bounds, u, rest, Pk) -> float:
    """How far one ulp of one entry of u, either way, moves edge_l."""
    moved = []
    for c in range(u.shape[0]):
        for toward in (-math.inf, math.inf):
            v = u.clone()
            v[c] = torch.nextafter(v[c], torch.tensor(toward, dtype=u.dtype,
                                                      device=u.device))
            moved.append(edge_l(eq, p, bounds, v, rest, Pk))
    return max(moved) - min(moved)


def main() -> int:
    if not torch.cuda.is_available():
        print("limiter_rounding: no CUDA device", flush=True)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    from .kernels import ell

    dt, dev = torch.float64, "cuda"
    pows = {fmad: library_pow(pow_library(fmad)) for fmad in (False, True)}
    gen = torch.Generator(device=dev).manual_seed(0)
    x = 0.05 + 20.0 * torch.rand(1 << 26, dtype=dt, device=dev, generator=gen)
    for fmad, pow_ in pows.items():
        for g in (1.4, 5.0 / 3.0):
            n = int((pow_(x, g) != torch.pow(x, g)).sum())
            print(f"pow(x, {g:.6g}) built with -fmad={str(fmad).lower()}: "
                  f"rounds otherwise than torch.pow on {n} of {x.numel()} "
                  "arguments", flush=True)

    hm, U_a, U, prec = blast_state(dt, dev)
    eq, p, st = hm.eq, hm.params, hm.stencil
    U_low, bounds, P, l = pk_up_inputs(hm, U_a, U, prec)
    args = (eq, p, st, U_low, bounds, P, l, False)
    (U_k, l_k), (U_r, l_r) = (ell.ell_pk_up(*args),
                              ell.ell_pk_up_reference(*args))
    live = st.mask > 0
    diff = (l_k - l_r).abs() * live
    print(f"2D dG Q1 step, f64, ERK54's 4-slot substep: U_next "
          f"{'bit-equal' if torch.equal(U_k, U_r) else 'differs'}; l' differs "
          f"on {int((diff > 0).sum())} of {int(live.sum())} live edges, max "
          f"{diff.max().item():.3e}", flush=True)
    l_T = st.transpose_edge(l)
    for k, i in (diff > 1e-12).nonzero().tolist():
        rest = 1.0 - torch.minimum(l[k, i], l_T[k, i])
        u, Pk = U_r[:, i], P[:, k, i]
        plain = edge_l(eq, p, bounds[:, i], u, rest, Pk)
        with mock.patch.object(torch, "pow", pows[False]):
            swapped = edge_l(eq, p, bounds[:, i], u, rest, Pk)
        spread = ulp_spread(eq, p, bounds[:, i], u, rest, Pk)
        same = "equal" if swapped == l_k[k, i].item() else "unequal"
        print(f"  edge (slot {k}, row {i}): kernel l' {l_k[k, i].item()!r}, "
              f"plain {l_r[k, i].item()!r} (on the slice {plain!r}), plain "
              f"with the kernels' pow {swapped!r} ({same} to the kernel's); "
              f"one ulp of U_next moves the plain l' over {spread:.3e}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
