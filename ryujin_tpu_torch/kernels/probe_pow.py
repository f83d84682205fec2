"""Pow microbenchmark: out = sum_r f(x + s_r) for the pow forms of
scripts/bench_pow.py and scripts/bench_pow_tpu.py (CUDA kernel
csrc/probe_pow.cu; rows 11 and 12 of the kernel table, the TPU kernels
bench_pow.py:58-71 and bench_pow_tpu.py:50-70)."""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import build

# the kernel's PowForm codes
FORMS = {"powf": 0, "exp2_log2": 1, "fast": 2, "newton": 3, "mult": 4,
         "sqrt": 5}
# mirrored by csrc/probe_pow.cu: the largest n, the shifts a block stages,
# the largest block of each kernel, and the launches it takes
POW_MAX_N = 1 << 30
POW_MAX_TERMS = 256
POW_POINTWISE_THREADS = 512
POW_SUMMED_THREADS = 256
POW_ITEMS = {False: (1, 2, 4), True: (1, 2)}
POW_UNROLLS = (1, 2, 4, 8)
# the default launches (tile_sweep pow): (threads, items, unroll) of the
# pointwise and the summed kernel
POW_DEFAULTS = {False: (256, 1, 1), True: (256, 1, 8)}
# items a thread of the forms that take more than one, from POW_VEC_MIN_N
# on (below, one): pointwise float4 vectors, where x b, one FMUL an
# element, moves bytes alone (row 11: 0.00182-0.00185 ms chained at two,
# 0.00189-0.00194 at one; the other forms lose at two); summed elements,
# where the short forms spread a thread's staging, barrier and loads over
# two sums (row 11, unroll 8: x b 0.00426-0.00435 against 0.00500-0.00523,
# sqrt, exp2 log2 and fast 1-4 % less; powf and Newton lose, their
# registers leave a wave's tail) (tile_sweep pow; NVIDIA H100 80GB HBM3,
# 700.00 W)
POW_ITEMS_OF = {False: {"mult": 2},
                True: {"mult": 2, "sqrt": 2, "exp2_log2": 2, "fast": 2}}
# the pointwise kernel takes float4 vectors from this n on, where they
# leave 16 warps an SM (132 SMs); below, one float a thread keeps four
# times the warps, which the long forms need to hide their latency: at
# row 12's 131,072 elements powf read 0.00180 ms chained one a thread,
# 0.00207-0.00492 in float4 launches, at row 11's 524,288 0.00309 against
# 0.00298 (tile_sweep pow; NVIDIA H100 80GB HBM3, 700.00 W)
POW_VEC_MIN_N = 4 * 132 * 512


class PowShape(NamedTuple):
    """Launch shape of the pow kernels: `threads` a block, `items` float4
    vectors (pointwise) or elements (summed) a thread, `unroll` terms a
    step (summed; 1 pointwise), `vec` floats a vector (4, or 1 for the
    scalar pointwise instance; 1 summed) and `blocks`."""

    threads: int
    items: int
    unroll: int
    vec: int
    blocks: int


@functools.lru_cache(maxsize=256)
def pow_shape(n: int, summed: bool, aligned: bool = True,
              threads: Optional[int] = None, items: Optional[int] = None,
              unroll: Optional[int] = None, vec: Optional[int] = None,
              form: Optional[str] = None) -> PowShape:
    """The launch of the pow kernel on n elements: pointwise, `items`
    float4 vectors a thread when x and out are 16-byte `aligned` and n is
    at least POW_VEC_MIN_N (the n mod 4 last elements go to the grid's
    first threads), else one float a thread; summed, `items` elements a
    thread and `unroll` terms a step; `vec` 4 or 1 asks for float4 or
    scalar pointwise launches at any n (scalar: one item).  As many
    blocks of `threads` as cover the vectors or elements, at least one.
    Defaults: POW_DEFAULTS, and from POW_VEC_MIN_N on the items of
    `form` in POW_ITEMS_OF.  Raises ValueError for a launch the kernels
    do not take.  Cached, so that a launch spends little host time on
    it."""
    d = POW_DEFAULTS[summed]
    threads, unroll = threads or d[0], unroll or d[2]
    if vec is None:
        vec = 4 if aligned and not summed and n >= POW_VEC_MIN_N else 1
    if items is None:
        big = n >= POW_VEC_MIN_N and (summed or vec == 4)
        items = POW_ITEMS_OF[summed].get(form, d[1]) if big else d[1]
    largest = POW_SUMMED_THREADS if summed else POW_POINTWISE_THREADS
    if (not 1 <= n <= POW_MAX_N or threads % 32 or not 32 <= threads <= largest
            or items not in POW_ITEMS[summed]
            or unroll not in (POW_UNROLLS if summed else (1,))
            or vec not in ((1,) if summed or not aligned else (1, 4))
            or (vec == 1 and not summed and items != 1)):
        raise ValueError(
            f"the pow kernel takes 1 <= n <= {POW_MAX_N}, whole warps up to "
            f"{largest} threads, items in {POW_ITEMS[summed]}, unroll in "
            f"{POW_UNROLLS if summed else (1,)} and float4 only pointwise on "
            f"an aligned base, not n = {n}, {threads} threads, items "
            f"{items}, unroll {unroll}, vec {vec}")
    units, chunk = n // vec, threads * items
    return PowShape(threads, items, unroll, vec, max(1, -(-units // chunk)))


def shifts(step: float, R: int) -> torch.Tensor:
    """[f32(step * r) for r < R]: each shift rounded to f32 from the double
    product, as jnp.float32(0.01 * k) and the weak-typed 1e-3 * r round."""
    return torch.from_numpy(
        np.array([np.float32(step * r) for r in range(R)], np.float32))


def _fast_log2(x):
    bits = x.view(torch.int32)
    e = (bits >> 23).to(torch.float32) - 127.0
    m = ((bits & 0x007FFFFF) | 0x3F800000).view(torch.float32)
    t = m - 1.0
    p = torch.full_like(t, float(np.float32(-0.034436006)))
    for c in (0.18216566, -0.46565442, 0.71517086, -0.71975631, 1.44269504):
        p = p * t + float(np.float32(c))
    return e + t * p


def _fast_exp2(x):
    i = torch.round(x)  # half to even, as jnp.round
    f = x - i
    p = torch.full_like(f, float(np.float32(1.8775767e-3)))
    for c in (8.9893397e-3, 5.5826318e-2, 2.4015361e-1, 6.9315308e-1,
              9.9999994e-1):
        p = p * f + float(np.float32(c))
    return p * ((i.to(torch.int32) + 127) << 23).view(torch.float32)


def _newton_pow14(x):
    seed = (0.4 * x.view(torch.int32).to(torch.float32)
            + float(np.float32(0.6 * 1064866805.0))).to(torch.int32)
    z = seed.view(torch.float32)
    x2 = x * x
    for _ in range(2):
        z2 = z * z
        z4 = z2 * z2
        z = z * (0.8 + (0.2 * x2) / (z4 * z))
    return x * z


def pow_form(v: torch.Tensor, form: str, b: float) -> torch.Tensor:
    """One evaluation of `form` on f32 v, one torch op per kernel step
    (scalars round to f32 in each op, as the kernel's float constants)."""
    if form == "powf":
        return torch.pow(v, b)
    if form == "exp2_log2":
        return torch.exp2(b * torch.log2(v))
    if form == "fast":
        return _fast_exp2(b * _fast_log2(v))
    if form == "newton":
        return _newton_pow14(v)
    if form == "mult":
        return v * b
    if form == "sqrt":
        return torch.sqrt(v)
    raise ValueError(f"unknown pow form {form!r}; one of {tuple(FORMS)}")


def probe_pow_reference(x, form: str, b: float, shifts=None, carry=None):
    """Plain torch: f(x) when `shifts` is None, else the sum of f(v + s_r)
    from 0 in r order, v = x, or x + 1e-9 carry."""
    if shifts is None:
        if carry is not None:
            raise ValueError("the pointwise form takes no carry")
        return pow_form(x, form, b)
    v = x if carry is None else x + 1e-9 * carry
    acc = torch.zeros_like(x)
    for s in shifts.tolist():
        acc = acc + pow_form(v + s, form, b)
    return acc


def key(form: str, R: int, shape) -> str:
    """The launch-count key of the instance: form, R (1 for the single
    evaluation) and shape."""
    return build.probe_key("probe_pow", form, f"R={R}",
                           "x".join(map(str, shape)))


def probe_pow(x, form: str, b: float, shifts=None, carry=None,
              shape: Optional[PowShape] = None):
    """sum_r f(x + s_r) of the f32 tensor x (or f(x) once when `shifts` is
    None; with `carry`, x + 1e-9 carry in place of x), at most
    POW_MAX_TERMS shifts, launched with `shape` (default: pow_shape's).
    Counted under key(form, R, x.shape)."""
    if form not in FORMS:
        raise ValueError(f"unknown pow form {form!r}; one of {tuple(FORMS)}")
    if not build.on_card(x):
        return probe_pow_reference(x, form, b, shifts, carry)
    if shifts is None and carry is not None:
        raise ValueError("the pointwise form takes no carry")
    if shifts is not None and not 1 <= shifts.numel() <= POW_MAX_TERMS:
        raise ValueError(f"the summed pow takes 1 to {POW_MAX_TERMS} shifts, "
                         f"not {shifts.numel()}")
    tensors = {"x": (x, x.shape)}
    if carry is not None:
        tensors["carry"] = (carry, x.shape)
    if shifts is not None:
        tensors["shifts"] = (shifts, (shifts.numel(),))
    build.check_probe(x.device, tensors)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    summed = shifts is not None
    if shape is None:
        shape = pow_shape(x.numel(), summed,
                          (x.data_ptr() | out.data_ptr()) % 16 == 0,
                          form=form)
    R = shifts.numel() if summed else 1
    build.launch_probe(
        key(form, R, x.shape), "ryujin_probe_pow", FORMS[form], int(summed),
        x.data_ptr(), build.ptr(carry), build.ptr(shifts), R, b,
        out.data_ptr(), x.numel(), *shape)
    return out
