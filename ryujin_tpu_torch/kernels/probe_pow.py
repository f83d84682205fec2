"""Pow microbenchmark: out = sum_r f(x + s_r) for the pow forms of
scripts/bench_pow.py and scripts/bench_pow_tpu.py (CUDA kernel
csrc/probe_pow.cu; rows 11 and 12 of the kernel table, the TPU kernels
bench_pow.py:58-71 and bench_pow_tpu.py:50-70)."""

from __future__ import annotations

import numpy as np
import torch

from . import build

# the kernel's PowForm codes
FORMS = {"powf": 0, "exp2_log2": 1, "fast": 2, "newton": 3, "mult": 4,
         "sqrt": 5}


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


def probe_pow(x, form: str, b: float, shifts=None, carry=None):
    """sum_r f(x + s_r) of the f32 tensor x (or f(x) once when `shifts` is
    None; with `carry`, x + 1e-9 carry in place of x).  Counted under
    key(form, R, x.shape)."""
    if form not in FORMS:
        raise ValueError(f"unknown pow form {form!r}; one of {tuple(FORMS)}")
    if not build.on_card(x):
        return probe_pow_reference(x, form, b, shifts, carry)
    if shifts is None and carry is not None:
        raise ValueError("the pointwise form takes no carry")
    tensors = {"x": (x, x.shape)}
    if carry is not None:
        tensors["carry"] = (carry, x.shape)
    if shifts is not None:
        tensors["shifts"] = (shifts, (shifts.numel(),))
    build.check_probe(x.device, tensors)
    out = torch.empty_like(x)
    R = 1 if shifts is None else shifts.numel()
    build.launch_probe(
        key(form, R, x.shape), "ryujin_probe_pow", FORMS[form],
        int(shifts is None), x.data_ptr(), build.ptr(carry), build.ptr(shifts),
        R, b, out.data_ptr(), x.numel())
    return out
