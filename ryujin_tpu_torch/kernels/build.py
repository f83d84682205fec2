"""Build and load the CUDA kernels of ryujin_tpu_torch/csrc.

All of csrc/*.cu goes through one nvcc invocation into a shared library
with a plain C interface, loaded with ctypes.  The library lands in
ryujin_tpu_torch/_build/, keyed by a hash of the sources and the command
line, and is built at first use.  Every entry point takes device
pointers and the CUDA stream as `void *`, launches on that stream without
synchronising, and returns cudaGetLastError().
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional

import torch

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "_build"
GENCODE = "arch=compute_90a,code=sm_90a"

# entry point -> number of device-pointer arguments (before the Consts
# pointer and the stream)
ENTRY_POINTS = {"pk1": 7, "pk2": 14, "pk3": 16, "pk_up": 8}

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


class Consts(ctypes.Structure):
    """Scalars of one launch; mirrors `struct Consts` in csrc/euler.cuh."""

    _fields_ = [
        ("gamma", ctypes.c_double),
        ("reference_density", ctypes.c_double),
        ("vacuum_small", ctypes.c_double),
        ("vacuum_large", ctypes.c_double),
        ("evc_factor", ctypes.c_double),
        ("relaxation_factor", ctypes.c_double),
        ("newton_tol", ctypes.c_double),
        ("measure_inv", ctypes.c_double),
        ("weight", ctypes.c_double),
        ("w0", ctypes.c_double),
        ("w1", ctypes.c_double),
        ("newton_iterations", ctypes.c_int),
        ("pow_n", ctypes.c_int),
        ("n_stages", ctypes.c_int),
        ("H", ctypes.c_int),
        ("W", ctypes.c_int),
    ]


def nvcc() -> str:
    return str(Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc")


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def nvcc_command(out: Path) -> List[str]:
    """The one nvcc invocation.  -fmad=false keeps a * b + c as two
    roundings, as the plain-torch references (one tensor op each) round
    it: with contraction on, the f32 indicator alpha (a noise-dominated
    ratio in smooth flow) and the limiter's Newton bracket (its accept test
    psi > 0 sits at roundoff near the root) moved off their references by
    1.4e-3 and 2.2e-2 at refinement 3; without it both match to 1e-6 and
    0, at a cost of 2% of PK3's time (H100 SXM, 700 W)."""
    return [
        nvcc(), "-gencode", GENCODE, "-std=c++17", "-O3", "-fmad=false",
        "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(out),
    ] + [str(s) for s in sources()]


def _tag() -> str:
    h = hashlib.sha256()
    for s in sorted(CSRC.glob("*.cu*")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    h.update(" ".join(nvcc_command(Path("x"))[1:]).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libryujin_kernels_{_tag()}.so"


def build() -> Path:
    """Compile the kernels unless the library for these sources exists.
    Raises RuntimeError with nvcc's output on failure.  nvcc's resource
    report (-Xptxas -v) is kept beside the library as `<lib>.log`."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".building-{os.getpid()}.so")
    cmd = nvcc_command(tmp)
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    except OSError as exc:
        raise RuntimeError(f"cannot run nvcc ({cmd[0]}): {exc}") from exc
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed (exit {res.returncode}):\n{' '.join(cmd)}\n"
            f"{res.stdout}\n{res.stderr}"
        )
    so.with_suffix(".so.log").write_text(res.stdout + res.stderr)
    os.replace(tmp, so)
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            for name, n_ptr in ENTRY_POINTS.items():
                for suffix in ("f32", "f64"):
                    fn = getattr(lib, f"ryujin_{name}_{suffix}")
                    fn.restype = ctypes.c_int
                    fn.argtypes = (
                        [ctypes.c_void_p] * n_ptr
                        + [ctypes.POINTER(Consts), ctypes.c_void_p]
                    )
            lib.ryujin_error_string.restype = ctypes.c_char_p
            lib.ryujin_error_string.argtypes = [ctypes.c_int]
            _LIB = lib
        return _LIB


def consts(eq, params, ca, stage_weights=()) -> Consts:
    """The scalars every kernel takes, from the equation, the module
    parameters, the canvas and the (static) stage weights."""
    if len(stage_weights) > 2:
        raise ValueError("the kernels take at most 2 stages")
    g = eq.params.gamma
    e = 2.0 * g / (g - 1.0)
    er = round(e)
    pow_n = er if abs(e - er) < 1.0e-8 and 1 <= abs(er) <= 16 else 0
    w = list(stage_weights) + [0.0] * (2 - len(stage_weights))
    return Consts(
        gamma=g,
        reference_density=eq.params.reference_density,
        vacuum_small=eq.params.vacuum_state_relaxation_small,
        vacuum_large=eq.params.vacuum_state_relaxation_large,
        evc_factor=params.evc_factor,
        relaxation_factor=params.limiter_relaxation_factor,
        newton_tol=params.limiter_newton_tolerance,
        measure_inv=ca.measure_inv,
        weight=1.0 - sum(stage_weights),
        w0=w[0],
        w1=w[1],
        newton_iterations=params.limiter_newton_max_iterations,
        pow_n=pow_n,
        n_stages=len(stage_weights),
        H=ca.shape[0],
        W=ca.shape[1],
    )


def check(device, dtype, tensors: Dict[str, tuple]) -> None:
    """Raise ValueError unless every tensor lies on `device`, has `dtype`,
    the given shape and is contiguous.  tensors: name -> (tensor, shape)."""
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the kernels take float32 or float64, not {dtype}")
    for name, (t, shape) in tensors.items():
        if t.device != device:
            raise ValueError(f"{name} on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise ValueError(f"{name} is {t.dtype}, expected {dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")


def launch(name: str, dtype, pointers, c: Consts) -> None:
    """Launch entry point `name` on the current stream; raise on a CUDA
    error reported by the launch."""
    lib = library()
    suffix = "f32" if dtype == torch.float32 else "f64"
    stream = torch.cuda.current_stream().cuda_stream
    rc = getattr(lib, f"ryujin_{name}_{suffix}")(
        *pointers, ctypes.byref(c), stream
    )
    if rc != 0:
        raise RuntimeError(
            f"CUDA error in {name}: {lib.ryujin_error_string(rc).decode()}"
        )


def ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def on_card(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain-torch reference); any other device raises."""
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or reference for device {t.device}")


def statics(ca, names) -> Dict[str, tuple]:
    """check() entries for the named CanvasArrays planes."""
    return {name: (getattr(ca, name), getattr(ca, name).shape) for name in names}
