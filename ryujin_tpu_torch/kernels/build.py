"""Build and load the CUDA kernels of ryujin_tpu_torch/csrc.

Every csrc/*.cu is compiled by its own nvcc process, all started
together, and the objects are linked into one shared library with a plain
C interface, loaded with ctypes.  The library lands in
ryujin_tpu_torch/_build/, keyed by a hash of the sources and the command
lines, and is built at first use.  Every entry point takes device
pointers and the CUDA stream as `void *`, launches on that stream without
synchronising, and returns cudaGetLastError().  The solver kernels take
(pointers..., Consts *, stream); the measurement probes (csrc/probe_*.cu)
take pointers, ints and floats of their own (PROBE_ENTRY_POINTS).
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from ..offline.structured import lattice_offsets

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "_build"
GENCODE = "arch=compute_90a,code=sm_90a"

# entry point -> number of device-pointer arguments (before the Consts
# pointer and the stream); the stream kernels and pk_up end theirs with the
# separable factors g_sep2 and f_sepz, null for the full statics
ENTRY_POINTS = {
    "pk1": 7, "pk2": 15, "pk3": 17, "pk_up": 10,
    "pk1_stream": 10, "pk2_stream": 16, "pk3_stream": 18,
    # the padded-ELL substep (csrc/ell_step.cu); cols and trans are int64
    "ell_pk1": 8, "ell_pk2": 15, "ell_pk3": 17, "ell_pk_up": 9,
}
MAX_K = 48  # lattice offsets a launch can carry (cG Q3: reach 3, K = 48)
# stage slots a launch can carry (ERK54's last substep: 4); PK2 and PK3
# launch their instance of at most 2 slots up to 2, of MAX_STAGES above
MAX_STAGES = 4

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# the probes' entry points -> argtypes (every pointer and the stream void *)
PROBE_ENTRY_POINTS = {
    # form, summed, x, carry, shifts, R, b, out, n, threads, items,
    # unroll, vec, blocks, stream
    "ryujin_probe_pow": [_I, _I, _P, _P, _P, _I, _F, _P, _L] + [_I] * 5 + [_P],
    # x, idx, out, P, W, groups, span, threads, vec, smem, stream
    "ryujin_probe_lane_gather": [_P, _P, _P] + [_I] * 7 + [_P],
    # x, idx, out, S, L, tiles, groups, rows, threads, smem, stream
    "ryujin_probe_sublane_gather": [_P, _P, _P] + [_I] * 7 + [_P],
    # X, cols, out, staged, C, K, n, nodes, threads, stages, bulk, band,
    # blocks, smem, stream
    "ryujin_probe_ell_gather_sum": [_P] * 4 + [_I, _I, _L] + [_I] * 7 + [_P],
    # layout, src, out, P, D, H * W, TD, tile, stages, blocks, segments,
    # threads, smem, stream
    "ryujin_probe_layout": [_I, _P, _P, _I, _I, _L] + [_I] * 7 + [_P],
    # mode, src, out, check, P, D, H * W, TD, tile, stages, blocks,
    # segments, threads, smem, stream
    "ryujin_probe_window": [_I, _P, _P, _P, _I, _I, _L] + [_I] * 7 + [_P],
    # centre, h0, h1, h2, out, check, nwin, p0, p1, p2, cen_pl, out_pl, D,
    # H * W, TD, tile, stages, blocks, segments, threads, smem, stream
    "ryujin_probe_pk1_shape": [_P] * 6 + [_I] * 7 + [_L] + [_I] * 7 + [_P],
}
# launches of each probe kernel instance, by probe_key; launch_probe adds
# one for each launch it makes
PROBE_LAUNCHES = collections.Counter()

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
        ("D", ctypes.c_int),
        ("H", ctypes.c_int),
        ("W", ctypes.c_int),
        ("dim", ctypes.c_int),
        ("half", ctypes.c_int),
        ("K", ctypes.c_int),
        ("dz", ctypes.c_int * MAX_K),
        ("dy", ctypes.c_int * MAX_K),
        ("dx", ctypes.c_int * MAX_K),
        ("block", ctypes.c_int * 3),
        ("grid", ctypes.c_int * 3),
        ("smem", ctypes.c_int),
        ("halo", ctypes.c_int),
        # stage weights 2 and 3, last (csrc/euler.cuh)
        ("w2", ctypes.c_double),
        ("w3", ctypes.c_double),
    ]


def cuda_tool(name: str) -> Path:
    """A program of the CUDA toolkit ($CUDA_HOME/bin, /usr/local/cuda)."""
    return Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / name


def nvcc() -> str:
    return str(cuda_tool("nvcc"))


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def compile_command(src: Path, obj: Path) -> List[str]:
    """nvcc for one source.  -fmad=false keeps a * b + c as two
    roundings, as the plain-torch references (one tensor op each) round
    it: with contraction on, the f32 indicator alpha (a noise-dominated
    ratio in smooth flow) and the limiter's Newton bracket (its accept test
    psi > 0 sits at roundoff near the root) moved off their references by
    1.4e-3 and 2.2e-2 at refinement 3; without it both match to 1e-6 and
    0, at a cost of 2% of PK3's time (H100 SXM, 700 W)."""
    return [
        nvcc(), "-gencode", GENCODE, "-std=c++17", "-O3", "-fmad=false",
        "-c", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(obj),
        str(src),
    ]


def link_command(objs: List[Path], out: Path) -> List[str]:
    return [nvcc(), "-gencode", GENCODE, "-shared", "-o", str(out)] + [
        str(o) for o in objs
    ]


def _tag() -> str:
    h = hashlib.sha256()
    for s in sorted(CSRC.glob("*.cu*")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    h.update(" ".join(compile_command(Path("x.cu"), Path("x.o"))[1:]).encode())
    h.update(" ".join(link_command([], Path("x"))[1:]).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libryujin_kernels_{_tag()}.so"


def _failed(cmd, res) -> RuntimeError:
    return RuntimeError(
        f"nvcc failed (exit {res.returncode}):\n{' '.join(cmd)}\n"
        f"{res.stdout}\n{res.stderr}"
    )


def build() -> Path:
    """Compile the kernels unless the library for these sources exists:
    one nvcc per source, all running at once, then one link.  Raises
    RuntimeError with nvcc's output on failure.  nvcc's resource report
    (-Xptxas -v) is kept beside the library as `<lib>.log`."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = f"{so.stem}.building-{os.getpid()}"
    jobs = []
    try:
        for src in sources():
            obj = BUILD_DIR / f"{stem}.{src.stem}.o"
            cmd = compile_command(src, obj)
            try:
                proc = subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True,
                )
            except OSError as exc:
                raise RuntimeError(
                    f"cannot run nvcc ({cmd[0]}): {exc}"
                ) from exc
            jobs.append((cmd, obj, proc))
        log = []
        for cmd, obj, proc in jobs:
            out, err = proc.communicate(timeout=900)
            res = subprocess.CompletedProcess(cmd, proc.returncode, out, err)
            if res.returncode != 0:
                raise _failed(cmd, res)
            log.append(out + err)
        tmp = BUILD_DIR / f"{stem}.so"
        cmd = link_command([obj for _, obj, _ in jobs], tmp)
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            raise _failed(cmd, res)
        so.with_suffix(".so.log").write_text("".join(log))
        os.replace(tmp, so)
    finally:
        for _, obj, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
            obj.unlink(missing_ok=True)
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
            for name, argtypes in PROBE_ENTRY_POINTS.items():
                fn = getattr(lib, name)
                fn.restype = ctypes.c_int
                fn.argtypes = argtypes
            lib.ryujin_error_string.restype = ctypes.c_char_p
            lib.ryujin_error_string.argtypes = [ctypes.c_int]
            _LIB = lib
        return _LIB


def _equation_fields(eq, params, measure_inv, stage_weights) -> dict:
    """The Consts fields of the equation, the module parameters, the mesh
    measure and the (static) stage weights."""
    if len(stage_weights) > MAX_STAGES:
        raise ValueError(f"the kernels take at most {MAX_STAGES} stages, "
                         f"not {len(stage_weights)}")
    g = eq.params.gamma
    e = 2.0 * g / (g - 1.0)
    er = round(e)
    pow_n = er if abs(e - er) < 1.0e-8 and 1 <= abs(er) <= 16 else 0
    w = list(stage_weights) + [0.0] * (MAX_STAGES - len(stage_weights))
    return dict(
        gamma=g,
        reference_density=eq.params.reference_density,
        vacuum_small=eq.params.vacuum_state_relaxation_small,
        vacuum_large=eq.params.vacuum_state_relaxation_large,
        evc_factor=params.evc_factor,
        relaxation_factor=params.limiter_relaxation_factor,
        newton_tol=params.limiter_newton_tolerance,
        measure_inv=measure_inv,
        weight=1.0 - sum(stage_weights),
        w0=w[0],
        w1=w[1],
        w2=w[2],
        w3=w[3],
        newton_iterations=params.limiter_newton_max_iterations,
        pow_n=pow_n,
        n_stages=len(stage_weights),
    )


def consts(eq, params, ca, stage_weights=(), half=True) -> Consts:
    """The scalars every kernel takes, from the equation, the module
    parameters, the canvas (2D [H, W] or 3D [D, H, W]), the (static) stage
    weights and the route of the stream kernels: half=True for the
    half-slot pre-scaled wavespeeds, False for the two-direction ones
    (instantiated for 3D canvases only)."""
    fields = _equation_fields(eq, params, ca.measure_inv, stage_weights)
    dim = len(ca.shape)
    if ca.K > MAX_K or dim not in (2, 3):
        raise ValueError(
            f"the kernels take a 2D or 3D canvas with at most {MAX_K} "
            f"lattice offsets, not {ca.K} on {ca.shape}"
        )
    if dim == 2 and not half:
        raise ValueError(
            "the two-direction route of the stream kernels is built for 3D "
            "canvases only"
        )
    D, H, W = canvas_dims(ca.shape)
    offsets = [(0,) * (3 - dim) + tuple(o) for o in ca.offsets]
    return Consts(
        **fields,
        D=D,
        H=H,
        W=W,
        dim=dim,
        half=int(half),
        K=ca.K,
        dz=(ctypes.c_int * MAX_K)(*(o[0] for o in offsets)),
        dy=(ctypes.c_int * MAX_K)(*(o[1] for o in offsets)),
        dx=(ctypes.c_int * MAX_K)(*(o[2] for o in offsets)),
    )


def ell_consts(eq, params, st, stage_weights=()) -> Consts:
    """The scalars of an ELL kernel (csrc/ell_step.cu) on the stencil `st`
    (solver/stencil.EllStencil): the rows n in W (D = H = 1), the space
    dimension and K, the slots a row."""
    if st.dim not in (1, 2, 3) or st.n >= 2 ** 31:
        raise ValueError(f"the ELL kernels take 1D-3D meshes of fewer than "
                         f"2^31 rows, not {st.n} rows in {st.dim}D")
    return Consts(
        **_equation_fields(eq, params, st.measure_inv, stage_weights),
        D=1, H=1, W=st.n, dim=st.dim, half=0, K=st.K,
    )


class Tile(NamedTuple):
    """Launch shape of a tiled kernel (pk1_stream, pk2_stream, pk3_stream,
    the stacked pk1, pk2 and pk3, pk_up): threads of a block (x, y, z), the
    halo of staged cells around the tile, the shared bytes a block takes
    (dynamic in the staged kernels and in pk_up at K = 48, static in pk_up
    at K = 24 and 26) and the grid (x, y, z)."""

    block: Tuple[int, int, int]
    halo: int
    smem: int
    grid: Tuple[int, int, int]


SMEM_MAX = 232448  # shared bytes a block can use on an H100 (227 KB)


def canvas_dims(shape) -> Tuple[int, int, int]:
    """(D, H, W) of a 2D [H, W] (D = 1) or 3D [D, H, W] canvas."""
    return (1,) * (3 - len(shape)) + tuple(int(v) for v in shape)


def reach_of(dim: int, K: int) -> int:
    """The lattice reach r of K = (2 r + 1)^dim - 1 offsets."""
    for r in range(1, 4):
        if (2 * r + 1) ** dim - 1 == K:
            return r
    raise ValueError(f"no lattice of reach 1-3 has K = {K} offsets in {dim}D")


def with_tile(c: Consts, tile: Tile) -> Consts:
    """c with the launch shape of `tile` (the tiled kernels read it and
    refuse one that does not fit their layout)."""
    c.block = (ctypes.c_int * 3)(*tile.block)
    c.grid = (ctypes.c_int * 3)(*tile.grid)
    c.smem = tile.smem
    c.halo = tile.halo
    return c


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


def check_probe(device, tensors: Dict[str, tuple]) -> None:
    """Raise ValueError unless every tensor (name -> (tensor, shape)) lies
    on `device`, is contiguous with the given shape and is float32, or
    int32 where its name starts with "idx" or "cols"."""
    for name, (t, shape) in tensors.items():
        want = torch.int32 if name.startswith(("idx", "cols")) else torch.float32
        if t.dtype != want:
            raise ValueError(f"{name} is {t.dtype}, expected {want}")
        if t.device != device:
            raise ValueError(f"{name} on {t.device}, expected {device}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")


def probe_key(kernel: str, *dims) -> str:
    """The PROBE_LAUNCHES key of one probe kernel instance: the kernel and
    what tells its instances apart."""
    return f"{kernel}[{', '.join(map(str, dims))}]"


def launch_probe(key: str, name: str, *args) -> None:
    """Launch the probe entry point `name` with `args` and the current
    stream, and count it under `key` (a probe_key); raise on a CUDA error
    reported by the launch."""
    lib = library()
    rc = getattr(lib, name)(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"CUDA error in {name}: {lib.ryujin_error_string(rc).decode()}"
        )
    PROBE_LAUNCHES[key] += 1


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


def check_reach1(ca) -> None:
    """Raise unless `ca` is the 2D reach-1 K = 8 canvas that pk1, pk2 and
    pk3 are compiled for."""
    if tuple(ca.offsets) != lattice_offsets(2, 1):
        raise ValueError(
            "pk1, pk2 and pk3 take the reach-1 K = 8 lattice; canvases of a "
            "larger reach take the stream kernels"
        )


def statics(ca, names) -> Dict[str, tuple]:
    """check() entries for the named CanvasArrays planes that are present
    (g_inc is None on a cG canvas)."""
    return {
        name: (getattr(ca, name), getattr(ca, name).shape)
        for name in names if getattr(ca, name) is not None
    }
