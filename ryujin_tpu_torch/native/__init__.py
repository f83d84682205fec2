"""Native (C++) components of ryujin_tpu_torch's host layer.

The port's own copy of ryujin_tpu/native: the host-side offline assembly
and canvas packing in C++ (assembly.cc), compiled with g++ on first use
and bound with ctypes.

Build artifacts are cached under ``_cache/`` keyed by a source hash.  A
failed build raises: the numpy paths of the offline layer are taken only
where a helper declines its input (it returns None or False), never
because the library is missing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

_HERE = Path(__file__).parent
_SOURCES = ["assembly.cc"]
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def _build() -> ctypes.CDLL:
    srcs = [_HERE / s for s in _SOURCES]
    h = hashlib.sha256()
    for s in srcs:
        h.update(s.read_bytes())
    tag = h.hexdigest()[:16]
    cache = _HERE / "_cache"
    cache.mkdir(exist_ok=True)
    so = cache / f"libryujin_native_{tag}.so"
    if not so.exists():
        tmp = so.with_suffix(f".building-{os.getpid()}.so")
        cmd = [
            "g++", "-O3", "-march=native", "-std=c++20", "-shared",
            "-fPIC", "-o", str(tmp),
        ] + [str(s) for s in srcs]
        try:
            subprocess.run(
                cmd, check=True, capture_output=True, text=True, timeout=300
            )
        except (subprocess.CalledProcessError, OSError,
                subprocess.TimeoutExpired) as exc:
            err = getattr(exc, "stderr", "") or str(exc)
            raise RuntimeError(
                f"ryujin_tpu_torch.native: g++ build failed:\n{err[:2000]}"
            ) from exc
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    i64 = ctypes.c_int64
    p_i64 = ctypes.POINTER(ctypes.c_int64)
    p_f64 = ctypes.POINTER(ctypes.c_double)
    lib.ryujin_q1_count.restype = i64
    lib.ryujin_q1_count.argtypes = [ctypes.c_int, i64, i64, p_i64, p_i64]
    lib.ryujin_q1_assemble.restype = ctypes.c_int
    lib.ryujin_q1_assemble.argtypes = [
        ctypes.c_int, i64, i64, p_f64, p_i64, p_i64, p_i64, p_i64,
        p_f64, p_f64, p_f64, p_f64, p_f64, p_f64,
    ]
    lib.ryujin_pack_edges.restype = ctypes.c_int
    lib.ryujin_pack_edges.argtypes = [
        ctypes.c_int, i64, p_i64, p_i64, p_i64, p_i64, p_i64, p_i64,
        p_f64, p_f64, i64, p_f64, p_f64, p_f64,
    ]
    lib.ryujin_face_owners.restype = ctypes.c_int
    lib.ryujin_face_owners.argtypes = [
        ctypes.c_int, i64, i64, p_i64, i64, ctypes.c_int, p_i64, p_i64,
    ]
    return lib


def get_lib() -> ctypes.CDLL:
    """The native library, built on first call; raises if g++ fails."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = _build()
    return _LIB


def _ptr(a, typ):
    return a.ctypes.data_as(ctypes.POINTER(typ))


def q1_assemble(vertices, cells, acells):
    """Native Q1 cG assembly.

    vertices [n_raw, dim] f64, cells/acells [nc, nsh] i64 (acells =
    master-mapped).  Returns (indptr, indices, mij, cij, mii, cii,
    lumped, measure) or None if the helper declines the mesh.
    """
    import numpy as np

    lib = get_lib()
    vertices = np.ascontiguousarray(vertices, dtype=np.float64)
    cells = np.ascontiguousarray(cells, dtype=np.int64)
    acells = np.ascontiguousarray(acells, dtype=np.int64)
    n_raw, dim = vertices.shape
    nc = cells.shape[0]
    indptr = np.empty(n_raw + 1, dtype=np.int64)
    nnz = lib.ryujin_q1_count(
        dim, nc, n_raw, _ptr(acells, ctypes.c_int64),
        _ptr(indptr, ctypes.c_int64),
    )
    if nnz < 0:
        return None  # pathological vertex valence: numpy fallback
    indices = np.empty(nnz, dtype=np.int64)
    mij = np.empty(nnz, dtype=np.float64)
    cij = np.empty((nnz, dim), dtype=np.float64)
    mii = np.empty(n_raw, dtype=np.float64)
    cii = np.empty((n_raw, dim), dtype=np.float64)
    lumped = np.empty(n_raw, dtype=np.float64)
    measure = np.empty(1, dtype=np.float64)
    rc = lib.ryujin_q1_assemble(
        dim, nc, n_raw,
        _ptr(vertices, ctypes.c_double), _ptr(cells, ctypes.c_int64),
        _ptr(acells, ctypes.c_int64), _ptr(indptr, ctypes.c_int64),
        _ptr(indices, ctypes.c_int64), _ptr(mij, ctypes.c_double),
        _ptr(cij, ctypes.c_double), _ptr(mii, ctypes.c_double),
        _ptr(cii, ctypes.c_double), _ptr(lumped, ctypes.c_double),
        _ptr(measure, ctypes.c_double),
    )
    if rc != 0:
        return None
    return indptr, indices, mij, cij, mii, cii, lumped, float(measure[0])


def pack_edges(dim, rows, indptr, indices, si, logical, flat,
               cij_in, mij_in, K, cij_out, mij_out, mask_out):
    """Native canvas edge packing; returns True on success.

    Writes into the (zeroed) cij_out [n_pad, K, dim], mij_out [n_pad, K],
    mask_out [n_pad, K] arrays in place.
    """
    import numpy as np

    lib = get_lib()
    c = ctypes
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    rc = lib.ryujin_pack_edges(
        dim, len(rows), _ptr(rows, c.c_int64),
        _ptr(np.ascontiguousarray(indptr, np.int64), c.c_int64),
        _ptr(np.ascontiguousarray(indices, np.int64), c.c_int64),
        _ptr(np.ascontiguousarray(si, np.int64), c.c_int64),
        _ptr(np.ascontiguousarray(logical, np.int64), c.c_int64),
        _ptr(np.ascontiguousarray(flat, np.int64), c.c_int64),
        _ptr(np.ascontiguousarray(cij_in, np.float64), c.c_double),
        _ptr(np.ascontiguousarray(mij_in, np.float64), c.c_double),
        K,
        _ptr(cij_out, c.c_double), _ptr(mij_out, c.c_double),
        _ptr(mask_out, c.c_double),
    )
    if rc == 1:
        raise AssertionError("edge beyond lattice neighborhood")
    if rc == 2:
        raise AssertionError("degenerate zero-offset edge")
    return rc == 0


def face_owners(dim, cells, n_vertices, faces):
    """Owning cell id per (boundary) face, or None if the helper declines."""
    import numpy as np

    lib = get_lib()
    c = ctypes
    cells = np.ascontiguousarray(cells, dtype=np.int64)
    faces = np.ascontiguousarray(faces, dtype=np.int64)
    owners = np.empty(len(faces), dtype=np.int64)
    rc = lib.ryujin_face_owners(
        dim, cells.shape[0], n_vertices, _ptr(cells, c.c_int64),
        faces.shape[0], faces.shape[1], _ptr(faces, c.c_int64),
        _ptr(owners, c.c_int64),
    )
    return owners if rc == 0 else None
