"""The measurement probes on the card: the counterparts of the TPU
microbenchmarks in scripts/ (rows 11-14 of the kernel table).

    python -m ryujin_tpu_torch.probes.pow        # bench_pow.py, bench_pow_tpu.py
    python -m ryujin_tpu_torch.probes.gather     # probe_gather.py
    python -m ryujin_tpu_torch.probes.layout3d   # probe_dma3d.py

Each takes its script's parameters as options with the script's defaults,
prints the card's nvidia-smi name and power limit, then the script's
figures and each kernel's error against its plain-torch version, and exits
1 where a kernel misses its bar or there is no CUDA device.  Every kernel
is timed here by `measure`: one warm launch (whose output is held against
the plain version), then 20 launches between CUDA events, each after an
L2 flush where the function's bytes fit in the 50 MB L2; then the kernel
and, where one PyTorch call computes the same function, that call, each
in a chain of CHAIN calls captured in one CUDA graph and replayed between
one pair of events (`graph_ms`), so that launch costs and the host's gaps
between calls drop out: the kernel's device time, beside its bound.
"""

from __future__ import annotations

import collections
import dataclasses
import subprocess
from typing import Callable, Optional

import torch

# the card's peaks (NVIDIA H100 SXM data sheet): device memory rate, L2
PEAK_BYTES_PER_S = 3.35e12
L2_BYTES = 50e6
SMS = 132
REPS = 20
CHAIN = 100  # calls of a chained reading


def smi(query: str) -> str:
    """The first card's nvidia-smi value(s) for `query`."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def card() -> Optional[str]:
    """Print and return the card's "name, power limit" line; None (after
    saying so) without a CUDA device."""
    if not torch.cuda.is_available():
        print("no CUDA device (torch.cuda.is_available() is false): the "
              "probes run on the card only", flush=True)
        return None
    line = smi("name,power.limit")
    print(f"card: {line}", flush=True)
    return line


def time_ms(fn: Callable[[], object], reps: int, flush: bool) -> float:
    """Mean ms of `reps` calls of fn on the card between CUDA events, each
    call timed alone after an L2 flush when `flush`, else back to back.
    The caller has made one warm call."""
    torch.cuda.synchronize()
    if not flush:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps
    # a read of 64 MiB leaves the 50 MB L2 holding clean lines of it: the
    # timed call neither hits its inputs there nor writes back dirty lines
    scratch = torch.zeros(64 << 20, dtype=torch.uint8, device="cuda")
    pairs = []
    for _ in range(reps):
        scratch.sum()
        pair = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        pair[0].record()
        fn()
        pair[1].record()
        pairs.append(pair)
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


def graph_ms(fn: Callable[[], object], calls: int) -> float:
    """Mean ms of a call of fn in a chain of `calls` calls back to back,
    captured in one CUDA graph and replayed (once warm, then once between
    CUDA events), L2 warm.  The probe kernels the capture records are
    counted as launched at each replay, not at the capture.  The caller
    has made one warm call."""
    from ..kernels import build

    torch.cuda.synchronize()
    before = collections.Counter(build.PROBE_LAUNCHES)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    recorded = build.PROBE_LAUNCHES - before
    build.PROBE_LAUNCHES.subtract(recorded)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    graph.replay()
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    build.PROBE_LAUNCHES.update(recorded)
    build.PROBE_LAUNCHES.update(recorded)
    del graph
    return start.elapsed_time(end) / calls


def ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in float32 units in the last place between a and b,
    entries of one sign."""
    return int((a.view(torch.int32).long() - b.view(torch.int32).long())
               .abs().max())


@dataclasses.dataclass
class Case:
    """One probe kernel at one shape, with what its record needs.

    kernel() launches `launches_per_call` kernels through the wrapper and
    returns the output (a tensor or a tuple of them); plain() computes it
    with the plain-torch version; instance is the wrapper's launch-count key
    (build.PROBE_LAUNCHES) of the kernel instance;
    library(), where one PyTorch call computes the same function, is that
    call.  bar: "exact" (bit-equal), "rel 1e-6" (max |k - p| / |p|) or
    "4 ulp".  nbytes: what the function must move per launch (inputs read
    once, output written once); ops_ms: its operations over the card's
    rates, where those may bind; reps: the timed calls."""

    name: str
    kernel: Callable[[], torch.Tensor]
    plain: Callable[[], torch.Tensor]
    bar: str
    nbytes: int
    source: str
    replaces: str
    instance: str
    library: Optional[Callable[[], object]] = None
    ops_ms: Optional[float] = None
    launches_per_call: int = 1
    reps: int = REPS


def held(bar: str, k, p):
    """(max |k - p|, the error measured against `bar`, within the bar) of
    two tensors, or of two tuples of tensors taken pairwise (the largest
    errors, all within)."""
    if isinstance(k, tuple):
        each = [held(bar, a, b) for a, b in zip(k, p, strict=True)]
        return (max(e[0] for e in each), max(e[1] for e in each),
                all(e[2] for e in each))
    finite = bool(torch.isfinite(k).all()) and bool(torch.isfinite(p).all())
    diff = float((k - p).abs().max()) if k.numel() else 0.0
    if bar == "exact":
        return diff, diff, finite and torch.equal(k, p)
    if bar == "rel 1e-6":
        rel = float(((k - p).abs() / p.abs()).max())
        return diff, rel, finite and rel <= 1e-6
    if bar == "4 ulp":
        d = ulps(k, p)
        return diff, d, finite and d <= 4
    raise ValueError(f"unknown bar {bar!r}")


def measure(case: Case) -> dict:
    """The record of `case`: its kernel's output (the warm call) held
    against the plain version, the mean ms of a launch, of the plain
    version and of the library call, and the bound; "chain_ms", the mean
    ms of a launch in a CUDA graph of CHAIN calls (graph_ms; "chain":
    CHAIN), and "library_chain_ms", a library call's the same way (None
    without one).  Launches only the kernels that the warm call and the
    timing make.  "instance" is the key of its launch count."""
    out = case.kernel()
    ref = case.plain()
    max_abs, err, ok = held(case.bar, out, ref)
    del out, ref
    flush = case.nbytes < L2_BYTES
    per, reps = case.launches_per_call, case.reps
    ms = time_ms(case.kernel, reps, flush) / per
    plain_ms = time_ms(case.plain, max(reps // 4, 2), flush) / per
    library_ms = library_chain_ms = None
    chain_ms = graph_ms(case.kernel, CHAIN) / per
    if case.library is not None:
        case.library()
        library_ms = time_ms(case.library, reps, flush)
        library_chain_ms = graph_ms(case.library, CHAIN)
    by_bytes = case.nbytes / PEAK_BYTES_PER_S * 1e3
    by_ops = case.ops_ms or 0.0
    return {
        "name": case.name, "route": "cuda", "source": case.source,
        "replaces": case.replaces, "max_abs_err": max_abs, "err": err,
        "bar": case.bar, "ok": ok, "ms": ms, "plain_ms": plain_ms,
        "library_ms": library_ms, "bound_ms": max(by_bytes, by_ops),
        "bound_by": "bytes" if by_bytes >= by_ops else "operations",
        "flushed": flush, "instance": case.instance,
        "chain": CHAIN,
        "chain_ms": chain_ms, "library_chain_ms": library_chain_ms,
    }


def report(rec: dict) -> str:
    """One line: the kernel against its plain version, and its times."""
    lib = ("null" if rec["library_ms"] is None
           else f"{rec['library_ms']:.4f} ms")
    lib_chain = ("null" if rec["library_chain_ms"] is None
                 else f"{rec['library_chain_ms']:.4f} ms")
    chained = (f"; chained ({rec['chain']} calls, one graph) kernel "
               f"{rec['chain_ms']:.4f} ms, library {lib_chain}")
    return (f"  {rec['name']}: vs plain {rec['err']:.3e} ({rec['bar']}) "
            f"{'ok' if rec['ok'] else 'FAIL'}; kernel {rec['ms']:.4f} ms, "
            f"plain {rec['plain_ms']:.4f} ms, library {lib}, bound "
            f"{rec['bound_ms']:.4f} ms ({rec['bound_by']})"
            f"{', L2 flushed' if rec['flushed'] else ''}{chained}")
