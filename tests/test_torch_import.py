"""The PyTorch port's package boundary: it imports neither jax nor triton
nor anything of the JAX package ryujin_tpu, its CUDA wrappers run their
plain versions on CPU tensors, and its nvcc commands target sm_90a."""

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from ryujin_tpu_torch.kernels import build, pk1  # noqa: E402

from test_torch_fixture import modules, step_case, to_torch  # noqa: E402

REPO = Path(__file__).resolve().parent.parent

_IMPORT_ALL = """
import importlib, pkgutil, sys
import ryujin_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    ryujin_tpu_torch.__path__, "ryujin_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert len(names) >= 25, names
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "triton", "ryujin_tpu",
                                    "scripts", "bench_pow", "bench_pow_tpu",
                                    "probe_gather", "probe_dma3d"))
print(len(names), bad)
sys.exit(1 if bad else 0)
"""


def test_import_leaves_out_jax_and_triton():
    """Importing every submodule of the port leaves jax, jaxlib, triton,
    the JAX package ryujin_tpu and the TPU scripts out of sys.modules."""
    res = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=REPO, capture_output=True,
        text=True, timeout=300,
    )
    assert res.returncode == 0, res.stdout + res.stderr


def test_ell_slice_modules_import_alone():
    """The modules of the padded-ELL slice import in a process of their
    own without jax, triton or the JAX package, and read no RYUJIN_
    variable."""
    names = ["ryujin_tpu_torch.offline.ell", "ryujin_tpu_torch.offline.reader",
             "ryujin_tpu_torch.offline.airfoil_profiles",
             "ryujin_tpu_torch.utils.cubic_spline",
             "ryujin_tpu_torch.solver.ell_step", "ryujin_tpu_torch.kernels.ell",
             "ryujin_tpu_torch.shocktube",
             "ryujin_tpu_torch.limiter_rounding"]
    code = (
        "import importlib, sys\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'triton', 'ryujin_tpu'))\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    reads = re.compile(r"(environ|getenv)\W[^\n]*RYUJIN_")
    for name in names:
        path = REPO / (name.replace(".", "/") + ".py")
        assert not reads.search(path.read_text()), name


def test_no_source_imports_the_jax_package():
    """No file of the port, and not chip_smoke.py, has an import statement
    of ryujin_tpu (docstrings and comments may name the counterpart)."""
    pattern = re.compile(r"^\s*(from|import)\s+ryujin_tpu(\.|\s|$)", re.M)
    files = sorted((REPO / "ryujin_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 25
    bad = [str(f.relative_to(REPO)) for f in files
           if pattern.search(f.read_text())]
    assert not bad, bad
    assert pattern.search("from ryujin_tpu.offline import mesh")
    assert not pattern.search("from ryujin_tpu_torch.offline import mesh")


def test_wrapper_on_cpu_runs_reference():
    """pk1 on CPU tensors returns pk1_reference's result and launches
    nothing."""
    _, _, _, U0, eq, params, _ = step_case()
    _, hm = modules()
    U, prec = hm.prepare_state_vector(to_torch(U0), 0.0)
    ca = hm.canvas.arrays
    before = pk1.pk1.launches
    lam, alpha = pk1.pk1(eq, params, ca, U, prec)
    lam_r, alpha_r = pk1.pk1_reference(eq, params, ca, U, prec)
    assert torch.equal(lam, lam_r) and torch.equal(alpha, alpha_r)
    assert pk1.pk1.launches == before
    with pytest.raises(ValueError):
        build.on_card(torch.empty(0, device="meta"))


def test_nvcc_command_targets_sm90a():
    """One compile command per source and one link, all for sm_90a."""
    srcs = build.sources()
    assert {s.name for s in srcs} == {
        "pk1.cu", "pk2.cu", "pk3.cu", "pk_up.cu", "pk1_stream.cu",
        "pk2_stream.cu", "pk3_stream.cu", "probe_pow.cu", "probe_gather.cu",
        "probe_layout3d.cu", "ell_step.cu",
    }
    for src in srcs:
        cmd = build.compile_command(src, Path("out.o"))
        assert cmd[cmd.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
        assert "-c" in cmd and "-O3" in cmd and "-fmad=false" in cmd
        assert [s for s in cmd if s.endswith(".cu")] == [str(src)]
    link = build.link_command([Path("a.o"), Path("b.o")], Path("out.so"))
    assert link[link.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
    assert "-shared" in link and link[-2:] == ["a.o", "b.o"]
    # every solver entry point is defined, f32 and f64, by its own source
    # (the ELL kernels' four by csrc/ell_step.cu)
    defined = set()
    for src in srcs:
        if not src.stem.startswith("probe_"):
            defined |= set(re.findall(r'extern "C" int ryujin_(\w+)_##SUFFIX\(',
                                      src.read_text()))
    assert set(build.ENTRY_POINTS) == defined
    assert {"ell_pk1", "ell_pk2", "ell_pk3", "ell_pk_up"} <= defined
    for src in srcs:
        if src.stem.startswith("probe_"):
            names = re.findall(r'extern "C" int (ryujin_probe_\w+)\(',
                               src.read_text())
            assert names and set(names) <= set(build.PROBE_ENTRY_POINTS)
    for argtypes in build.PROBE_ENTRY_POINTS.values():
        assert argtypes[-1] is ctypes.c_void_p  # the stream


def test_entry_points_mean_the_card_unless_the_cpu_is_named():
    """HyperbolicModule defaults to the card, and bench.entry() without a
    device raises where there is none instead of picking the CPU; with
    device="cpu" it runs one substep through the plain path."""
    import inspect

    from ryujin_tpu_torch import bench
    from ryujin_tpu_torch.solver.hyperbolic import HyperbolicModule

    default = inspect.signature(HyperbolicModule.__init__).parameters["device"]
    assert default.default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            bench.entry()
    fn, args = bench.entry(device="cpu")
    U, tau, ok = fn(*args)
    assert U.device.type == "cpu" and bool(ok) and float(tau) > 0.0
    assert set(bench.CASES) == {"step2d", "q2step2d", "box3d", "dg1box3d",
                                "cylinder3d", "amr2d", "annulus2d"}


def test_bench_reads_separable_mode_from_two_values_only():
    """The bench and profile_step take RYUJIN_SEP "0" (or unset) and "1"
    and refuse any other value; the library reads no RYUJIN_ variable."""
    from ryujin_tpu_torch import bench

    assert bench.separable_from_env({}) is False
    assert bench.separable_from_env({"RYUJIN_SEP": "0"}) is False
    assert bench.separable_from_env({"RYUJIN_SEP": "1"}) is True
    for value in ("2", "", "true", " 1"):
        with pytest.raises(ValueError, match="RYUJIN_SEP"):
            bench.separable_from_env({"RYUJIN_SEP": value})
    reads = re.compile(r"(environ|getenv)\W[^\n]*RYUJIN_")
    readers = sorted(
        str(f.relative_to(REPO))
        for f in (REPO / "ryujin_tpu_torch").rglob("*.py")
        if reads.search(f.read_text())
    )
    assert readers == ["ryujin_tpu_torch/bench.py"], readers
    assert reads.search('os.environ.get("RYUJIN_SEP", "0")')


def test_sass_diff_matches_instances_across_the_statics_argument():
    """sass_diff pairs a full-statics instance with the same instance of a
    library built before the accessor argument, and leaves the dG and SEP
    instances out."""
    from ryujin_tpu_torch.sass_diff import key

    old = "_ZN6ryujin17pk2_stream_kernelIfLi3ELb0EEEvPKfS2_"
    full = ("_ZN6ryujin17pk2_stream_kernelIfLi3ELb0ELb0ENS_11FullStatics"
            "IfEEEEvPKT_S5_")
    sep = ("_ZN6ryujin17pk2_stream_kernelIfLi3ELb0ELb0ENS_10SepStatics"
           "IfEEEEvPKT_S5_")
    dg = ("_ZN6ryujin17pk2_stream_kernelIfLi3ELb0ELb1ENS_11FullStatics"
          "IfEEEEvPKT_S5_")
    assert key(old) == key(full) == ("pk2_stream_kernel", "fLi3ELb0E")
    assert key(sep) is None and key(dg) is None
    assert key("_ZN6ryujin12pk_up_kernelIdLi3ELi26ENS_11FullStaticsIdEEEEvPKT_"
               ) == key("_ZN6ryujin12pk_up_kernelIdLi3ELi26EEEvPKd")


def test_probes_read_no_environment_and_import_no_script():
    """The probes (probes/, kernels/probe_*.py) take options, not
    environment variables, and neither import nor path-load the TPU
    scripts they replace."""
    files = sorted((REPO / "ryujin_tpu_torch" / "probes").glob("*.py"))
    files += sorted((REPO / "ryujin_tpu_torch" / "kernels").glob("probe_*.py"))
    assert len(files) == 7
    env = re.compile(r"os\.environ|getenv\(")
    script = re.compile(
        r"^\s*(from|import)\s+"
        r"(scripts|bench_pow|bench_pow_tpu|probe_gather|probe_dma3d)\b"
        r"|sys\.path|spec_from_file_location", re.M)
    for f in files:
        text = f.read_text()
        assert not env.search(text), f.name
        assert not script.search(text), f.name
    assert script.search("import bench_pow_tpu")
    assert env.search('os.environ.get("P", "24")')
    assert script.search("from scripts import probe_gather")
