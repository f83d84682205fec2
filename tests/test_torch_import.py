"""The PyTorch port's package boundary: it imports neither jax nor triton
nor anything of the JAX package ryujin_tpu, its CUDA wrappers run their
plain versions on CPU tensors, and its nvcc commands target sm_90a."""

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
             if m.split(".")[0] in ("jax", "jaxlib", "triton", "ryujin_tpu"))
print(len(names), bad)
sys.exit(1 if bad else 0)
"""


def test_import_leaves_out_jax_and_triton():
    """Importing every submodule of the port leaves jax, jaxlib, triton and
    the JAX package ryujin_tpu out of sys.modules."""
    res = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=REPO, capture_output=True,
        text=True, timeout=300,
    )
    assert res.returncode == 0, res.stdout + res.stderr


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
        "pk2_stream.cu", "pk3_stream.cu",
    }
    for src in srcs:
        cmd = build.compile_command(src, Path("out.o"))
        assert cmd[cmd.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
        assert "-c" in cmd and "-O3" in cmd and "-fmad=false" in cmd
        assert [s for s in cmd if s.endswith(".cu")] == [str(src)]
    link = build.link_command([Path("a.o"), Path("b.o")], Path("out.so"))
    assert link[link.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
    assert "-shared" in link and link[-2:] == ["a.o", "b.o"]
    assert set(build.ENTRY_POINTS) == {s.stem for s in srcs}


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
    assert set(bench.CASES) == {"step2d", "q2step2d"}
