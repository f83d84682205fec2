"""The PyTorch port's package boundary: it imports neither jax nor triton,
its CUDA wrappers run their plain versions on CPU tensors, and its nvcc
command targets sm_90a."""

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
assert len(names) >= 15, names
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "triton"))
print(len(names), bad)
sys.exit(1 if bad else 0)
"""


def test_import_leaves_out_jax_and_triton():
    res = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=REPO, capture_output=True,
        text=True, timeout=300,
    )
    assert res.returncode == 0, res.stdout + res.stderr


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
    cmd = build.nvcc_command(Path("out.so"))
    assert cmd[cmd.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
    assert "-shared" in cmd and "-O3" in cmd
    srcs = {Path(s).name for s in cmd if s.endswith(".cu")}
    assert srcs == {"pk1.cu", "pk2.cu", "pk3.cu", "pk_up.cu"}
