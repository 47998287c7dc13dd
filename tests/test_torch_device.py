"""Device policy of the port: no jax, no silent CPU fallback, kernels only on
CUDA tensors, a clear error without nvcc, TF32 off."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dealii_asm_tpu_torch import device as port_device
from dealii_asm_tpu_torch.fem.dofs import DofHandler
from dealii_asm_tpu_torch.fem.general_dofs import GeneralDofHandler
from dealii_asm_tpu_torch.kernels import build, launch_counts
from dealii_asm_tpu_torch.kernels.banded_laplace import (banded_laplace,
                                                         banded_laplace_plain)
from dealii_asm_tpu_torch.kernels.fdm_patch import fdm_patch, fdm_patch_plain
from dealii_asm_tpu_torch.mesh.grid import StructuredMesh
from dealii_asm_tpu_torch.mesh.unstructured import hyper_ball_balanced
from dealii_asm_tpu_torch.models.poisson import run_config
from dealii_asm_tpu_torch.ops.laplace import LaplaceOperator
from dealii_asm_tpu_torch.ops.laplace_general import GeneralLaplaceOperator
from dealii_asm_tpu_torch.ops.transfer_general import GeneralTwoLevelTransfer
from dealii_asm_tpu_torch.precond.asm import ASMPreconditioner
from dealii_asm_tpu_torch.precond.asm_general import GeneralASMPreconditioner

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

NO_JAX_SLICE = r"""
import importlib, json, pkgutil, sys

class NoJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "dealii_asm_tpu"):
            raise ImportError("the port imported " + name)
        return None

sys.meta_path.insert(0, NoJax())
import dealii_asm_tpu_torch
for m in pkgutil.walk_packages(dealii_asm_tpu_torch.__path__,
                               "dealii_asm_tpu_torch."):
    importlib.import_module(m.name)
from dealii_asm_tpu_torch.models.poisson import run_config
with open("experiments/e2e_aniso_q4.json") as f:
    p = json.load(f)
p["n refinements"] = 2
p["print timing"] = False
p["solver"]["best of"] = 1
r = run_config(p, log=lambda *a: None, device="cpu")
assert r["converged"] and r["it"] == 4, r["it"]
with open("experiments/e2e_kershaw_q4.json") as f:
    p = json.load(f)
p["n refinements"] = 0
p["print timing"] = False
p["solver"]["best of"] = 1
r = run_config(p, log=lambda *a: None, device="cpu")
assert r["converged"] and r["it"] == 28, r["it"]
with open("experiments/e2e_ball_q4.json") as f:
    p = json.load(f)
p["n refinements"] = 0
p["print timing"] = False
p["solver"]["best of"] = 1
r = run_config(p, log=lambda *a: None, device="cpu")
assert r["converged"] and r["it"] == 5, r["it"]
loaded = [m for m in sys.modules
          if m.split(".")[0] in ("jax", "jaxlib", "dealii_asm_tpu")]
assert not loaded, loaded
print("NO_JAX_OK")
"""


def test_port_imports_no_jax_and_runs_the_slice():
    """Neither jax nor any module of the JAX package is imported, on the
    flagship's path, the Kershaw path and the ball path."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", NO_JAX_SLICE], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "NO_JAX_OK" in out.stdout


def test_entry_points_default_to_the_card():
    """Without ``device=`` the port targets cuda: on a machine without a GPU
    it raises the resolve_device error and runs nothing on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-fallback check needs none")
    assert port_device.DEFAULT_DEVICE == "cuda"
    params = {"dim": 3, "degree": 2, "n refinements": 1,
              "mesh": {"name": "kershaw", "eps": 0.3},
              "solver": {"type": "CG"}, "preconditioner": {"type": "Identity"}}
    logged = []
    with pytest.raises(RuntimeError, match="is_available"):
        run_config(params, log=logged.append)
    assert logged == []  # nothing was built, so nothing ran on the CPU
    dofs = DofHandler(StructuredMesh(3, (1, 1, 1)), 2)
    ball = [GeneralDofHandler(hyper_ball_balanced(3), p) for p in (1, 2)]
    for make in (lambda: LaplaceOperator(dofs),
                 lambda: ASMPreconditioner(dofs),
                 lambda: GeneralLaplaceOperator(ball[1]),
                 lambda: GeneralASMPreconditioner(ball[1]),
                 lambda: GeneralTwoLevelTransfer(*ball)):
        with pytest.raises(RuntimeError, match="is_available"):
            make()


def test_cuda_device_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the no-fallback check needs none")
    params = {"dim": 3, "degree": 2, "n refinements": 1,
              "mesh": {"name": "hypercube"}, "solver": {"type": "CG"},
              "preconditioner": {"type": "Identity"}}
    with pytest.raises(RuntimeError, match="is_available"):
        run_config(params, log=lambda *a: None, device="cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        LaplaceOperator(DofHandler(StructuredMesh(3, (1, 1, 1)), 2),
                        device="cuda")


def test_kernel_wrappers_take_plain_path_on_cpu():
    dofs = DofHandler(StructuredMesh(3, (2, 3, 2)), 3)
    op = LaplaceOperator(dofs, dtype=torch.float32, device="cpu")
    asm = ASMPreconditioner(dofs, weighting_type="symm", dtype=torch.float32,
                            device="cpu")
    x = torch.as_tensor(np.random.default_rng(9).standard_normal(dofs.n_dofs),
                        dtype=torch.float32)
    before = launch_counts()
    v = banded_laplace(x, op.tables)
    y = fdm_patch(x, asm.tables, 0.5)
    assert launch_counts() == before
    assert torch.equal(v, banded_laplace_plain(x, op.tables))
    assert torch.equal(y, fdm_patch_plain(x, asm.tables, 0.5))


def test_kernel_wrappers_reject_other_devices():
    dofs = DofHandler(StructuredMesh(3, (1, 1, 1)), 2)
    op = LaplaceOperator(dofs, dtype=torch.float32, device="cpu")
    with pytest.raises(TypeError, match="unsupported device"):
        banded_laplace(torch.empty(dofs.n_dofs, device="meta"), op.tables)


def test_build_raises_clear_error_without_nvcc(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "DEFAULT_CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()
    assert not (tmp_path / "build").exists()


def test_tf32_policy():
    port_device.resolve_device("cpu")
    port_device.assert_no_tf32()
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="TF32"):
            port_device.assert_no_tf32()
    finally:
        port_device.apply_precision_policy()
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
