"""The solver anatomy and transfer benchmark of the port
(``models/solver_bench.py``) against the JAX package's
``models/solver_bench.py``: the same ``>>`` lines apart from the seconds.

A balanced hyper-cube at "n subdivision" 2 (2×1×1 cells, Q3, 112 DoFs),
float32 operator, Jacobi preconditioned, 7 steps under an
IterationNumberControl for each of the six solvers; the transfers from
degrees 1 and 2.  The fields compared: the label, the DoF count and the
iteration or repetition count; the seconds are positive.
"""

import io
import json

import pytest
import torch

from dealii_asm_tpu.models import solver_bench as jax_bench
from dealii_asm_tpu_torch.models import solver_bench

PARAMS = {"n subdivision": 2, "fe degree": 3, "n iterations": 7,
          "n repetitions": 2}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test process (see tests/test_torch_gmres.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fields(text):
    lines = [ln.split() for ln in text.splitlines() if ln.startswith(">>")]
    for ln in lines:
        assert float(ln[4]) > 0.0
    return [ln[:4] for ln in lines]


@pytest.mark.parametrize("fn", ["run_solver_anatomy", "run_transfer_bench"])
def test_lines_match_jax(fn):
    got, ref = io.StringIO(), io.StringIO()
    records = []
    hook = {"run_solver_anatomy": "on_solver",
            "run_transfer_bench": "on_transfer"}[fn]
    n = getattr(solver_bench, fn)(dict(PARAMS), out=got, device="cpu",
                                  **{hook: records.append})
    getattr(jax_bench, fn)(dict(PARAMS), out=ref)
    assert _fields(got.getvalue()) == _fields(ref.getvalue())
    assert n == 112 and len(records) == len(_fields(got.getvalue()))
    if fn == "run_solver_anatomy":
        assert [r["name"] for r in records] == [
            "CG", "FCG", "GMRES", "FGMRES", "Bicgstab", "IDR"]
        assert all(r["n_its"] == 7 for r in records)


def test_main_reads_each_config(tmp_path, capsys):
    """``python -m dealii_asm_tpu_torch.models.solver_bench cfg.json
    --device cpu``: "kind" picks the anatomy (default) or the transfers."""
    a, b = tmp_path / "solvers.json", tmp_path / "transfer.json"
    a.write_text(json.dumps(dict(PARAMS, solvers="CG IDR")))
    b.write_text(json.dumps(dict(PARAMS, kind="transfer")))
    assert solver_bench.main([str(a), str(b), "--device", "cpu"]) == 0
    fields = _fields(capsys.readouterr().out)
    assert [f[1] for f in fields] == [
        "solver-CG", "solver-IDR", "transfer-1-restrict",
        "transfer-1-prolongate", "transfer-2-restrict",
        "transfer-2-prolongate"]
