"""The control: the plain reference in the program's place, one precision
below what the configuration states, has to come out not correct."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from fembench import check, control

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("name,r", [("aniso_q4_r7", 2), ("kershaw_q4", 0),
                                    ("aniso_q4_r6", 2)])
def test_the_control_fails_the_residual_gap(tiny_cell, name, r):
    """On the CPU (no TF32) the float32 outer solve is what the comparison
    catches; the sound program reads far below the same limit."""
    torch.set_num_threads(1)
    cell = tiny_cell(name, r)
    limits = cell["workload"]["limits"]
    ctl, = control.readings(cell, [21], False, "cpu")
    assert ctl["numbers"]["residual_gap"] > 10 * limits["residual_gap"]
    ok, _ = check.judge(ctl["numbers"], limits)
    assert not ok
    prog, = control.readings(cell, [21], True, "cpu")
    assert check.judge(prog["numbers"], limits)[0]


@pytest.mark.card
@pytest.mark.parametrize("name", ["aniso_q4_r7", "kershaw_q4", "aniso_q4_r6"])
def test_the_control_fails_at_the_cells_own_size(cuda_device, name):
    out = subprocess.run([sys.executable, "-m", "fembench.control",
                          "--workload", name, "--seeds", "5", "6", "7"],
                         cwd=ROOT, capture_output=True, text=True, timeout=3000)
    assert out.returncode == 0, out.stderr[-2000:]
    for line in out.stdout.splitlines():
        assert json.loads(line)["wrong"]
