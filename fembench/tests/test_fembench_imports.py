"""What a run loads: nothing of JAX or the JAX package (top-level module
names compared whole: the port's name begins with the JAX package's), and
the reference nothing of the program."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

RUN = """
import copy, json, sys, torch
torch.set_num_threads(1)
from fembench import harness, run
cell = harness.load_cell("aniso_q4_r7")
cell["config"] = copy.deepcopy(cell["config"])
cell["config"]["n refinements"] = 1
rec = run.measure(cell, 3, 0.1, False, device="cpu")
assert run.result(cell, rec, False, {})["correct"]
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

REFERENCE = """
import json, sys, torch
from fembench.reference import multigrid
from fembench import check
cfg = json.load(open("fembench/configs/kershaw_q4.json"))["config"]
cfg["n refinements"] = 0
outer, V = multigrid.build(cfg, "cpu")
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def loaded(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_a_run_loads_no_jax():
    names = loaded(RUN)
    assert "dealii_asm_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "dealii_asm_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    names = loaded(REFERENCE)
    assert not names & {"dealii_asm_tpu_torch", "dealii_asm_tpu", "jax",
                        "jaxlib", "flax"}
