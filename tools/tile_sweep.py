#!/usr/bin/env python3
"""Time kernels B and C for several tile shapes at 64^3 cells Q4 float32.

    python3 tools/tile_sweep.py                # every variant below
    python3 tools/tile_sweep.py plan c4x4      # some of them

Each variant is a copy of dealii_asm_tpu_torch/ (under _tile_sweep/)
whose csrc/fdm_tile.cuh gives m = 5 (p = 4) float32 another tile shape
(tx, ty, most layers a block, threads) for kernel B and for kernel C; the
copies are built in parallel, then each is timed in its own process with
CUDA events (B alone, C, and kernel A then B as one step), twice in turns.
Needs one GPU.  Prints one line per variant and round, and the card's name
and power limit.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORK = os.path.join(ROOT, "_tile_sweep")
PLAN_B = "      case 4:\n      case 5: return {8, 8, 16, 512};"
PLAN_C = "    case 4:\n    case 5: return itemsize == 4 ? TileShape{8, 8, 32, 512}"
# name -> (kernel B tile, kernel C tile) at m = 5, float32
VARIANTS = {
    "plan": ((8, 8, 16, 512), (8, 8, 32, 512)),
    "b8x8x8": ((8, 8, 8, 512), (8, 8, 32, 512)),
    "b8x8x16t256": ((8, 8, 16, 256), (8, 8, 32, 512)),
    "c8x8x16": ((8, 8, 16, 512), (8, 8, 16, 512)),
    "c8x8x32t1024": ((8, 8, 16, 512), (8, 8, 32, 1024)),
    "c4x4": ((8, 8, 16, 512), (4, 4, 32, 256)),
}

CHILD = r'''
import json, sys
import torch
sys.path.insert(0, sys.argv[1])
from dealii_asm_tpu_torch.fem.dofs import DofHandler
from dealii_asm_tpu_torch.kernels.banded_laplace import banded_laplace
from dealii_asm_tpu_torch.kernels.fdm_patch import fdm_patch, fdm_patch_plain
from dealii_asm_tpu_torch.kernels.smoother_step import (smoother_step,
                                                        smoother_step_plain)
from dealii_asm_tpu_torch.mesh.grid import StructuredMesh
from dealii_asm_tpu_torch.ops.laplace import LaplaceOperator
from dealii_asm_tpu_torch.precond.asm import ASMPreconditioner

dofs = DofHandler(StructuredMesh(3, (64, 64, 64)), 4)
op = LaplaceOperator(dofs, dtype=torch.float32, device="cuda")
asm = ASMPreconditioner(dofs, weighting_type="symm", dtype=torch.float32,
                        device="cuda")
g = torch.Generator(device="cuda").manual_seed(1)
x = torch.randn(dofs.n_dofs, device="cuda", generator=g)
b = torch.randn(dofs.n_dofs, device="cuda", generator=g)


def ms(fn, reps=30):
    fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


B = lambda: fdm_patch(x, asm.tables, 0.37)
C = lambda: smoother_step(x, b, op.tables, asm.tables, 0.37)
AB = lambda: fdm_patch(banded_laplace(x, op.tables, b), asm.tables, 0.37, x)
err_b = float((B() - fdm_patch_plain(x, asm.tables, 0.37)).abs().max())
err_c = float((C() - smoother_step_plain(x, b, op.tables, asm.tables,
                                         0.37)).abs().max())
print("RESULT " + json.dumps({"B_ms": ms(B), "C_ms": ms(C), "A_then_B_ms":
                              ms(AB), "B_max_abs_err": err_b,
                              "C_max_abs_err": err_c}))
'''


def make(name: str, tile_b: tuple, tile_c: tuple) -> str:
    """A copy of the package with the m = 5 float32 tiles replaced."""
    d = os.path.join(WORK, name)
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "dealii_asm_tpu_torch"),
                    os.path.join(d, "dealii_asm_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    path = os.path.join(d, "dealii_asm_tpu_torch", "kernels", "csrc",
                        "fdm_tile.cuh")
    with open(path) as f:
        src = f.read()
    if PLAN_B not in src or PLAN_C not in src:
        raise SystemExit("tile_sweep: fdm_tile.cuh's m = 5 plan changed")
    src = src.replace(PLAN_B, "      case 4: return {8, 8, 16, 512};\n"
                      "      case 5: return {%d, %d, %d, %d};" % tile_b)
    src = src.replace(PLAN_C, "    case 5: return itemsize == 4 ? TileShape"
                      "{%d, %d, %d, %d}\n" % tile_c
                      + "                                 : TileShape"
                      "{4, 4, 32, 256};\n    case 4: return itemsize == 4 ? "
                      "TileShape{8, 8, 32, 512}")
    with open(path, "w") as f:
        f.write(src)
    return d


def main(argv) -> int:
    names = argv or list(VARIANTS)
    dirs = {n: make(n, *VARIANTS[n]) for n in names}
    t0 = time.perf_counter()
    build = ("import sys; sys.path.insert(0, sys.argv[1]); "
             "from dealii_asm_tpu_torch.kernels import build; build.load()")
    procs = [subprocess.Popen([sys.executable, "-c", build, d])
             for d in dirs.values()]
    if any([p.wait() for p in procs]):  # wait for every build
        return 1
    print(f"built {len(dirs)} variants in {time.perf_counter() - t0:.1f} s")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    for _ in range(2):
        for n, d in dirs.items():
            out = subprocess.run([sys.executable, "-c", CHILD, d],
                                 capture_output=True, text=True)
            line = [x for x in out.stdout.splitlines()
                    if x.startswith("RESULT ")]
            tiles = "B %s, C %s" % VARIANTS[n]
            print(f"{n} ({tiles}): "
                  + (line[0][7:] if line else out.stderr[-2000:]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
