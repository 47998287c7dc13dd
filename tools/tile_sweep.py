#!/usr/bin/env python3
"""Time kernel variants at 64^3 cells Q4 on one GPU: tile shapes of kernels
A, B and C, with kernel D's sweep (A's residual and B's momentum step per
sub-step) at Q4 and Q2 beside them.

    python3 tools/tile_sweep.py                # the A variants
    python3 tools/tile_sweep.py plan c4x4      # some variants by name
    python3 tools/tile_sweep.py all            # every variant below
    python3 tools/tile_sweep.py plan --parent DIR   # beside another checkout

Each variant is a copy of dealii_asm_tpu_torch/ (under _tile_sweep/) with
its kernel sources edited (VARIANTS: file, text, replacement); "plan" is
the sources as they are.  The copies are built in parallel, then each is
timed in its own process with CUDA events, twice in turns: kernel A's vmult
in float32 and float64 (p = 4), B alone, C, kernel A then B as one step,
and kernel D's degree-2 Chebyshev sweep from x and from zero at 64^3 cells
Q4 and Q2 (the fdm1 ladder's finest levels).  Each variant's kernel-C
output on the same inputs is compared bit for bit with the plan's (no
variant changes C's code); --parent DIR adds the package of another
checkout at DIR (a parent commit, or another design of D) as the variant
"parent", built and timed in place.  Prints one line per variant and
round, the C comparison, and the card's name and power limit.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORK = os.path.join(ROOT, "_tile_sweep")
TILE = "fdm_tile.cuh"
PLANE = "banded_plane.cuh"
PLAN_B = "      case 4:\n      case 5: return {8, 8, 16, 512};"
PLAN_C = ("    case 4:\n    case 5: return itemsize == 4 ? "
          "TileShape{8, 8, 32, 512}")
PLAN_A = "constexpr BandShape band_shape(int p, int itemsize) {\n"


def _b(tile):  # kernel B's m = 5 tile
    return [(TILE, PLAN_B, "      case 4: return {8, 8, 16, 512};\n"
             "      case 5: return {%d, %d, %d, %d};" % tile)]


def _c(tile):  # kernel C's m = 5 float32 tile
    return [(TILE, PLAN_C, "    case 5: return itemsize == 4 ? TileShape"
             "{%d, %d, %d, %d}\n" % tile
             + "                                 : TileShape"
             "{4, 4, 32, 256};\n    case 4: return itemsize == 4 ? "
             "TileShape{8, 8, 32, 512}")]


def _a(shape):  # kernel A's p = 4 shape (wx, wy, cz, threads, minb)
    return [(PLANE, PLAN_A, PLAN_A + "  if (p == 4) return BandShape{%d, %d, "
             "%d, %d, %d};\n" % shape)]


# name -> edits of the kernel sources
VARIANTS = {
    "plan": [],
    "a32x16": _a((32, 16, 64, 256, 2)),
    "a32x32": _a((32, 32, 64, 256, 2)),
    "a64x16": _a((64, 16, 64, 256, 2)),
    "a32x8": _a((32, 8, 64, 256, 2)),
    "a32x16t512": _a((32, 16, 64, 512, 1)),
    "a32x16z32": _a((32, 16, 32, 256, 2)),
    "a32x16m1": _a((32, 16, 64, 256, 1)),
    "b8x8x8": _b((8, 8, 8, 512)),
    "b8x8x16t256": _b((8, 8, 16, 256)),
    "c8x8x16": _c((8, 8, 16, 512)),
    "c8x8x32t1024": _c((8, 8, 32, 1024)),
    "c4x4": _c((4, 4, 32, 256)),
}
DEFAULT = ("plan", "a32x16", "a32x32", "a64x16", "a32x8", "a32x16t512",
           "a32x16z32", "a32x16m1")

CHILD = r'''
import json, sys
import torch
sys.path.insert(0, sys.argv[1])
from dealii_asm_tpu_torch.fem.dofs import DofHandler
from dealii_asm_tpu_torch.kernels.banded_laplace import (banded_laplace,
                                                         banded_laplace_plain)
from dealii_asm_tpu_torch.kernels.fdm_patch import fdm_patch, fdm_patch_plain
from dealii_asm_tpu_torch.kernels.smoother_step import (smoother_step,
                                                        smoother_step_plain)
from dealii_asm_tpu_torch.kernels.smoother_sweep import (
    smoother_sweep, smoother_sweep_plain)
from dealii_asm_tpu_torch.mesh.grid import StructuredMesh
from dealii_asm_tpu_torch.ops.laplace import LaplaceOperator
from dealii_asm_tpu_torch.precond.asm import ASMPreconditioner

dofs = DofHandler(StructuredMesh(3, (64, 64, 64)), 4)
op = LaplaceOperator(dofs, dtype=torch.float32, device="cuda")
op64 = LaplaceOperator(dofs, dtype=torch.float64, device="cuda")
asm = ASMPreconditioner(dofs, weighting_type="symm", dtype=torch.float32,
                        device="cuda")
g = torch.Generator(device="cuda").manual_seed(1)
x = torch.randn(dofs.n_dofs, device="cuda", generator=g)
b = torch.randn(dofs.n_dofs, device="cuda", generator=g)
x64 = x.double()
# Chebyshev 1st kind, degree 2, lambda_max 1.92, range 20 (chip_smoke.py)
from dealii_asm_tpu_torch.solvers.chebyshev import chebyshev_sweep_coefficients
coefs = chebyshev_sweep_coefficients(2, (1.92 + 0.096) / 2, (1.92 - 0.096) / 2,
                                     "1st kind", lam_max=1.92)


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


def err(a, b):
    return float((a - b).abs().max())


A32 = lambda: banded_laplace(x, op.tables)
A64 = lambda: banded_laplace(x64, op64.tables)
B = lambda: fdm_patch(x, asm.tables, 0.37)
C = lambda: smoother_step(x, b, op.tables, asm.tables, 0.37)
AB = lambda: fdm_patch(banded_laplace(x, op.tables, b), asm.tables, 0.37, x)
D = lambda: smoother_sweep(x, b, op.tables, asm.tables, coefs)
D0 = lambda: smoother_sweep(None, b, op.tables, asm.tables, coefs, True)
dofs2 = DofHandler(StructuredMesh(3, (64, 64, 64)), 2)
op2 = LaplaceOperator(dofs2, dtype=torch.float32, device="cuda")
asm2 = ASMPreconditioner(dofs2, weighting_type="symm", dtype=torch.float32,
                         device="cuda")
x2 = torch.randn(dofs2.n_dofs, device="cuda", generator=g)
b2 = torch.randn(dofs2.n_dofs, device="cuda", generator=g)
D2 = lambda: smoother_sweep(x2, b2, op2.tables, asm2.tables, coefs)
D20 = lambda: smoother_sweep(None, b2, op2.tables, asm2.tables, coefs, True)
out = {"A_f32_ms": ms(A32), "A_f64_ms": ms(A64), "B_ms": ms(B),
       "C_ms": ms(C), "A_then_B_ms": ms(AB), "D_ms": ms(D),
       "D_zero_ms": ms(D0), "D_q2_ms": ms(D2), "D_q2_zero_ms": ms(D20),
       "D_again_ms": ms(D)}
out.update({
    "A_f32_max_abs_err": err(A32(), banded_laplace_plain(x, op.tables)),
    "A_f64_max_abs_err": err(A64(), banded_laplace_plain(x64, op64.tables)),
    "B_max_abs_err": err(B(), fdm_patch_plain(x, asm.tables, 0.37)),
    "C_max_abs_err": err(C(), smoother_step_plain(x, b, op.tables,
                                                  asm.tables, 0.37)),
    "D_max_abs_err": err(D(), smoother_sweep_plain(x, b, op.tables,
                                                   asm.tables, coefs))})
torch.save(C().cpu(), sys.argv[2])
print("RESULT " + json.dumps(out))
'''


def make(name: str) -> str:
    """A copy of the package with the variant's edits."""
    d = os.path.join(WORK, name)
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "dealii_asm_tpu_torch"),
                    os.path.join(d, "dealii_asm_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    csrc = os.path.join(d, "dealii_asm_tpu_torch", "kernels", "csrc")
    for fname, old, new in VARIANTS[name]:
        path = os.path.join(csrc, fname)
        with open(path) as f:
            src = f.read()
        if old not in src:
            raise SystemExit(f"tile_sweep: {fname} no longer holds {old!r}")
        with open(path, "w") as f:
            f.write(src.replace(old, new))
    return d


def main(argv) -> int:
    parent = None
    if "--parent" in argv:
        i = argv.index("--parent")
        parent = os.path.abspath(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    names = (list(VARIANTS) if argv == ["all"] else argv) or list(DEFAULT)
    dirs = {n: make(n) for n in names}
    if parent is not None:
        dirs["parent"] = parent
    t0 = time.perf_counter()
    build = ("import sys; sys.path.insert(0, sys.argv[1]); "
             "from dealii_asm_tpu_torch.kernels import build; build.load()")
    procs = {n: subprocess.Popen([sys.executable, "-c", build, d],
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
             for n, d in dirs.items()}
    for n, proc in procs.items():  # wait for every build
        log = proc.communicate()[0]
        if proc.returncode != 0:
            print(f"{n}: build failed\n{log[-3000:]}", flush=True)
            del dirs[n]
    print(f"built {len(dirs)} variants in {time.perf_counter() - t0:.1f} s")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    c_out = {n: os.path.join(WORK, f"{n}_C.pt") for n in dirs}
    for _ in range(2):
        for n, d in dirs.items():
            out = subprocess.run([sys.executable, "-c", CHILD, d, c_out[n]],
                                 capture_output=True, text=True)
            line = [x for x in out.stdout.splitlines()
                    if x.startswith("RESULT ")]
            edits = ("; ".join(new.strip().splitlines()[-1].strip()
                               for _, _, new in VARIANTS[n]) if n in VARIANTS
                     else d) or "as planned"
            print(f"{n} ({edits}): "
                  + (line[0][7:] if line else out.stderr[-2000:]), flush=True)
    import torch

    if "plan" in dirs and os.path.exists(c_out["plan"]):
        ref = torch.load(c_out["plan"])
        for n in dirs:
            if n != "plan" and os.path.exists(c_out[n]):
                got = torch.load(c_out[n])
                same = torch.equal(got, ref)
                print(f"kernel C output, {n} against plan: "
                      + ("bit-identical" if same else "DIFFERS (max abs "
                         f"{float((got - ref).abs().max()):.3e})"))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
