#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dealii_asm_tpu_torch) on one GPU.

    python3 chip_smoke.py            # the whole check, one GPU
    python3 chip_smoke.py --quick    # build + kernel checks at 2^3 cells only
    python3 chip_smoke.py --only 9,13   # build + the named solve phases only
    python3 chip_smoke.py --only 14,15,16   # build + the vertex-patch phases
    python3 chip_smoke.py --only 17,18,19,20   # build + the named inputs

Phases, each of which must pass (the script exits non-zero otherwise):
1. toolchain: torch and its CUDA, nvcc, triton, the card's name and power
   limit;
2. build the kernels from dealii_asm_tpu_torch/kernels/csrc with nvcc, and
   print the launch plan of every instantiation of kernel A, of the tiled
   kernels B and C (tile, threads, shared bytes) and of the line-per-thread
   cell body of E and F (cells a warp and a block, threads, shared and
   parameter bytes), held equal to kernels/banded_laplace.py::launch_plan,
   kernels/fdm_patch.py::launch_plan and kernels/merged_laplace.py::
   cell_plan; with --ptxas also registers and spills, and the count of E's
   and F's multiplies that take a table entry from the parameter bank or
   from a uniform register loaded from it;
3. every kernel against its plain PyTorch version on the card, on random
   inputs from a seed, with kernel and plain times from CUDA events taken in
   turns (plain, kernel, kernel, plain):
   - A (float32 and float64), B and C on Cartesian meshes at 2^3, 16^3 and
     64^3 cells Q4 (B and C also at p = 2, and in float64 at 2^3 and 16^3);
     at 64^3 Q4 also C timed in turns against A then B back to back (the
     fusion must pay);
   - A (both precisions, vmult and residual), B (without and with xold)
     and C on meshes of 5 x 7 x 13 and 1 x 9 x 6 cells (ragged tiles, a
     1-cell axis) at p = 1..7, B and C also in float64 on 5 x 7 x 13 cells
     and with the weightings none and pre at p = 2 and 4, and on the
     ladder's stretch-50 mesh at 16^3 cells Q4 (per-coordinate tables),
     repeated runs bit-identical;
   - E (float64 and float32) on Kershaw meshes (eps 0.3, mapping degree 3)
     at 2^3, 12^3 and 48^3 cells Q4 and at p = 1..7 (12^3 cells), in its
     vmult and residual modes, repeated runs bit-identical; timed at 48^3
     cells Q4, Q2 and Q1 (the Kershaw levels; CUDA events over calls and
     over replays of a CUDA graph of one call, which leaves out the host's
     launch cost), printed before the kernel table;
   - F (float64 and float32) on the balanced hyperball (mapping degree 2)
     at 32, 2,048 and 131,072 cells Q4 and at p = 1..7 (2,048 cells), in
     its vmult and residual modes, repeated runs bit-identical;
   - D (float32) on Cartesian meshes at 16^3 and 64^3 cells Q4 and Q2 and
     on 5 x 7 x 13 cells Q4, Chebyshev rows of both kinds at
     degree 2, 3 and 4 and Relaxation rows (f1 = 0), from x and from the
     zero guess (an x full of NaN must not matter), repeated runs
     bit-identical; in float64 at 16^3 cells Q4 (degree 2 and 3); with the
     weightings none and pre on 5 x 7 x 13 cells at p = 2 and 4; two
     launches per sub-step (kernel A's residual, then kernel B's momentum
     step; one for the zero guess's first), read by torch.profiler; at
     degree 2 D timed at Q4 and Q2, and at 64^3 Q4 in turns against the
     unfused loop (kernels A and B with torch vector operations) and, for
     Relaxation rows, two unrolled kernel-C steps;
4. the flagship solve (experiments/e2e_aniso_q4.json, 64^3 cells Q4,
   16,974,593 DoFs) through run_config on the card: converged in 5 CG
   iterations, with A, B and C launched on that path; and the same config at
   2 refinements on the card against the plain CPU path;
5. the Kershaw solve (experiments/e2e_kershaw_q4.json, 48^3 cells Q4,
   7,189,057 DoFs) through run_config on the card: converged in 55 CG
   iterations, with E launched in both precisions on that path; and the same
   config at 1 refinement on the card against the plain CPU path (38
   iterations on the CPU, the card within one: see ``run_solve``);
6. the hyperball solve (experiments/e2e_ball_q4.json, 131,072 cells Q4,
   8,438,273 DoFs) through run_config on the card: converged in 7 CG
   iterations, with F launched in both precisions on that path, and two
   applies of its V-cycle bit-identical; and the same config at 1 refinement
   on the card against the plain CPU path (6 iterations on the CPU, the card
   within one);
7. the large-scaling ladder's fdm1 rung at 6 refinements
   (experiments/sweep_large_scaling/input_0025.json: anisotropy stretch 50,
   64^3 cells Q4, 16,974,593 DoFs, hp-multigrid, Chebyshev-2 around FDM)
   through run_config on the card with DEALII_ASM_TPU_CHAIN_DEGREES=2 set by
   this script: converged in 65 CG iterations, with D and A launched on
   that path; the same config at 2 refinements on the card (kernel D)
   against the plain CPU path (9 iterations); and once more at full size
   with the variable unset: 65 iterations and no launch of D;
8. the ladder's r = 7 rung (input_0029.json, 128^3 cells Q4, 135,005,697
   DoFs, CoarseCG coarse solve) with the variable set to 2: converged (the
   JAX package has no count at this size); its count, setup and solve
   seconds and peak device memory are printed;
9. GMRES (experiments/sweep_cartesian/input_0210.json: restart 15, CGS2,
   right preconditioning, ph-multigrid, Chebyshev-1 around FDM overlap 1
   "post", Q3) at 6 refinements, 64^3 cells, 7,189,057 DoFs: A (both
   precisions), B and C launched, D not;
10. the same with FDM overlap 2 RAS (input_0300.json), 7,189,057 DoFs: A
   launched, B, C and D not (overlap > 1 and RAS take the plain global
   FDM apply); before it, the plain apply's time per call at 64^3 cells Q3
   in float32 (overlap 2 RAS and symm) beside kernel B's (overlap 1);
11. the ladder's fdm2 rung at 6 refinements (sweep_large_scaling/
   input_0026.json: CG, hp-multigrid, Chebyshev-2 around FDM overlap 2
   "symm", stretch 50, Q4), 16,974,593 DoFs: A launched, B, C and D not;
12. the hyperball at 4 refinements, 131,072 cells Q2, 1,061,121 DoFs:
   GMRES around Chebyshev-1 and element FDM (sweep_ball/input_0060.json)
   and CG around Chebyshev-1 and the inverse diagonal (input_0000.json), F
   launched in both precisions;
13. experiments/default.json (Kershaw eps 0.2, GMRES restart 15,
   ph-multigrid, per-cell FDM "post", Q4, 24^3 cells, 912,673 DoFs): E
   launched in both precisions; at 0 refinements the card within one
   iteration of the CPU (its last residual lies within 2% of the
   threshold, ``probe sensitivity``);
14. experiments/e2e_kershaw_fdmv.json (Kershaw eps 0.3, Q4, 48^3 cells,
   7,189,057 DoFs, ph-multigrid, Chebyshev-2 around vertex-star FDM
   "symm"): E launched in both precisions; its count printed beside the
   reference's 49; before it, the Kershaw vertex and element overlap-2 RAS
   FDM applies at 48^3 cells Q4;
15. experiments/e2e_ball_fdmv.json (the ball at 3 refinements, 16,384
   cells Q4, 1,061,121 DoFs, Chebyshev-1 around vertex FDM "symm"): F
   launched in both precisions, two V-cycle applies bit-identical; before
   it, the ball vertex FDM apply;
16. the ladder's fdmv rung at 6 refinements (input_0027.json, 64^3 cells
   Q4, 16,974,593 DoFs) derived with "mg type" "ph" (the hp original puts
   p-levels on the 1-cell mesh, which has no interior vertex: it raises a
   ValueError in both packages, and input_0003.json as written must raise
   it on the card): A launched; before it, the Cartesian vertex FDM apply
   at 64^3 cells Q4;
17. inputs/jw_01..03 at their own sizes (symmetric hypercube, gaussian-jw
   rhs with its Dirichlet lift, ph-multigrid, Chebyshev-2 around FDM
   overlap 1 "symm"; Q2, Q4, Q7: 35,937, 274,625 and 1,442,897 DoFs): A
   (both precisions) and B launched; before them, A, B (without and with
   xold) and C against their plain versions at jw_03's shape (16^3 cells
   Q7, h = 0.125), float32 and float64;
18. inputs/mp_02 at its own size (Kershaw-mp, 36^3 cells Q7, 16,194,277
   DoFs, GMRES(30), p-multigrid around Chebyshev-1 and per-cell overlap-2
   RAS FDM, the dense coarse solve of 50,653 DoFs assembled and factorised
   on the card): E launched in both precisions, B, C and D not;
19. inputs/mp_00, 01, 03, 04 and 05 at 1 refinement (2,048,383 DoFs;
   mp_04 and mp_05 with the linear-geometry outer operator, plain torch):
   E launched (float32; float64 also where the outer operator is merged),
   B, C and D not;
20. inputs/dummy.json (2D Q3, 625 DoFs, CG around Diagonal, plain torch):
   24 iterations, no kernel launched.
Phases 9 to 16 accept any converged count at full size (the JAX package has
none there); their small checks hold the CPU path to the JAX package's CPU
count (pinned from one JAX run_config each: 0210 and 0300 5 and 8 at 3
refinements, input_0026 10 at 3, ball 0060 and 0000 5 and 5 at 1,
default.json 101 at 0, e2e_kershaw_fdmv 44 at 1, e2e_ball_fdmv 6 at 1,
the ph ladder fdmv 11 at 3; jw_01..03 8, 8, 8 at 2, 1, 1 refinements on
the homogeneous system; mp_00..05 6, 8, 8, 14, 6, 15 at 2 subdivisions and
0 refinements; dummy.json 24) and the card to the CPU path (Kershaw within
one iteration).  Phases 17 to 19 accept any converged count at full size
(the JAX package has none there).  B, C and D are launched 0 times in
phases 10, 11, 14 to 16 and 18 to 20.  Each FDM apply of phases 14 to 16
is held in float64 on the card to 1e-12 of the CPU's float64 apply and in
float32 to 1e-5, repeats
bit-identical, and timed with CUDA events beside the element overlap-1
apply on the same mesh (kernel B on the Cartesian one).
The launch counts of each solve are set to 0 just before it and read just
after.  Before the kernel table come E's times at the Kershaw level
shapes.  The last two lines of standard output are the kernel table as JSON
and the result line {"ok": true, "device": {...}}.  Without a GPU, or
without the package beside the script, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP = os.path.join(HERE, "experiments", "e2e_aniso_q4.json")
KERSHAW = os.path.join(HERE, "experiments", "e2e_kershaw_q4.json")
BALL = os.path.join(HERE, "experiments", "e2e_ball_q4.json")
LADDER_R6 = os.path.join(HERE, "experiments", "sweep_large_scaling",
                         "input_0025.json")
LADDER_R7 = os.path.join(HERE, "experiments", "sweep_large_scaling",
                         "input_0029.json")
GMRES_POST = os.path.join(HERE, "experiments", "sweep_cartesian",
                          "input_0210.json")
GMRES_RAS = os.path.join(HERE, "experiments", "sweep_cartesian",
                         "input_0300.json")
LADDER_FDM2 = os.path.join(HERE, "experiments", "sweep_large_scaling",
                           "input_0026.json")
BALL_GMRES = os.path.join(HERE, "experiments", "sweep_ball", "input_0060.json")
BALL_DIAG = os.path.join(HERE, "experiments", "sweep_ball", "input_0000.json")
DEFAULT = os.path.join(HERE, "experiments", "default.json")
KERSHAW_FDMV = os.path.join(HERE, "experiments", "e2e_kershaw_fdmv.json")
BALL_FDMV = os.path.join(HERE, "experiments", "e2e_ball_fdmv.json")
LADDER_FDMV = os.path.join(HERE, "experiments", "sweep_large_scaling",
                           "input_0027.json")
LADDER_FDMV_R0 = os.path.join(HERE, "experiments", "sweep_large_scaling",
                              "input_0003.json")
INPUTS = os.path.join(HERE, "inputs")
# the named study inputs: (own-size DoFs, small refinements, the JAX
# package's count there; jw on the homogeneous system, pinned from one JAX
# run each with its assemble_rhs zeroing the constrained rows, see
# tests/test_torch_rhs.py)
JW = {"jw_01": (35_937, 2, 8), "jw_02": (274_625, 1, 8),
      "jw_03": (1_442_897, 1, 8)}
# Kershaw-mp: the JAX package's counts at 2 subdivisions and 0 refinements
# (3,375 DoFs; tests/test_torch_inputs.py)
MP_SMALL = {"mp_00": 6, "mp_01": 8, "mp_02": 8, "mp_03": 14, "mp_04": 6,
            "mp_05": 15}
MP_COMPACT = ("mp_04", "mp_05")  # "operator mapping type": "linear geometry"
CHAIN_GATE = "DEALII_ASM_TPU_CHAIN_DEGREES"
SEED = 20261016

# kernel (its launch-count key) -> (source, TPU kernel it replaces)
KERNELS = {
    "banded_laplace_f32": ("dealii_asm_tpu_torch/kernels/csrc/banded_laplace.cu",
                           "dealii_asm_tpu/ops/pallas/dd_vmult.py:564"),
    "banded_laplace_f64": ("dealii_asm_tpu_torch/kernels/csrc/banded_laplace.cu",
                           "dealii_asm_tpu/ops/pallas/dd_vmult.py:296"),
    "fdm_patch": ("dealii_asm_tpu_torch/kernels/csrc/fdm_patch.cu",
                  "dealii_asm_tpu/ops/pallas/fdm_slab.py:138"),
    "smoother_step": ("dealii_asm_tpu_torch/kernels/csrc/smoother_step.cu",
                      "dealii_asm_tpu/ops/pallas/smoother_step.py:1053"),
    "merged_laplace_f64": ("dealii_asm_tpu_torch/kernels/csrc/merged_laplace.cu",
                           "dealii_asm_tpu/ops/pallas/merged_vmult.py:339"),
    "merged_laplace_f32": ("dealii_asm_tpu_torch/kernels/csrc/merged_laplace.cu",
                           "dealii_asm_tpu/ops/pallas/merged_vmult.py:339"),
    "lanes_laplace_f64": ("dealii_asm_tpu_torch/kernels/csrc/lanes_laplace.cu",
                          "dealii_asm_tpu/ops/pallas/lanes_vmult.py:263"),
    "lanes_laplace_f32": ("dealii_asm_tpu_torch/kernels/csrc/lanes_laplace.cu",
                          "dealii_asm_tpu/ops/pallas/lanes_vmult.py:263"),
    "smoother_sweep": ("dealii_asm_tpu_torch/kernels/csrc/smoother_sweep.cu",
                       "dealii_asm_tpu/ops/pallas/smoother_step.py:968"),
}
# the solve whose run_config launches each kernel
FLAGSHIP_KERNELS = ("banded_laplace_f32", "banded_laplace_f64", "fdm_patch",
                    "smoother_step")
KERSHAW_KERNELS = ("merged_laplace_f64", "merged_laplace_f32")
BALL_KERNELS = ("lanes_laplace_f64", "lanes_laplace_f32")
LADDER_KERNELS = ("smoother_sweep",)
# the largest shape each kernel's solve gives it (the kernels line reports it)
MAIN_SHAPE = dict.fromkeys(FLAGSHIP_KERNELS, "64^3 cells Q4")
MAIN_SHAPE.update(dict.fromkeys(KERSHAW_KERNELS, "48^3 cells Q4"))
MAIN_SHAPE.update(dict.fromkeys(BALL_KERNELS, "131072 cells Q4"))
MAIN_SHAPE["smoother_sweep"] = "64^3 cells Q4, degree 2, from x"

# Peaks of one H100 SXM (NVIDIA data sheet, dense, at the full 700 W):
# device memory 3.35 TB/s; float32 67 TFLOP/s and float64 34 TFLOP/s outside
# the tensor cores (the kernels use none).
PEAK_BYTES_S = 3.35e12
PEAK_FLOP_S = {4: 67e12, 8: 34e12}

# Stated bounds on max|kernel - plain| / max|plain| (same inputs, same card):
# - A float64: 1e-12, only the summation order differs;
# - A float32: 1e-5, float32 rounding of 9-tap sums in another order;
# - B and C float32: 1e-4.  The plain version applies the folded dense
#   per-axis transforms G_d (the JAX global-FDM path), the kernel the per-cell
#   m x m transforms: the same float32 products in another order and
#   grouping.  Both are also held against the float64 plain version: the
#   kernel may not be worse than twice the plain float32 version (or 1e-4).
# - E float64: 1e-12 and float32: 1e-5, the same products summed in another
#   order (the plain version's dense q-space axis products add zeros too).
# - F float64: 1e-12 and float32: 1e-5, the same products summed in another
#   order (the plain version contracts with einsums and scatters with
#   index_add_).
# - D float32: 1e-4, C's bound: each sub-step is A's and B's arithmetic
#   against the plain composition's, as in C, and the Chebyshev rows keep
#   the sub-steps' rounding at the size of one step's.
# - B, C and D float64: 1e-12, the same float64 products in another order
#   and grouping (the float32 bounds above cover float32 rounding).
BOUNDS = {"banded_laplace_f32": 1e-5, "banded_laplace_f64": 1e-12,
          "fdm_patch": 1e-4, "smoother_step": 1e-4,
          "merged_laplace_f64": 1e-12, "merged_laplace_f32": 1e-5,
          "lanes_laplace_f64": 1e-12, "lanes_laplace_f32": 1e-5,
          "smoother_sweep": 1e-4}
BOUND_F64 = 1e-12


class Failed(Exception):
    pass


def sh(cmd) -> str:
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
        return (out.stdout + out.stderr).strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e})"


def cuda_time(fn, reps: int) -> float:
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_time(fn, reps: int):
    """Device ms of one call of ``fn`` without the host's launch cost: the
    call captured once in a CUDA graph and replayed (None if the capture
    fails)."""
    import torch

    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        return cuda_time(graph.replay, reps)
    except RuntimeError as e:
        print(f"    graph capture failed: {e}")
        return None


def in_turns(plain, kernel, reps: int):
    """(kernel_ms, plain_ms): order plain, kernel, kernel, plain."""
    p1 = cuda_time(plain, reps)
    k1 = cuda_time(kernel, reps)
    k2 = cuda_time(kernel, reps)
    p2 = cuda_time(plain, reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


def print_time(tag: str, n: int, k_ms: float, p_ms: float) -> None:
    print(f"    time {tag}: kernel {k_ms:.4f} ms ({n / k_ms / 1e6:.2f} GDoF/s), "
          f"plain {p_ms:.4f} ms ({n / p_ms / 1e6:.2f} GDoF/s)")


def rel_err(a, b) -> float:
    """max|a - b| / max|b|, in float64 (a zero b, as on a mesh whose every
    node is constrained, gives max|a - b| / 1e-300)."""
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


def bound(n_bytes: float, n_flop: float, itemsize: int) -> tuple:
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate of their type."""
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_flop = n_flop / PEAK_FLOP_S[itemsize] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_flop else (t_flop, "operations")


def banded_work(n: int, p: int, itemsize: int) -> tuple:
    """(bytes, flop) of one kernel-A vmult on n nodes: u in, v out, the six
    diagonal tables; per node 7 (2p+1) multiply-adds (Mx u, Kx u; My, Ky;
    Kz, Mz)."""
    n_1d = round(n ** (1 / 3))
    return ((2 * n + 6 * (2 * p + 1) * n_1d) * itemsize,
            2.0 * 7 * (2 * p + 1) * n)


def fdm_work(cells: int, n: int, p: int, itemsize: int) -> tuple:
    """(bytes, flop) of one kernel-B apply: src in, out out, and per cell
    six m x m x m^2 transforms and the eigenvalue scaling."""
    m = p + 1
    n_1d = round(n ** (1 / 3))
    tables = 3 * round(cells ** (1 / 3)) * (m * m + m) + 6 * n_1d
    return ((2 * n + tables) * itemsize,
            2.0 * cells * (6 * m ** 4 + m ** 3))


def merged_work(cells: int, n: int, p: int, itemsize: int,
                residual: bool = False) -> tuple:
    """(bytes, flop) of one kernel-E apply: u (and rhs) in, v out, the
    (C, 6, Q) coefficients; per cell 16 m^4 + 9 m^3 multiply-adds (the
    eight 1D contractions of the sum factorisation and C g), and the
    summation of the cell results onto the nodes."""
    m = p + 1
    vectors = (3 if residual else 2) * n
    return ((vectors + 6 * cells * m ** 3 + 4 * m * m) * itemsize,
            2.0 * cells * (16 * m ** 4 + 9 * m ** 3) + 8.0 * n)


def lanes_work(cells: int, n: int, p: int, itemsize: int,
               residual: bool = False) -> tuple:
    """(bytes, flop) of one kernel-F apply: u (and rhs) in, v out, the int32
    gather table and the (C, 6, Q) coefficients; per cell 16 m^4 + 9 m^3
    multiply-adds, and the summation of the cell results onto the DoFs.
    The scratch and the CSR the kernel also moves are not the function's
    inputs or outputs."""
    m = p + 1
    vectors = (3 if residual else 2) * n
    return ((vectors + 6 * cells * m ** 3 + 4 * m * m) * itemsize
            + 4 * cells * m ** 3,
            2.0 * cells * (16 * m ** 4 + 9 * m ** 3) + cells * m ** 3)


def sweep_work(cells: int, n: int, p: int, k: int, zero_x: bool) -> tuple:
    """(bytes, flop) of one kernel-D sweep of k sub-steps in float32: x
    (not under zero_x) and b in, x' out, the tables once; k times B's
    operations and A's for every sub-step that applies A (all but the first
    under zero_x)."""
    fb, ff = fdm_work(cells, n, p, 4)
    ab, af = banded_work(n, p, 4)
    vectors = (2 if zero_x else 3) * n * 4
    return (vectors + fb + ab - 4 * 4 * n,
            k * ff + (k - 1 if zero_x else k) * af)


def check_plans() -> None:
    """Phase 2: the launch plan of every instantiation of kernels A, B, C,
    E and F as the library has it (dat_band_plan, dat_tile_plan,
    dat_cell_plan) against launch_plan's and cell_plan's mirrors."""
    import ctypes

    from dealii_asm_tpu_torch.kernels import banded_laplace
    from dealii_asm_tpu_torch.kernels.build import load
    from dealii_asm_tpu_torch.kernels.fdm_patch import KERNEL_IDS, launch_plan
    from dealii_asm_tpu_torch.kernels.merged_laplace import cell_plan

    lib = load()
    got = (ctypes.c_int * 5)()
    for p in range(1, 8):
        for itemsize in (4, 8):
            if lib.dat_band_plan(p, itemsize, got) != 0:
                raise Failed(f"dat_band_plan({p}, {itemsize})")
            plan = banded_laplace.launch_plan(p, itemsize)
            want = (*plan.tile, plan.threads, plan.shared_bytes)
            print(f"  plan banded_laplace p={p} float{8 * itemsize}: tile "
                  f"{got[0]}x{got[1]} nodes, {got[2]} planes a block, "
                  f"{got[3]} threads, {got[4]} shared bytes; grid at 64^3 "
                  f"cells {plan.grid((64 * p + 1,) * 3)}")
            if tuple(got) != want:
                raise Failed(f"plan banded_laplace p={p} itemsize={itemsize}:"
                             f" library {tuple(got)}, launch_plan {want}")
    for kernel, kid in KERNEL_IDS.items():
        for p in range(1, 8):
            for itemsize in (4, 8):
                if lib.dat_tile_plan(kid, p, itemsize, got) != 0:
                    raise Failed(f"dat_tile_plan({kernel}, {p}, {itemsize})")
                plan = launch_plan(p, itemsize, kernel)
                want = (*plan.tile, plan.threads, plan.shared_bytes)
                print(f"  plan {kernel} p={p} float{8 * itemsize}: tile "
                      f"{got[0]}x{got[1]}, {got[2]} layers a block, "
                      f"{got[3]} threads, {got[4]} shared bytes")
                if tuple(got) != want:
                    raise Failed(f"plan {kernel} p={p} itemsize={itemsize}: "
                                 f"library {tuple(got)}, launch_plan {want}")
    for p in range(1, 8):
        for itemsize in (4, 8):
            if lib.dat_cell_plan(p, itemsize, got) != 0:
                raise Failed(f"dat_cell_plan({p}, {itemsize})")
            plan = cell_plan(p, itemsize)
            want = (plan.cells_per_warp, plan.cells, plan.threads,
                    plan.shared_bytes, plan.param_bytes)
            print(f"  plan merged/lanes cells p={p} float{8 * itemsize}: "
                  f"{got[1]} cells a block ({got[0] or 'spanning'} a warp), "
                  f"{got[2]} threads, {got[3]} shared bytes, {got[4]} "
                  f"parameter bytes")
            if tuple(got) != want:
                raise Failed(f"plan cells p={p} itemsize={itemsize}: "
                             f"library {tuple(got)}, cell_plan {want}")


def sass_table_operands() -> None:
    """With --ptxas: how many of the floating-point multiplies of E's and
    F's cell kernels take an operand from the parameter bank (c[0x0][...],
    where the by-value 1D tables live) or from a uniform register (loaded
    from that bank by ULDC, once a warp), from cuobjdump -sass of the built
    library."""
    import re

    from dealii_asm_tpu_torch.kernels import build

    tool = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    text = sh([tool, "-sass", str(build.build())])
    stats, cur = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            m = re.search(r"(merged|lanes)_cells_kernelI([df])Li(\d)E", line)
            cur = None
            if m:
                dt = "float64" if m[2] == "d" else "float32"
                cur = f"{m[1]} {dt} p={m[3]}"
            continue
        if cur and re.search(r"\b(DFMA|FFMA|DMUL|FMUL)\b", line):
            s = stats.setdefault(cur, [0, 0, 0, []])
            s[0] += "c[0x0]" in line
            s[1] += bool(re.search(r"\bUR\d", line))
            s[2] += 1
            if len(s[3]) < 4:
                s[3].append(" ".join(line.split("*/")[1].split("/*")[0]
                                     .split()))
    if not stats:
        print(f"  sass: no cell kernel found ({text[:200]!r})")
    for name, (const, uniform, total, lines) in sorted(stats.items()):
        print(f"  sass {name}: of {total} multiplies {const} take a "
              f"parameter-bank operand, {uniform} a uniform register; e.g. "
              + " | ".join(lines))


def check_kernels(cells_list, degrees_small, results):
    """Phase 3: kernels A, B, C vs their plain versions on the card."""
    import numpy as np
    import torch

    from dealii_asm_tpu_torch.fem.dofs import DofHandler
    from dealii_asm_tpu_torch.kernels.banded_laplace import (
        banded_laplace, banded_laplace_plain)
    from dealii_asm_tpu_torch.kernels.fdm_patch import (fdm_patch,
                                                        fdm_patch_plain)
    from dealii_asm_tpu_torch.kernels.smoother_step import (
        smoother_step, smoother_step_plain)
    from dealii_asm_tpu_torch.mesh.grid import StructuredMesh
    from dealii_asm_tpu_torch.ops.laplace import LaplaceOperator
    from dealii_asm_tpu_torch.precond.asm import ASMPreconditioner

    rng = np.random.default_rng(SEED)
    dev = "cuda"
    cases = [(c, 4) for c in cells_list] + [(cells_list[0], p)
                                           for p in degrees_small if p != 4]
    for c, p in cases:
        dofs = DofHandler(StructuredMesh(3, (c, c, c)), p)
        n = dofs.n_dofs
        reps = 20 if n > 1_000_000 else 100
        x64 = torch.as_tensor(rng.standard_normal(n), device=dev)
        b64 = torch.as_tensor(rng.standard_normal(n), device=dev)
        tag = f"{c}^3 cells Q{p}, {n} DoFs"
        # A in both precisions
        for dt, name in ((torch.float32, "banded_laplace_f32"),
                         (torch.float64, "banded_laplace_f64")):
            op = LaplaceOperator(dofs, dtype=dt, device=dev)
            x, b = x64.to(dt), b64.to(dt)
            for rhs in (None, b):
                got = banded_laplace(x, op.tables, rhs)
                ref = banded_laplace_plain(x, op.tables, rhs)
                err = rel_err(got, ref)
                what = "residual" if rhs is not None else "vmult"
                print(f"  A {name} {what:8s} {tag}: max rel err {err:.3e} "
                      f"(bound {BOUNDS[name]:g})")
                if not err <= BOUNDS[name]:
                    raise Failed(f"{name} {what} {tag}: {err:.3e}")
            abs_err = float((banded_laplace(x, op.tables)
                             - banded_laplace_plain(x, op.tables)).abs().max())
            k_ms, p_ms = in_turns(lambda: banded_laplace_plain(x, op.tables),
                                  lambda: banded_laplace(x, op.tables), reps)
            print_time(tag, n, k_ms, p_ms)
            results.setdefault(name, {})[tag] = (
                abs_err, k_ms, p_ms, bound(*banded_work(n, p, x.element_size()),
                                           x.element_size()))
        # B and C in float32, against plain float32 and plain float64
        op = LaplaceOperator(dofs, dtype=torch.float32, device=dev)
        asm = ASMPreconditioner(dofs, weighting_type="symm",
                                dtype=torch.float32, device=dev)
        asm64 = ASMPreconditioner(dofs, weighting_type="symm",
                                  dtype=torch.float64, device=dev)
        op64 = LaplaceOperator(dofs, dtype=torch.float64, device=dev)
        x, b = x64.float(), b64.float()
        om = 0.37
        runs = {
            "fdm_patch": (lambda: fdm_patch(x, asm.tables, om),
                          lambda: fdm_patch_plain(x, asm.tables, om),
                          lambda: fdm_patch_plain(x64, asm64.tables, om)),
            "smoother_step": (
                lambda: smoother_step(x, b, op.tables, asm.tables, om),
                lambda: smoother_step_plain(x, b, op.tables, asm.tables, om),
                lambda: smoother_step_plain(x64, b64, op64.tables,
                                            asm64.tables, om)),
        }
        for name, (kern, plain, ref64) in runs.items():
            got, ref, r64 = kern(), plain(), ref64()
            if not torch.equal(got, kern()):
                raise Failed(f"{name} {tag}: repeated runs differ")
            err = rel_err(got, ref)
            e_k, e_p = rel_err(got.double(), r64), rel_err(ref.double(), r64)
            print(f"  {name} {tag}: max rel err {err:.3e} (bound "
                  f"{BOUNDS[name]:g}); vs float64: kernel {e_k:.3e}, plain "
                  f"float32 {e_p:.3e}; repeated runs bit-identical")
            if not err <= BOUNDS[name] or not e_k <= max(2 * e_p, 1e-4):
                raise Failed(f"{name} {tag}: {err:.3e} / {e_k:.3e}")
            k_ms, p_ms = in_turns(plain, kern, reps)
            print_time(tag, n, k_ms, p_ms)
            nb, nf = fdm_work(c ** 3, n, p, 4)
            if name == "smoother_step":  # x, b in; x' out; A's work too
                ab, af = banded_work(n, p, 4)
                nb, nf = nb + ab - 4 * n, nf + af
            results.setdefault(name, {})[tag] = (
                float((got - ref).abs().max()), k_ms, p_ms, bound(nb, nf, 4))
        if c < 64:  # B and C in float64 against their plain float64 versions
            check_f64({
                "B": (lambda: fdm_patch(x64, asm64.tables, om),
                      lambda: fdm_patch_plain(x64, asm64.tables, om)),
                "C": (lambda: smoother_step(x64, b64, op64.tables,
                                            asm64.tables, om),
                      lambda: smoother_step_plain(x64, b64, op64.tables,
                                                  asm64.tables, om))}, tag)
        if c == max(cells_list) and p == 4:
            # the fusion pays only if one pass beats A then B back to back
            two = lambda: fdm_patch(banded_laplace(x, op.tables, b),
                                    asm.tables, om, x)
            c_ms, ab_ms = in_turns(two, runs["smoother_step"][0], reps)
            err = rel_err(runs["smoother_step"][0](), two())
            print(f"    C one pass {c_ms:.4f} ms against A then B "
                  f"{ab_ms:.4f} ms ({tag}): ratio {ab_ms / c_ms:.3f}, "
                  f"{'C faster' if c_ms < ab_ms else 'C NOT faster'}; max "
                  f"rel difference {err:.3e}")
        del op, asm, asm64, op64
        torch.cuda.empty_cache()


def check_f64(runs: dict, tag: str) -> None:
    """Each float64 kernel of ``runs`` (name -> (kernel, plain)) within
    BOUND_F64 of its plain float64 version, repeated runs bit-identical."""
    import torch

    for what, (kern, plain) in runs.items():
        got = kern()
        same = torch.equal(got, kern())
        err = rel_err(got, plain())
        print(f"  {what} float64 {tag}: max rel err {err:.3e} (bound "
              f"{BOUND_F64:g}); repeated runs "
              f"{'bit-identical' if same else 'DIFFER'}")
        if not (err <= BOUND_F64 and same):
            raise Failed(f"{what} float64 {tag}: {err:.3e}, "
                         f"bit-identical={same}")


def check_merged(cells_list, degrees_small, level_degrees, results, rows):
    """Phase 3: kernel E (both precisions) vs its plain version on Kershaw
    meshes: each size of ``cells_list`` at Q4, each of ``degrees_small`` on
    the second size, and each of ``level_degrees`` on the largest (the
    Kershaw levels' shapes).  Timed in turns at Q4 and on the largest size;
    the largest size's times also go to ``rows``."""
    import numpy as np
    import torch

    from dealii_asm_tpu_torch.fem.dofs import DofHandler
    from dealii_asm_tpu_torch.kernels.merged_laplace import (
        merged_laplace, merged_laplace_plain)
    from dealii_asm_tpu_torch.mesh.grid import StructuredMesh
    from dealii_asm_tpu_torch.mesh.transforms import kershaw_transform
    from dealii_asm_tpu_torch.ops.laplace import LaplaceOperator

    rng = np.random.default_rng(SEED + 1)
    dev = "cuda"
    small = cells_list[min(1, len(cells_list) - 1)]
    big = max(cells_list)
    cases = [(c, 4) for c in cells_list]
    cases += [(small, p) for p in degrees_small if (small, p) not in cases]
    cases += [(big, p) for p in level_degrees if (big, p) not in cases]
    for c, p in cases:
        mesh = StructuredMesh(3, (c, c, c),
                              transform=kershaw_transform(0.3, 0.3))
        dofs = DofHandler(mesh, p)
        n = dofs.n_dofs
        reps = 20 if n > 1_000_000 else 100
        x64 = torch.as_tensor(rng.standard_normal(n), device=dev)
        b64 = torch.as_tensor(rng.standard_normal(n), device=dev)
        tag = f"{c}^3 cells Q{p}, {n} DoFs"
        for dt, name in ((torch.float64, "merged_laplace_f64"),
                         (torch.float32, "merged_laplace_f32")):
            op = LaplaceOperator(dofs, dtype=dt, device=dev, mapping_degree=3)
            x, b = x64.to(dt), b64.to(dt)
            for rhs in (None, b):
                got = merged_laplace(x, op.tables, rhs)
                again = merged_laplace(x, op.tables, rhs)
                ref = merged_laplace_plain(x, op.tables, rhs)
                err = rel_err(got, ref)
                what = "residual" if rhs is not None else "vmult"
                same = torch.equal(got, again)
                print(f"  E {name} {what:8s} {tag}: max rel err {err:.3e} "
                      f"(bound {BOUNDS[name]:g}); repeated runs "
                      f"{'bit-identical' if same else 'DIFFER'}")
                if not err <= BOUNDS[name] or not same:
                    raise Failed(f"{name} {what} {tag}: {err:.3e}, "
                                 f"bit-identical={same}")
            if p == 4 or c == big:
                abs_err = float((merged_laplace(x, op.tables)
                                 - merged_laplace_plain(x, op.tables))
                                .abs().max())
                k_ms, p_ms = in_turns(
                    lambda: merged_laplace_plain(x, op.tables),
                    lambda: merged_laplace(x, op.tables), reps)
                print_time(tag, n, k_ms, p_ms)
                work = bound(*merged_work(c ** 3, n, p, x.element_size()),
                             x.element_size())
                results.setdefault(name, {})[tag] = (abs_err, k_ms, p_ms,
                                                     work)
                if c == big:
                    g_ms = graph_time(lambda: merged_laplace(x, op.tables),
                                      5 * reps)
                    g_txt = "not measured" if g_ms is None else f"{g_ms:.4f}"
                    rows.append(f"E {name} {tag}: kernel {k_ms:.4f} ms "
                                f"({g_txt} ms replayed in a CUDA graph), "
                                f"plain {p_ms:.4f} ms, bound {work[0]:.4f} "
                                f"ms ({work[1]}), {work[0] / k_ms:.1%} of "
                                "it")
            del op
            torch.cuda.empty_cache()


def check_tiles(degrees, results, cases=None):
    """Phase 3: kernels A (both precisions), B (without and with xold) and
    C against their plain versions on meshes whose cell counts leave ragged
    tiles and a 1-cell axis, at every degree, B and C also in float64 and
    under the weightings none and pre, and on the ladder's stretch-50 mesh
    at 16^3 cells Q4, whose per-coordinate tables differ along z.  Phase
    17 passes its own ``cases`` ((cells, lengths, p, weighting): jw_03's
    symmetric hypercube, h = 0.125 at Q7)."""
    import numpy as np
    import torch

    from dealii_asm_tpu_torch.fem.dofs import DofHandler
    from dealii_asm_tpu_torch.kernels.banded_laplace import (
        banded_laplace, banded_laplace_plain)
    from dealii_asm_tpu_torch.kernels.fdm_patch import (fdm_patch,
                                                        fdm_patch_plain)
    from dealii_asm_tpu_torch.kernels.smoother_step import (
        smoother_step, smoother_step_plain)
    from dealii_asm_tpu_torch.mesh.grid import StructuredMesh
    from dealii_asm_tpu_torch.ops.laplace import LaplaceOperator
    from dealii_asm_tpu_torch.precond.asm import ASMPreconditioner

    rng = np.random.default_rng(SEED + 4)
    dev = "cuda"
    unit = (1.0, 1.0, 1.0)
    if cases is None:
        cases = ([((5, 7, 13), unit, p, "symm") for p in degrees]
                 + [((1, 9, 6), unit, p, "post") for p in degrees]
                 + [((5, 7, 13), unit, p, wt) for wt in ("none", "pre")
                    for p in (2, 4)]
                 + [((16, 16, 16), (1.0, 1.0, 50.0), 4, "symm")])
    for cells, lengths, p, wt in cases:
        dofs = DofHandler(StructuredMesh(3, cells, lengths=lengths), p)
        n = dofs.n_dofs
        x64 = torch.as_tensor(rng.standard_normal(n), device=dev)
        b64 = torch.as_tensor(rng.standard_normal(n), device=dev)
        x, b = x64.float(), b64.float()
        tag = (f"{'x'.join(map(str, cells))} cells Q{p} {wt}"
               + (f", lengths {lengths}" if lengths != unit else "")
               + f", {n} DoFs")
        f32 = [LaplaceOperator(dofs, dtype=torch.float32, device=dev).tables,
               ASMPreconditioner(dofs, weighting_type=wt, dtype=torch.float32,
                                 device=dev).tables]
        f64 = [LaplaceOperator(dofs, dtype=torch.float64, device=dev).tables,
               ASMPreconditioner(dofs, weighting_type=wt, dtype=torch.float64,
                                 device=dev).tables]
        om = 0.37
        runs = {
            "B": (lambda: fdm_patch(x, f32[1], om),
                  lambda: fdm_patch_plain(x, f32[1], om),
                  lambda: fdm_patch_plain(x64, f64[1], om)),
            "B xold": (lambda: fdm_patch(x, f32[1], om, b),
                       lambda: fdm_patch_plain(x, f32[1], om, b),
                       lambda: fdm_patch_plain(x64, f64[1], om, b64)),
            "C": (lambda: smoother_step(x, b, *f32, om),
                  lambda: smoother_step_plain(x, b, *f32, om),
                  lambda: smoother_step_plain(x64, b64, *f64, om)),
        }
        for what, (kern, plain, ref64) in runs.items():
            name = "smoother_step" if what == "C" else "fdm_patch"
            got, ref, r64 = kern(), plain(), ref64()
            same = torch.equal(got, kern())
            err = rel_err(got, ref)
            e_k, e_p = rel_err(got.double(), r64), rel_err(ref.double(), r64)
            print(f"  {what} {tag}: max rel err {err:.3e} (bound "
                  f"{BOUNDS[name]:g}); vs float64: kernel {e_k:.3e}, plain "
                  f"float32 {e_p:.3e}; repeated runs "
                  f"{'bit-identical' if same else 'DIFFER'}")
            if not (err <= BOUNDS[name] and e_k <= max(2 * e_p, 1e-4)
                    and same):
                raise Failed(f"{what} {tag}: {err:.3e} / {e_k:.3e}, "
                             f"bit-identical={same}")
        if cells == (5, 7, 13) or lengths == (2.0, 2.0, 2.0):
            check_f64({
                "B": (lambda: fdm_patch(x64, f64[1], om),
                      lambda: fdm_patch_plain(x64, f64[1], om)),
                "B xold": (lambda: fdm_patch(x64, f64[1], om, b64),
                           lambda: fdm_patch_plain(x64, f64[1], om, b64)),
                "C": (lambda: smoother_step(x64, b64, *f64, om),
                      lambda: smoother_step_plain(x64, b64, *f64, om))}, tag)
        if wt in ("symm", "post") and lengths[2] != 50.0:
            # kernel A's ragged tiles and chunks
            for tabs, u, rhs, name in ((f32[0], x, b, "banded_laplace_f32"),
                                       (f64[0], x64, b64,
                                        "banded_laplace_f64")):
                for r in (None, rhs):
                    got = banded_laplace(u, tabs, r)
                    same = torch.equal(got, banded_laplace(u, tabs, r))
                    err = rel_err(got, banded_laplace_plain(u, tabs, r))
                    what = "residual" if r is not None else "vmult"
                    print(f"  A {name} {what:8s} {tag}: max rel err "
                          f"{err:.3e} (bound {BOUNDS[name]:g}); repeated "
                          f"runs {'bit-identical' if same else 'DIFFER'}")
                    if not (err <= BOUNDS[name] and same):
                        raise Failed(f"{name} {what} {tag}: {err:.3e}, "
                                     f"bit-identical={same}")
        del f32, f64
        torch.cuda.empty_cache()


def check_lanes(refinements, degrees_small, results):
    """Phase 3: kernel F (both precisions) vs its plain version on the
    balanced hyperball at each of ``refinements`` at Q4 and each of
    ``degrees_small`` on the second; timed in turns at Q4."""
    import numpy as np
    import torch

    from dealii_asm_tpu_torch.fem.general_dofs import GeneralDofHandler
    from dealii_asm_tpu_torch.kernels.lanes_laplace import (
        lanes_laplace, lanes_laplace_plain)
    from dealii_asm_tpu_torch.mesh.unstructured import hyper_ball_balanced
    from dealii_asm_tpu_torch.ops.laplace_general import \
        GeneralLaplaceOperator

    rng = np.random.default_rng(SEED + 2)
    dev = "cuda"
    meshes = [hyper_ball_balanced(3)]
    while len(meshes) <= max(refinements):
        meshes.append(meshes[-1].refine())
    small = refinements[min(1, len(refinements) - 1)]
    cases = [(r, 4) for r in refinements]
    cases += [(small, p) for p in degrees_small if (small, p) not in cases]
    for r, p in cases:
        mesh = meshes[r]
        dofs = GeneralDofHandler(mesh, p)
        n, c = dofs.n_dofs, mesh.n_cells_total
        reps = 20 if n > 1_000_000 else 100
        x64 = torch.as_tensor(rng.standard_normal(n), device=dev)
        b64 = torch.as_tensor(rng.standard_normal(n), device=dev)
        tag = f"{c} cells Q{p}, {n} DoFs"
        for dt, name in ((torch.float64, "lanes_laplace_f64"),
                         (torch.float32, "lanes_laplace_f32")):
            op = GeneralLaplaceOperator(dofs, dtype=dt, device=dev)
            x, b = x64.to(dt), b64.to(dt)
            for rhs in (None, b):
                got = lanes_laplace(x, op.tables, rhs)
                again = lanes_laplace(x, op.tables, rhs)
                ref = lanes_laplace_plain(x, op.tables, rhs)
                err = rel_err(got, ref)
                what = "residual" if rhs is not None else "vmult"
                same = torch.equal(got, again)
                print(f"  F {name} {what:8s} {tag}: max rel err {err:.3e} "
                      f"(bound {BOUNDS[name]:g}); repeated runs "
                      f"{'bit-identical' if same else 'DIFFER'}")
                if not err <= BOUNDS[name] or not same:
                    raise Failed(f"{name} {what} {tag}: {err:.3e}, "
                                 f"bit-identical={same}")
            if p == 4:
                abs_err = float((lanes_laplace(x, op.tables)
                                 - lanes_laplace_plain(x, op.tables))
                                .abs().max())
                k_ms, p_ms = in_turns(
                    lambda: lanes_laplace_plain(x, op.tables),
                    lambda: lanes_laplace(x, op.tables), reps)
                print_time(tag, n, k_ms, p_ms)
                work = lanes_work(c, n, p, x.element_size())
                results.setdefault(name, {})[tag] = (
                    abs_err, k_ms, p_ms, bound(*work, x.element_size()))
            del op
            torch.cuda.empty_cache()


def device_kernels(fn, tries: int = 3) -> list:
    """The names of the device kernels one call of ``fn`` launches, in
    order (torch.profiler).  A trace can lose kernels but never adds one
    (on the H100 the profiler has returned, after good traces, one with no
    kernel and one without the call's first kernel), so ``fn`` is traced
    ``tries`` times and the trace with the most kernels is taken; the
    counts of all are printed."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    traces = []
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        traces.append([e.name for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and "memset" not in e.name.lower()
                       and "memcpy" not in e.name.lower()])
    print(f"    kernels in {tries} traces: {[len(t) for t in traces]}")
    return max(traces, key=len)


def check_sweep(cells_list, results):
    """Phase 3: kernel D vs its plain version on Cartesian meshes (float32;
    float64 and the weightings none and pre too), its launches per sweep,
    its time at Q4 and Q2 (the fdm1 ladder's level degrees), and at the
    largest Q4 size its time beside the unfused loop and unrolled kernel-C
    steps."""
    import numpy as np
    import torch

    from dealii_asm_tpu_torch.fem.dofs import DofHandler
    from dealii_asm_tpu_torch.kernels.banded_laplace import banded_laplace
    from dealii_asm_tpu_torch.kernels.fdm_patch import fdm_patch
    from dealii_asm_tpu_torch.kernels.smoother_step import smoother_step
    from dealii_asm_tpu_torch.kernels.smoother_sweep import (
        smoother_sweep, smoother_sweep_plain)
    from dealii_asm_tpu_torch.mesh.grid import StructuredMesh
    from dealii_asm_tpu_torch.ops.laplace import LaplaceOperator
    from dealii_asm_tpu_torch.precond.asm import ASMPreconditioner
    from dealii_asm_tpu_torch.solvers.chebyshev import \
        chebyshev_sweep_coefficients

    rng = np.random.default_rng(SEED + 3)
    dev = "cuda"
    # the eigenvalue data of an FDM-preconditioned level (max estimate 1.2
    # times a Lanczos estimate of 1.6, smoothing range 20)
    mx = 1.92
    alpha = mx / 20.0
    theta, delta = (mx + alpha) / 2.0, (mx - alpha) / 2.0
    omega = 2.0 / (alpha + mx)
    rows = [(f"{kind}, degree {k}",
             chebyshev_sweep_coefficients(k, theta, delta, kind, lam_max=mx))
            for k in (2, 3, 4) for kind in ("1st kind", "4th kind")]
    rows.append(("relaxation, degree 3", [(0.0, omega)] * 3))
    name = "smoother_sweep"
    c16, cmax = cells_list[0], max(cells_list)
    # (cells, p, weighting, dtype, rows)
    cases = ([((c, c, c), 4, "symm", torch.float32, rows) for c in cells_list]
             + [((c, c, c), 2, "symm", torch.float32, rows)
                for c in sorted({c16, cmax})]
             + [((5, 7, 13), 4, "symm", torch.float32, rows)]
             + [((5, 7, 13), p, wt, torch.float32, rows)
                for wt in ("none", "pre") for p in (2, 4)]
             + [((c16,) * 3, 4, "symm", torch.float64,
                 [r for r in rows if "degree 4" not in r[0]])])
    for cells, p, wt, dt, case_rows in cases:
        dofs = DofHandler(StructuredMesh(3, cells), p)
        n = dofs.n_dofs
        c = cells[0] if len(set(cells)) == 1 else None
        reps = 10 if n > 1_000_000 else 50
        op = LaplaceOperator(dofs, dtype=dt, device=dev)
        asm = ASMPreconditioner(dofs, weighting_type=wt, dtype=dt, device=dev)
        a, f = op.tables, asm.tables
        x = torch.as_tensor(rng.standard_normal(n), dtype=dt, device=dev)
        b = torch.as_tensor(rng.standard_normal(n), dtype=dt, device=dev)
        nan_x = torch.full_like(x, float("nan"))
        shape = f"{c}^3" if c else "x".join(map(str, cells))
        bnd = BOUNDS[name] if dt == torch.float32 else BOUND_F64
        tag = (f"{shape} cells Q{p}{'' if wt == 'symm' else ' ' + wt}"
               f"{' float64' if dt == torch.float64 else ''}, {n} DoFs")
        for label, coefs in case_rows:
            for zero_x in (False, True):
                xin = nan_x if zero_x else x
                got = smoother_sweep(xin, b, a, f, coefs, zero_x)
                same = torch.equal(got, smoother_sweep(xin, b, a, f, coefs,
                                                       zero_x))
                err = rel_err(got, smoother_sweep_plain(xin, b, a, f, coefs,
                                                        zero_x))
                finite = bool(torch.isfinite(got).all())
                print(f"  D {label}{', zero guess' if zero_x else ''} {tag}: "
                      f"max rel err {err:.3e} (bound {bnd:g}); repeated runs "
                      f"{'bit-identical' if same else 'DIFFER'}"
                      + ("" if finite else "; NOT FINITE"))
                if not (err <= bnd and same and finite):
                    raise Failed(f"{name} {label} zero_x={zero_x} {tag}: "
                                 f"{err:.3e}, bit-identical={same}, "
                                 f"finite={finite}")
        if dt != torch.float32 or wt != "symm" or cells == (5, 7, 13):
            del op, asm
            continue
        coefs = rows[0][1]  # 1st kind, degree 2: the fdm1 ladder's sweep
        for zero_x in (False, True):
            xin = None if zero_x else x
            kern = lambda: smoother_sweep(xin, b, a, f, coefs, zero_x)
            plain = lambda: smoother_sweep_plain(xin, b, a, f, coefs, zero_x)
            k_ms, p_ms = in_turns(plain, kern, reps)
            form = "zero guess" if zero_x else "from x"
            print_time(f"D degree 2 {form} {tag}", n, k_ms, p_ms)
            work = bound(*sweep_work(int(np.prod(cells)), n, p, 2, zero_x),
                         4)
            print(f"    bound {work[0]:.4f} ms ({work[1]})")
            key = f"{shape} cells Q{p}, degree 2, {form}, {n} DoFs"
            results.setdefault(name, {})[key] = (
                float((kern() - plain()).abs().max()), k_ms, p_ms, work)
            # two launches per sub-step (A's residual, B's momentum step),
            # one for the zero guess's first sub-step
            names = device_kernels(kern)
            want = 2 * len(coefs) - (1 if zero_x else 0)
            print(f"    launches per sweep {tag} {form}: D {len(names)} "
                  f"({', '.join(nm.split('<')[0] for nm in names)})")
            if len(names) != want:
                raise Failed(f"{name} {form} {tag}: {len(names)} launches for "
                             f"{len(coefs)} sub-steps, want {want}")
        if c != cmax or p != 4:
            continue

        def unfused():
            """The unfused smoother loop on the card: kernels A and B with
            the torch vector operations between them."""
            xs, pm = x, None
            for s, (f1, f2) in enumerate(coefs):
                y = fdm_patch(banded_laplace(xs, a, rhs=b), f, f2)
                pm = y if s == 0 else f1 * pm + y
                xs = xs + pm
            return xs

        err = rel_err(unfused(), smoother_sweep(x, b, a, f, coefs))
        d_ms, u_ms = in_turns(unfused, lambda: smoother_sweep(x, b, a, f,
                                                              coefs), reps)
        print(f"    D degree 2 from x {tag}: D {d_ms:.4f} ms, unfused loop "
              f"(A, B, torch vector ops) {u_ms:.4f} ms, ratio "
              f"{u_ms / d_ms:.3f}; max rel difference {err:.3e}")
        relax = [(0.0, omega)] * 2
        steps = lambda: smoother_step(smoother_step(x, b, a, f, omega), b, a,
                                      f, omega)
        err = rel_err(steps(), smoother_sweep(x, b, a, f, relax))
        d_ms, c_ms = in_turns(steps, lambda: smoother_sweep(x, b, a, f, relax),
                              reps)
        print(f"    D relaxation degree 2 from x {tag}: D {d_ms:.4f} ms, two "
              f"unrolled kernel-C steps {c_ms:.4f} ms, ratio "
              f"{c_ms / d_ms:.3f}; max rel difference {err:.3e}")
        if not err <= bnd:
            raise Failed(f"{name} vs kernel C steps {tag}: {err:.3e}")
        del op, asm
        torch.cuda.empty_cache()


def run_solve(path: str, n_small: int | None, it_small: int | None,
              it_full: int | None, n_dofs: int, kernels, counts,
              slack: int = 0, check_vcycle: bool = False, record=None,
              absent=(), best_of: int | None = None,
              refinements: int | None = None, precon: dict | None = None,
              small_mesh: dict | None = None):
    """Phase 4 to 13: one config through run_config on the card, first (with
    ``n_small`` given) at ``n_small`` refinements against the plain CPU
    path, then at full size (the config's "n refinements", or
    ``refinements``) with the launch counts set to 0 just before and read
    just after.  Every kernel of ``kernels`` must be launched and none of
    ``absent``; ``counts`` takes the counts of ``record`` (default
    ``kernels``).  ``it_full`` None accepts any converged count; ``best_of``
    overrides the config's, ``precon`` updates its "preconditioner"
    section (a derived config) and ``small_mesh`` the small case's "mesh"
    section.

    The small case holds the CPU path to ``it_small`` (the JAX package's
    count), the card's solution to rel-l2 1e-6 of the CPU's, the first 20
    residuals of the card's CG history to rel 1e-4 of the CPU's (GMRES: its
    first restart cycle to 1e-6 of the initial residual, see
    ``check_small``), and the card's count to within ``slack`` of the
    CPU's.  The Kershaw case allows
    one iteration: its last residual lies within 10% of the stopping
    threshold, and float32 rounding of the level operators alone (kernel E
    or its plain version) moves it by more (``python -m
    dealii_asm_tpu_torch.probe sensitivity``); so may the ball's.  With
    ``check_vcycle`` two applies of the solve's preconditioner to the same
    vector must agree bitwise."""
    import torch

    from dealii_asm_tpu_torch.kernels import launch_counts, reset_launch_counts
    from dealii_asm_tpu_torch.models.poisson import run_config

    with open(path) as f:
        params = json.load(f)
    if best_of is not None:
        params["solver"]["best of"] = best_of
    if refinements is not None:
        params["n refinements"] = refinements
    name = os.path.basename(path)
    if precon:
        params["preconditioner"].update(precon)
        name += f" derived with {json.dumps(precon)}"
    if n_small is not None:
        check_small(params, name, n_small, it_small, slack, small_mesh)

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    res = run_config(params, log=print, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = launch_counts()
    counts.update({k: got[k] for k in (kernels if record is None
                                       else record)})
    x = res["solution"]
    finite = bool(torch.isfinite(x).all())
    print(f"  {name}: {res['n_dofs']} DoFs, converged={res['converged']}, "
          f"it={res['it']}, setup {res['setup_time']:.3f} s, best-of-"
          f"{params['solver'].get('best of', 1)} solve {res['time']:.4f} s, "
          f"run_config wall {wall:.3f} s, "
          f"peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    thr = (float(params["solver"].get("rel tolerance", 1e-2))
           * res["residuals"][0])
    print(f"  last residuals / threshold: "
          f"{[round(r / thr, 4) for r in res['residuals'][-2:]]}")
    print(f"  launch counts on this path: {json.dumps(got)}")
    if x.shape != (n_dofs,) or x.dtype != torch.float64 or not finite:
        raise Failed(f"{name} solution: shape {tuple(x.shape)}, {x.dtype}, "
                     f"finite={finite}")
    if not res["converged"] or it_full not in (None, res["it"]):
        raise Failed(f"{name}: converged={res['converged']}, it={res['it']}, "
                     f"expected {it_full}")
    missing = [k for k in kernels if got[k] <= 0]
    if missing:
        raise Failed(f"kernels not launched on the {name} path: {missing}")
    launched = [k for k in absent if got[k] != 0]
    if launched:
        raise Failed(f"kernels launched on the {name} path: {launched}")
    if check_vcycle:
        # the V-cycle sums in a fixed order everywhere: two applies agree
        # bitwise
        b = torch.sin(torch.arange(n_dofs, dtype=torch.float64,
                                   device="cuda"))
        pre = res["preconditioner"]
        same = torch.equal(pre.vmult(b), pre.vmult(b))
        print(f"  two V-cycle applies {'bit-identical' if same else 'DIFFER'}")
        if not same:
            raise Failed(f"{name}: repeated V-cycle applies differ")
    return res


def check_small(params: dict, name: str, n_small: int, it_small: int,
                slack: int, small_mesh: dict | None = None) -> None:
    """The config at ``n_small`` refinements (its "mesh" section updated by
    ``small_mesh``) on the card against the plain CPU path (see
    ``run_solve``)."""
    from dealii_asm_tpu_torch.models.poisson import run_config

    small = copy.deepcopy(params)
    small["n refinements"] = n_small
    if small_mesh:
        small["mesh"].update(small_mesh)
    small["print timing"] = False
    small["solver"]["best of"] = 1
    quiet = lambda *a: None
    r_gpu = run_config(copy.deepcopy(small), log=quiet, device="cuda")
    r_cpu = run_config(copy.deepcopy(small), log=quiet, device="cpu")
    xg = r_gpu["solution"].cpu()
    xc = r_cpu["solution"]
    rel = float((xg - xc).norm() / xc.norm())
    n_hist, h_bound = 21, 1e-4
    gmres = small["solver"].get("type") == "GMRES"
    if gmres:
        # GMRES's estimates |g_k+1| come from rotations of Hessenberg
        # entries that carry the V-cycle's float32 rounding at the scale of
        # the initial residual: they are compared to it (1e-6), not to
        # themselves.  A restart starts from the true residual b - A x,
        # whose x carries that rounding times A: only the first cycle is
        # compared
        n_hist = min(n_hist, int(small["solver"].get("max n tmp vectors",
                                                     30)) - 1)
        h_bound = 1e-6
    hg, hc = r_gpu["residuals"][:n_hist], r_cpu["residuals"][:n_hist]
    hist = max(abs(a - b) / (hc[0] if gmres else b) for a, b in zip(hg, hc))
    thr = float(small["solver"].get("rel tolerance", 1e-2)) * hc[0]
    last = lambda h: [round(r / thr, 4) for r in h[-2:]]
    print(f"  {name} at {n_small} refinements ({r_gpu['n_dofs']} DoFs): card "
          f"{r_gpu['it']} its, cpu {r_cpu['it']} its (expected {it_small}), "
          f"rel l2 solution difference {rel:.3e} (bound 1e-6), first "
          f"{len(hc) - 1} residuals agree to {hist:.2e} (bound {h_bound:g}"
          f"{' of the initial residual' if gmres else ''}); last "
          f"residuals / threshold: card {last(r_gpu['residuals'])}, cpu "
          f"{last(r_cpu['residuals'])}")
    if not (r_cpu["converged"] and r_cpu["it"] == it_small
            and r_gpu["converged"] and rel <= 1e-6 and hist <= h_bound
            and abs(r_gpu["it"] - r_cpu["it"]) <= slack):
        raise Failed(f"{name} at {n_small} refinements disagrees with the "
                     "CPU path")


def run_ladder(counts) -> None:
    """Phases 7 and 8: the large-scaling ladder's fdm1 rungs with kernel D
    behind its gate, set here and restored after."""
    saved = os.environ.get(CHAIN_GATE)
    try:
        os.environ[CHAIN_GATE] = "2"
        print(f"== ladder fdm1 r=6 on the card, {CHAIN_GATE}=2")
        run_solve(LADDER_R6, 2, 9, 65, 16_974_593,
                  LADDER_KERNELS + ("banded_laplace_f32",
                                    "banded_laplace_f64"), counts,
                  record=LADDER_KERNELS, best_of=3)
        del os.environ[CHAIN_GATE]
        print(f"== ladder fdm1 r=6 on the card, {CHAIN_GATE} unset")
        run_solve(LADDER_R6, None, None, 65, 16_974_593,
                  ("banded_laplace_f32", "fdm_patch"), counts, record=(),
                  absent=LADDER_KERNELS, best_of=1)
        os.environ[CHAIN_GATE] = "2"
        print(f"== ladder fdm1 r=7 (CoarseCG) on the card, {CHAIN_GATE}=2")
        run_solve(LADDER_R7, None, None, None, 135_005_697,
                  LADDER_KERNELS + ("banded_laplace_f32",
                                    "banded_laplace_f64"), counts,
                  record=(), best_of=1)
    finally:
        if saved is None:
            os.environ.pop(CHAIN_GATE, None)
        else:
            os.environ[CHAIN_GATE] = saved


def plain_fdm_times() -> None:
    """The plain global FDM apply (overlap 2, RAS and symm) per call at
    64^3 cells Q3 in float32, beside kernel B's overlap-1 apply, CUDA events
    in turns; the kernel-B calls here are outside every solve's count."""
    import torch

    from dealii_asm_tpu_torch.fem.dofs import DofHandler
    from dealii_asm_tpu_torch.mesh.grid import StructuredMesh
    from dealii_asm_tpu_torch.precond.asm import ASMPreconditioner

    dofs = DofHandler(StructuredMesh(3, (64, 64, 64)), 3)
    x = torch.randn(dofs.n_dofs, generator=torch.Generator().manual_seed(SEED)
                    ).to(device="cuda", dtype=torch.float32)
    asms = {(o, wt): ASMPreconditioner(dofs, n_overlap=o, weighting_type=wt,
                                       dtype=torch.float32, device="cuda")
            for o, wt in ((1, "post"), (2, "ras"), (2, "symm"))}
    b_ms, ras_ms = in_turns(lambda: asms[2, "ras"].vmult(x),
                            lambda: asms[1, "post"].vmult(x), 20)
    symm_ms = cuda_time(lambda: asms[2, "symm"].vmult(x), 20)
    print(f"  FDM apply at 64^3 cells Q3 float32 ({dofs.n_dofs} DoFs): "
          f"plain overlap 2 RAS {ras_ms:.4f} ms, plain overlap 2 symm "
          f"{symm_ms:.4f} ms, kernel B overlap 1 post {b_ms:.4f} ms")
    del asms
    torch.cuda.empty_cache()


def run_new_paths(counts, phases) -> None:
    """Phases 9 to 16 (those named in ``phases``): GMRES, overlap 2 and
    RAS, the inverse diagonal on the ball, and vertex patches, through
    run_config."""
    absent_fused = ("fdm_patch", "smoother_step") + LADDER_KERNELS
    a_both = ("banded_laplace_f32", "banded_laplace_f64")
    if 9 in phases:
        print("== phase 9: GMRES, FDM overlap 1 post (input_0210) on the card")
        run_solve(GMRES_POST, 3, 5, None, 7_189_057, FLAGSHIP_KERNELS,
                  counts, record=(), absent=LADDER_KERNELS, best_of=3,
                  refinements=6)
    if 10 in phases:
        print("== phase 10: GMRES, FDM overlap 2 RAS (input_0300) on the card")
        plain_fdm_times()
        run_solve(GMRES_RAS, 3, 8, None, 7_189_057, a_both, counts,
                  record=(), absent=absent_fused, best_of=3, refinements=6)
    if 11 in phases:
        print("== phase 11: ladder fdm2 r=6 (input_0026) on the card")
        run_solve(LADDER_FDM2, 3, 10, None, 16_974_593, a_both, counts,
                  record=(), absent=absent_fused, best_of=3)
    if 12 in phases:
        print("== phase 12: hyperball Q2, GMRES around element FDM "
              "(sweep_ball input_0060) on the card")
        run_solve(BALL_GMRES, 1, 5, None, 1_061_121, BALL_KERNELS, counts,
                  record=(), best_of=3, refinements=4)
        print("== phase 12: hyperball Q2, CG around Chebyshev-1 and Diagonal "
              "(sweep_ball input_0000) on the card")
        run_solve(BALL_DIAG, 1, 5, None, 1_061_121, BALL_KERNELS, counts,
                  record=(), best_of=3, refinements=4)
    if 13 in phases:
        print("== phase 13: default.json (Kershaw, GMRES) on the card")
        run_solve(DEFAULT, 0, 101, None, 912_673, KERSHAW_KERNELS, counts,
                  slack=1, record=(), best_of=3)
    run_vertex_paths(counts, phases)
    run_input_paths(counts, phases)


def patch_apply_cases(phase: int) -> tuple:
    """(dofs, shape, cases, beside) of the FDM applies that
    ``check_patch_applies`` holds and times for a phase: cases are
    (label, make(dtype, device)), beside the (label, make) of the apply
    printed beside them."""
    from dealii_asm_tpu_torch.fem.dofs import DofHandler
    from dealii_asm_tpu_torch.mesh.grid import StructuredMesh
    from dealii_asm_tpu_torch.models.poisson import make_mesh_family
    from dealii_asm_tpu_torch.precond.asm import (ASMPreconditioner,
                                                  CellASMPreconditioner)
    from dealii_asm_tpu_torch.precond.asm_general import \
        GeneralASMPreconditioner

    if phase == 16:
        dofs = DofHandler(StructuredMesh(3, (64, 64, 64)), 4)
        cls, shape = ASMPreconditioner, "64^3 cells Q4"
        beside = ("kernel B, element overlap 1 symm", dict())
        cases = [("Cartesian vertex symm", dict(patch_type="vertex"))]
    else:
        with open(KERSHAW_FDMV if phase == 14 else BALL_FDMV) as f:
            family = make_mesh_family(json.load(f))
        dofs = family.dofs_at(3, 4)
        if phase == 14:
            cls, shape = CellASMPreconditioner, "Kershaw 48^3 cells Q4"
            cases = [("Kershaw vertex symm", dict(patch_type="vertex")),
                     ("Kershaw element overlap 2 RAS",
                      dict(n_overlap=2, weighting_type="ras"))]
        else:
            cls, shape = GeneralASMPreconditioner, "ball 16384 cells Q4"
            cases = [("ball vertex symm", dict(patch_type="vertex"))]
        beside = ("per-cell element overlap 1 symm", dict())

    def maker(kw):
        kw = {"weighting_type": "symm", **kw}
        return lambda dtype, device: cls(dofs, dtype=dtype, device=device,
                                         **kw)

    return dofs, shape, [(label, maker(kw)) for label, kw in cases], (
        beside[0], maker(beside[1]))


def check_patch_applies(phase: int) -> None:
    """The phase's vertex (and per-patch overlap-2 RAS) FDM apply at its
    solve's finest shape: float64 on the card within 1e-12 of the CPU's
    float64 apply, float32 on the card within 1e-5 of it, each repeated
    apply bit-identical; CUDA-event ms of both precisions, beside the
    element overlap-1 apply on the same mesh (kernel B on the Cartesian
    mesh, outside every solve's launch count)."""
    import torch

    dofs, shape, cases, (b_label, b_make) = patch_apply_cases(phase)
    n = dofs.n_dofs
    x64 = torch.randn(n, generator=torch.Generator().manual_seed(SEED),
                      dtype=torch.float64)
    xg = {torch.float64: x64.cuda(), torch.float32: x64.float().cuda()}
    b32 = b_make(torch.float32, "cuda")
    b_ms = cuda_time(lambda: b32.vmult(xg[torch.float32]), 20)
    del b32
    for label, make in cases:
        ref = make(torch.float64, "cpu").vmult(x64)
        line = []
        for dt, bnd in ((torch.float64, BOUND_F64), (torch.float32, 1e-5)):
            asm = make(dt, "cuda")
            y = asm.vmult(xg[dt])
            same = torch.equal(y, asm.vmult(xg[dt]))
            err = rel_err(y.cpu(), ref)
            ms = cuda_time(lambda: asm.vmult(xg[dt]), 20)
            m = asm.m
            line.append(f"{str(dt)[6:]} {ms:.4f} ms, max rel err {err:.3e} "
                        f"(bound {bnd:g}), repeat "
                        f"{'bit-identical' if same else 'DIFFERS'}")
            if not (err <= bnd and same):
                raise Failed(f"{label} apply {dt}: {err:.3e}, "
                             f"bit-identical={same}")
            del asm, y
            torch.cuda.empty_cache()
        print(f"  {label} FDM apply at {shape} ({n} DoFs, windows of {m}^3) "
              f"against the CPU float64 apply: {'; '.join(line)}; beside: "
              f"{b_label} float32 {b_ms:.4f} ms")


def run_vertex_paths(counts, phases) -> None:
    """Phases 14 to 16 (those named in ``phases``): vertex-star patches
    through run_config on Kershaw, the ball and the Cartesian ladder mesh,
    each after its FDM applies' check; B, C and D are not launched."""
    import torch

    from dealii_asm_tpu_torch.models.poisson import run_config

    absent_fused = ("fdm_patch", "smoother_step") + LADDER_KERNELS
    a_both = ("banded_laplace_f32", "banded_laplace_f64")
    if 14 in phases:
        print("== phase 14: e2e_kershaw_fdmv (Kershaw, vertex FDM) on the card")
        check_patch_applies(14)
        res = run_solve(KERSHAW_FDMV, 1, 44, None, 7_189_057,
                        KERSHAW_KERNELS, counts, slack=1, record=(),
                        absent=absent_fused, best_of=3)
        print(f"  count {res['it']} beside the reference's 49 at this size "
              "(deal.II; the JAX package takes 49 at 912,673 DoFs and never "
              "ran this size)")
        del res
    if 15 in phases:
        print("== phase 15: e2e_ball_fdmv (ball, vertex FDM) on the card")
        check_patch_applies(15)
        run_solve(BALL_FDMV, 1, 6, None, 1_061_121, BALL_KERNELS, counts,
                  record=(), absent=absent_fused, best_of=3,
                  check_vcycle=True)
    if 16 in phases:
        print("== phase 16: ladder fdmv (Cartesian vertex FDM) on the card; "
              "derived config: input_0027.json with \"mg type\": \"ph\" (the "
              "hp original raises in both packages)")
        with open(LADDER_FDMV_R0) as f:
            params = json.load(f)
        try:
            run_config(params, log=lambda *a: None, device="cuda")
        except ValueError as e:
            print(f"  input_0003.json as written (hp, r=0) raises "
                  f"{type(e).__name__}: {e}")
        else:
            raise Failed("input_0003.json (hp fdmv, r=0) did not raise")
        torch.cuda.empty_cache()
        check_patch_applies(16)
        run_solve(LADDER_FDMV, 3, 11, None, 16_974_593, a_both, counts,
                  record=(), absent=absent_fused, best_of=1,
                  precon={"mg type": "ph"})


def coarse_solver_time() -> None:
    """Phase 18: the dense coarse solve of mp_02 (Kershaw-mp 36^3 cells Q1,
    50,653 DoFs, float32 inverse) built on the card: seconds (host clock
    around synchronize) and peak device memory of the assembly, the
    Cholesky factor and the blocked inverse."""
    import torch

    from dealii_asm_tpu_torch.models.poisson import make_mesh_family
    from dealii_asm_tpu_torch.precond.multigrid import DirectCoarseSolver

    with open(os.path.join(INPUTS, "mp_02.json")) as f:
        family = make_mesh_family(json.load(f))
    dofs = family.dofs_at(family.n_refinements, 1)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    solver = DirectCoarseSolver(dofs, dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    b = torch.ones(dofs.n_dofs, dtype=torch.float32, device="cuda")
    ms = cuda_time(lambda: solver.vmult(b), 5)
    print(f"  dense coarse solve, {dofs.n_dofs} DoFs: built in {secs:.3f} s, "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB, apply {ms:.4f} ms (float32 inverse "
          f"{solver.Ainv.numel() * 4 / 2**30:.2f} GiB)")
    del solver
    torch.cuda.empty_cache()


def check_compact_apply() -> None:
    """Phase 19: the linear-geometry outer operator of mp_04 at 1 refinement
    (18^3 Kershaw-mp cells Q7, plain torch) against kernel E float64 with
    the same degree-1 mapping on the card (the same operator: rel 1e-12),
    repeats bit-identical, with CUDA-event ms of both."""
    import torch

    from dealii_asm_tpu_torch.models.poisson import make_mesh_family
    from dealii_asm_tpu_torch.ops.laplace import LaplaceOperator

    with open(os.path.join(INPUTS, "mp_04.json")) as f:
        family = make_mesh_family(json.load(f))
    dofs = family.dofs_at(1, 7)
    x = torch.randn(dofs.n_dofs, generator=torch.Generator().manual_seed(SEED),
                    dtype=torch.float64).cuda()
    compact = LaplaceOperator(dofs, device="cuda", mapping_degree=1,
                              mapping_type="linear geometry")
    merged = LaplaceOperator(dofs, device="cuda", mapping_degree=1)
    y = compact.vmult(x)
    same = torch.equal(y, compact.vmult(x))
    err = rel_err(y, merged.vmult(x))
    c_ms, e_ms = in_turns(lambda: merged.vmult(x), lambda: compact.vmult(x),
                          5)
    print(f"  linear-geometry outer apply at 18^3 cells Q7 ({dofs.n_dofs} "
          f"DoFs, float64): {c_ms:.4f} ms against kernel E's {e_ms:.4f} ms; "
          f"max rel difference {err:.3e} (bound {BOUND_F64:g}); repeat "
          f"{'bit-identical' if same else 'DIFFERS'}")
    if not (err <= BOUND_F64 and same):
        raise Failed(f"linear-geometry apply: {err:.3e}, bit-identical={same}")
    del compact, merged
    torch.cuda.empty_cache()


def run_input_paths(counts, phases) -> None:
    """Phases 17 to 20 (those named in ``phases``): the named study inputs
    of ``inputs/`` through run_config on the card, each after its small
    check (the CPU path at the JAX package's count, the card at the CPU
    path's).  17: jw_01..03 at their own sizes (symmetric hypercube,
    gaussian-jw rhs with its Dirichlet lift, ph-multigrid, Chebyshev-2
    around FDM overlap 1): A and B launched, after kernels A, B and C are
    held to their plain versions at jw_03's shape (16^3 cells Q7, h =
    0.125; C serves degree-1 steps only, so these Chebyshev-2 levels step
    through A then B).  18: mp_02 at its own size (Kershaw-mp 36^3 cells Q7,
    16,194,277 DoFs, GMRES, p-multigrid around per-cell overlap-2 RAS, the
    dense coarse solve at 50,653 DoFs on the card): E launched, B, C and D
    not.  19: mp_00, 01, 03, 04 and 05 at 1 refinement (2,048,383 DoFs;
    mp_04 and 05 with the linear-geometry outer operator, plain torch): E
    launched, B, C and D not; all six mp configs held at 2 subdivisions.
    20: inputs/dummy.json (2D Q3, CG around Diagonal; plain torch): no
    kernel launched."""
    absent_fused = ("fdm_patch", "smoother_step") + LADDER_KERNELS
    # Chebyshev-2 steps through A then B (C serves degree-1 steps)
    a_b = ("banded_laplace_f32", "banded_laplace_f64", "fdm_patch")
    if 17 in phases:
        print("== phase 17: inputs/jw_01..03 (symmetric hypercube, "
              "gaussian-jw) on the card")
        results = {}
        check_tiles((), results,
                    cases=[((16, 16, 16), (2.0, 2.0, 2.0), 7, "symm")])
        for name, (n_dofs, r_small, it_small) in JW.items():
            run_solve(os.path.join(INPUTS, f"{name}.json"), r_small, it_small,
                      None, n_dofs, a_b, counts, record=(),
                      absent=LADDER_KERNELS, best_of=3)
    mp_small = {"n subdivisions": 2}
    if 18 in phases:
        print("== phase 18: inputs/mp_02 (Kershaw-mp Q7, GMRES, per-cell "
              "overlap-2 RAS, dense coarse solve) at its own size on the card")
        coarse_solver_time()
        res = run_solve(os.path.join(INPUTS, "mp_02.json"), 0,
                        MP_SMALL["mp_02"], None, 16_194_277, KERSHAW_KERNELS,
                        counts, record=(), absent=absent_fused, best_of=1,
                        small_mesh=mp_small)
        del res
    if 19 in phases:
        print("== phase 19: inputs/mp_00, 01, 03, 04, 05 at 1 refinement on "
              "the card")
        check_compact_apply()
        with open(os.path.join(INPUTS, "mp_02.json")) as f:
            check_small(json.load(f), "mp_02.json", 0, MP_SMALL["mp_02"], 0,
                        mp_small)
        for name in ("mp_00", "mp_01", "mp_03", "mp_04", "mp_05"):
            kernels = (("merged_laplace_f32",) if name in MP_COMPACT
                       else KERSHAW_KERNELS)
            run_solve(os.path.join(INPUTS, f"{name}.json"), 0, MP_SMALL[name],
                      None, 2_048_383, kernels, counts, record=(),
                      absent=absent_fused, best_of=1, refinements=1,
                      small_mesh=mp_small)
    if 20 in phases:
        print("== phase 20: inputs/dummy.json (2D Q3, CG around Diagonal) on "
              "the card")
        run_solve(os.path.join(INPUTS, "dummy.json"), 3, 24, 24, 625, (),
                  counts, record=(), absent=tuple(KERNELS), best_of=3)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="build and check the kernels at 2^3 cells only")
    ap.add_argument("--ptxas", action="store_true",
                    help="print registers and shared memory per kernel")
    ap.add_argument("--only", default=None,
                    help="comma-separated solve phases (9-20) to run after "
                         "the build, and nothing else; prints no result")
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(HERE, "dealii_asm_tpu_torch")):
        print("chip_smoke: the dealii_asm_tpu_torch package is not beside "
              "this script", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs a GPU", file=sys.stderr)
        return 2
    from dealii_asm_tpu_torch.device import apply_precision_policy
    from dealii_asm_tpu_torch.kernels import build

    apply_precision_policy()
    print("== toolchain")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    print(f"python {sys.version.split()[0]}")
    try:
        nvcc = build.find_nvcc()
        for line in sh([nvcc, "--version"]).splitlines():
            if "release" in line or line.startswith("Build"):
                print(f"nvcc: {line}")
    except RuntimeError as e:
        print(f"FAIL: {e}")
        return 1
    try:
        import triton  # noqa: F401

        print(f"triton {triton.__version__} imports")
    except ImportError as e:
        print(f"triton does not import ({e})")
    smi = sh(["nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader"])
    print(f"gpu: {smi}")

    results, counts, level_rows = {}, {}, []
    try:
        print("== build")
        t0 = time.perf_counter()
        build.load(verbose=args.ptxas)
        print(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s "
              f"(nvcc {build.last_build_seconds or 0.0:.1f} s)")
        check_plans()
        if args.ptxas:
            sass_table_operands()
        if args.only:
            run_new_paths(counts, {int(t) for t in args.only.split(",")})
            print(f"phases {args.only} passed (the full check prints the "
                  "result line)")
            return 0
        print("== kernels vs plain PyTorch on the card")
        check_kernels([2] if args.quick else [2, 16, 64], [2, 4], results)
        check_merged([2] if args.quick else [2, 12, 48], range(1, 8),
                     () if args.quick else (2, 1), results, level_rows)
        check_tiles(range(1, 8), results)
        check_lanes([0] if args.quick else [0, 2, 4], range(1, 8), results)
        check_sweep([2] if args.quick else [16, 64], results)
        if not args.quick:
            print("== flagship solve on the card")
            run_solve(FLAGSHIP, 2, 4, 5, 16_974_593, FLAGSHIP_KERNELS, counts)
            print("== Kershaw solve on the card")
            run_solve(KERSHAW, 1, 38, 55, 7_189_057, KERSHAW_KERNELS, counts,
                      slack=1)
            print("== hyperball solve on the card")
            run_solve(BALL, 1, 6, 7, 8_438_273, BALL_KERNELS, counts, slack=1,
                      check_vcycle=True)
            run_ladder(counts)
            run_new_paths(counts, range(9, 21))
    except Failed as e:
        print(f"FAIL: {e}")
        return 1
    if args.quick:
        print("quick check passed (the full check prints the result line)")
        return 0

    table = []
    for name, (src, repl) in KERNELS.items():
        # each kernel at the largest shape its solve gives it
        tag = [k for k in results[name] if k.startswith(MAIN_SHAPE[name])][0]
        abs_err, k_ms, p_ms, (b_ms, b_by) = results[name][tag]
        # no single PyTorch call computes any of these functions on these
        # inputs (node-type dependent banded factors, per-cell patch
        # solves, per-quadrature-point coefficients; a sparse product would
        # need the assembled matrix, another input): library_ms is null
        table.append({"name": name, "route": "cuda", "source": src,
                      "replaces": repl, "launches": counts[name],
                      "max_abs_err": abs_err, "ms": k_ms, "plain_ms": p_ms,
                      "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                      "shape": tag})
    for row in level_rows:
        print(row)
    print(smi)
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
