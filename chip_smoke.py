#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dealii_asm_tpu_torch) on one GPU.

    python3 chip_smoke.py            # the whole check, one GPU
    python3 chip_smoke.py --quick    # build + kernel checks at 2^3 cells only
    python3 chip_smoke.py --only 9,13   # build + the named solve phases only
    python3 chip_smoke.py --only 14,15,16   # build + the vertex-patch phases
    python3 chip_smoke.py --only 17,18,19,20   # build + the named inputs
    python3 chip_smoke.py --only 21   # build + the matrix-free-loop driver
    python3 chip_smoke.py --only 22   # build + the solver breadth phase
    python3 chip_smoke.py --only 23   # build + multi-device, drivers, output
    python3 chip_smoke.py --only 24   # build + the sharded ball
    python3 chip_smoke.py --only 25   # build + kernel G's checks and times

Phases, each of which must pass (the script exits non-zero otherwise):
1. toolchain: torch and its CUDA, nvcc, triton, the card's name and power
   limit;
2. build the kernels from dealii_asm_tpu_torch/kernels/csrc with nvcc, and
   print the launch plan of every instantiation of kernel A, of the tiled
   kernels B, C and G (tile, threads, shared bytes) and of the
   line-per-thread cell body of E and F (cells a warp and a block, threads,
   shared and parameter bytes), held equal to kernels/banded_laplace.py::
   launch_plan, kernels/fdm_patch.py::launch_plan, kernels/cell_fdm_patch.py
   ::launch_plan and kernels/merged_laplace.py::cell_plan; with --ptxas also registers and spills, and the count of E's
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
   - G (float32 and float64) on Kershaw meshes (eps 0.3) against
     CellASMPreconditioner's plain apply: at p = 1..7 on 5 x 7 x 13 and
     1 x 9 x 6 cells (ragged tiles, a 1-cell axis) under the weightings
     none, pre, post and symm, at 2^3, 12^3 and 48^3 cells Q4 and at 48^3
     cells Q2 and Q1 (the Kershaw levels), repeated runs bit-identical;
     timed at the three Kershaw levels in both precisions in turns against
     the plain chain, and replayed in a CUDA graph, beside its bound
     (fembench/roofline.py::patch_fdm_work); also alone as phase 25;
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
   24 iterations, no kernel launched;
21. the matrix-free-loop benchmark driver (models/benchmark.py) on
   periodic balanced hyper-cubes: experiments/matrix_free_loop.json and
   every label family at s = 6, Q3 (operator, add/none/pre/post/symm/RAS
   around element overlap 1 and 2 and vertex patches, every storage
   letter, Chebyshev around the diagonal and around FDM) on the card
   against the plain CPU path (the >> lines equal apart from the seconds;
   one apply of each label within rel L2 1e-5, Chebyshev 1e-4); then
   sweep_mfl_degree/input_0002.json and sweep_mfl_cheby/input_0002.json
   at their own size (128 x 128 x 64 cells Q4, 67,108,864 DoFs): each
   label's ms per call and per apply, setup seconds, one apply finite,
   peak device memory, beside kernels A float32 and B at 64^3 cells Q4 per
   DoF, timed before, between and after the two configs; kernels A to F
   launched 0 times over the phase (kernels refuse periodic meshes, as the
   JAX kernels do);
22. the solver breadth: (a) the flagship under FCG, FGMRES, BiCGStab, IDR
   and Richardson and with "mixed precision solve": true (the plain CG, as
   the JAX run_config reads JSON true), each with A, B and C launched and
   after its small check at 2 refinements, then mixed-precision
   refinement (solvers/refinement.py) on the flagship's operators and
   multigrid; (b) the flagship with bfloat16 levels (A float64 only; any
   converged count, non-convergence reported); (c) the solver anatomy and
   transfer bench of models/solver_bench.py at 64^3 cells Q4 (A float32
   launched); (d) 2D Kershaw (Q3, 7 refinements) and the 2D ball (Q2,
   Diagonal, 8 refinements), no kernel launched; (e) the matrix-based
   AdditiveSchwarz (overlap 1 and 2), SubMesh and CG preconditioners at
   12^3 cells Q4 through run_config and the DomainPreconditioner at 8^3,
   each count equal to the CPU path's at the same size;
23. multi-device on structured meshes and the last drivers: (a) the
   flagship through the sharded path (``parallel/driver.py``) at world size
   1 under NCCL (a one-rank process group of this process; NCCL refuses two
   ranks on one card): at 2 refinements with its 17^3 level sharded against
   the plain CPU path on one device (4 iterations, rel l2 1e-6), then at
   full size with levels 4-6 sharded: 5 iterations, the solution within
   1e-5 of the single-device solve, which runs first with its warm-up
   traced ("print timing": the tracer of utils/profiling.py) and its
   level x stage table printed; its collectives, the replicated tail's
   launches (E, F and D none), and the top sharded level's plain applies
   beside kernels A and B at the same size; (b) the dryrun
   (``parallel/dryrun.py``) on one spawned NCCL rank; (c) the variant
   studies (composition: graph and eager chains; access: global, gather,
   lanes and cuda, kernel C's step held to the global step within
   C's bound 1e-4, the gather step within B's 1e-4)
   at 64^3 cells Q4 and the power kernel on the periodic box of 64^3 cells
   Q4 (16,777,216 DoFs), every ``>>`` line printed; the mesh gallery into a
   temporary directory; "do output" at 2 refinements;
24. the ball (experiments/e2e_ball_q4.json) through the sharded
   unstructured path (``parallel/general_sharded.py``) at world size 1
   under NCCL, its fine level sharded with kernel F per shard: at 1
   refinement against the plain CPU path on one device (6 iterations, rel
   l2 1e-6), then at full size (8,438,273 DoFs): 7 iterations, the solution
   within 1e-5 of phase 6's single-device solve, two V-cycle applies
   bit-identical, A-E launched 0 times, F float32 and float64 each launched
   once by one sharded fine-level apply and one outer apply; its setup,
   solve, peak memory, B and Gmax, collectives per V-cycle, and the sharded
   fine level's vmult and FDM apply beside the single-device F and
   GeneralASMPreconditioner at the same size.
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
phases 10, 11, 14 to 16 and 18 to 20; G on every Kershaw level of phases 5
and 13, 0 times on the flagship and in phases 14, 18 and 19 (vertex and
overlap-2 RAS patches).  Each FDM apply of phases 14 to 16
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
import contextlib
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
MFL = os.path.join(HERE, "experiments", "matrix_free_loop.json")
MFL_FULL = [os.path.join(HERE, "experiments", d, "input_0002.json")
            for d in ("sweep_mfl_degree", "sweep_mfl_cheby")]
MFL_FULL_DOFS = 67_108_864
# every label family of the matrix-free loop at s = 6, Q3 (2^3 periodic
# cells, 216 DoFs): the operator, the weightings around element overlap 1
# and 2 and vertex patches under every storage letter, RAS, Chebyshev
# around the diagonal and around FDM
MFL_FAMILIES = {
    "dim": 3, "n subdivision": 6, "fe degree": 3, "n repetitions": 10,
    "use cartesian mesh": True, "number type": "float32",
    "preconditioner types":
        "vmult add-1-c none-1-g-s-n pre-1-l post-1-dg symm-1-g-p-c ras-1-c "
        "pre-2-l post-2-dg symm-2-g-p-n ras-2-c none-v-c pre-v-c post-v-l "
        "symm-v-c ras-v-c cheby-3-0-diag cheby-3-2-symm-1-c "
        "cheby-2-0-symm-2-g-p-n cheby-3-2-symm-v-c cheby-2-0-post-1-c"}
# card against the CPU path, one apply of each label (relative L2): float32
# rounding of the same plain torch products in another order; Chebyshev
# labels carry the eigenvalue estimate's rounding through the polynomial
MFL_TOL, MFL_TOL_CHEBY = 1e-5, 1e-4
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
# phase 22: the JAX package's CPU counts of the flagship at 2 refinements
# (4,913 DoFs) under each new solver and with bfloat16 levels (its
# run_config on the config with "solver"/"type" or "mg number type" set)
BREADTH_SMALL = {"FCG": 4, "FGMRES": 4, "Bicgstab": 2, "IDR": 5,
                 "Richardson": 6}
BF16_SMALL = 5
# 2D Kershaw (6^2 base cells: 3 subdivisions, 1 initial refinement) and the
# 2D ball (12 cells) at the refinement the phase runs; the host setup grows
# about 4x a refinement (see PERF.md), which sets the largest that stays
# within a minute
KERSHAW_2D_R, BALL_2D_R = 7, 8
_2D_SOLVE = {"type": "CG", "rel tolerance": 1e-5}
KERSHAW_2D = {
    "dim": 2, "degree": 3, "mesh": {"name": "kershaw", "eps": 0.3},
    "solver": dict(_2D_SOLVE), "preconditioner": {
        "type": "Multigrid", "mg type": "h",
        "mg smoother": {"type": "Chebyshev", "degree": 2,
                        "preconditioner": {"type": "FDM"}},
        "mg coarse grid solver": {"type": "AMG"}}}
BALL_2D = {"dim": 2, "degree": 2, "mesh": {"name": "hyperball"},
           "solver": dict(_2D_SOLVE), "preconditioner": {"type": "Diagonal"}}
# phase 22 (e): the matrix-based family at 12^3 cells Q4
BLOCK_PROBLEM = {"dim": 3, "degree": 4, "n refinements": 2,
                 "mesh": {"name": "hypercube", "n subdivisions": 3},
                 "solver": {"type": "CG", "rel tolerance": 1e-5,
                            "best of": 3}, "print timing": True}
BLOCK_CASES = [
    {"type": "AdditiveSchwarzPreconditioner", "n overlap": 1},
    {"type": "AdditiveSchwarzPreconditioner", "n overlap": 2},
    {"type": "SubMeshPreconditioner", "n overlap": 1},
    {"type": "CGPreconditioner", "n overlap": 1, "n iterations": 2},
]
# phase 6's solution (on the host) and best-of-3 solve time, which phase 24
# holds its sharded solve to; it solves on one device itself when phase 6
# did not run
BALL_REF = {}
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
    # no TPU kernel: the JAX package's XLA einsum of the per-cell tables
    "cell_fdm_patch": ("dealii_asm_tpu_torch/kernels/csrc/cell_fdm_patch.cu",
                       "none (XLA einsum, dealii_asm_tpu/precond/asm.py:466)"),
}
# the solve whose run_config launches each kernel
FLAGSHIP_KERNELS = ("banded_laplace_f32", "banded_laplace_f64", "fdm_patch",
                    "smoother_step")
# E on every deformed level; G only where the smoother is element overlap 1
MERGED_KERNELS = ("merged_laplace_f64", "merged_laplace_f32")
KERSHAW_KERNELS = MERGED_KERNELS + ("cell_fdm_patch",)
BALL_KERNELS = ("lanes_laplace_f64", "lanes_laplace_f32")
LADDER_KERNELS = ("smoother_sweep",)
# the largest shape each kernel's solve gives it (the kernels line reports it)
MAIN_SHAPE = dict.fromkeys(FLAGSHIP_KERNELS, "64^3 cells Q4")
MAIN_SHAPE.update(dict.fromkeys(KERSHAW_KERNELS, "48^3 cells Q4"))
MAIN_SHAPE.update(dict.fromkeys(BALL_KERNELS, "131072 cells Q4"))
MAIN_SHAPE["smoother_sweep"] = "64^3 cells Q4, degree 2, from x"
MAIN_SHAPE["cell_fdm_patch"] = "48^3 cells Q4"

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
# - G float32: 1e-5, float64: 1e-12: the plain version applies the same
#   per-cell m x m transforms as batched products, the kernel per line in
#   another order (the same eigenvalue sums and reciprocals).
BOUNDS = {"banded_laplace_f32": 1e-5, "banded_laplace_f64": 1e-12,
          "fdm_patch": 1e-4, "smoother_step": 1e-4,
          "merged_laplace_f64": 1e-12, "merged_laplace_f32": 1e-5,
          "lanes_laplace_f64": 1e-12, "lanes_laplace_f32": 1e-5,
          "smoother_sweep": 1e-4, "cell_fdm_patch": 1e-5}
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
    E, F and G as the library has it (dat_band_plan, dat_tile_plan,
    dat_cell_plan, dat_cell_tile_plan) against launch_plan's and
    cell_plan's mirrors."""
    import ctypes

    from dealii_asm_tpu_torch.kernels import banded_laplace, cell_fdm_patch
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
    for p in range(1, 8):
        for itemsize in (4, 8):
            if lib.dat_cell_tile_plan(p, itemsize, got) != 0:
                raise Failed(f"dat_cell_tile_plan({p}, {itemsize})")
            plan = cell_fdm_patch.launch_plan(p, itemsize)
            want = (*plan.tile, plan.threads, plan.shared_bytes)
            print(f"  plan cell_fdm_patch p={p} float{8 * itemsize}: tile "
                  f"{got[0]}x{got[1]}, {got[2]} layers a block, {got[3]} "
                  f"threads, {got[4]} shared bytes; grid at 48^3 cells "
                  f"{plan.grid((48, 48, 48))}")
            if tuple(got) != want:
                raise Failed(f"plan cell_fdm_patch p={p} itemsize={itemsize}:"
                             f" library {tuple(got)}, launch_plan {want}")


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


def check_cell_fdm(cells_list, results, rows):
    """Phase 3: kernel G (both precisions) vs ``CellASMPreconditioner``'s
    plain apply on Kershaw meshes (eps 0.3): ragged meshes at p = 1..7 under
    every multiplicity weighting, each size of ``cells_list`` at Q4 and the
    largest at Q2 and Q1.  Timed in turns against the plain chain, and
    replayed in a CUDA graph, on the largest size; those times go to
    ``rows``."""
    import numpy as np
    import torch

    from dealii_asm_tpu_torch.fem.dofs import DofHandler
    from dealii_asm_tpu_torch.kernels.cell_fdm_patch import cell_fdm_patch
    from dealii_asm_tpu_torch.mesh.grid import StructuredMesh
    from dealii_asm_tpu_torch.mesh.transforms import kershaw_transform
    from dealii_asm_tpu_torch.precond.asm import CellASMPreconditioner
    from fembench.roofline import patch_fdm_work

    rng = np.random.default_rng(SEED + 7)
    name = "cell_fdm_patch"
    big = max(cells_list)
    cases = [((5, 7, 13), p, wt) for p in range(1, 8)
             for wt in ("none", "pre", "post", "symm")]
    cases += [((1, 9, 6), p, "symm") for p in range(1, 8)]
    cases += [((c, c, c), 4, "symm") for c in cells_list]
    cases += [((big, big, big), p, "symm") for p in (2, 1)]
    for cells, p, wt in cases:
        mesh = StructuredMesh(3, cells, transform=kershaw_transform(0.3, 0.3))
        dofs = DofHandler(mesh, p)
        n = dofs.n_dofs
        x64 = torch.as_tensor(rng.standard_normal(n), device="cuda")
        tag = "x".join(map(str, cells)) if len(set(cells)) > 1 else \
            f"{cells[0]}^3"
        tag = f"{tag} cells Q{p}, {n} DoFs, {wt}"
        timed = cells[0] == big and len(set(cells)) == 1
        for dt in (torch.float32, torch.float64):
            asm = CellASMPreconditioner(dofs, weighting_type=wt, dtype=dt,
                                        device="cuda")
            if not asm.fused:
                raise Failed(f"{name} {tag}: the gate refused the level")
            t = asm.cell_tables
            x = x64.to(dt)
            got = cell_fdm_patch(x, t)
            same = torch.equal(got, cell_fdm_patch(x, t))
            err = rel_err(got, t.plain(x))
            bnd = BOUNDS[name] if dt == torch.float32 else BOUND_F64
            print(f"  G {str(dt)[6:]} {tag}: max rel err {err:.3e} (bound "
                  f"{bnd:g}); repeated runs "
                  f"{'bit-identical' if same else 'DIFFER'}")
            if not (err <= bnd and same):
                raise Failed(f"{name} {dt} {tag}: {err:.3e}, "
                             f"bit-identical={same}")
            if timed:
                isz = x.element_size()
                k_ms, p_ms = in_turns(lambda: t.plain(x),
                                      lambda: cell_fdm_patch(x, t), 20)
                g_ms = graph_time(lambda: cell_fdm_patch(x, t), 200)
                g_txt = "not measured" if g_ms is None else f"{g_ms:.4f}"
                work = bound(*patch_fdm_work(mesh.n_cells_total, n, p + 1,
                                             isz), isz)
                print_time(tag, n, k_ms, p_ms)
                rows.append(f"G {str(dt)[6:]} {tag}: kernel {k_ms:.4f} ms "
                            f"({g_txt} ms replayed in a CUDA graph), plain "
                            f"{p_ms:.4f} ms, bound {work[0]:.4f} ms "
                            f"({work[1]}), {work[0] / k_ms:.1%} of it")
                if dt == torch.float32 and p == 4:
                    abs_err = float((got - t.plain(x))
                                    .abs().max())
                    results.setdefault(name, {})[tag] = (abs_err, k_ms, p_ms,
                                                         work)
            del asm, t
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


def deep_update(params: dict, changes: dict) -> dict:
    """``params`` with ``changes`` merged in, nested sections key by key."""
    for k, v in changes.items():
        if isinstance(v, dict) and isinstance(params.get(k), dict):
            deep_update(params[k], v)
        else:
            params[k] = v
    return params


def run_solve(path, n_small: int | None, it_small: int | None,
              it_full: int | None, n_dofs: int, kernels, counts,
              slack: int = 0, check_vcycle: bool = False, record=None,
              absent=(), best_of: int | None = None,
              refinements: int | None = None, precon: dict | None = None,
              small_mesh: dict | None = None, derive: dict | None = None,
              must_converge: bool = True):
    """Phase 4 to 13: one config through run_config on the card, first (with
    ``n_small`` given) at ``n_small`` refinements against the plain CPU
    path, then at full size (the config's "n refinements", or
    ``refinements``) with the launch counts set to 0 just before and read
    just after.  Every kernel of ``kernels`` must be launched and none of
    ``absent``; ``counts`` takes the counts of ``record`` (default
    ``kernels``).  ``it_full`` None accepts any converged count; ``best_of``
    overrides the config's, ``precon`` updates its "preconditioner"
    section (a derived config) and ``small_mesh`` the small case's "mesh"
    section; ``derive`` is merged into the whole config, section by section
    (phase 22), and ``path`` may be a (name, config) pair.  With
    ``must_converge`` False a full-size solve that does not converge is
    reported (as the JAX package reports it, 999), not failed.

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

    if isinstance(path, tuple):
        name, params = path[0], copy.deepcopy(path[1])
    else:
        with open(path) as f:
            params = json.load(f)
        name = os.path.basename(path)
    if best_of is not None:
        params["solver"]["best of"] = best_of
    if refinements is not None:
        params["n refinements"] = refinements
    if precon:
        params["preconditioner"].update(precon)
        name += f" derived with {json.dumps(precon)}"
    if derive:
        deep_update(params, derive)
        name += f" derived with {json.dumps(derive)}"
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
    n_dofs = n_dofs or res["n_dofs"]
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
    if not must_converge and not res["converged"]:
        max_it = params["solver"].get("max iterations", 1000)
        print(f"  {name}: not converged in {max_it} iterations (reported "
              "as 999)")
    elif not res["converged"] or it_full not in (None, res["it"]):
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
    solver = small["solver"].get("type")
    gmres = solver in ("GMRES", "FGMRES")
    # BiCGStab, IDR and Richardson: each residual carries the float32
    # V-cycle's rounding (kernels on the card, plain versions on the CPU)
    # at the scale of the initial residual, so they are compared to it
    initial = gmres or solver in ("Bicgstab", "IDR", "Richardson")
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
    hist = max(abs(a - b) / (hc[0] if initial else b)
               for a, b in zip(hg, hc))
    thr = float(small["solver"].get("rel tolerance", 1e-2)) * hc[0]
    last = lambda h: [round(r / thr, 4) for r in h[-2:]]
    print(f"  {name} at {n_small} refinements ({r_gpu['n_dofs']} DoFs): card "
          f"{r_gpu['it']} its, cpu {r_cpu['it']} its (expected {it_small}), "
          f"rel l2 solution difference {rel:.3e} (bound 1e-6), first "
          f"{len(hc) - 1} residuals agree to {hist:.2e} (bound {h_bound:g}"
          f"{' of the initial residual' if initial else ''}); last "
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
    run_benchmark_paths(phases)
    run_breadth_paths(counts, phases)
    run_parallel_paths(counts, phases)
    run_sharded_ball_phase(phases)
    if 25 in phases:
        print("== phase 25: kernel G against its plain version on the card")
        rows = []
        check_cell_fdm([2, 12, 48], {}, rows)
        for row in rows:
            print(row)


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
                        MERGED_KERNELS, counts, slack=1, record=(),
                        absent=absent_fused + ("cell_fdm_patch",), best_of=3)
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
                        MP_SMALL["mp_02"], None, 16_194_277, MERGED_KERNELS,
                        counts, record=(),
                        absent=absent_fused + ("cell_fdm_patch",), best_of=1,
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
                       else MERGED_KERNELS)
            run_solve(os.path.join(INPUTS, f"{name}.json"), 0, MP_SMALL[name],
                      None, 2_048_383, kernels, counts, record=(),
                      absent=absent_fused + ("cell_fdm_patch",), best_of=1,
                      refinements=1, small_mesh=mp_small)
    if 20 in phases:
        print("== phase 20: inputs/dummy.json (2D Q3, CG around Diagonal) on "
              "the card")
        run_solve(os.path.join(INPUTS, "dummy.json"), 3, 24, 24, 625, (),
                  counts, record=(), absent=tuple(KERNELS), best_of=3)


def _bench_lines(text: str) -> list:
    return [l.split() for l in text.splitlines() if l.startswith(">>")]


def check_benchmark_small(params: dict, name: str) -> None:
    """The benchmark driver on the card against its plain CPU path: the
    same ``>>`` lines apart from the seconds, and one apply of each label
    to the same source vector within ``MFL_TOL`` (``MFL_TOL_CHEBY``)."""
    import io

    import torch

    from dealii_asm_tpu_torch.models.benchmark import run_benchmark

    applies, texts = {}, {}
    for device in ("cpu", "cuda"):
        got = applies.setdefault(device, {})
        out = io.StringIO()
        run_benchmark(params, out=out, device=device,
                      on_label=lambda r, fn, src: got.__setitem__(
                          r["label"], fn(src).cpu()))
        texts[device] = out.getvalue()
    cpu, card = _bench_lines(texts["cpu"]), _bench_lines(texts["cuda"])
    labels = params["preconditioner types"].split()
    if len(card) != len(labels) or [l[:4] + l[5:] for l in card] != \
            [l[:4] + l[5:] for l in cpu]:
        raise Failed(f"{name}: >> lines differ between the card and the "
                     f"CPU:\n{texts['cuda']}{texts['cpu']}")
    worst = {}
    for label in labels:
        a, b = applies["cuda"][label].double(), applies["cpu"][label].double()
        err = float(torch.linalg.vector_norm(a - b)
                    / torch.linalg.vector_norm(b))
        tol = MFL_TOL_CHEBY if label.startswith("cheby") else MFL_TOL
        worst[label] = err
        if not err <= tol:
            raise Failed(f"{name} {label}: card against CPU rel L2 {err:.3e}"
                         f" > {tol:g}")
    print(f"  {name}: {len(labels)} labels, {card[0][2]} DoFs, >> lines equal "
          f"to the CPU's apart from the seconds; card against CPU rel L2 "
          f"max {max(worst.values()):.3e} "
          f"({max(worst, key=worst.get)})")


class Yardstick:
    """Kernel A float32 and kernel B (symm) at 64^3 cells Q4, CUDA-event ms
    per call, timed between the full-size configs of phase 21; their
    launches are not counted (the counts are restored after each)."""

    def __init__(self):
        import torch

        from dealii_asm_tpu_torch.fem.dofs import DofHandler
        from dealii_asm_tpu_torch.mesh.grid import StructuredMesh
        from dealii_asm_tpu_torch.ops.laplace import LaplaceOperator
        from dealii_asm_tpu_torch.precond.asm import ASMPreconditioner

        dofs = DofHandler(StructuredMesh(3, (64, 64, 64)), 4)
        self.n = dofs.n_dofs
        self.op = LaplaceOperator(dofs, dtype=torch.float32, device="cuda")
        self.asm = ASMPreconditioner(dofs, weighting_type="symm",
                                     dtype=torch.float32, device="cuda")
        if not self.asm.fused:
            raise Failed("the yardstick's FDM apply is not kernel B")
        self.x = torch.randn(self.n, generator=torch.Generator().manual_seed(
            SEED)).to(device="cuda", dtype=torch.float32)
        self.a_ms, self.b_ms = [], []

    def time(self) -> None:
        from dealii_asm_tpu_torch.kernels import LAUNCHES

        saved = dict(LAUNCHES)
        self.a_ms.append(cuda_time(lambda: self.op.vmult(self.x), 20))
        self.b_ms.append(cuda_time(lambda: self.asm.vmult(self.x), 20))
        LAUNCHES.update(saved)

    def per_dof_ns(self) -> tuple:
        a = sum(self.a_ms) / len(self.a_ms)
        b = sum(self.b_ms) / len(self.b_ms)
        return a, b, a / self.n * 1e6, b / self.n * 1e6


def run_benchmark_full(path: str, yard: Yardstick) -> None:
    """One matrix-free-loop config at its own size through the driver on
    the card: each label's ms per call and per apply (the line's count,
    n_rep·factor), its setup seconds, one apply finite, the peak device
    memory; then the yardstick in turn."""
    import torch

    from dealii_asm_tpu_torch.models.benchmark import run_benchmark

    with open(path) as f:
        params = json.load(f)
    n_rep = int(params.get("n repetitions", 10))
    name = os.path.relpath(path, HERE)
    rows = []

    def on_label(r, fn, src):
        y = fn(src)
        if y.shape != src.shape or not bool(torch.isfinite(y).all()):
            raise Failed(f"{name} {r['label']}: one apply gives "
                         f"{tuple(y.shape)}, finite="
                         f"{bool(torch.isfinite(y).all())}")
        rows.append(r)

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    n = run_benchmark(params, device="cuda", on_label=on_label)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    if n != MFL_FULL_DOFS:
        raise Failed(f"{name}: {n} DoFs, expected {MFL_FULL_DOFS}")
    a_ms, b_ms, a_ns, b_ns = yard.per_dof_ns()
    print(f"  {name}: {n} DoFs, problem setup "
          f"{rows[0]['problem_setup_s']:.3f} s, wall {wall:.1f} s, peak "
          f"device memory {peak:.2f} GiB")
    for r in rows:
        ms_call = r["seconds"] / n_rep * 1e3
        ms_apply = r["seconds"] / r["count"] * 1e3
        print(f"    {r['label']}: {ms_call:.4f} ms per call, {ms_apply:.4f} "
              f"ms per apply ({ms_apply / n * 1e6:.4f} ns per DoF; "
              f"{ms_apply / (n * a_ns / 1e6):.2f}x kernel A, "
              f"{ms_apply / (n * b_ns / 1e6):.2f}x kernel B per DoF), "
              f"setup {r['setup_s']:.3f} s")
    yard.time()


def run_flagship_solvers(counts) -> None:
    """Phase 22 (a) and (b): the flagship under each new Krylov solver, with
    "mixed precision solve": true, and with bfloat16 levels, each through
    run_config after its small check at 2 refinements (the JAX package's
    CPU counts there, ``BREADTH_SMALL``); then the refinement itself on the
    flagship's operators and multigrid (``refined_solve``), since the JAX
    run_config's condition never engages it (JSON true reads "True")."""
    for solver, it_small in BREADTH_SMALL.items():
        print(f"== phase 22a: flagship, {solver} on the card")
        run_solve(FLAGSHIP, 2, it_small, None, 16_974_593, FLAGSHIP_KERNELS,
                  counts, record=(), absent=LADDER_KERNELS,
                  slack=1 if solver in ("Bicgstab", "IDR") else 0,
                  derive={"solver": {"type": solver}},
                  must_converge=solver != "Richardson")
    print("== phase 22a: flagship, \"mixed precision solve\": true on the card")
    res = run_solve(FLAGSHIP, 2, 4, 5, 16_974_593, FLAGSHIP_KERNELS, counts,
                    record=(), absent=LADDER_KERNELS,
                    derive={"mixed precision solve": True})
    run_refinement(res)
    del res
    print("== phase 22b: flagship with bfloat16 levels on the card")
    run_solve(FLAGSHIP, 2, BF16_SMALL, None, 16_974_593,
              ("banded_laplace_f64",), counts, record=(),
              absent=("banded_laplace_f32", "fdm_patch", "smoother_step")
              + LADDER_KERNELS,
              derive={"mg number type": "bfloat16",
                      "solver": {"max iterations": 200}},
              must_converge=False)


def run_refinement(res) -> None:
    """Mixed-precision refinement on the flagship: float64 residuals of the
    outer operator, float32 CG inner solves on the finest level operator
    preconditioned by run_config's float32 multigrid, to rel 1e-5; best of
    3 after a warm-up, beside the plain float64 CG of the same run."""
    import torch

    from dealii_asm_tpu_torch.kernels import launch_counts, reset_launch_counts
    from dealii_asm_tpu_torch.ops.laplace import LaplaceOperator
    from dealii_asm_tpu_torch.solvers.refinement import refined_solve

    mg = res["preconditioner"].inner
    op32 = mg.operators[-1]
    op64 = LaplaceOperator(op32.dofs, dtype=torch.float64, device="cuda")
    b = op64.assemble_rhs("constant")
    cycles = []
    solve = lambda log=lambda *a: None: refined_solve(
        op64.vmult, op32.vmult, b, mg.vmult, rel_tolerance=1e-5, log=log)
    reset_launch_counts()
    r = solve(log=cycles.append)
    got = launch_counts()
    best = 999.0
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r2 = solve()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
        if r2.n_iterations != r.n_iterations:
            raise Failed("refinement: repeated solve took another count")
    rel = [round(v / r.residuals[0], 10) for v in r.residuals]
    print(f"  refined_solve on the flagship: converged={r.converged}, "
          f"{r.n_iterations} inner CG its in {r.outer_cycles} cycles, true "
          f"residual / initial {rel}, best-of-3 solve {best:.4f} s (plain "
          f"float64 CG: {res['it']} its, {res['time']:.4f} s)")
    for line in cycles:
        print(f"  {line.strip()}")
    print(f"  launch counts of the refinement: {json.dumps(got)}")
    if got["banded_laplace_f32"] <= 0 or got["banded_laplace_f64"] <= 0:
        raise Failed("refinement: kernel A not launched in both precisions")
    if not bool(torch.isfinite(r.x).all()):
        raise Failed("refinement: non-finite solution")


def run_anatomy() -> None:
    """Phase 22 (c): the solver anatomy and the transfer bench
    (``models/solver_bench.py``) at "n subdivision" 36, Q4 (64^3 cells,
    16,974,593 DoFs, the flagship's size), 20 iterations each; kernel A
    (float32) launched in the anatomy."""
    import torch

    from dealii_asm_tpu_torch.kernels import launch_counts, reset_launch_counts
    from dealii_asm_tpu_torch.models.solver_bench import (run_solver_anatomy,
                                                          run_transfer_bench)

    print("== phase 22c: solver anatomy and transfers at 64^3 cells Q4 on "
          "the card")
    params = {"n subdivision": 36, "fe degree": 4, "n iterations": 20}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    n = run_solver_anatomy(params, device="cuda")
    got = launch_counts()
    print(f"  anatomy: {n} DoFs, wall {time.perf_counter() - t0:.3f} s, "
          f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
          f"launch counts {json.dumps(got)}")
    if n != 16_974_593 or got["banded_laplace_f32"] <= 0:
        raise Failed("anatomy: wrong size or kernel A (float32) not launched")
    run_transfer_bench(params, device="cuda")


def run_2d_paths(counts) -> None:
    """Phase 22 (d): 2D Kershaw (eps 0.3, Q3, h-multigrid, Chebyshev-2
    around per-cell FDM; 5,313,025 DoFs) and the 2D ball (Q2, CG around
    Diagonal; 3,147,777 DoFs) through run_config, each after its small
    check at 2 refinements (the JAX package's counts 26 and 40); no kernel
    launched (2D runs plain torch, as the JAX package runs XLA there).
    The host setup grows about 4x a refinement (2D Kershaw 16.7 s at 7
    refinements, the ball 37.3 s at 8 on the card's host), so one more
    refinement passes a minute."""
    print(f"== phase 22d: 2D Kershaw at {KERSHAW_2D_R} refinements on the "
          "card")
    run_solve(("2D Kershaw eps 0.3 Q3", KERSHAW_2D), 2, 26, None, None, (),
              counts, record=(), absent=tuple(KERNELS), slack=1,
              refinements=KERSHAW_2D_R, best_of=3)
    print(f"== phase 22d: 2D ball at {BALL_2D_R} refinements on the card")
    # the Diagonal preconditioner leaves CG's count growing about 2x a
    # refinement (40 at 2 refinements): the config allows 5000, best of 1
    run_solve(("2D ball Q2 Diagonal", BALL_2D), 2, 40, None, None, (),
              counts, record=(), absent=tuple(KERNELS), slack=1,
              refinements=BALL_2D_R, best_of=1,
              derive={"solver": {"max iterations": 5000},
                      "print timing": True})


def run_block_paths(counts) -> None:
    """Phase 22 (e): the matrix-based family on 3D Cartesian 12^3 cells Q4
    (117,649 DoFs), CG to rel 1e-5: AdditiveSchwarzPreconditioner at
    overlap 1 and 2, SubMeshPreconditioner and CGPreconditioner (2 block
    iterations) at overlap 1 through run_config, and the
    DomainPreconditioner (2 slabs, 1 halo layer; SciPy sparse LU on the
    host) around CG at 8^3 cells Q4 (35,937 DoFs: the LU of the two
    61,852-DoF slabs at 12^3 takes about 90 s on the host); each on the
    card and on the CPU path, the counts equal.  Kernel A (float64, the
    outer operator) launched; A float32, B, C and D not."""
    import torch

    from dealii_asm_tpu_torch.fem.dofs import DofHandler
    from dealii_asm_tpu_torch.kernels import launch_counts, reset_launch_counts
    from dealii_asm_tpu_torch.mesh.grid import StructuredMesh
    from dealii_asm_tpu_torch.models.poisson import run_config
    from dealii_asm_tpu_torch.ops.laplace import LaplaceOperator
    from dealii_asm_tpu_torch.precond.domain import DomainPreconditioner
    from dealii_asm_tpu_torch.solvers.krylov import solve

    quiet = lambda *a: None
    absent = ("banded_laplace_f32", "fdm_patch", "smoother_step") \
        + LADDER_KERNELS
    for prm in BLOCK_CASES:
        params = copy.deepcopy(BLOCK_PROBLEM)
        params["preconditioner"] = dict(prm)
        print(f"== phase 22e: {json.dumps(prm)} at 12^3 cells Q4")
        t0 = time.perf_counter()
        cpu = run_config(copy.deepcopy(params), log=quiet, device="cpu")
        print(f"  CPU path: {cpu['it']} its, setup {cpu['setup_time']:.3f} s, "
              f"wall {time.perf_counter() - t0:.3f} s")
        run_solve((prm["type"], params), None, None, cpu["it"], 117_649,
                  ("banded_laplace_f64",), counts, record=(), absent=absent)
    print("== phase 22e: DomainPreconditioner (2 slabs, 1 halo) at 8^3 "
          "cells Q4")
    dofs = DofHandler(StructuredMesh(3, (8, 8, 8)), 4)
    t0 = time.perf_counter()
    dp = DomainPreconditioner(dofs, n_subdomains=2, n_halo_layers=1)
    setup = time.perf_counter() - t0
    its = {}
    for dev in ("cpu", "cuda"):
        op = LaplaceOperator(dofs, device=dev)
        b = op.assemble_rhs("constant")
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        best = 999.0
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = solve("CG", op.vmult, b, M=dp.vmult, rel_tolerance=1e-5)
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        its[dev] = r.n_iterations if r.converged else 999
        print(f"  {dev}: {its[dev]} its, best-of-3 solve {best:.4f} s, setup "
              f"(host sparse LU) {setup:.3f} s, peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launch "
              f"counts {json.dumps(launch_counts())}")
    if (its["cpu"] != its["cuda"] or its["cpu"] == 999
            or launch_counts()["banded_laplace_f64"] <= 0):
        raise Failed(f"DomainPreconditioner: card {its['cuda']} its, CPU "
                     f"{its['cpu']}")


def run_breadth_paths(counts, phases) -> None:
    """Phase 22 (if named in ``phases``): (a)-(e) above."""
    if 22 not in phases:
        return
    run_flagship_solvers(counts)
    run_anatomy()
    run_2d_paths(counts)
    run_block_paths(counts)


def _flagship(refinements: int | None = None) -> dict:
    with open(FLAGSHIP) as f:
        params = json.load(f)
    if refinements is not None:
        params["n refinements"] = refinements
    return params


@contextlib.contextmanager
def one_nccl_rank():
    """A one-rank NCCL process group of this process on card 0 (NCCL
    refuses two ranks on one card) and its ``Shards``; destroyed after."""
    import tempfile

    import torch
    import torch.distributed as dist

    from dealii_asm_tpu_torch.parallel.sharding import process_shards

    store = tempfile.TemporaryDirectory(prefix="chip_smoke_nccl_")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{store.name}/store",
                            rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        shards = process_shards(1, "cuda")
        print(f"  process group: {dist.get_backend()} world size "
              f"{dist.get_world_size()}, rank device {shards.device}")
        yield shards
    finally:
        dist.destroy_process_group()
        store.cleanup()


def run_sharded_flagship(counts) -> None:
    """Phase 23 (a): the flagship through ``parallel/driver.py`` at world
    size 1 under NCCL (a one-rank process group in this process), the
    levels from 274,625 DoFs up sharded (plain torch per shard) over the
    replicated tail of the single-device factory.  First at 2 refinements
    with the 17^3 level sharded ("replicate below" 1000) against the plain
    CPU path on one device (the JAX package's count 4); then at full size
    beside the single-device solve, its set-up and warm-up traced under
    "print timing" (the tracer's level x stage table printed): 5
    iterations, the solution within the solve's 1e-5 relative of the
    single-device one.  Then the top sharded level's plain
    applies beside kernels A (float32) and B at the same size."""
    import torch

    from dealii_asm_tpu_torch.kernels import (LAUNCHES, launch_counts,
                                              reset_launch_counts)
    from dealii_asm_tpu_torch.models.poisson import run_config

    quiet = lambda *a: None  # noqa: E731
    with one_nccl_rank() as shards:
        small = _flagship(2)
        small["print timing"] = False
        small["solver"]["best of"] = 1
        small["preconditioner"]["replicate below"] = 1000
        r_card = run_config(copy.deepcopy(small), log=quiet, device="cuda",
                            shards=shards)
        r_cpu = run_config(copy.deepcopy(small), log=quiet, device="cpu")
        rel = float((r_card["solution"].cpu() - r_cpu["solution"]).norm()
                    / r_cpu["solution"].norm())
        print(f"  sharded flagship at 2 refinements ({r_card['n_dofs']} "
              f"DoFs, the 17^3 level sharded): card {r_card['it']} its, cpu "
              f"one device {r_cpu['it']} (JAX 4), rel l2 {rel:.3e} (bound "
              "1e-6)")
        if not (r_card["converged"] and r_card["it"] == r_cpu["it"] == 4
                and rel <= 1e-6):
            raise Failed("sharded flagship at 2 refinements disagrees")

        torch.cuda.empty_cache()
        ref = run_config(_flagship(), log=quiet, device="cuda")
        print(f"  single-device flagship: it {ref['it']}, best-of-3 solve "
              f"{ref['time']:.4f} s (untraced); the level x stage table "
              "above (run_config prints it under \"print timing\") sums the"
              " ms of the traced warm-up solve")
        x_ref = ref["solution"]
        del ref
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        shards.reset_traffic()
        t0 = time.perf_counter()
        res = run_config(_flagship(), log=quiet, device="cuda",
                         shards=shards)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got, traffic = launch_counts(), dict(shards.traffic)
        rel = float((res["solution"] - x_ref).norm() / x_ref.norm())
        print(f"  sharded flagship (world size 1, NCCL): {res['n_dofs']} "
              f"DoFs, converged={res['converged']}, it={res['it']}, setup "
              f"{res['setup_time']:.3f} s, best-of-3 solve "
              f"{res['time']:.4f} s, run_config wall {wall:.3f} s, peak "
              f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
              f" GiB; rel l2 to the single-device solution {rel:.3e} (bound "
              "1e-5)")
        print(f"  collectives over the run (setup, warm-up, 3 timed "
              f"solves): {json.dumps(traffic)}; launch counts (the "
              f"replicated tail): {json.dumps(got)}")
        if not (res["converged"] and res["it"] == 5 and rel <= 1e-5
                and res["n_dofs"] == 16_974_593):
            raise Failed("sharded flagship: wrong count or solution")
        for k in KERSHAW_KERNELS + BALL_KERNELS + LADDER_KERNELS:
            if got[k] != 0:
                raise Failed(f"kernel {k} launched on the sharded path")
        b = torch.sin(torch.arange(res["n_dofs"], dtype=torch.float64,
                                   device="cuda"))
        shards.reset_traffic()
        res["preconditioner"].vmult(b)
        print(f"  one sharded V-cycle: {json.dumps(shards.traffic)} (CG adds 3 "
              "all_reduces an iteration: two dots and a norm)")
        mg = res["preconditioner"].inner
        top = mg.operators[-1].__self__  # the top level's ShardedLattice
        saved = dict(LAUNCHES)
        x = torch.randn(top.n_local, generator=torch.Generator().manual_seed(
            SEED)).to(device="cuda", dtype=torch.float32)
        v_ms = cuda_time(lambda: top.vmult(x), 10)
        f_ms = cuda_time(lambda: top.smoother_vmult(x), 10)
        yard = Yardstick()
        yard.time()
        LAUNCHES.update(saved)
        print(f"  top sharded level at {top.n_dofs} DoFs (float32): plain "
              f"vmult {v_ms:.4f} ms ({v_ms / top.n_dofs * 1e6:.4f} ns per "
              f"DoF) against kernel A {yard.a_ms[0]:.4f} ms; plain FDM "
              f"{f_ms:.4f} ms against kernel B {yard.b_ms[0]:.4f} ms")
        del res, x_ref, mg, top, yard, b


def run_drivers_output() -> None:
    """Phase 23 (b) and (c): the dryrun launcher with one NCCL rank; the
    variant studies (composition and access) and the power kernel at 64^3
    cells Q4 and the periodic box of 64^3 cells (16,777,216 DoFs), every
    ``>>`` line printed, kernel C's ``cuda`` access step held to the
    ``global`` step within C's bound; the mesh gallery into a temporary
    directory; "do output" at 2 refinements."""
    import tempfile

    import torch

    from dealii_asm_tpu_torch.kernels import launch_counts, reset_launch_counts
    from dealii_asm_tpu_torch.models import (mesh_gallery, power_kernel,
                                             variant_bench)
    from dealii_asm_tpu_torch.models.poisson import run_config
    from dealii_asm_tpu_torch.parallel.dryrun import dryrun, spawn

    print("== phase 23b: dryrun, one NCCL rank (spawned)")
    rec = spawn(1, dryrun, device="cuda")[0]
    print(f"  {json.dumps(rec)}")
    if not rec["ok"]:
        raise Failed("dryrun on the card failed")

    print("== phase 23c: variant studies and power kernel at 64^3 cells Q4")
    torch.cuda.empty_cache()
    bench = {"n subdivisions": 64, "degree": 4, "n repetitions": 3}
    variant_bench.run_composition_bench(bench, device="cuda")
    steps = {}
    reset_launch_counts()
    variant_bench.run_access_bench(
        bench, device="cuda",
        on_label=lambda label, fn, x: steps.setdefault(label, fn(x)))
    got = launch_counts()
    err = rel_err(steps["cuda"], steps["global"])
    # the gather route: the per-patch float32 products of the global form
    # in another order and grouping, B's bound
    g_err = rel_err(steps["gather"], steps["global"])
    print(f"  access: cuda step against the global step: max rel err "
          f"{err:.3e} (bound {BOUNDS['smoother_step']:g}); kernel C "
          f"launches {got['smoother_step']}; gather step against the "
          f"global step {g_err:.3e} (bound {BOUNDS['fdm_patch']:g})")
    if err > BOUNDS["smoother_step"] or got["smoother_step"] <= 0:
        raise Failed("the cuda access step disagrees or did not launch C")
    if g_err > BOUNDS["fdm_patch"]:
        raise Failed("the gather access step disagrees")
    del steps
    torch.cuda.empty_cache()
    power_kernel.run_power_kernel({"n subdivision": 36, "fe degree": 4,
                                   "n repetitions": 5}, device="cuda")

    print("== phase 23c: mesh gallery and \"do output\"")
    with tempfile.TemporaryDirectory() as tmp:
        rows = mesh_gallery.run_gallery(os.path.join(tmp, "gallery"))
        mesh_gallery.run_coarsening(4)
        path = os.path.join(tmp, "flagship_r2.vtu")
        params = _flagship(2)
        params.update({"print timing": False, "do output": True,
                       "output file": path})
        params["solver"]["best of"] = 1
        res = run_config(params, log=lambda *a: None, device="cuda")
        with open(path) as f:
            head = f.read(400)
        n_pts = f'NumberOfPoints="{res["n_dofs"]}"'
        print(f"  gallery: {len(rows)} meshes; do output: "
              f"{os.path.getsize(path)} bytes, {n_pts}")
        if len(rows) != 10 or n_pts not in head:
            raise Failed("gallery or VTU output wrong")


def check_shard_tables(dofs, coeff, ranks: int) -> None:
    """Kernel F on every rank's local tables of a ``ranks``-way
    ``GeneralPartition`` of ``dofs``, built on the host (no process group):
    a local vector whose ghost slots are "free" in F's CSR inverse, and
    shards of a few cells.  ``coeff`` is the (C, 6, Q) cell table in the
    problem's cell order; each rank takes its slice.  F in both precisions
    against its plain version on the same inputs, at F's bound; these
    launches are not counted."""
    import numpy as np
    import torch

    from dealii_asm_tpu_torch.fem.lagrange import shape_1d
    from dealii_asm_tpu_torch.kernels import LAUNCHES
    from dealii_asm_tpu_torch.kernels.lanes_laplace import (
        lanes_laplace, lanes_laplace_plain, lanes_tables)
    from dealii_asm_tpu_torch.parallel.general_sharded import \
        GeneralPartition

    saved = dict(LAUNCHES)
    part = GeneralPartition(dofs, ranks)
    p = dofs.degree
    s = shape_1d(p, p + 1)
    gen = torch.Generator().manual_seed(SEED)
    worst = {}
    for dt, name in ((torch.float32, "lanes_laplace_f32"),
                     (torch.float64, "lanes_laplace_f64")):
        shape_host = torch.tensor(np.stack([s.N, s.D, s.D, s.D]), dtype=dt)
        shape = shape_host.to("cuda")
        for r in range(ranks):
            lo, hi = part.cell_bounds[r], part.cell_bounds[r + 1]
            t = lanes_tables(part.cells.local_rows(r),
                             np.zeros(part.n_loc, bool),
                             coeff[lo:hi].to("cuda", dt).contiguous(), shape,
                             shape_host, p)
            u = torch.randn(part.n_loc, generator=gen).to("cuda", dt)
            err = rel_err(lanes_laplace(u, t), lanes_laplace_plain(u, t))
            worst[name] = max(worst.get(name, 0.0), err)
            del t, u
    LAUNCHES.update(saved)
    cells = np.diff(part.cell_bounds)
    print(f"  F on the local tables of {ranks} ranks of {dofs.n_dofs} DoFs "
          f"({cells.min()}-{cells.max()} cells a rank, B {part.B}, Gmax "
          f"{part.Gmax}): max rel err f32 {worst['lanes_laplace_f32']:.3e} "
          f"(bound {BOUNDS['lanes_laplace_f32']:g}), f64 "
          f"{worst['lanes_laplace_f64']:.3e} (bound "
          f"{BOUNDS['lanes_laplace_f64']:g})")
    for name, err in worst.items():
        if not err <= BOUNDS[name]:
            raise Failed(f"{name} on {ranks}-rank local tables: {err:.3e}")


def run_sharded_ball() -> None:
    """Phase 24: the ball (experiments/e2e_ball_q4.json) through
    ``parallel/general_sharded.py`` at world size 1 under NCCL: its fine
    level sharded (kernel F per shard, float32, and the float64 outer
    operator), every coarser level replicated.  At 1 refinement the card
    against the CPU path on one device (6 iterations, rel l2 1e-6); at
    full size 7 iterations, the solution within 1e-5 of the single-device
    solve (phase 6's, or solved here first; its solve time beside the
    sharded one), two V-cycle applies bit-identical, no launch of A-E, F
    float64 launched by the run; F float32 launched once by one sharded
    fine-level apply and F float64 once by one apply of the float64 outer
    operator, built as ``build_sharded_general`` builds it; F on the
    local tables of 4 ranks at full size and of 12 ranks of the unrefined
    ball; setup, solve, peak memory, B and Gmax, the collectives per
    V-cycle and the sharded fine level's vmult and FDM apply beside the
    single-device F and ``GeneralASMPreconditioner`` at the same size."""
    import torch

    from dealii_asm_tpu_torch.fem.general_dofs import GeneralDofHandler
    from dealii_asm_tpu_torch.kernels import (LAUNCHES, launch_counts,
                                              reset_launch_counts)
    from dealii_asm_tpu_torch.mesh.unstructured import hyper_ball_balanced
    from dealii_asm_tpu_torch.models.poisson import run_config
    from dealii_asm_tpu_torch.ops.laplace_general import \
        GeneralLaplaceOperator
    from dealii_asm_tpu_torch.parallel.general_sharded import \
        ShardedGeneralOperator
    from dealii_asm_tpu_torch.precond.asm_general import \
        GeneralASMPreconditioner

    quiet = lambda *a: None  # noqa: E731
    with open(BALL) as f:
        full = json.load(f)
    with one_nccl_rank() as shards:
        small = copy.deepcopy(full)
        small.update({"n refinements": 1, "print timing": False})
        small["solver"]["best of"] = 1
        r_card = run_config(copy.deepcopy(small), log=quiet, device="cuda",
                            shards=shards)
        r_cpu = run_config(copy.deepcopy(small), log=quiet, device="cpu")
        rel = float((r_card["solution"].cpu() - r_cpu["solution"]).norm()
                    / r_cpu["solution"].norm())
        print(f"  sharded ball at 1 refinement ({r_card['n_dofs']} DoFs): "
              f"card {r_card['it']} its, cpu one device {r_cpu['it']} (JAX "
              f"6), rel l2 {rel:.3e} (bound 1e-6)")
        if not (r_card["converged"] and r_card["it"] == r_cpu["it"] == 6
                and rel <= 1e-6):
            raise Failed("sharded ball at 1 refinement disagrees")
        del r_card, r_cpu

        if "solution" not in BALL_REF:
            torch.cuda.empty_cache()
            one = run_config(copy.deepcopy(full), log=quiet, device="cuda")
            BALL_REF.update(solution=one["solution"].cpu(), time=one["time"])
            del one
        x_ref, t_one = BALL_REF["solution"], BALL_REF["time"]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        shards.reset_traffic()
        t0 = time.perf_counter()
        res = run_config(copy.deepcopy(full), log=quiet, device="cuda",
                         shards=shards)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got, traffic = launch_counts(), dict(shards.traffic)
        rel = float((res["solution"].cpu() - x_ref).norm() / x_ref.norm())
        print(f"  sharded ball (world size 1, NCCL): {res['n_dofs']} DoFs, "
              f"converged={res['converged']}, it={res['it']}, setup "
              f"{res['setup_time']:.3f} s, best-of-3 solve "
              f"{res['time']:.4f} s, run_config wall {wall:.3f} s, peak "
              f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
              f" GiB; rel l2 to the single-device solution {rel:.3e} (bound "
              "1e-5)")
        print(f"  single-device best-of-3 solve in this run {t_one:.4f} s: "
              f"the sharded solve takes {res['time'] / t_one:.3f}x, "
              f"{res['time'] - t_one:+.4f} s")
        print(f"  collectives over the run (setup, warm-up, 3 timed "
              f"solves): {json.dumps(traffic)}; launch counts: "
              f"{json.dumps(got)}")
        if not (res["converged"] and res["it"] == 7 and rel <= 1e-5
                and res["n_dofs"] == 8_438_273):
            raise Failed("sharded ball: wrong count or solution")
        launched = [k for k in KERNELS if k not in BALL_KERNELS and got[k]]
        if launched:
            raise Failed(f"kernels launched on the sharded ball: {launched}")
        if not (got["lanes_laplace_f32"] > 0 and got["lanes_laplace_f64"] > 0):
            raise Failed("the sharded ball did not launch kernel F in both "
                         "precisions")

        pre = res["preconditioner"]
        sop = pre.inner.operators[-1].__self__
        sasm = pre.inner.smoothers[-1].M.__self__
        part = sop.part
        dofs = part.dofs
        print(f"  partition: B {part.B}, Gmax {part.Gmax} (one rank: the "
              "ghost block is the one zero slot)")
        b = torch.sin(torch.arange(part.B, dtype=torch.float64,
                                   device="cuda"))
        shards.reset_traffic()
        y1 = pre.vmult(b)
        per_cycle = dict(shards.traffic)
        y2 = pre.vmult(b)
        same = torch.equal(y1, y2)
        print(f"  one sharded V-cycle: {json.dumps(per_cycle)}; two applies "
              f"{'bit-identical' if same else 'DIFFER'}")
        if not same:
            raise Failed("sharded ball: repeated V-cycle applies differ")
        del y1, y2
        # the float64 outer operator as build_sharded_general builds it
        # around run_config's operator (assembled here on the card)
        op64 = GeneralLaplaceOperator(dofs, dtype=torch.float64,
                                      device="cuda")
        sop64 = ShardedGeneralOperator(op64, part, shards)
        reset_launch_counts()
        sop.vmult(b.float())
        y64 = sop64.vmult(b)
        got = launch_counts()
        err64 = rel_err(sop64.unpad(y64), op64.vmult(sop64.unpad(b)))
        print(f"  one sharded fine-level apply and one outer apply: F f32 "
              f"{got['lanes_laplace_f32']}, F f64 {got['lanes_laplace_f64']}"
              f"; the outer apply against the single-device float64 F: max "
              f"rel err {err64:.3e} (bound {BOUNDS['lanes_laplace_f64']:g})")
        if not (got["lanes_laplace_f32"] == 1
                and got["lanes_laplace_f64"] == 1
                and err64 <= BOUNDS["lanes_laplace_f64"]):
            raise Failed("the sharded applies did not launch kernel F")
        del op64, sop64, y64

        check_shard_tables(dofs, sop.tables.coeff, 4)
        ball0 = GeneralDofHandler(hyper_ball_balanced(3), 4)
        check_shard_tables(ball0, GeneralLaplaceOperator(
            ball0, device="cpu").coeff6, 12)

        saved = dict(LAUNCHES)
        x = torch.randn(part.B, generator=torch.Generator().manual_seed(
            SEED)).to(device="cuda", dtype=torch.float32)
        v_ms = cuda_time(lambda: sop.vmult(x), 10)
        f_ms = cuda_time(lambda: sasm.vmult(x), 10)
        del res, pre, sop, sasm
        torch.cuda.empty_cache()
        op1 = GeneralLaplaceOperator(dofs, dtype=torch.float32,
                                     device="cuda")
        asm1 = GeneralASMPreconditioner(dofs, n_overlap=1,
                                        weighting_type="symm",
                                        dtype=torch.float32, device="cuda")
        u = part.unpad(x.cpu()).to("cuda")
        v1_ms = cuda_time(lambda: op1.vmult(u), 10)
        f1_ms = cuda_time(lambda: asm1.vmult(u), 10)
        LAUNCHES.update(saved)
        print(f"  sharded fine level at {dofs.n_dofs} DoFs (float32): vmult "
              f"{v_ms:.4f} ms against single-device F {v1_ms:.4f} ms; FDM "
              f"{f_ms:.4f} ms against single-device GeneralASMPreconditioner"
              f" {f1_ms:.4f} ms")
        del op1, asm1, x, u


def run_parallel_paths(counts, phases) -> None:
    """Phase 23 (if named in ``phases``): (a)-(c) above."""
    if 23 not in phases:
        return
    t0 = time.perf_counter()
    print("== phase 23a: the flagship through the sharded path, world size "
          "1, NCCL")
    run_sharded_flagship(counts)
    run_drivers_output()
    print(f"  phase 23: {time.perf_counter() - t0:.1f} s")


def run_sharded_ball_phase(phases) -> None:
    """Phase 24 (if named in ``phases``): ``run_sharded_ball``."""
    if 24 not in phases:
        return
    t0 = time.perf_counter()
    print("== phase 24: the ball through the sharded unstructured path, "
          "world size 1, NCCL")
    run_sharded_ball()
    print(f"  phase 24: {time.perf_counter() - t0:.1f} s")


def run_benchmark_paths(phases) -> None:
    """Phase 21 (if named in ``phases``): the matrix-free-loop driver
    (``models/benchmark.py``) on periodic meshes.  The card against the
    CPU path at matrix_free_loop.json's size and on every label family at
    s = 6, Q3; then sweep_mfl_degree/input_0002 and sweep_mfl_cheby/
    input_0002 at their own size (67,108,864 DoFs, Q4), kernels A f32 and
    B timed at 64^3 Q4 before, between and after them.  No kernel takes a
    periodic mesh: A to F launched 0 times over the phase."""
    if 21 not in phases:
        return
    from dealii_asm_tpu_torch.kernels import launch_counts, reset_launch_counts

    print("== phase 21: matrix-free-loop benchmark (periodic meshes) on the "
          "card")
    reset_launch_counts()
    with open(MFL) as f:
        check_benchmark_small(json.load(f), "matrix_free_loop.json")
    check_benchmark_small(MFL_FAMILIES, "label families at s=6 Q3")
    yard = Yardstick()
    yard.time()
    for path in MFL_FULL:
        run_benchmark_full(path, yard)
    a_ms, b_ms, a_ns, b_ns = yard.per_dof_ns()
    print(f"  yardstick at 64^3 cells Q4 ({yard.n} DoFs, float32): kernel A "
          f"{a_ms:.4f} ms ({a_ns:.4f} ns per DoF; runs "
          f"{', '.join(f'{t:.4f}' for t in yard.a_ms)}), kernel B symm "
          f"{b_ms:.4f} ms ({b_ns:.4f} ns per DoF; runs "
          f"{', '.join(f'{t:.4f}' for t in yard.b_ms)})")
    got = launch_counts()
    print(f"  launch counts over phase 21: {json.dumps(got)}")
    launched = [k for k in KERNELS if got[k] != 0]
    if launched:
        raise Failed(f"kernels launched on periodic meshes: {launched}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="build and check the kernels at 2^3 cells only")
    ap.add_argument("--ptxas", action="store_true",
                    help="print registers and shared memory per kernel")
    ap.add_argument("--only", default=None,
                    help="comma-separated phases (9-25) to run after "
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
        check_cell_fdm([2] if args.quick else [2, 12, 48], results,
                       level_rows)
        check_tiles(range(1, 8), results)
        check_lanes([0] if args.quick else [0, 2, 4], range(1, 8), results)
        check_sweep([2] if args.quick else [16, 64], results)
        if not args.quick:
            print("== flagship solve on the card")
            run_solve(FLAGSHIP, 2, 4, 5, 16_974_593, FLAGSHIP_KERNELS, counts,
                      absent=("cell_fdm_patch",))
            print("== Kershaw solve on the card")
            run_solve(KERSHAW, 1, 38, 55, 7_189_057, KERSHAW_KERNELS, counts,
                      slack=1)
            print("== hyperball solve on the card")
            ball = run_solve(BALL, 1, 6, 7, 8_438_273, BALL_KERNELS, counts,
                             slack=1, check_vcycle=True)
            BALL_REF.update(solution=ball["solution"].cpu(), time=ball["time"])
            del ball
            run_ladder(counts)
            run_new_paths(counts, range(9, 25))
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
