#!/usr/bin/env python3
"""Time kernel variants at 64^3 cells Q4 on one GPU: tile shapes of kernels
A, B and C, with kernel D's sweep (A's residual and B's momentum step per
sub-step) at Q4 and Q2 beside them; or, with ``ef`` first, variants of the
cell body of kernels E and F.

    python3 tools/tile_sweep.py                # the A variants
    python3 tools/tile_sweep.py plan c4x4      # some variants by name
    python3 tools/tile_sweep.py all            # every variant below
    python3 tools/tile_sweep.py plan --parent DIR   # beside another checkout
    python3 tools/tile_sweep.py ef             # E and F: plan, skeleton, ...
    python3 tools/tile_sweep.py ef plan --parent DIR
    python3 tools/tile_sweep.py g              # kernel G's float32 tiles
    python3 tools/tile_sweep.py g plan q4_8x8  # some of them by name

In ``ef`` mode each variant times kernel E in float64 and float32 on the
Kershaw mesh (eps 0.3, mapping degree 3) at 48^3 cells Q4, Q2 and Q1 (the
Kershaw levels) and kernel F in both precisions on the balanced hyperball
at 131,072 cells Q4, and prints each output's max relative difference from
its plain version (the variants sum in other orders, so outputs are not
compared bit for bit).  ``skeleton`` is the memory skeleton: the same
launches with every 1D contraction replaced by the identity, so the
coefficients and u are still read, pass through the shared-memory round
trips and are summed into the output, but no table multiply is left; its
time is the floor the body is held to.  ``warpPxN`` runs degree P with
one cell a warp and N cells (warps) a block, ``packedPxN`` packs the lines
of N cells into a block (block barriers), both precisions alike unless
the variant says otherwise; ``bounds6`` holds float64 p = 4 to 6 blocks
an SM; ``prefetch`` loads the coefficients before the cell's values and
``gathers`` unrolls the node gather and the DoF scatter.  The ball's DoF
tables are built once (about 40 s of host NumPy) and handed to
every variant's process.

In ``g`` mode each variant builds only kernel G (``cell_fdm_patch.cu``),
with one float32 tile of one m changed (``q4_8x8``: m = 5, 8 x 8 cells);
one process builds the Kershaw tables (eps 0.3, 48^3 cells, Q4, Q2 and
Q1, symm) once, loads every variant's library side by side and times
each level in every variant twice in turns (CUDA events over calls and
over replays of a CUDA graph of one call), with its max relative
difference from the plain apply.

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

CELL = "sumfac_cell.cuh"
PLAN_E4 = ("      return itemsize == 8 ? CellShape{1, 4, 128} : "
           "CellShape{0, 5, 125};")
PLAN_E1 = "    case 1: return {8, 64, 256};"


def _e4(f64, f32=None):  # E's and F's p = 4 shapes (cpw, cells, threads)
    return [(CELL, PLAN_E4, "      return itemsize == 8 ? CellShape{%d, %d, "
             "%d} : CellShape{%d, %d, %d};" % (*f64, *(f32 or f64)))]


def _e1(shape):  # E's and F's p = 1 shape
    return [(CELL, PLAN_E1, "    case 1: return {%d, %d, %d};" % shape)]


# float64 p = 4 held to 6 blocks an SM (85 registers a thread)
BOUNDS6 = [(f, "__launch_bounds__(CellConfig<T, P>::NT)",
            "__launch_bounds__(CellConfig<T, P>::NT, "
            "sizeof(T) == 8 && P == 4 ? 6 : 1)")
           for f in ("merged_laplace.cu", "lanes_laplace.cu")]


# the 1D contractions of sumfac_cell.cuh, each replaced by the identity
SKELETON = [
    (CELL, "acc += A[q][s] * in[q] + B[q][s] * in2[q];",
     "acc += q == s ? in[q] + in2[q] : T(0);"),
    (CELL, "acc += A[q][s] * in[s];", "acc += q == s ? in[s] : T(0);"),
    (CELL, "acc += A[q][s] * in[q];", "acc += q == s ? in[q] : T(0);"),
]
# the coefficients loaded before the cell's values, not in the z stage
PREFETCH = [
    (CELL, "    coeff_load(cf, cc, li, live);\n", ""),
    (CELL, "  T cf[6][M];  // loaded in the z stage\n",
     "  T cf[6][M];\n  if (active) coeff_load(cf, cc, li, live);\n"),
]
# kernel E's node gather and F's DoF scatter with their (at most 8, or
# the first 8) loads unrolled and predicated, in the same summation order
GATHERS = [
    ("merged_laplace.cu", """    for (int a = 0; a < nz; ++a)
      for (int b = 0; b < ny; ++b)
        for (int e = 0; e < nx; ++e) {
          const size_t cell =""", """#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 2; ++b)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (a < nz && b < ny && e < nx) {
          const size_t cell ="""),
    ("lanes_laplace.cu", "    for (int k = b; k < e; ++k) v += vcell[slots[k]];",
     """#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (k < e - b) v += vcell[slots[b + k]];
    for (int k = b + 8; k < e; ++k) v += vcell[slots[k]];"""),
]
EF_VARIANTS = {
    "plan": [],
    "skeleton": SKELETON,
    "warp4x8": _e4((1, 8, 256)),       # one cell a warp, 8 a block
    "warp4x4": _e4((1, 4, 128)),
    "warp4x2": _e4((1, 2, 64)),
    "warp4x16": _e4((1, 16, 512)),
    "packed4x10": _e4((0, 10, 250)),   # lines packed across 10 cells
    "packed4x5": _e4((0, 5, 125)),
    "packed4x3": _e4((1, 4, 128), (0, 3, 75)),
    "bounds6": BOUNDS6,
    "q1x32": _e1((8, 32, 128)),
    "q1x16": _e1((8, 16, 64)),
    "prefetch": PREFETCH,
    "gathers": GATHERS,
}
EF_DEFAULT = ("plan", "skeleton", "warp4x8", "packed4x10")

# kernel G: one float32 tile (tx, ty, cz, threads) of one m
G_SRC = "cell_fdm_patch.cu"
G_PLAN = "constexpr TileShape cell_tile_shape(int m, int itemsize) {\n"


def _g(m, tile):
    return [(G_SRC, G_PLAN, G_PLAN + "  if (itemsize == 4 && m == %d) "
             "return {%d, %d, %d, %d};\n" % (m, *tile))]


G_CHUNK = ("  const int chunk = cell_chunk_layers(tx * ty, t.Cz, C::CZ, "
           "C::MINB);\n")
G_MINB = "  static constexpr int MINB = min_blocks(BYTES, NT);\n"


def _gc(m, cz):  # kernel G's float32 chunk at m fixed to cz layers
    return [(G_SRC, G_CHUNK, G_CHUNK.replace(
        "= cell_chunk_layers", "= sizeof(T) == 4 && M == %d ? %d : "
        "cell_chunk_layers" % (m, cz)))]


def _gb(m, minb):  # kernel G's float32 blocks an SM at m (launch bounds)
    return [(G_SRC, G_MINB, G_MINB.replace(
        "= min_blocks", "= sizeof(T) == 4 && M == %d ? %d : min_blocks"
        % (m, minb)))]


G_VARIANTS = {
    "plan": [],
    "q4_cz8": _gc(5, 8),  # B's chunk rule at 48^3
    "q4_4x4": _g(5, (4, 4, 16, 256)),
    "q4_4x4cz8": _g(5, (4, 4, 16, 256)) + _gc(5, 8),
    "q4_8x8": _g(5, (8, 8, 16, 512)),
    "q4_minb2": _gb(5, 2),
    "q4_4x4x128": _g(5, (4, 4, 16, 128)),
    "q2_8x8": _g(3, (8, 8, 16, 256)),
    "q2_cz2": _gc(3, 2),  # B's chunk rule at 48^3
    "q2_8x4": _g(3, (8, 4, 16, 128)),
    "q1_8x8": _g(2, (8, 8, 16, 128)),
    "q1_cz2": _gc(2, 2),
}
G_SYMBOLS = ("dat_cell_fdm_patch", "dat_cell_tile_plan")
G_BUILD = ("import sys; sys.path.insert(0, sys.argv[1]); "
           "from dealii_asm_tpu_torch.kernels import build; "
           f"build.SOURCES = ({G_SRC!r},); "
           "build.SIGNATURES = {k: v for k, v in build.SIGNATURES.items() "
           f"if k.startswith({G_SYMBOLS!r})}}; print(build.build())")


def g_sweep(libs: dict) -> None:
    """Kernel G's variants (name -> library path) at the Kershaw levels,
    twice in turns, in this process."""
    import ctypes

    import torch

    sys.path.insert(0, ROOT)
    from dealii_asm_tpu_torch.fem.dofs import DofHandler
    from dealii_asm_tpu_torch.kernels.build import SIGNATURES
    from dealii_asm_tpu_torch.mesh.grid import StructuredMesh
    from dealii_asm_tpu_torch.mesh.transforms import kershaw_transform
    from dealii_asm_tpu_torch.precond.asm import CellASMPreconditioner

    fns = {}
    for n, path in libs.items():
        fn = ctypes.CDLL(path).dat_cell_fdm_patch_f32
        fn.argtypes = SIGNATURES["dat_cell_fdm_patch_f32"]
        fn.restype = ctypes.c_int
        fns[n] = fn
    levels = {}
    for p in (4, 2, 1):
        dofs = DofHandler(StructuredMesh(
            3, (48, 48, 48), transform=kershaw_transform(0.3, 0.3)), p)
        asm = CellASMPreconditioner(dofs, weighting_type="symm",
                                    dtype=torch.float32, device="cuda")
        x = torch.randn(dofs.n_dofs, device="cuda")
        levels[p] = (asm.cell_tables, x, asm.vmult_plain(x).double(),
                     torch.empty_like(x))
    def call(fn, t, x, out):
        ptrs = [v.data_ptr() for v in (*t.V, t.lam, *t.fin, *t.fout)]
        return lambda: fn(x.data_ptr(), out.data_ptr(), *ptrs, *t.cells, t.p,
                          torch.cuda.current_stream().cuda_stream)

    def ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        for _ in range(reps):
            fn()
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e) / reps

    for rnd in range(2):
        for n, fn in fns.items():
            line = []
            for p, (t, x, ref, out) in levels.items():
                run = call(fn, t, x, out)
                if run() != 0:
                    line.append(f"Q{p} launch failed")
                    continue
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    run()
                rel = float((out.double() - ref).abs().max() / ref.abs().max())
                line.append(f"Q{p} {ms(run, 100):.4f} ms, graph "
                            f"{ms(graph.replay, 300):.4f} ms, rel {rel:.1e}")
            print(f"round {rnd} {n}: " + "; ".join(line), flush=True)


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


EF_CHILD = r'''
import json, pickle, sys
import torch
sys.path.insert(0, sys.argv[1])
from dealii_asm_tpu_torch.fem.dofs import DofHandler
from dealii_asm_tpu_torch.kernels.lanes_laplace import (lanes_laplace,
                                                        lanes_laplace_plain)
from dealii_asm_tpu_torch.kernels.merged_laplace import (merged_laplace,
                                                         merged_laplace_plain)
from dealii_asm_tpu_torch.mesh.grid import StructuredMesh
from dealii_asm_tpu_torch.mesh.transforms import kershaw_transform
from dealii_asm_tpu_torch.ops.laplace import LaplaceOperator
from dealii_asm_tpu_torch.ops.laplace_general import GeneralLaplaceOperator


def ms(fn, reps=None):
    """CUDA-event ms a call over about 30 ms of back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    if reps is None:
        reps = max(50, min(3000, int(30 / ms(fn, 10))))
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def graph_ms(fn):
    """Device ms a call without the host's launch cost: one call captured
    in a CUDA graph, replayed."""
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        return ms(graph.replay)
    except RuntimeError as err:
        print(f"graph capture failed: {err}", file=sys.stderr)
        return None


def split(fn):
    """Device us a call of each kernel fn launches (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = ev.cuda_time_total
        for name in ("cells_kernel", "gather_kernel", "scatter_kernel"):
            if name in ev.key and us:
                out[name] = us / 10
    return out


def rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max())


g = torch.Generator(device="cuda").manual_seed(1)
out = {}
for p in (4, 2, 1):
    dofs = DofHandler(StructuredMesh(3, (48, 48, 48),
                                     transform=kershaw_transform(0.3, 0.3)), p)
    x64 = torch.randn(dofs.n_dofs, device="cuda", dtype=torch.float64,
                      generator=g)
    for dt, tag in ((torch.float64, "f64"), (torch.float32, "f32")):
        op = LaplaceOperator(dofs, dtype=dt, device="cuda", mapping_degree=3)
        x = x64.to(dt)
        key = f"E_{tag}_q{p}"
        out[key + "_ms"] = ms(lambda: merged_laplace(x, op.tables))
        out[key + "_graph_ms"] = graph_ms(lambda: merged_laplace(x, op.tables))
        if p == 4:
            out[key + "_split_us"] = split(lambda: merged_laplace(x, op.tables))
        out[key + "_rel_err"] = rel(merged_laplace(x, op.tables),
                                    merged_laplace_plain(x, op.tables))
        del op
        torch.cuda.empty_cache()
from dealii_asm_tpu_torch.fem.general_dofs import GeneralDofHandler
from dealii_asm_tpu_torch.mesh.unstructured import hyper_ball_balanced
mesh = hyper_ball_balanced(3)
for _ in range(4):
    mesh = mesh.refine()
dofs = GeneralDofHandler.__new__(GeneralDofHandler)
with open(sys.argv[3], "rb") as f:
    dofs.__dict__.update(pickle.load(f))
object.__setattr__(dofs, "mesh", mesh)  # a frozen dataclass
x64 = torch.randn(dofs.n_dofs, device="cuda", dtype=torch.float64,
                  generator=g)
for dt, tag in ((torch.float64, "f64"), (torch.float32, "f32")):
    op = GeneralLaplaceOperator(dofs, dtype=dt, device="cuda")
    x = x64.to(dt)
    out[f"F_{tag}_q4_ms"] = ms(lambda: lanes_laplace(x, op.tables))
    out[f"F_{tag}_q4_graph_ms"] = graph_ms(lambda: lanes_laplace(x, op.tables))
    out[f"F_{tag}_q4_split_us"] = split(lambda: lanes_laplace(x, op.tables))
    out[f"F_{tag}_q4_rel_err"] = rel(lanes_laplace(x, op.tables),
                                     lanes_laplace_plain(x, op.tables))
    del op
    torch.cuda.empty_cache()
print("RESULT " + json.dumps(out))
'''


def ball_tables() -> str:
    """The ball's Q4 DoF handler at 4 refinements (131,072 cells), pickled
    once for every variant's process."""
    import pickle

    sys.path.insert(0, ROOT)
    from dealii_asm_tpu_torch.fem.general_dofs import GeneralDofHandler
    from dealii_asm_tpu_torch.mesh.unstructured import hyper_ball_balanced

    path = os.path.join(WORK, "ball_q4.pkl")
    mesh = hyper_ball_balanced(3)
    for _ in range(4):
        mesh = mesh.refine()
    dofs = GeneralDofHandler(mesh, 4)
    dofs.cell_dofs, dofs.boundary_mask, dofs.n_dofs  # the cached tables
    with open(path, "wb") as f:  # the mesh holds a closure: rebuilt there
        pickle.dump({k: v for k, v in vars(dofs).items() if k != "mesh"}, f)
    return path


def make(name: str, variants=VARIANTS) -> str:
    """A copy of the package with the variant's edits."""
    d = os.path.join(WORK, name)
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "dealii_asm_tpu_torch"),
                    os.path.join(d, "dealii_asm_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    csrc = os.path.join(d, "dealii_asm_tpu_torch", "kernels", "csrc")
    for fname, old, new in variants[name]:
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
    ef = argv[:1] == ["ef"]
    g = argv[:1] == ["g"]
    if ef or g:
        argv = argv[1:]
    variants = EF_VARIANTS if ef else G_VARIANTS if g else VARIANTS
    names = ((list(variants) if argv == ["all"] or (g and not argv) else argv)
             or list(EF_DEFAULT if ef else DEFAULT))
    os.makedirs(WORK, exist_ok=True)
    dirs = {n: make(n, variants) for n in names}
    if g:
        t0 = time.perf_counter()
        procs = {n: subprocess.Popen([sys.executable, "-c", G_BUILD, d],
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)
                 for n, d in dirs.items()}
        libs = {}
        for n, proc in procs.items():
            log = proc.communicate()[0]
            if proc.returncode != 0:
                print(f"{n}: build failed\n{log[-3000:]}", flush=True)
            else:
                libs[n] = log.strip().splitlines()[-1]
        print(f"built {len(libs)} variants of kernel G in "
              f"{time.perf_counter() - t0:.1f} s")
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip())
        g_sweep(libs)
        return 0
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
    if ef:
        t0 = time.perf_counter()
        ball = ball_tables()
        print(f"ball DoF tables built in {time.perf_counter() - t0:.1f} s")
    c_out = {n: os.path.join(WORK, f"{n}_C.pt") for n in dirs}
    for _ in range(2):
        for n, d in dirs.items():
            cmd = ([sys.executable, "-c", EF_CHILD, d, "-", ball] if ef
                   else [sys.executable, "-c", CHILD, d, c_out[n]])
            out = subprocess.run(cmd, capture_output=True, text=True)
            line = [x for x in out.stdout.splitlines()
                    if x.startswith("RESULT ")]
            edits = ("; ".join(new.strip().splitlines()[-1].strip()
                               for _, _, new in variants[n] if new.strip())
                     if n in variants else d) or "as planned"
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
