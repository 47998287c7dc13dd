#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dealii_asm_tpu_torch) on one GPU.

    python3 chip_smoke.py            # the whole check, one GPU
    python3 chip_smoke.py --quick    # build + kernel checks at 2^3 cells only

Phases, each of which must pass (the script exits non-zero otherwise):
1. toolchain: torch and its CUDA, nvcc, triton, the card's name and power
   limit;
2. build the kernels from dealii_asm_tpu_torch/kernels/csrc with nvcc;
3. every kernel against its plain PyTorch version on the card, on random
   inputs from a seed, with kernel and plain times from CUDA events taken in
   turns (plain, kernel, kernel, plain):
   - A (float32 and float64), B and C on Cartesian meshes at 2^3, 16^3 and
     64^3 cells Q4 (B and C also at p = 2);
   - E (float64 and float32) on Kershaw meshes (eps 0.3, mapping degree 3)
     at 2^3, 12^3 and 48^3 cells Q4 and at p = 1 and 2, in its vmult and
     residual modes, repeated runs bit-identical;
   - F (float64 and float32) on the balanced hyperball (mapping degree 2)
     at 32, 2,048 and 131,072 cells Q4 and at p = 1 and 2 (2,048 cells), in
     its vmult and residual modes, repeated runs bit-identical;
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
   within one).
The launch counts of each solve are set to 0 just before it and read just
after.  The last two lines of standard output are the kernel table as JSON
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
}
# the solve whose run_config launches each kernel
FLAGSHIP_KERNELS = ("banded_laplace_f32", "banded_laplace_f64", "fdm_patch",
                    "smoother_step")
KERSHAW_KERNELS = ("merged_laplace_f64", "merged_laplace_f32")
BALL_KERNELS = ("lanes_laplace_f64", "lanes_laplace_f32")
# the largest shape each kernel's solve gives it (the kernels line reports it)
MAIN_SHAPE = dict.fromkeys(FLAGSHIP_KERNELS, "64^3 cells Q4")
MAIN_SHAPE.update(dict.fromkeys(KERSHAW_KERNELS, "48^3 cells Q4"))
MAIN_SHAPE.update(dict.fromkeys(BALL_KERNELS, "131072 cells Q4"))

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
BOUNDS = {"banded_laplace_f32": 1e-5, "banded_laplace_f64": 1e-12,
          "fdm_patch": 1e-4, "smoother_step": 1e-4,
          "merged_laplace_f64": 1e-12, "merged_laplace_f32": 1e-5,
          "lanes_laplace_f64": 1e-12, "lanes_laplace_f32": 1e-5}


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
        del op, asm, asm64, op64
        torch.cuda.empty_cache()


def check_merged(cells_list, degrees_small, results):
    """Phase 3: kernel E (both precisions) vs its plain version on Kershaw
    meshes."""
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
    cases = [(c, 4) for c in cells_list] + [(small, p) for p in degrees_small]
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
            abs_err = float((merged_laplace(x, op.tables)
                             - merged_laplace_plain(x, op.tables)).abs().max())
            k_ms, p_ms = in_turns(lambda: merged_laplace_plain(x, op.tables),
                                  lambda: merged_laplace(x, op.tables), reps)
            print_time(tag, n, k_ms, p_ms)
            work = merged_work(c ** 3, n, p, x.element_size())
            results.setdefault(name, {})[tag] = (
                abs_err, k_ms, p_ms, bound(*work, x.element_size()))
            del op
            torch.cuda.empty_cache()


def check_lanes(refinements, degrees_small, results):
    """Phase 3: kernel F (both precisions) vs its plain version on the
    balanced hyperball."""
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
    cases = [(r, 4) for r in refinements] + [(small, p) for p in degrees_small]
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
            abs_err = float((lanes_laplace(x, op.tables)
                             - lanes_laplace_plain(x, op.tables)).abs().max())
            k_ms, p_ms = in_turns(lambda: lanes_laplace_plain(x, op.tables),
                                  lambda: lanes_laplace(x, op.tables), reps)
            print_time(tag, n, k_ms, p_ms)
            work = lanes_work(c, n, p, x.element_size())
            results.setdefault(name, {})[tag] = (
                abs_err, k_ms, p_ms, bound(*work, x.element_size()))
            del op
            torch.cuda.empty_cache()


def run_solve(path: str, n_small: int, it_small: int, it_full: int,
              n_dofs: int, kernels, counts, slack: int = 0,
              check_vcycle: bool = False):
    """Phase 4 or 5: one config through run_config on the card, first at
    ``n_small`` refinements against the plain CPU path, then at full size
    with the launch counts set to 0 just before and read just after.

    The small case holds the CPU path to ``it_small`` (the JAX package's
    count), the card's solution to rel-l2 1e-6 of the CPU's, the first 20
    residuals of the card's CG history to rel 1e-4 of the CPU's, and the
    card's count to within ``slack`` of the CPU's.  The Kershaw case allows
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
    name = os.path.basename(path)
    small = copy.deepcopy(params)
    small["n refinements"] = n_small
    small["print timing"] = False
    small["solver"]["best of"] = 1
    quiet = lambda *a: None
    r_gpu = run_config(copy.deepcopy(small), log=quiet, device="cuda")
    r_cpu = run_config(copy.deepcopy(small), log=quiet, device="cpu")
    xg = r_gpu["solution"].cpu()
    xc = r_cpu["solution"]
    rel = float((xg - xc).norm() / xc.norm())
    hg, hc = r_gpu["residuals"][:21], r_cpu["residuals"][:21]
    hist = max(abs(a - b) / b for a, b in zip(hg, hc))
    thr = float(small["solver"]["rel tolerance"]) * hc[0]
    last = lambda h: [round(r / thr, 4) for r in h[-2:]]
    print(f"  {name} at {n_small} refinements ({r_gpu['n_dofs']} DoFs): card "
          f"{r_gpu['it']} its, cpu {r_cpu['it']} its (expected {it_small}), "
          f"rel l2 solution difference {rel:.3e} (bound 1e-6), first 20 "
          f"residuals agree to {hist:.2e} (bound 1e-4); last residuals / "
          f"threshold: card {last(r_gpu['residuals'])}, cpu "
          f"{last(r_cpu['residuals'])}")
    if not (r_cpu["converged"] and r_cpu["it"] == it_small
            and r_gpu["converged"] and rel <= 1e-6 and hist <= 1e-4
            and abs(r_gpu["it"] - r_cpu["it"]) <= slack):
        raise Failed(f"{name} at {n_small} refinements disagrees with the "
                     "CPU path")

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    res = run_config(params, log=print, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = launch_counts()
    counts.update({k: got[k] for k in kernels})
    x = res["solution"]
    finite = bool(torch.isfinite(x).all())
    print(f"  {name}: {res['n_dofs']} DoFs, converged={res['converged']}, "
          f"it={res['it']}, setup {res['setup_time']:.3f} s, best-of-3 solve "
          f"{res['time']:.4f} s, run_config wall {wall:.3f} s, "
          f"peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    thr = float(params["solver"]["rel tolerance"]) * res["residuals"][0]
    print(f"  last residuals / threshold: "
          f"{[round(r / thr, 4) for r in res['residuals'][-2:]]}")
    print(f"  launch counts on this path: {json.dumps(got)}")
    if x.shape != (n_dofs,) or x.dtype != torch.float64 or not finite:
        raise Failed(f"{name} solution: shape {tuple(x.shape)}, {x.dtype}, "
                     f"finite={finite}")
    if not (res["converged"] and res["it"] == it_full):
        raise Failed(f"{name}: converged={res['converged']}, it={res['it']}, "
                     f"expected {it_full}")
    missing = [k for k in kernels if got[k] <= 0]
    if missing:
        raise Failed(f"kernels not launched on the {name} path: {missing}")
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="build and check the kernels at 2^3 cells only")
    ap.add_argument("--ptxas", action="store_true",
                    help="print registers and shared memory per kernel")
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

    results, counts = {}, {}
    try:
        print("== build")
        t0 = time.perf_counter()
        build.load(verbose=args.ptxas)
        print(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s "
              f"(nvcc {build.last_build_seconds or 0.0:.1f} s)")
        print("== kernels vs plain PyTorch on the card")
        check_kernels([2] if args.quick else [2, 16, 64], [2, 4], results)
        check_merged([2] if args.quick else [2, 12, 48], [1, 2], results)
        check_lanes([0] if args.quick else [0, 2, 4], [1, 2], results)
        if not args.quick:
            print("== flagship solve on the card")
            run_solve(FLAGSHIP, 2, 4, 5, 16_974_593, FLAGSHIP_KERNELS, counts)
            print("== Kershaw solve on the card")
            run_solve(KERSHAW, 1, 38, 55, 7_189_057, KERSHAW_KERNELS, counts,
                      slack=1)
            print("== hyperball solve on the card")
            run_solve(BALL, 1, 6, 7, 8_438_273, BALL_KERNELS, counts, slack=1,
                      check_vcycle=True)
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
    print(smi)
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
