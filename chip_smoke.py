#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dealii_asm_tpu_torch) on one GPU.

    python3 chip_smoke.py            # the whole check, one GPU
    python3 chip_smoke.py --quick    # build + kernel checks at 2^3 cells only

Phases, each of which must pass (the script exits non-zero otherwise):
1. toolchain: torch and its CUDA, nvcc, triton, the card's name and power
   limit;
2. build the kernels from dealii_asm_tpu_torch/kernels/csrc with nvcc;
3. every kernel against its plain PyTorch version on the card, on random
   inputs from a seed, at 2^3, 16^3 and 64^3 cells Q4 (A in float32 and
   float64; B and C also at p = 2), with kernel and plain times from CUDA
   events taken in turns (plain, kernel, kernel, plain);
4. the flagship solve (experiments/e2e_aniso_q4.json, 64^3 cells Q4,
   16,974,593 DoFs) through run_config on the card: converged in 5 CG
   iterations, with every kernel launched on that path; and the same config at
   2 refinements on the card against the plain CPU path.
The last two lines of standard output are the kernel table as JSON and the
result line {"ok": true, "device": {...}}.  Without a GPU, or without the
package beside the script, it exits non-zero and prints no result.
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
}

# Stated bounds on max|kernel - plain| / max|plain| (same inputs, same card):
# - A float64: 1e-12, only the summation order differs;
# - A float32: 1e-5, float32 rounding of 9-tap sums in another order;
# - B and C float32: 1e-4.  The plain version applies the folded dense
#   per-axis transforms G_d (the JAX global-FDM path), the kernel the per-cell
#   m x m transforms: the same float32 products in another order and
#   grouping.  Both are also held against the float64 plain version: the
#   kernel may not be worse than twice the plain float32 version (or 1e-4).
BOUNDS = {"banded_laplace_f32": 1e-5, "banded_laplace_f64": 1e-12,
          "fdm_patch": 1e-4, "smoother_step": 1e-4}


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


def check_kernels(cells_list, degrees_small, results):
    """Phase 3: each kernel vs its plain version on the card."""
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
            results.setdefault(name, {})[tag] = (abs_err, k_ms, p_ms)
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
            results.setdefault(name, {})[tag] = (
                float((got - ref).abs().max()), k_ms, p_ms)
        del op, asm, asm64, op64
        torch.cuda.empty_cache()


def run_flagship(counts):
    """Phase 4: the flagship solve on the card, through run_config."""
    import torch

    from dealii_asm_tpu_torch.kernels import launch_counts, reset_launch_counts
    from dealii_asm_tpu_torch.models.poisson import run_config

    with open(FLAGSHIP) as f:
        params = json.load(f)
    # the small case first: card vs the plain CPU path
    small = copy.deepcopy(params)
    small["n refinements"] = 2
    quiet = lambda *a: None
    r_gpu = run_config(small, log=quiet, device="cuda")
    r_cpu = run_config(small, log=quiet, device="cpu")
    xg = r_gpu["solution"].cpu()
    xc = r_cpu["solution"]
    rel = float((xg - xc).norm() / xc.norm())
    print(f"  2 refinements ({r_gpu['n_dofs']} DoFs): card {r_gpu['it']} its, "
          f"cpu {r_cpu['it']} its, rel l2 solution difference {rel:.3e} "
          "(bound 1e-6)")
    if not (r_gpu["converged"] and r_gpu["it"] == r_cpu["it"] == 4
            and rel <= 1e-6):
        raise Failed("small flagship case disagrees with the CPU path")

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    res = run_config(params, log=print, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts.update(launch_counts())
    x = res["solution"]
    finite = bool(torch.isfinite(x).all())
    print(f"  flagship: {res['n_dofs']} DoFs, converged={res['converged']}, "
          f"it={res['it']}, setup {res['setup_time']:.3f} s, best-of-3 solve "
          f"{res['time']:.4f} s, run_config wall {wall:.3f} s, "
          f"peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"  launch counts on the main path: {json.dumps(counts)}")
    if x.shape != (16_974_593,) or x.dtype != torch.float64 or not finite:
        raise Failed(f"solution: shape {tuple(x.shape)}, {x.dtype}, "
                     f"finite={finite}")
    if not (res["converged"] and res["it"] == 5):
        raise Failed(f"flagship: converged={res['converged']}, it={res['it']}")
    missing = [k for k, v in counts.items() if v <= 0]
    if missing:
        raise Failed(f"kernels not launched on the main path: {missing}")
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
        cells = [2] if args.quick else [2, 16, 64]
        check_kernels(cells, [2, 4], results)
        if not args.quick:
            print("== flagship solve on the card")
            run_flagship(counts)
    except Failed as e:
        print(f"FAIL: {e}")
        return 1
    if args.quick:
        print("quick check passed (the full check prints the result line)")
        return 0

    big = [k for k in results["fdm_patch"] if k.startswith("64^3")][0]
    table = []
    for name, (src, repl) in KERNELS.items():
        abs_err, k_ms, p_ms = results[name][big]
        table.append({"name": name, "route": "cuda", "source": src,
                      "replaces": repl, "launches": counts[name],
                      "max_abs_err": abs_err, "ms": k_ms, "plain_ms": p_ms})
    print(smi)
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
