"""Measurements of the port's solve on one GPU.

    python -m dealii_asm_tpu_torch.probe profile CONFIG.json [--refinements N]
    python -m dealii_asm_tpu_torch.probe sensitivity CONFIG.json --refinements N

``profile``: ``run_config`` on the card, with ``torch.profiler`` over the
first timed solve (after the warm-up solve): device time by kernel name, the
solve's wall time, and the device's idle share 1 − busy/wall, busy being the
union of the kernels' intervals.

``sensitivity``: the CG iteration count, the last residuals over the
stopping threshold and the levels' Lanczos estimates of the largest
eigenvalue, on the CPU's plain path and on the card with kernel E or its
plain version in each precision.  It shows how far the rounding of the
float32 level operators moves the count when the last residual lies close
to the threshold.

Both print the card's name and power limit first; they need a GPU.
"""

from __future__ import annotations

import argparse
import copy
import json
import subprocess
import sys
import time

import torch

from .kernels import merged_laplace as merged
from .models import poisson
from .ops import laplace
from .solvers import chebyshev


def _quiet(*_):
    pass


def _load(path: str, refinements: int | None) -> dict:
    with open(path) as f:
        params = json.load(f)
    if refinements is not None:
        params["n refinements"] = refinements
    params["print timing"] = True
    params.setdefault("solver", {})["best of"] = 1
    return params


def _busy_us(events) -> float:
    """Length of the union of the device kernels' intervals (µs)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def profile(params: dict, rows: int = 25) -> None:
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    state = {}
    solve = poisson.krylov_solve

    def second_solve_profiled(*args, **kwargs):
        state["calls"] = state.get("calls", 0) + 1
        if state["calls"] != 2:
            return solve(*args, **kwargs)
        torch.cuda.synchronize()
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            result = solve(*args, **kwargs)
            torch.cuda.synchronize()
            state["wall"] = time.perf_counter() - t0
        state["prof"] = prof
        return result

    poisson.krylov_solve = second_solve_profiled
    try:
        res = poisson.run_config(params, log=_quiet, device="cuda")
    finally:
        poisson.krylov_solve = solve
    prof, wall = state["prof"], state["wall"]
    busy = _busy_us(prof.events()) * 1e-6
    print(f"{res['n_dofs']} DoFs, {res['it']} iterations, profiled solve "
          f"{wall:.4f} s, device busy {busy:.4f} s, idle share "
          f"{1.0 - busy / wall:.3f}")
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=rows))


def sensitivity(params: dict) -> None:
    params["print timing"] = False
    rel = float(params.get("solver", {}).get("rel tolerance", 1e-2))

    def plain_in(dtypes):
        def kernel(u, t, rhs=None):
            fn = (merged.merged_laplace_plain if u.dtype in dtypes
                  else merged.merged_laplace)
            return fn(u, t, rhs)
        return kernel

    variants = [("cpu", "plain", merged.merged_laplace),
                ("cuda", "kernel E f64 + f32", merged.merged_laplace),
                ("cuda", "plain f64, kernel E f32", plain_in((torch.float64,))),
                ("cuda", "kernel E f64, plain f32", plain_in((torch.float32,))),
                ("cuda", "plain f64 + f32",
                 plain_in((torch.float32, torch.float64)))]
    estimate = chebyshev.estimate_eigenvalues
    estimates = []

    def recorded(*args, **kwargs):
        info = estimate(*args, **kwargs)
        estimates.append(info.min_eigenvalue_estimate)
        return info

    chebyshev.estimate_eigenvalues = recorded
    try:
        for device, name, kernel in variants:
            laplace.merged_laplace = kernel  # read when an operator is built
            estimates.clear()
            res = poisson.run_config(copy.deepcopy(params), log=_quiet,
                                     device=device)
            h = res["residuals"]
            last = [round(r / (rel * h[0]), 4) for r in h[-3:]]
            print(f"{device:4s} {name:24s}: {res['it']} iterations; last "
                  f"residuals / threshold {last}; Lanczos largest "
                  f"eigenvalues {[f'{e:.9g}' for e in estimates]}")
    finally:
        laplace.merged_laplace = merged.merged_laplace
        chebyshev.estimate_eigenvalues = estimate


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m dealii_asm_tpu_torch.probe")
    ap.add_argument("what", choices=("profile", "sensitivity"))
    ap.add_argument("config")
    ap.add_argument("--refinements", type=int, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe: torch.cuda.is_available() is False; it needs a GPU",
              file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"gpu: {smi}")
    params = _load(args.config, args.refinements)
    (profile if args.what == "profile" else sensitivity)(params)
    return 0


if __name__ == "__main__":
    sys.exit(main())
