"""Measurements of the port's solve on one GPU.

    python -m dealii_asm_tpu_torch.probe profile CONFIG.json [--refinements N]
    python -m dealii_asm_tpu_torch.probe sensitivity CONFIG.json --refinements N
    python -m dealii_asm_tpu_torch.probe setup CONFIG.json [--refinements N]

``profile``: ``run_config`` on the card, with ``torch.profiler`` over the
first timed solve (after the warm-up solve): device time by kernel name, the
solve's wall time, and the device's idle share 1 − busy/wall, busy being the
union of the kernels' intervals.

``sensitivity``: the CG iteration count, the last residuals over the
stopping threshold and the levels' Lanczos estimates of the largest
eigenvalue, on the CPU's plain path and on the card with the config's
Laplace kernel (E on Kershaw meshes, F on the hyperball) or its plain
version in each precision.  It shows how far the rounding of the float32
level operators moves the count when the last residual lies close to the
threshold.

``setup``: the host (NumPy) set-up stages of an unstructured (hyperball)
config, each summed over the meshes and levels the solve uses and timed on
its own (the tables are cached, so ``run_config`` computes each once), then
``run_config``'s whole setup on the card for comparison.

All print the card's name and power limit first; they need a GPU.
"""

from __future__ import annotations

import argparse
import copy
import json
import subprocess
import sys
import time

import torch

from .kernels import lanes_laplace as lanes
from .kernels import merged_laplace as merged
from .models import poisson
from .ops import laplace, laplace_general
from .precond.asm import element_fdm_collection
from .solvers import chebyshev
from .utils.config import get_child


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


def _laplace_kernel(params: dict):
    """(module, name, kernel, plain version, letter) of the Laplace apply
    that the config's operators call: F on the hyperball, else E.  The
    operator modules read the name when an operator is built (E) or applied
    (F)."""
    if params.get("mesh", {}).get("name") == "hyperball":
        return (laplace_general, "lanes_laplace", lanes.lanes_laplace,
                lanes.lanes_laplace_plain, "F")
    return (laplace, "merged_laplace", merged.merged_laplace,
            merged.merged_laplace_plain, "E")


def sensitivity(params: dict) -> None:
    params["print timing"] = False
    rel = float(params.get("solver", {}).get("rel tolerance", 1e-2))
    module, attr, kern, plain, letter = _laplace_kernel(params)

    def plain_in(dtypes):
        def kernel(u, t, rhs=None):
            return (plain if u.dtype in dtypes else kern)(u, t, rhs)
        return kernel

    variants = [("cpu", "plain", kern),
                ("cuda", f"kernel {letter} f64 + f32", kern),
                ("cuda", f"plain f64, kernel {letter} f32",
                 plain_in((torch.float64,))),
                ("cuda", f"kernel {letter} f64, plain f32",
                 plain_in((torch.float32,))),
                ("cuda", "plain f64 + f32",
                 plain_in((torch.float32, torch.float64)))]
    estimate = chebyshev.estimate_eigenvalues
    estimates = []

    def recorded(*args, **kwargs):
        info = estimate(*args, **kwargs)
        estimates.append(info.max_eigenvalue_estimate)
        return info

    chebyshev.estimate_eigenvalues = recorded
    try:
        for device, name, kernel in variants:
            setattr(module, attr, kernel)
            estimates.clear()
            res = poisson.run_config(copy.deepcopy(params), log=_quiet,
                                     device=device)
            h = res["residuals"]
            last = [round(r / (rel * h[0]), 4) for r in h[-3:]]
            print(f"{device:4s} {name:24s}: {res['it']} iterations; last "
                  f"residuals / threshold {last}; Lanczos largest "
                  f"eigenvalues {[f'{e:.9g}' for e in estimates]}")
    finally:
        setattr(module, attr, kern)
        chebyshev.estimate_eigenvalues = estimate


def setup(params: dict) -> None:
    family = poisson.make_mesh_family(params)
    if not isinstance(family, poisson.GeneralMeshFamily):
        raise SystemExit("probe setup: the stages timed are those of an "
                         "unstructured (hyperball) config")
    degree = int(params["degree"])
    precon_p = get_child(params, "preconditioner")
    levels, _ = poisson.mg_level_layout(precon_p, family, degree)
    meshes = range(family.n_levels)
    handlers = sorted(set(levels) | {(family.n_refinements, degree)})
    smoothed = levels[1:]  # every level but the coarse one has a smoother
    n_overlap = int(get_child(get_child(precon_p, "mg smoother"),
                              "preconditioner").get("n overlap", 1))

    def extents(r, p):
        return family.mesh_at(r).harmonic_patch_extents(p + 1)

    def fdm_keys(r, p):
        nbr = family.mesh_at(r).face_neighbors()
        return element_fdm_collection(extents(r, p), nbr[:, 0::2] >= 0,
                                      nbr[:, 1::2] >= 0, p, n_overlap)

    stages = [
        ("mesh refinement", meshes, family.mesh_at),
        ("face tables", meshes, lambda r: family.mesh_at(r).face_neighbors()),
        ("cell_dofs and boundary masks", handlers,
         lambda rp: (family.dofs_at(*rp).cell_dofs,
                     family.dofs_at(*rp).boundary_mask)),
        ("mapping support points (degree 2)", meshes,
         lambda r: family.mesh_at(r).cell_mapping_points(2)),
        ("harmonic patch extents", smoothed, lambda rp: extents(*rp)),
        ("FDM keys and 1D eigenproblems", smoothed, lambda rp: fdm_keys(*rp)),
    ]
    total = 0.0
    for name, items, fn in stages:
        t0 = time.perf_counter()
        for item in items:
            fn(item)
        dt = time.perf_counter() - t0
        total += dt
        print(f"host setup: {name:36s} {dt:9.3f} s over {len(items)} "
              f"{'meshes' if items is meshes else 'levels'}")
    print(f"host setup: {'sum of the stages above':36s} {total:9.3f} s")
    res = poisson.run_config(copy.deepcopy(params), log=_quiet, device="cuda")
    print(f"run_config on the card: setup {res['setup_time']:.3f} s, "
          f"{res['it']} iterations, solve {res['time']:.4f} s, "
          f"{res['n_dofs']} DoFs")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m dealii_asm_tpu_torch.probe")
    ap.add_argument("what", choices=("profile", "sensitivity", "setup"))
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
    {"profile": profile, "sensitivity": sensitivity,
     "setup": setup}[args.what](params)
    return 0


if __name__ == "__main__":
    sys.exit(main())
