"""Measurements of the port's solve on one GPU.

    python -m dealii_asm_tpu_torch.probe profile CONFIG.json [--refinements N]
                                                 [--solver TYPE]
    python -m dealii_asm_tpu_torch.probe sensitivity CONFIG.json --refinements N
    python -m dealii_asm_tpu_torch.probe setup CONFIG.json [--refinements N]
    python -m dealii_asm_tpu_torch.probe ladder [SPEC ...] [--best-of N]
                                                [--device cuda|cpu]

``profile``: ``run_config`` on the card, with ``torch.profiler`` over the
first timed solve (after the warm-up solve): device time by kernel name, the
solve's wall time, the device's idle share 1 − busy/wall, busy being the
union of the kernels' intervals, and the number of device operations
(kernels, copies, fills) the solve issued; then each of the port's own
kernels (one line per instantiation) with its launches and device ms.  The
warm-up solve runs under ``torch.cuda.set_sync_debug_mode("warn")``, which
warns once per call that waits for the device: their count over the
iterations is the host syncs per iteration.  ``--solver`` replaces the
config's "solver"/"type" (FCG, FGMRES, Bicgstab, IDR, Richardson, ...).

``sensitivity``: the iteration count, the last residuals over the
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

``ladder``: the large-scaling ladder, the counterpart of
``experiments/run_large_scaling.py``.  Each SPEC is ``smoother:rmin[-rmax]``
with smoother diag, fdm1, fdm2 or fdmv; each rung reads its config from
``experiments/sweep_large_scaling/`` (anisotropy stretch 50, Q4,
hp-multigrid) and prints one JSON record to standard output, with the keys
of the JAX script's records (the outer solve is float64) plus the setup
seconds, the device, and on the card the peak device memory and the kernel
launches of the rung.  Default plan: fdm1:0-7 diag:7 fdm2:7 fdmv:7.  A rung
whose options are not ported, that has a level without vertex patches (the
fdmv column: the hp layout puts p-levels on the 1-cell mesh, where the JAX
package raises too), or that runs out of device memory, records the error
and the ladder goes on; any other error stops it.

All print the card's name and power limit first; all but ``ladder
--device cpu`` need a GPU.
"""

from __future__ import annotations

import argparse
import copy
import json
import re
import subprocess
import sys
import time
import warnings
from pathlib import Path

import torch

from . import kernels
from .kernels import lanes_laplace as lanes
from .kernels import merged_laplace as merged
from .models import poisson
from .ops import laplace, laplace_general
from .precond.asm import element_fdm_collection
from .precond.fdm import NoVertexPatches
from .solvers import chebyshev
from .utils.config import get_child


def _quiet(*_):
    pass


def _load(path: str, refinements: int | None,
          solver: str | None = None) -> dict:
    with open(path) as f:
        params = json.load(f)
    if refinements is not None:
        params["n refinements"] = refinements
    if solver is not None:
        params.setdefault("solver", {})["type"] = solver
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
        if state["calls"] == 1:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    result = solve(*args, **kwargs)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            state["syncs"] = sum("synchroniz" in str(w.message)
                                 for w in caught)
            return result
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
    n_dev = sum(e.device_type == torch.autograd.DeviceType.CUDA
                for e in prof.events())
    print(f"{res['n_dofs']} DoFs, {res['it']} iterations, profiled solve "
          f"{wall:.4f} s, device busy {busy:.4f} s, idle share "
          f"{1.0 - busy / wall:.3f}, {n_dev} device operations")
    print(f"host syncs in the warm-up solve: {state['syncs']}, "
          f"{state['syncs'] / max(res['it'], 1):.2f} per iteration")
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=rows))
    # the port's own kernels in full (the table cuts their names and rows)
    for ev in prof.key_averages():
        m = re.search(r"dat::\(anonymous namespace\)::(\w+(<[^>]*>)?)", ev.key)
        if m:
            print(f"kernel {m[1]}: {ev.count} launches, "
                  f"{ev.self_device_time_total / 1e3:.3f} ms")


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


LADDER_DIR = (Path(__file__).resolve().parent.parent / "experiments"
              / "sweep_large_scaling")
LADDER_COLUMN = {"diag": 0, "fdm1": 1, "fdm2": 2, "fdmv": 3}


def ladder_config(smoother: str, refinement: int) -> dict:
    """The sweep config of one rung (``run_large_scaling.py:31-36``)."""
    idx = refinement * 4 + LADDER_COLUMN[smoother]
    with open(LADDER_DIR / f"input_{idx:04d}.json") as f:
        params = json.load(f)
    if params["n refinements"] != refinement:
        raise ValueError(f"input_{idx:04d}.json is not refinement "
                         f"{refinement}")
    return params


def ladder_plan(specs) -> list:
    plan = []
    for spec in specs:
        name, rng = spec.split(":")
        lo, _, hi = rng.partition("-")
        plan += [(name, r) for r in range(int(lo), int(hi or lo) + 1)]
    return plan


def ladder(specs, best_of: int = 3, device: str = "cuda") -> list:
    """Run the rungs of ``specs`` and print one JSON record each."""
    cuda = torch.device(device).type == "cuda"
    records = []
    for name, r in ladder_plan(specs):
        params = ladder_config(name, r)
        params["solver"]["best of"] = best_of
        print(f"=== {name} r={r} (outer f64, {device})", flush=True)
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launch_counts()
        t0 = time.perf_counter()
        rec = {"smoother": name, "refinement": r, "outer_dtype": "f64",
               "device": (torch.cuda.get_device_name(0) if cuda else "cpu")}
        try:
            res = poisson.run_config(params, log=_quiet, device=device)
        except (NotImplementedError, NoVertexPatches,
                torch.cuda.OutOfMemoryError) as e:
            rec["error"] = f"{type(e).__name__}: {e}"[:500]
        else:
            it, t = res["it"], res["time"]
            rec.update({
                "n_dofs": res["n_dofs"], "n_cells": res["n_cells"], "it": it,
                "converged": res["converged"], "solve_seconds": t,
                "seconds_per_it": t / max(it, 1),
                "ns_per_dof_it": t / max(it, 1) / res["n_dofs"] * 1e9,
                "gdofs_per_s": res["n_dofs"] * it / t / 1e9 if t > 0 else None,
                "setup_seconds": res["setup_time"],
                "setup_plus_total_seconds": time.perf_counter() - t0})
            del res
            if cuda:
                rec["peak_device_memory_gib"] = (
                    torch.cuda.max_memory_allocated() / 2**30)
                rec["launches"] = {k: v for k, v in
                                   kernels.launch_counts().items() if v}
        print(json.dumps(rec), flush=True)
        records.append(rec)
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m dealii_asm_tpu_torch.probe")
    sub = ap.add_subparsers(dest="what", required=True)
    for what in ("profile", "sensitivity", "setup"):
        sp = sub.add_parser(what)
        sp.add_argument("config")
        sp.add_argument("--refinements", type=int, default=None)
        sp.add_argument("--solver", default=None)
    lp = sub.add_parser("ladder")
    lp.add_argument("specs", nargs="*",
                    default=["fdm1:0-7", "diag:7", "fdm2:7", "fdmv:7"])
    lp.add_argument("--best-of", type=int, default=3)
    lp.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    on_card = args.what != "ladder" or torch.device(args.device).type == "cuda"
    if on_card:
        if not torch.cuda.is_available():
            print("probe: torch.cuda.is_available() is False; it needs a GPU",
                  file=sys.stderr)
            return 2
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip()
        print(f"gpu: {smi}")
    if args.what == "ladder":
        ladder(args.specs, args.best_of, args.device)
        return 0
    params = _load(args.config, args.refinements, args.solver)
    {"profile": profile, "sensitivity": sensitivity,
     "setup": setup}[args.what](params)
    return 0


if __name__ == "__main__":
    sys.exit(main())
