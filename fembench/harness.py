"""Set-up, measured window and traced stages of one benchmark run.

The program under test is ``dealii_asm_tpu_torch``: a run sets it up through
its public entry ``models/poisson.py::run_config`` (one warm-up solve), keeps
the operator and preconditioner that ``run_config`` hands to
``solvers/krylov.py::solve``, and then drives ``krylov.solve`` with them on
the traffic's right-hand sides, one closed-loop caller, for the window's
seconds.  Nothing here imports JAX or the JAX package.

Each configuration names its plain reference (``reference``; the
interface is in ``fembench/reference/__init__.py``).  Where the reference
numbers its DoFs as the box lattice, as the program does on a structured
mesh, the traffic is made on that lattice and vectors pass between the two
as they are.  Otherwise ``numbering`` matches the program's finest support
points to the reference's once, at set-up: each program point has to have
exactly one reference point within ``POINT_TOL`` of the reference's
largest extent (a k-d tree's nearest neighbour: rounding both sets to a
grid would part two points that straddle a grid line), and the
right-hand sides are made at the reference's unit-box points, put in the
program's order.
"""

from __future__ import annotations

import copy
import gc
import heapq
import importlib
import itertools
import json
import time
import warnings
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SAMPLE = 3  # right-hand sides whose answers a run checks
STAGE_REPEATS = 20  # applies a traced stage is timed over
BENCHMARK = ROOT.parent / "BENCHMARK.json"
DEFAULT_REFERENCE = "multigrid"  # a configuration file without "reference"
POINT_TOL = 1e-9  # support points match within this share of the extent


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, benchmark: Path = BENCHMARK) -> dict:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration (the
    file's ``config``, as run), its traffic spec, its workload file and the
    names of the metrics it reports with and without tracing."""
    from . import traffic

    bench = read_json(benchmark)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config_file = read_json(ROOT.parent / configs[cell["config"]]["file"])

    def reported(metrics):
        return [m["name"] for m in metrics
                if name in m.get("workloads", [name])]

    return {"name": name, "cell": cell, "config": config_file["config"],
            "reference": config_file.get("reference", DEFAULT_REFERENCE),
            "guarantees": config_file["guarantees"],
            "traffic": traffic.load(cell["traffic"]),
            "workload": read_json(ROOT / "workloads" / f"{name}.json"),
            "end_to_end": reported(bench["end_to_end"]),
            "per_layer": reported(bench["per_layer"]),
            "units": {m["name"]: m["unit"]
                      for m in bench["end_to_end"] + bench["per_layer"]}}


def reference(of: dict):
    """The reference module (``fembench/reference/<name>.py``) of a cell of
    ``load_cell`` or of a configuration file: the name its ``reference``
    key gives, ``DEFAULT_REFERENCE`` where it has none."""
    name = of.get("reference", DEFAULT_REFERENCE)
    return importlib.import_module(f"{__package__}.reference.{name}")


@dataclass
class Numbering:
    """How the program's DoFs sit among the reference's: on one box
    ``lattice`` ((cells, degree), both numbered alike), or program DoF i
    at the reference's ``perm[i]`` (None: the reference's own numbering),
    with the traffic's unit-box points ``unit`` and free-DoF mask ``free``
    in the program's order; ``mismatch`` says why the point sets do not
    match."""

    lattice: tuple | None = None
    perm: torch.Tensor | None = None
    unit: np.ndarray | None = None
    free: np.ndarray | None = None
    mismatch: str | None = None


def numbering(cell: dict, program_points=None) -> Numbering:
    """The numbering of a cell's program against its reference.
    ``program_points`` (a callable giving the program's (n, 3) support
    points) is called only for a reference that is not on the lattice;
    without it the answers are in the reference's own numbering (the
    control)."""
    ref = reference(cell)
    lat = ref.lattice(cell["config"])
    if lat is not None:
        return Numbering(lattice=lat)
    support, free, unit = ref.points(cell["config"])
    if program_points is None:
        return Numbering(unit=unit, free=free)
    perm, why = match_points(np.asarray(program_points()), support)
    if why is not None:
        return Numbering(mismatch=why)
    return Numbering(perm=torch.as_tensor(perm), unit=unit[perm],
                     free=free[perm])


def match_points(program: np.ndarray, ref: np.ndarray,
                 rel_tol: float = POINT_TOL) -> tuple:
    """(perm, None) with ``ref[perm[i]]`` the one reference point within
    ``rel_tol`` × the reference's largest extent of ``program[i]``, or
    (None, why) where the two point sets do not match."""
    from scipy.spatial import cKDTree

    if program.shape != ref.shape:
        return None, (f"the program has {program.shape[0]} support points, "
                      f"the reference {ref.shape[0]}")
    n = ref.shape[0]
    tol = rel_tol * max(float(np.ptp(ref, axis=0).max()), 1e-300)
    dist, idx = cKDTree(ref).query(program, distance_upper_bound=tol,
                                   workers=-1)
    lost = int(np.count_nonzero(~np.isfinite(dist)))
    if lost:
        return None, (f"{lost} of the program's {n} support points have no "
                      f"reference point within {tol:.3g}")
    twice = int(np.count_nonzero(np.bincount(idx, minlength=n) > 1))
    if twice:
        return None, (f"{twice} reference points are the nearest of more "
                      "than one program point")
    return idx.astype(np.int64), None


def right_hand_sides(cell: dict, seed: int, nb: Numbering, device):
    """The traffic's right-hand sides of a run, in the program's numbering."""
    from . import traffic

    if nb.mismatch is not None:
        raise ValueError(f"no right-hand sides: {nb.mismatch}")
    if nb.lattice is not None:
        cells, degree = nb.lattice
        return traffic.RightHandSides(cell["traffic"], seed, cells, degree,
                                      device)
    return traffic.PointRightHandSides(cell["traffic"], seed, nb.unit,
                                       nb.free, device)


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class Program:
    """What ``run_config`` built: the solve's callables and arguments, the
    preconditioner (a precision adapter around the multigrid) and the
    finest level's operator and smoother."""

    solver: str
    A: object
    M: object
    kwargs: dict
    precond: object
    device: torch.device
    n_dofs: int
    finest: dict = field(default_factory=dict)
    guarantee_facts: dict = field(default_factory=dict)

    def solve(self, b):
        from dealii_asm_tpu_torch.solvers import krylov

        return krylov.solve(self.solver, self.A, b, M=self.M, **self.kwargs)

    @property
    def multigrid(self):
        return self.precond.inner

    @property
    def finest_operator(self):
        return self.multigrid.operators[-1]

    @property
    def finest_smoother(self):
        return self.multigrid.smoothers[-1]

    def points(self) -> np.ndarray:
        """(n, 3) physical support points of the solve's DoFs, in its
        numbering (the outer operator's DoF handler)."""
        return self.A.__self__.dofs.node_points(np.arange(self.n_dofs))


def set_up(config: dict, device="cuda") -> Program:
    """``run_config`` on a copy of ``config`` with "best of" 1 and "print
    timing" false (exactly one warm-up solve), capturing what it hands to
    ``krylov.solve``."""
    from dealii_asm_tpu_torch.models import poisson

    params = copy.deepcopy(config)
    params["print timing"] = False
    params.setdefault("solver", {})["best of"] = 1
    seen = {}
    real = poisson.krylov_solve

    def capture(solver_type, A, b, M=None, **kwargs):
        seen.update(solver=solver_type, A=A, M=M, kwargs=kwargs,
                    b_dtype=b.dtype)
        return real(solver_type, A, b, M=M, **kwargs)

    poisson.krylov_solve = capture
    try:
        res = poisson.run_config(params, log=lambda *_: None, device=device)
    finally:
        poisson.krylov_solve = real
    prog = Program(seen["solver"], seen["A"], seen["M"], seen["kwargs"],
                   res["preconditioner"], torch.device(device), res["n_dofs"])
    prog.guarantee_facts = {
        "outer_dtype": str(seen["A"].__self__.dtype),
        "rhs_dtype": str(seen["b_dtype"]),
        "level_dtype": str(getattr(prog.precond, "inner_dtype", None)),
        "rel_tolerance": seen["kwargs"].get("rel_tolerance"),
        "coarse": type(_coarsest(prog.multigrid).coarse_solver.__self__).__name__,
        "n_levels": _count_levels(prog.multigrid)}
    del res
    op, sm = prog.finest_operator, prog.finest_smoother
    cells = int(op.dofs.mesh.n_cells_total)
    kind = level_kind(op)
    prog.finest = {"kind": kind,
                   "cells": cells, "n": op.n_dofs, "p": op.degree,
                   "itemsize": op.dtype.itemsize, "degree": int(sm.degree),
                   # the per-patch tables of a deformed level's Schwarz
                   # apply; one element patch a cell on the others
                   "patches": (int(sm.M.__self__.V0.shape[0])
                               if kind == "deformed" else cells)}
    gc.collect()
    return prog


def level_kind(op) -> str:
    """"cartesian" or "deformed" for the structured operator, "general" for
    the unstructured one (kernel F)."""
    from dealii_asm_tpu_torch.ops.laplace import LaplaceOperator
    from dealii_asm_tpu_torch.ops.laplace_general import \
        GeneralLaplaceOperator

    if isinstance(op, GeneralLaplaceOperator):
        return "general"
    if isinstance(op, LaplaceOperator):
        return "deformed" if op.deformed else "cartesian"
    raise ValueError(f"no roofline count for a level of {type(op).__name__}")


def _coarsest(mg):
    """The innermost multigrid (a ph or hp layout nests one as the coarse
    solver of the other)."""
    while type(getattr(mg.coarse_solver, "__self__", None)) is type(mg):
        mg = mg.coarse_solver.__self__
    return mg


def _count_levels(mg) -> int:
    n = mg.n_levels
    while type(getattr(mg.coarse_solver, "__self__", None)) is type(mg):
        mg = mg.coarse_solver.__self__
        n += mg.n_levels - 1
    return n


@dataclass
class Kept:
    """A sampled solve's answer, held on the host."""

    x: torch.Tensor
    norm_b: float
    reported: float
    iterations: int
    converged: bool


def run_window(prog: Program, rhs, seconds: float, sample) -> dict:
    """Solve the right-hand sides 0, 1, …, K−1, 0, … one after another
    (each solve ends in a synchronize), each at least once, until the
    solves have taken ``seconds``; the first solve of each sampled right-hand side keeps its
    answer on the host.  The clock stops while such an answer is copied
    out, so that the harness's copies count in no solve's time and take no
    device memory.  Returns the per-solve wall times, iterations and
    convergence."""
    dev = prog.device
    pin = dev.type == "cuda"
    buffers = {k: torch.empty(prog.n_dofs, dtype=torch.float64,
                              pin_memory=pin) for k in sample}
    kept = {}
    times, its, conv = [], [], []
    synchronize(dev)
    t_start = last = time.perf_counter()
    i = 0
    while True:
        k = i % rhs.count
        r = prog.solve(rhs(k))
        synchronize(dev)
        now = time.perf_counter()
        times.append(now - last)
        its.append(r.n_iterations)
        conv.append(bool(r.converged))
        if k in buffers and k not in kept:
            buffers[k].copy_(r.x)
            kept[k] = Kept(buffers[k], r.residuals[0], r.residuals[-1],
                           r.n_iterations, r.converged)
            now = time.perf_counter()
        del r.x
        last = now
        i += 1
        if sum(times) >= seconds and i >= rhs.count:
            break
    return {"seconds": times, "iterations": its, "converged": conv,
            "kept": kept, "t_start": t_start}


def device_seconds(fn, reps: int, device: torch.device) -> float:
    """Seconds of one call of ``fn``: CUDA events around ``reps`` calls
    after one warm call (the host clock on the CPU)."""
    fn()
    synchronize(device)
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) * 1e-3 / reps


def count_syncs(prog: Program, b) -> dict:
    """Host syncs of one solve: the warnings that
    ``torch.cuda.set_sync_debug_mode("warn")`` gives for each call that
    waits for the device."""
    if prog.device.type != "cuda":
        return {"count": 0, "iterations": prog.solve(b).n_iterations}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            r = prog.solve(b)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return {"count": sum("synchroniz" in str(w.message) for w in caught),
            "iterations": r.n_iterations}


def _intervals(events, device_side: bool):
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.time_range.start, e.time_range.end, e.name) for e in events
            if (e.device_type == cuda) == device_side]


def profile_solves(prog: Program, rhs, n_solves: int) -> dict:
    """torch.profiler over ``n_solves`` solves: the wall seconds, the union
    of the device operations' intervals (busy seconds), the ten device
    operations (kernels, copies, fills, by their own names) with the most
    device time, and the ten host activities (the innermost recorded host
    event at each idle stretch's middle) that the device's idle time fell
    into."""
    from torch.profiler import ProfilerActivity, profile

    synchronize(prog.device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n_solves):
            prog.solve(rhs(i % rhs.count))
        synchronize(prog.device)
        wall = time.perf_counter() - t0
    events = prof.events()
    dev = sorted(_intervals(events, True))
    merged = []
    for a, b, _ in dev:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy_us = sum(b - a for a, b in merged)
    gaps = [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)]
    by_host = {}
    host = sorted(_intervals(events, False))
    heap, j = [], 0
    for a, b in sorted(gaps, key=lambda g: (g[0] + g[1]) / 2):
        mid = (a + b) / 2
        while j < len(host) and host[j][0] <= mid:
            s, e, name = host[j]
            heapq.heappush(heap, (e - s, e, name))
            j += 1
        while heap and heap[0][1] < mid:
            heapq.heappop(heap)
        name = heap[0][2] if heap else "(host outside any recorded op)"
        by_host[name] = by_host.get(name, 0.0) + (b - a) * 1e-6
    ops = {}  # device time by the device operation's own name
    for a, b, name in dev:
        ops[name[:200]] = ops.get(name[:200], 0.0) + (b - a) * 1e-6
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"window_s": wall, "busy_s": busy_us * 1e-6,
            "device_ops": top(ops), "idle_gaps": top(by_host)}


def traced_stages(prog: Program, rhs, sample, n_profile: int) -> dict:
    """The per-layer measurements of a ``--trace 1`` run, on the program's
    own objects after the window: host syncs of one solve; the V-cycle's
    device time on the sampled right-hand sides (the window's initial
    residuals); the finest float level operator's apply and one
    post-smoothing step of its smoother from a nonzero guess; a profile of
    ``n_profile`` steady solves."""
    dev, reps = prog.device, STAGE_REPEATS
    bs = [rhs(k) for k in sample]
    out = {"syncs": count_syncs(prog, bs[0])}
    nxt = itertools.cycle(bs).__next__
    out["vcycle_s"] = device_seconds(lambda: prog.M(nxt()), reps, dev)
    op, sm = prog.finest_operator, prog.finest_smoother
    b32 = bs[0].to(op.dtype)
    del bs
    out["level_vmult_s"] = device_seconds(lambda: op.vmult(b32), reps, dev)
    x32 = sm.vmult(b32)
    out["smoother_step_s"] = device_seconds(lambda: sm.step(x32, b32), reps, dev)
    del b32, x32
    out["profile"] = profile_solves(prog, rhs, n_profile)
    return out


def free(prog: Program) -> None:
    """Drop the program's state and return its device memory."""
    for name in ("A", "M", "precond"):
        setattr(prog, name, None)
    gc.collect()
    if prog.device.type == "cuda":
        torch.cuda.empty_cache()


def forbidden_modules(modules) -> list:
    """Loaded modules whose top-level name, taken whole, is JAX's or the
    JAX package's."""
    banned = {"jax", "jaxlib", "flax", "dealii_asm_tpu"}
    return sorted({m.split(".")[0] for m in modules} & banned)


def percentile(values, q: int) -> float:
    """The q-th percentile (inclusive method of ``statistics.quantiles``)."""
    import statistics

    if len(values) < 2:
        return float(values[0])
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


def sample_of(seed: int, count: int, size: int) -> list:
    """``size`` of the ``count`` right-hand sides, drawn from the seed."""
    rng = np.random.default_rng([int(seed) % 2 ** 63, 1])
    return sorted(int(k) for k in rng.choice(count, size=min(size, count),
                                             replace=False))
