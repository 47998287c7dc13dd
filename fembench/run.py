"""Run one benchmark cell once on the card.

    python3 -m fembench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (an entry of ``BENCHMARK.json``'s ``workloads``) names a
configuration (``fembench/configs/<name>.json``), a traffic mix
(``fembench/traffic/<name>.json``) and its own file of limits and profile
length (``fembench/workloads/<cell>.json``).  The run sets the solver up,
solves the mix's right-hand sides in a closed loop for ``--seconds``, checks
a sample of the answers against the plain reference, and prints one JSON
line: with ``--trace 0`` the cell's end-to-end metrics, with ``--trace 1``
its per-layer metrics (each the value of its reader,
``fembench/metrics/<metric>.py``) and the profiler's breakdown.  Without a
CUDA device it exits with code 2 and prints no result.
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path

T0 = time.perf_counter()


def _process_age() -> float:
    """Seconds since this process started (Linux ``/proc``), else 0."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


AGE0 = _process_age()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402

import torch  # noqa: E402

from . import check, harness  # noqa: E402

METRICS = Path(__file__).resolve().parent / "metrics"


def metric_file(name: str) -> Path:
    """The reader of metric ``name``: ``fembench/metrics/<name>.py``, else,
    for a quantity split by the end-to-end metric it moves
    (``<quantity>.<group>``), ``fembench/metrics/<quantity>.py``."""
    own = METRICS / f"{name}.py"
    return own if own.is_file() else METRICS / f"{name.split('.')[0]}.py"


def read_metric(name: str, run: dict):
    """The value of the metric's reader's ``read(run)``, or None where it
    finds nothing to read."""
    spec = importlib.util.spec_from_file_location(
        "fembench_metric_" + name.replace(".", "_"), metric_file(name))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(run)


def card() -> dict:
    name = torch.cuda.get_device_name(0)
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        limit = "unknown"
    return {"kind": name, "power_limit": limit.splitlines()[0] if limit else
            "unknown"}


def measure(cell: dict, seed: int, seconds: float, trace: bool,
            device="cuda") -> dict:
    """Set-up, window, traced stages and the reference check of one run;
    returns the run record that the metric readers read (without a window
    where the program's support points do not match the reference's)."""
    workload = cell["workload"]
    prog = harness.set_up(cell["config"], device)
    dev = prog.device
    nb = harness.numbering(cell, prog.points)
    if nb.mismatch is not None:
        harness.free(prog)
        return {"mismatch": nb.mismatch}
    rhs = harness.right_hand_sides(cell, seed, nb, dev)
    sample = harness.sample_of(seed, rhs.count, harness.SAMPLE)
    rhs(0)  # the generator's first products
    harness.synchronize(dev)
    window = harness.run_window(prog, rhs, seconds, sample)
    run = {"setup_s": AGE0 + window["t_start"] - T0,
           "window": {k: window[k] for k in ("seconds", "iterations",
                                             "converged")},
           "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                          if dev.type == "cuda" else 0),
           "finest": prog.finest, "facts": prog.guarantee_facts,
           "sample": sample}
    kept = window["kept"]
    vcycles = {k: prog.M(rhs(k)).cpu() for k in sample}
    run["stages"] = (harness.traced_stages(prog, rhs, sample,
                                           int(workload["profile_solves"]))
                     if trace else {})
    harness.free(prog)
    del prog
    run["numbers"] = check.Judge(cell, dev, nb.perm).numbers(rhs, kept,
                                                             vcycles)
    run["sample_converged"] = [kept[k].converged for k in sorted(kept)]
    run["rhs_iterations"] = {k: window["iterations"][k]
                             for k in range(rhs.count)}
    return run


def result(cell: dict, run: dict, trace: bool, device_info: dict) -> dict:
    """The result line of a run record."""
    if "mismatch" in run:  # nothing was solved or compared
        return {"correct": False, "attempted": 0, "failed": 1, "metrics": {},
                "device": dict(device_info),
                "checks": {"numbering": run["mismatch"]}}
    names = cell["per_layer"] if trace else cell["end_to_end"]
    metrics = {}
    for name in names:
        value = read_metric(name, run)
        if value is not None:
            metrics[name] = {"value": float(value), "unit": cell["units"][name]}
    ok, checks = check.judge(run["numbers"], cell["workload"]["limits"])
    broken = check.guarantees_kept(cell["guarantees"], run["facts"])
    w = run["window"]
    failed = sum(not c for c in w["converged"])
    if not ok or broken or not all(run["sample_converged"]):
        failed = max(failed, 1)
    line = {"correct": failed == 0 and not broken,
            "attempted": len(w["seconds"]), "failed": failed,
            "metrics": metrics, "device": dict(device_info)}
    if trace:
        prof = run["stages"]["profile"]
        line["device"].update(busy_s=prof["busy_s"], window_s=prof["window_s"])
        line["breakdown"] = {"device_ops": prof["device_ops"],
                             "idle_gaps": prof["idle_gaps"]}
    line["checks"] = checks
    if broken:
        line["checks"]["guarantees"] = broken
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    chips = int(cell["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"fembench: the cell needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    run = measure(cell, args.seed, args.seconds, bool(args.trace))
    banned = harness.forbidden_modules(list(sys.modules))
    if banned:
        print(f"fembench: modules of {banned} were loaded", file=sys.stderr)
        return 3
    info = card()
    line = result(cell, run, bool(args.trace),
                  {"platform": "gpu", "kind": info["kind"], "count": chips,
                   "memory_peak_bytes": int(run.get("peak_bytes", 0))})
    if "window" in run:
        w = run["window"]
        print(f"card {info['kind']}, power limit {info['power_limit']}; "
              f"{len(w['seconds'])} solves, iterations of the right-hand "
              f"sides {run['rhs_iterations']}, sample {run['sample']}",
              file=sys.stderr)
    for name, c in line["checks"].items():
        if isinstance(c, dict):
            print(f"check {name} {c['value']!r} limit {c['limit']!r}",
                  file=sys.stderr)
        else:
            print(f"check {name} failed: {c}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
