"""The program's own spans in a ``--trace 1`` run.

The program (``dealii_asm_tpu_torch/utils/profiling.py``) marks its set-up
steps, its solves, CG iterations and V-cycle stages as spans while its
tracer is on, and each span enters a ``torch.profiler.record_function``
range, so the profiler's trace holds them beside the device operations on
one clock.  This module reads them:

- ``traced_again``: ``harness.set_up`` with the tracer on, then the span
  pass; the exclusive host seconds of each set-up span
  (``profiling.SETUP``, ``setup_seconds``: a span's time less that of the
  set-up spans nested in it, so the DoF tables built inside an operator's
  set-up count as "setup.dofs" alone);
- ``span_pass``: ``n`` solves with the tracer on under ``torch.profiler``.
  Each device operation's time goes to the innermost program span whose
  host interval holds its launch (the runtime call of the same
  correlation id, the ctypes launches of the program's kernels included),
  and each stretch in which the device idles to the innermost program span
  that holds its middle.  A program on the CPU has no device operations:
  there the outermost ``aten`` operations stand in for them; a program on
  a card whose profile holds none gives no pass.  It reads the profile's
  raw kineto events (the profiler's own event tree would take tens of
  seconds to build for a Kershaw solve).  Its totals and ten largest idle
  stretches by span go to stderr.

A reader (``fembench/metrics/<metric>.py``) gets the run record alone, so
the first reader of these metrics in a run calls ``of(run)``, which makes
the pass once, after the window and the check, on a second, warm set-up of
the cell named by the command's ``--workload`` on the card, the traffic
drawn from its ``--seed`` (the run's own program is freed by then).  The
set-up metrics thus miss what only a process's first set-up pays (CUDA's
start, the kernel library's load, first-touch allocations).  The window,
the V-cycle samples, ``harness.traced_stages`` and its profile run with
the tracer off, so no other metric and no part of the ``breakdown`` reads
a traced solve.  A program without the tracer (an earlier commit) gives
no record, and the readers then give None.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from . import harness

OUTSIDE = "(outside any program span)"


def _profiling():
    """The program's tracer module, or None where it has no tracer."""
    try:
        from dealii_asm_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "tracing") else None


def setup_seconds(spans, names) -> dict:
    """{name: exclusive host seconds} of the spans named in ``names``: each
    span's time less that of the spans of ``names`` nearest inside it."""
    by_id = {s.id: s for s in spans}
    out = {name: 0.0 for name in names}
    for s in spans:
        if s.name not in names:
            continue
        t = (s.end_ns - s.start_ns) * 1e-9
        out[s.name] += t
        p = s.parent
        while p is not None and by_id[p].name not in names:
            p = by_id[p].parent
        if p is not None:
            out[by_id[p].name] -= t
    return out


def _innermost(spans, times):
    """For each of the sorted ``times``, the name of the innermost of
    the ``spans`` (start, end, name) that holds it, else ``OUTSIDE``.  The
    spans of one thread nest, so the open ones form a stack."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    stack, j, out = [], 0, []
    for t in times:
        while j < len(spans) and spans[j][0] <= t:
            while stack and stack[-1][1] < spans[j][0]:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1][2] if stack else OUTSIDE)
    return out


def _device_ops(events, names, on_card: bool):
    """[(launch, start, end)] of the device operations and the program
    spans [(start, end, name)] of a profile's raw kineto events, in ns on
    its clock.  A device operation's launch is the host runtime call
    (``cu*``) of the same correlation id; the device copies of the spans'
    ``record_function`` ranges are left out.  Off the card the outermost
    ``aten`` operations stand in for the device operations; on the card a
    profile without device operations gives None."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    spans, dev, launch, aten = [], [], {}, []
    for e in events:
        kind, name, a, b = e.device_type(), e.name(), e.start_ns(), e.end_ns()
        if e.is_user_annotation():
            if kind == cpu and name in names:
                spans.append((a, b, name))
        elif kind == cuda:
            if b > a:
                dev.append((e.correlation_id(), a, b))
        elif kind == cpu:
            if name.startswith("cu"):
                launch[e.correlation_id()] = a
            elif name.startswith("aten::"):
                aten.append((a, b))
    if on_card:
        if not dev:
            return None
        return [(launch.get(c), a, b) for c, a, b in dev], spans
    ops, end = [], None
    for a, b in sorted(aten, key=lambda o: (o[0], -o[1])):
        if end is None or a >= end:  # not inside the last outermost one
            ops.append((a, a, b))
            end = b
    return ops, spans


def attribute(events, names, on_card: bool) -> dict | None:
    """Device busy and idle seconds of a profile (its raw kineto events) by
    innermost program span (``names``), the number of device operations,
    the total busy seconds, and the busy seconds of operations whose launch
    was found inside some program span; None for a card's profile that
    holds no device operation."""
    found = _device_ops(events, names, on_card)
    if found is None:
        return None
    ops, spans = found
    busy, covered = {}, 0.0
    launched = sorted((l, b - a) for l, a, b in ops if l is not None)
    names_at = _innermost(spans, [l for l, _ in launched])
    for (l, d), name in zip(launched, names_at):
        busy[name] = busy.get(name, 0.0) + d * 1e-9
        if name != OUTSIDE:
            covered += d * 1e-9
    total = sum(b - a for _, a, b in ops) * 1e-9
    merged = []
    for _, a, b in sorted(ops, key=lambda o: o[1]):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    gaps = [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)]
    gaps.sort(key=lambda g: g[0] + g[1])
    idle = {}
    for (a, b), name in zip(gaps, _innermost(spans, [(a + b) / 2
                                                     for a, b in gaps])):
        idle[name] = idle.get(name, 0.0) + (b - a) * 1e-9
    return {"busy_s": busy, "idle_s": idle, "n_device_ops": len(ops),
            "device_s": total, "covered_s": covered}


def tallies(spans) -> dict:
    """Counts of the solve spans: solves, CG iterations and V-cycles of
    the outer multigrid inside solves (Lanczos estimates of the set-up
    run CG outside any solve)."""
    in_solve = [s for s in spans if s.solve is not None]
    cycles = [s for s in in_solve if s.name == "mg.vcycle"]
    top = max((s.level for s in cycles), default=None)
    return {"solve": sum(s.name == "solve" for s in in_solve),
            "cg.iteration": sum(s.name == "cg.iteration" for s in in_solve),
            "mg.vcycle": sum(s.level == top for s in cycles)}


def span_pass(prog, rhs, n: int) -> dict | None:
    """``n`` steady solves (right-hand sides 0, 1, ...) with the tracer on
    under ``torch.profiler``: the device time and idle time by innermost
    program span, the span tallies and the tracer's counters; None
    without a tracer, and for a program on a card whose profile holds no
    device operation (stderr says so)."""
    from torch.profiler import ProfilerActivity, profile

    profiling = _profiling()
    if profiling is None:
        return None
    on_card = prog.device.type == "cuda"
    acts = [ProfilerActivity.CPU]
    if on_card:
        acts.append(ProfilerActivity.CUDA)
    names = set(profiling.STAGES) | set(profiling.SOLVE)
    harness.synchronize(prog.device)
    with profile(activities=acts) as prof, profiling.tracing() as tracer:
        t0 = time.perf_counter()
        for i in range(n):
            prog.solve(rhs(i % rhs.count))
        harness.synchronize(prog.device)
        wall = time.perf_counter() - t0
    out = attribute(prof.profiler.kineto_results.events(), names, on_card)
    if out is None:
        print("span pass: the profile holds no device operation; no span "
              "metric is read", file=sys.stderr)
        return None
    recs = tracer.records()
    out["tallies"] = tallies(recs)
    out["counters"] = dict(tracer.totals)
    top = sorted(out["idle_s"].items(), key=lambda kv: -kv[1])[:10]
    share = out["covered_s"] / max(out["device_s"], 1e-30)
    print(f"span pass: {n} solves in {wall:.6f} s, device busy "
          f"{out['device_s']:.6f} s ({share:.4%} launched in a span), idle "
          f"{sum(out['idle_s'].values()):.6f} s; idle by span (s): "
          + ", ".join(f"{k} {v:.6f}" for k, v in top), file=sys.stderr)
    return out


def traced_again(cell: dict, seed: int, device) -> dict | None:
    """A second set-up of the cell with the tracer on and the span pass
    over the workload's ``profile_solves``: {"setup_s": set-up seconds by
    span, "pass": the pass or None}; None without a tracer."""
    profiling = _profiling()
    if profiling is None:
        return None
    t0 = time.perf_counter()
    with profiling.tracing() as tracer:
        prog = harness.set_up(cell["config"], device)
    setup = setup_seconds(tracer.records(), profiling.SETUP)
    t1 = time.perf_counter()
    rhs = harness.right_hand_sides(cell, seed,
                                   harness.numbering(cell, prog.points),
                                   prog.device)
    out = {"setup_s": setup,
           "pass": span_pass(prog, rhs, int(cell["workload"]["profile_solves"]))}
    harness.free(prog)
    del prog, rhs
    print(f"span pass: second set-up {t1 - t0:.3f} s, of it by span (s) "
          + ", ".join(f"{k} {v:.3f}" for k, v in setup.items())
          + f"; the pass {time.perf_counter() - t1:.1f} s", file=sys.stderr)
    return out


def command_line():
    """(cell, seed, device) of the ``fembench.run`` command that this
    process runs: its ``--workload`` and ``--seed``, on the card; None
    without them."""
    ap = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int)
    args = ap.parse_known_args(sys.argv[1:])[0]
    if args.workload is None or args.seed is None:
        return None
    return harness.load_cell(args.workload), args.seed, "cuda"


def of(run: dict) -> dict | None:
    """The run's span record (``run["spans"]``), made on first use for the
    cell and seed of ``command_line()``; None without them."""
    if "spans" not in run:
        ctx = command_line()
        if ctx is None:
            return None
        run["spans"] = traced_again(*ctx)
    return run["spans"]


def pass_of(run: dict) -> dict | None:
    """The span pass of the run's span record, or None."""
    s = of(run)
    return None if s is None else s["pass"]
