"""Spans, counters and traces (PyTorch).

Counterpart of ``dealii_asm_tpu/utils/profiling.py``, the port of the
reference's two instrumentation mechanisms (per-stage timers, hardware
counters), as one process-wide tracer that is off by default:

- ``span(name, level=None)`` marks a stretch of program code (a set-up
  step, a solve, a CG iteration, a V-cycle stage on a level).  While the
  tracer is off it hands back one shared object that does nothing, after a
  single check of a module global: no string, no CUDA event, no
  ``record_function``.
- ``count(name, n=1)`` adds to the innermost open span and to the run's
  total (host syncs, allocator segments, the fixed-order scatter's group
  gathers "fixed_sum.gathers"); the run's totals also hold the kernel
  launches of the traced stretch (``kernels.LAUNCHES``).
- The unstructured Schwarz apply (``precond/asm_general.py``) marks
  "asm.gather" and "asm.scatter" inside the smoothing spans of its
  levels; they are solve spans (``SOLVE``), so the table's solve line
  counts them.
- ``spanned(name)`` makes a function (a lazily built table) a span.
- ``tracing()`` switches the tracer on.  Each span then records its name,
  level, id, parent and solve id (shared by every span of one
  ``krylov.solve``), its host start and end (``time.perf_counter_ns``),
  a ``torch.profiler.record_function`` range (so a running profiler
  carries the span on the device trace's clock) and, on a card, a timing
  event at each edge, never synchronized.  The events are resolved when
  the trace is read: one synchronize, then each device extent is put on
  the host clock through one anchor pair taken when the card is first
  seen.
- ``Tracer.print_table`` prints the level × stage table of the V-cycle
  (host and device ms; the levels of nested multigrids counted together,
  the coarsest 0) under ``"print timing"``.
- ``trace`` writes a ``torch.profiler`` Chrome trace with the tracer on.

The JAX module's ``hlo_cost`` reads XLA's cost model of a jitted function.
PyTorch has no such model of an eager function; the benchmark's analytic
bounds (``fembench/roofline.py``) play its part.
"""

from __future__ import annotations

import contextlib
import functools
import time
from dataclasses import dataclass, field

import torch

# the V-cycle's stage spans and the JAX StageTimer's names for them
STAGES = {"mg.pre_smooth": "pre smooth", "mg.residual": "residual",
          "mg.restrict": "restrict", "mg.coarse_solve": "coarse solve",
          "mg.prolongate": "prolongate", "mg.post_smooth": "post smooth"}
SETUP = ("setup.mesh", "setup.dofs", "setup.operator", "setup.transfer",
         "setup.smoother", "setup.coarse", "setup.kernels", "setup.warmup")
SOLVE = ("solve", "cg.iteration", "cg.operator", "cg.precond", "mg.vcycle",
         "asm.gather", "asm.scatter")

_active = None  # the Tracer while tracing is on


class _Off:
    """What ``span`` returns while the tracer is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str, level: int | None = None):
    """A context manager that marks the block as span ``name`` (on
    ``level`` of the V-cycle, if given) while tracing is on."""
    tracer = _active
    if tracer is None:
        return _OFF
    return _Open(tracer, name, level, False)


def solve_span():
    """The span of one Krylov solve: it starts a new solve id and counts
    the allocator's new device segments over the solve
    (``allocator.segments``)."""
    tracer = _active
    if tracer is None:
        return _OFF
    return _Open(tracer, "solve", None, True)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while tracing is on."""
    tracer = _active
    if tracer is not None:
        tracer.add(name, n)


def spanned(name: str):
    """Decorator: each call of the function is span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


@dataclass(eq=False)
class Span:
    """One span as the tracer recorded it; times in ns on the host clock
    (``time.perf_counter_ns``); the device extent is None without a card."""

    name: str
    level: int | None
    id: int
    parent: int | None
    solve: int | None
    start_ns: int = 0
    end_ns: int = 0
    counts: dict = field(default_factory=dict)
    device_start_ns: float | None = None
    device_end_ns: float | None = None

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6

    @property
    def device_ms(self) -> float | None:
        if self.device_start_ns is None:
            return None
        return (self.device_end_ns - self.device_start_ns) * 1e-6


def _segments() -> int:
    return torch.cuda.memory_stats().get("segment.all.allocated", 0)


class _Open:
    """A span being recorded."""

    __slots__ = ("tracer", "name", "level", "is_solve", "rec", "fn",
                 "events", "segments")

    def __init__(self, tracer, name, level, is_solve):
        self.tracer = tracer
        self.name = name
        self.level = level
        self.is_solve = is_solve

    def __enter__(self):
        t = self.tracer
        parent = t.stack[-1] if t.stack else None
        if self.is_solve:
            solve = t.n_solves
            t.n_solves += 1
        else:
            solve = None if parent is None else parent.solve
        rec = self.rec = Span(self.name, self.level, len(t.spans),
                              None if parent is None else parent.id, solve)
        t.spans.append(rec)
        t.stack.append(rec)
        self.fn = torch.profiler.record_function(rec.name)
        self.fn.__enter__()
        self.events = None
        if t.on_card():
            if self.is_solve:
                self.segments = _segments()
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            self.events = (start, torch.cuda.Event(enable_timing=True))
        rec.start_ns = time.perf_counter_ns()
        return rec

    def __exit__(self, *exc):
        t, rec = self.tracer, self.rec
        rec.end_ns = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record()
            t.unresolved.append((rec, self.events))
            if self.is_solve:
                t.add("allocator.segments", _segments() - self.segments)
        self.fn.__exit__(*exc)
        t.stack.pop()
        return False


class Tracer:
    """The spans and counters of one stretch of tracing."""

    def __init__(self):
        from ..kernels import LAUNCHES

        self.spans: list[Span] = []
        self.stack: list[Span] = []
        self.counters: dict = {}
        self.n_solves = 0
        self._launches = LAUNCHES
        self._launch_base = dict(LAUNCHES)
        self.unresolved = []
        self._card = torch.cuda.is_available()
        self._anchor = None  # (start event, its host time in ns)

    def on_card(self) -> bool:
        """Whether spans record device events: a card is present and CUDA
        has been initialised.  The first time, the anchor pair is taken:
        an event that has completed and the host time just after."""
        if self._anchor is not None:
            return True
        if not (self._card and torch.cuda.is_initialized()):
            return False
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e0.record()
        torch.cuda.synchronize()
        self._anchor = (e0, time.perf_counter_ns())
        return True

    def add(self, name: str, n: int) -> None:
        self.counters[name] = self.counters.get(name, 0) + n
        if self.stack:
            c = self.stack[-1].counts
            c[name] = c.get(name, 0) + n

    def launches(self) -> dict:
        """{"launches.<wrapper>": kernel launches while tracing}."""
        return {f"launches.{k}": n - self._launch_base[k]
                for k, n in self._launches.items()
                if n > self._launch_base[k]}

    @property
    def totals(self) -> dict:
        """The counters' run totals and the kernel launches."""
        return {**self.counters, **self.launches()}

    def records(self) -> list[Span]:
        """The spans, their device extents resolved (one synchronize)."""
        if self.unresolved:
            torch.cuda.synchronize()
            e0, h0 = self._anchor
            for rec, (a, b) in self.unresolved:
                rec.device_start_ns = h0 + e0.elapsed_time(a) * 1e6
                rec.device_end_ns = h0 + e0.elapsed_time(b) * 1e6
            self.unresolved = []
        return self.spans

    def stages(self) -> dict:
        """{(level, JAX stage name): [spans, host ms, device ms or None]}
        summed over the stage spans."""
        out = {}
        for s in self.records():
            if s.name in STAGES:
                c = out.setdefault((s.level, STAGES[s.name]), [0, 0.0, None])
                c[0] += 1
                c[1] += s.host_ms
                if s.device_ms is not None:
                    c[2] = (c[2] or 0.0) + s.device_ms
        return out

    def stage_counts(self) -> dict:
        """{(level, JAX stage name): number of stage spans}."""
        return {k: v[0] for k, v in self.stages().items()}

    def print_table(self, file=None) -> None:
        """The level × stage table (host ms / device ms summed over the
        traced V-cycles), then the set-up and solve spans and the
        counters.  Nothing if no V-cycle was traced."""
        cells = self.stages()
        recs = self.spans
        if not cells:
            return
        stages = sorted({k[1] for k in cells})
        levels = sorted({k[0] for k in cells})
        print("level | " + " | ".join(f"{s:>19}" for s in stages), file=file)
        for l in levels:
            row = []
            for s in stages:
                if (l, s) not in cells:
                    row.append(f"{'-':>19}")
                    continue
                _, h, d = cells[l, s]
                row.append(f"{h:9.3f}/" + (f"{'-':>9}" if d is None
                                            else f"{d:9.3f}"))
            print(f"{l:5d} | " + " | ".join(row), file=file)
        print("(ms, host / device, summed over the traced V-cycles; levels "
              "of nested multigrids counted together, the coarsest 0)",
              file=file)
        for group in (SETUP, SOLVE):
            parts = []
            for name in group:
                sel = [s for s in recs if s.name == name]
                if sel:
                    parts.append(f"{name} {len(sel)}x "
                                 f"{sum(s.host_ms for s in sel):.3f} ms")
            if parts:
                print("; ".join(parts), file=file)
        totals = self.totals
        if totals:
            print("; ".join(f"{k} {v}" for k, v in sorted(totals.items())),
                  file=file)


@contextlib.contextmanager
def tracing():
    """Switch the tracer on for the block; yields the ``Tracer``.  Inside
    a block that already traces, the active tracer goes on."""
    global _active
    if _active is not None:
        yield _active
        return
    tracer = Tracer()
    _active = tracer
    try:
        yield tracer
    finally:
        _active = None


@contextlib.contextmanager
def paused():
    """Switch the tracer off for the block (a timed stretch of a traced
    run), and on again after it."""
    global _active
    tracer, _active = _active, None
    before = None if tracer is None else dict(tracer._launches)
    try:
        yield
    finally:
        _active = tracer
        if tracer is not None:  # the block's launches are not the trace's
            for k, n in tracer._launches.items():
                tracer._launch_base[k] += n - before[k]


@contextlib.contextmanager
def trace(log_dir: str = "chiprun_out/torch_trace"):
    """A ``torch.profiler`` trace of the block with the tracer on (CPU and,
    on a card, CUDA activity; the program's spans beside the operations),
    written as a Chrome trace into ``log_dir``; yields the profiler, whose
    ``key_averages()`` tabulate the kernels."""
    import os

    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof, tracing():
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
