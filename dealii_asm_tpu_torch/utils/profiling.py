"""Stage timers and traces (PyTorch).

Counterpart of ``dealii_asm_tpu/utils/profiling.py``, the port of the
reference's two instrumentation mechanisms:
- per-multigrid-stage wall-clock timers (``StageTimer``, printed as a
  level × stage matrix by ``print_timings``); their edges synchronize the
  device, as the JAX timer blocks on each stage's result;
- hardware counters → ``trace``, a ``torch.profiler`` context.

The JAX module's ``hlo_cost`` reads XLA's cost model of a jitted function.
PyTorch has no such model of an eager function; the port's analytic bounds
(``chip_smoke.py``: ``bound`` and the ``*_work`` counts) play its part.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


def _sync() -> None:
    """Wait for the card's queued work; nothing on a CPU-only run (CUDA is
    never initialised here)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class StageTimer:
    """Accumulates wall time per (level, stage), synchronizing the device at
    both edges of a timed stage."""

    def __init__(self):
        self.times = defaultdict(float)
        self.counts = defaultdict(int)

    def run(self, level: int, name: str, fn, *args):
        """fn(*args), timed."""
        _sync()
        t0 = time.perf_counter()
        out = fn(*args)
        _sync()
        self.times[(level, name)] += time.perf_counter() - t0
        self.counts[(level, name)] += 1
        return out

    def print_timings(self, file=None):
        """Level × stage matrix of the summed seconds (nothing if empty)."""
        if not self.times:
            return
        stages = sorted({k[1] for k in self.times})
        levels = sorted({k[0] for k in self.times})
        header = "level | " + " | ".join(f"{s:>12}" for s in stages)
        print(header, file=file)
        for l in levels:
            row = f"{l:5d} | " + " | ".join(
                f"{self.times.get((l, s), 0.0):12.6f}" for s in stages)
            print(row, file=file)


@contextlib.contextmanager
def trace(log_dir: str = "chiprun_out/torch_trace"):
    """A ``torch.profiler`` trace of the block (CPU and, on a card, CUDA
    activity), written as a Chrome trace into ``log_dir``; yields the
    profiler, whose ``key_averages()`` tabulate the kernels."""
    import os

    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
