"""The span pass (``fembench/spans.py``) on the card, on both cells'
configurations cut to a small size: the device time of one solve is
attributed to the program's spans (the ctypes launches of the kernels
included) from the device operations of the profile, the program's
``host_syncs`` counter equals the sync-debug warnings of the same solve,
and a steady solve allocates no new device segment."""

import pytest

from fembench import harness, spans
from fembench.reference.multigrid import Problem
from fembench.traffic import RightHandSides

SMALL = {"aniso_q4_r7": 4, "kershaw_q4": 1}


class _One:
    """One right-hand side, made before the profiled solve."""

    count = 1

    def __init__(self, b):
        self.b = b

    def __call__(self, _):
        return self.b


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(SMALL))
def test_spans_hold_the_device_time_and_count_the_syncs(cuda_device,
                                                         tiny_cell, name):
    from dealii_asm_tpu_torch.utils import profiling

    cell = tiny_cell(name, SMALL[name])
    prog = harness.set_up(cell["config"], cuda_device)
    prob = Problem(cell["config"])
    rhs = RightHandSides(cell["traffic"], 2 ** 31 + 7,
                         [c * 2 ** prob.refinements for c in prob.base],
                         prob.degree, cuda_device)
    b = rhs(0)
    # the first "warn" of a process also warns that the mode is a
    # prototype, and that warning's text matches too
    first = harness.count_syncs(prog, b)
    with profiling.tracing() as tracer:
        prog.solve(b)  # the tracer's anchor is taken in the first span
        before = tracer.totals.get("host_syncs", 0)
        syncs = harness.count_syncs(prog, b)
        counted = tracer.totals["host_syncs"] - before
    steady = [s for s in tracer.records() if s.name == "solve"][-1]
    # CG: 2 reads before its loop, 3 an iteration, 2 in the last one
    assert counted == syncs["count"] == 3 * syncs["iterations"] + 1
    assert first["count"] - syncs["count"] in (0, 1)
    # the kernels' launches are in the totals; the caching allocator
    # serves a steady solve from the segments it holds
    assert any(k.startswith("launches.") and v > 0
               for k, v in tracer.totals.items())
    assert steady.counts["allocator.segments"] == 0
    out = spans.span_pass(prog, _One(b), 1)
    assert out is not None and out["n_device_ops"] > 0
    assert out["tallies"]["solve"] == 1
    assert out["tallies"]["cg.iteration"] == syncs["iterations"]
    assert out["covered_s"] >= 0.99 * out["device_s"] > 0
    assert out["busy_s"].get("mg.restrict", 0.0) > 0
    assert out["busy_s"].get("cg.iteration", 0.0) > 0
    harness.free(prog)
