"""The port's tracer (dealii_asm_tpu_torch/utils/profiling.py) and the
benchmark's readers of its spans (fembench/metrics/), on the CPU at tiny
sizes.

Contract:
- with the tracer off the V-cycle and a CG solve give the same bits as
  with it on;
- on an h-multigrid and a nested ph-multigrid: one "solve" span, as many
  "cg.iteration" spans in it as iterations, as many V-cycles of the outer
  multigrid as preconditioner applies, the six stage spans on every level
  of both multigrids (the levels counted together, the coarsest 0), and
  parent links that nest;
- CG's reductions count 3·iterations + 1 host syncs (2 before the loop, 3
  an iteration, 2 in the last one);
- the traced set-up gives every set-up span, each span's exclusive time
  (the DoF tables built inside an operator's set-up count as "setup.dofs"
  alone), and the tracer's table rows for every level;
- the run's launch totals are the kernel launches of the traced stretch,
  a paused block's left out;
- the span pass's stand-in device operations (the outermost ``aten``
  operations) serve a program on the CPU only: a card's profile without
  device operations gives no attribution;
- each new reader gives its value on a synthetic run record, and None
  without the record's spans; the solve readers give None where the
  record has set-up spans but no pass;
- on the unstructured ball each Schwarz apply marks "asm.gather" and
  "asm.scatter" once, inside the smoothing spans,
  and each fixed-order scatter adds its number of valence groups (the
  distinct patch counts of its table) to "fixed_sum.gathers"; a
  structured solve records the span names and counters it did before.
"""

import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from dealii_asm_tpu_torch.ops.fixed_sum import FixedOrderSum
from dealii_asm_tpu_torch.precond.asm_general import GeneralASMPreconditioner
from dealii_asm_tpu_torch.utils import profiling
from fembench import harness, spans, traffic
from fembench import run as frun

H = {
    "dim": 3, "degree": 2, "n refinements": 2,
    "solver": {"type": "CG", "rel tolerance": 1e-6},
    "preconditioner": {
        "type": "Multigrid", "mg type": "h",
        "mg smoother": {"type": "Chebyshev", "degree": 2,
                        "preconditioner": {"type": "FDM",
                                           "weighting type": "symm"}},
        "mg coarse grid solver": {"type": "AMG"}},
}
PH = dict(copy.deepcopy(H), degree=3, **{"n refinements": 1})
PH["preconditioner"]["mg type"] = "ph"
CONFIGS = {"h": H, "ph": PH}


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("layout", sorted(CONFIGS))
def test_traced_solve_is_bit_equal_and_its_spans_nest(layout):
    with profiling.tracing() as setup_trace:
        prog = harness.set_up(CONFIGS[layout], "cpu")
    secs = spans.setup_seconds(setup_trace.records(), profiling.SETUP)
    for name in ("setup.mesh", "setup.dofs", "setup.operator",
                 "setup.transfer", "setup.smoother", "setup.coarse",
                 "setup.warmup"):
        assert secs[name] > 0, name
    cfg = CONFIGS[layout]
    cells = (2 ** cfg["n refinements"],) * 3
    b = traffic.RightHandSides(traffic.load("smooth_rhs8"), 3, cells,
                               cfg["degree"], "cpu")(0)
    y_off, r_off = prog.M(b), prog.solve(b)
    applies = []
    M = prog.M
    prog.M = lambda v: applies.append(1) or M(v)
    with profiling.tracing() as tracer:
        y_on, r_on = M(b), prog.solve(b)
    assert torch.equal(y_on, y_off) and torch.equal(r_on.x, r_off.x)
    assert r_on.n_iterations == r_off.n_iterations > 1

    recs = tracer.records()
    solves = [s for s in recs if s.name == "solve"]
    assert len(solves) == 1 and solves[0].solve == 0
    mine = [s for s in recs if s.solve == 0]
    assert sum(s.name == "cg.iteration" for s in mine) == r_on.n_iterations
    n_levels = harness._count_levels(prog.multigrid)
    cycles = [s for s in recs if s.name == "mg.vcycle"]
    assert sum(s.level == n_levels - 1 and s.solve == 0
               for s in cycles) == len(applies)
    assert len(applies) == r_on.n_iterations
    stages = {(s.level, s.name) for s in recs if s.name in profiling.STAGES}
    fine = {"mg.pre_smooth", "mg.residual", "mg.restrict", "mg.prolongate",
            "mg.post_smooth"}
    assert stages >= {(0, "mg.coarse_solve")} | {
        (l, n) for l in range(1, n_levels) for n in fine}
    assert {s.level for s in recs if s.name in profiling.STAGES} == set(
        range(n_levels))
    if layout == "ph":  # the inner V-cycle, one a coarse solve of the outer
        assert {s.level for s in cycles} == {prog.multigrid.level_offset,
                                             n_levels - 1}
    for i, s in enumerate(recs):
        assert s.id == i and s.start_ns <= s.end_ns
        if s.parent is not None:
            p = recs[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
            assert s.solve == p.solve or s.name == "solve"
    # CG's reads of ‖r‖, (p, Ap) and (r, z) on the host
    assert tracer.totals["host_syncs"] == 3 * r_on.n_iterations + 1
    assert solves[0].counts == {"host_syncs": 2}  # before the loop
    assert sum(s.counts.get("host_syncs", 0) for s in mine
               if s.name == "cg.iteration") == 3 * r_on.n_iterations - 1


def test_off_path_shares_one_object_and_records_nothing():
    assert profiling._active is None
    a = profiling.span("mg.restrict", 3)
    assert a is profiling.span("cg.iteration") is profiling.solve_span()
    with a:
        profiling.count("host_syncs")
    with profiling.tracing() as tracer:
        with profiling.paused():
            with profiling.span("mg.restrict", 1):
                profiling.count("host_syncs")
        with profiling.span("mg.restrict", 1) as rec:
            profiling.count("host_syncs", 2)
    assert [s.name for s in tracer.records()] == ["mg.restrict"]
    assert rec.counts == tracer.totals == {"host_syncs": 2}
    assert rec.device_ms is None and rec.level == 1


SETUP_S = {"setup.mesh": 1.5, "setup.dofs": 2.0, "setup.operator": 4.0,
           "setup.transfer": 0.5, "setup.smoother": 3.0,
           "setup.coarse": 0.25, "setup.kernels": 9.0, "setup.warmup": 1.0}
RECORD = {"spans": {"setup_s": SETUP_S, "pass": {
    "busy_s": {"mg.restrict": 0.010, "mg.prolongate": 0.020,
               "cg.iteration": 0.012, "cg.operator": 0.5},
    "idle_s": {"mg.pre_smooth": 0.003, "mg.post_smooth": 0.009,
               "cg.iteration": 0.4},
    "tallies": {"solve": 2, "cg.iteration": 6, "mg.vcycle": 10},
}}}
EXPECTED = {"setup_mesh_dofs_s": 3.5, "setup_levels_s": 7.75,
            "transfer_ms": 3.0, "krylov_vector_ms": 2.0,
            "smoother_idle_ms": 1.2}


READERS = sorted(EXPECTED) + [m + ".host_paced" for m in sorted(EXPECTED)
                               if not m.startswith("setup")]


@pytest.mark.parametrize("name", READERS)
def test_span_readers(name):
    value = EXPECTED[name.split(".")[0]]
    assert frun.read_metric(name, RECORD) == pytest.approx(value)
    assert frun.read_metric(name, {}) is None
    assert frun.read_metric(name, {"spans": None}) is None
    no_pass = {"spans": {"setup_s": SETUP_S, "pass": None}}
    assert frun.read_metric(name, no_pass) == (
        pytest.approx(value) if name.startswith("setup") else None)



def test_launch_totals_leave_out_a_paused_block():
    from dealii_asm_tpu_torch import kernels

    key = "banded_laplace_f32"
    n0 = kernels.LAUNCHES[key]
    try:
        with profiling.tracing() as tracer:
            kernels.LAUNCHES[key] += 2
            with profiling.paused():
                kernels.LAUNCHES[key] += 5
            kernels.LAUNCHES[key] += 1
            assert tracer.totals == {"launches." + key: 3}
    finally:
        kernels.LAUNCHES[key] = n0


class _Event:
    """The part of a raw kineto event that the span pass reads."""

    def __init__(self, kind, name, a, b, corr=0, annotation=False):
        self.kind, self.name_, self.a, self.b = kind, name, a, b
        self.corr, self.annotation = corr, annotation

    def device_type(self):
        return self.kind

    def name(self):
        return self.name_

    def start_ns(self):
        return self.a

    def end_ns(self):
        return self.b

    def correlation_id(self):
        return self.corr

    def is_user_annotation(self):
        return self.annotation


def test_aten_stand_ins_serve_the_cpu_only():
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    host = [_Event(cpu, "cg.iteration", 0, 100, annotation=True),
            _Event(cpu, "mg.restrict", 10, 40, annotation=True),
            _Event(cpu, "aten::mm", 12, 20), _Event(cpu, "aten::add", 14, 16),
            _Event(cpu, "aten::dot", 50, 60)]
    names = {"cg.iteration", "mg.restrict"}
    out = spans.attribute(host, names, on_card=False)
    assert out["n_device_ops"] == 2  # the add runs inside the mm's span
    assert out["busy_s"] == pytest.approx({"mg.restrict": 8e-9,
                                           "cg.iteration": 10e-9})
    assert out["idle_s"] == pytest.approx({"mg.restrict": 30e-9})  # at 35
    assert spans.attribute(host, names, on_card=True) is None
    card = host + [_Event(cpu, "cudaLaunchKernel", 11, 12, corr=7),
                   _Event(cuda, "gemm", 30, 45, corr=7)]
    out = spans.attribute(card, names, on_card=True)
    assert out["n_device_ops"] == 1 and out["covered_s"] == out["device_s"]
    assert out["busy_s"] == pytest.approx({"mg.restrict": 15e-9})


def test_setup_seconds_are_exclusive():
    S = profiling.Span
    recs = [S("setup.operator", None, 0, None, None, 0, 10_000_000_000),
            S("cg.iteration", None, 1, 0, None, 1_000_000_000,
              5_000_000_000),
            S("setup.dofs", None, 2, 1, None, 2_000_000_000, 3_000_000_000),
            S("setup.dofs", None, 3, 2, None, 2_000_000_000,
              2_500_000_000)]
    secs = spans.setup_seconds(recs, profiling.SETUP)
    assert secs["setup.operator"] == pytest.approx(9.0)
    assert secs["setup.dofs"] == pytest.approx(1.0)
    assert sum(secs.values()) == pytest.approx(10.0)


BALL = dict(json.loads((Path(__file__).resolve().parents[1] / "experiments"
                        / "e2e_ball_q4.json").read_text()),
            **{"n refinements": 0, "print timing": False})
ASM_SPANS = ("asm.gather", "asm.scatter")


def test_ball_schwarz_spans_and_fixed_sum_gathers(monkeypatch):
    applies, calls = [], []
    vmult, call = GeneralASMPreconditioner.vmult, FixedOrderSum.__call__

    def counted_vmult(self, src):
        applies.append(self)
        return vmult(self, src)

    def counted_call(self, values):
        calls.append(self)
        return call(self, values)

    monkeypatch.setattr(GeneralASMPreconditioner, "vmult", counted_vmult)
    monkeypatch.setattr(FixedOrderSum, "__call__", counted_call)
    prog = harness.set_up(BALL, "cpu")  # its smoothers bind the counted vmult
    applies.clear()
    calls.clear()
    free = torch.as_tensor(~prog.A.__self__.dofs.boundary_mask)
    b = torch.where(free, torch.randn(prog.n_dofs, dtype=torch.float64,
                                      generator=torch.Generator().manual_seed(3)),
                    0.0)
    with profiling.tracing() as tracer:
        prog.solve(b)
    recs = tracer.records()
    assert applies
    for name in ASM_SPANS:
        mine = [s for s in recs if s.name == name]
        assert len(mine) == len(applies), name
        for s in mine:  # nested in a smoothing stage of a V-cycle
            assert recs[s.parent].name in ("mg.pre_smooth", "mg.post_smooth")
    scatters = [s for s in recs if s.name == "asm.scatter"]
    for s, asm in zip(scatters, applies):
        idx = asm.patch_idx.numpy().reshape(-1)
        counts = np.bincount(idx, minlength=asm.dofs.n_dofs + 1)
        groups = len(set(counts[:asm.dofs.n_dofs].tolist()) - {0})
        assert s.counts == {"fixed_sum.gathers": groups}
    assert tracer.totals["fixed_sum.gathers"] == sum(len(f.groups)
                                                     for f in calls)
    assert len(calls) > len(applies)  # the transfers' scatters too


def test_structured_spans_and_counters_are_as_before():
    prog = harness.set_up(CONFIGS["h"], "cpu")
    cells = (2 ** H["n refinements"],) * 3
    b = traffic.RightHandSides(traffic.load("smooth_rhs8"), 3, cells,
                               H["degree"], "cpu")(0)
    with profiling.tracing() as tracer:
        prog.solve(b)
    assert {s.name for s in tracer.records()} == {
        "solve", "cg.iteration", "cg.operator", "cg.precond", "mg.vcycle",
        *profiling.STAGES}
    assert set(tracer.totals) == {"host_syncs"}
