"""Configurations beyond the structured box, on the CPU at tiny sizes: the
lattice cells still run the harness's earlier code paths bit for bit, the
right-hand sides on point sets equal the lattice ones, a reference that
numbers its DoFs in another order reads the same numbers through the
matching of support points (and a point set that differs is not correct),
and an unstructured (hyperball) finest level is counted as kernel F's."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fembench import check, control, harness, run as frun, traffic
from fembench.reference import multigrid
from fembench.reference.fe import gll
from fembench.tests import shuffled_reference

ROOT = Path(__file__).resolve().parents[2]
SEED = 2 ** 31 + 99
LATTICE = [("aniso_q4_r7", 1), ("kershaw_q4", 0)]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def shuffled(monkeypatch):
    """The stand-in reference, found by name as a module under
    ``fembench/reference/`` would be."""
    monkeypatch.setitem(sys.modules, "fembench.reference.shuffled",
                        shuffled_reference)
    return shuffled_reference


# -- frozen copies of the harness's code paths before a configuration could
# -- name its reference (right-hand sides, finest-level facts, comparison)

class FrozenRightHandSides:
    def __init__(self, spec, seed, cells, degree, device, dtype=torch.float64):
        K, kmax = int(spec["right_hand_sides"]), int(spec["max_mode"])
        rng = np.random.default_rng(int(seed) % 2 ** 64)
        a = np.arange(1, kmax + 1)
        damp = (a[:, None, None] + a[None, :, None] + a[None, None, :]
                - 2.0) ** -float(spec["decay"])
        self.amp = torch.as_tensor(rng.standard_normal((K, kmax, kmax, kmax))
                                   * damp, dtype=dtype, device=device)
        self.sines = []
        for c in cells:
            nodes = gll(degree + 1)
            k = np.arange(int(c) * degree + 1)
            cell = np.minimum(k // degree, int(c) - 1)
            x = (cell + nodes[k - cell * degree]) / int(c)
            s = np.sin(np.pi * a[:, None] * x[None, :])
            s[:, [0, -1]] = 0.0
            self.sines.append(torch.as_tensor(s, dtype=dtype, device=device))
        self.count = K

    def __call__(self, k):
        sx, sy, sz = self.sines
        t = torch.einsum("cba,by,ax->cyx", self.amp[k], sy, sx)
        return (sz.mT @ t.reshape(t.shape[0], -1)).reshape(-1)


def frozen_finest(prog):
    op, sm = prog.finest_operator, prog.finest_smoother
    cells = int(op.dofs.mesh.n_cells_total)
    return {"kind": "deformed" if op.deformed else "cartesian",
            "cells": cells, "n": op.n_dofs, "p": op.degree,
            "itemsize": op.dtype.itemsize, "degree": int(sm.degree),
            "patches": (int(sm.M.__self__.V0.shape[0]) if op.deformed
                        else cells)}


def frozen_numbers(config, device, rhs, kept, vcycles):
    outer, V = multigrid.build(config, device=device)
    gaps, vgaps = [], []
    for k in sorted(kept):
        kp = kept[k]
        b = rhs(k).to(torch.float64)
        x = kp.x.to(device)
        true = float(torch.linalg.vector_norm(b - outer.vmult(x)))
        gaps.append(abs(true - kp.reported) / kp.norm_b)
        z = V.vmult(b)
        diff = vcycles[k].to(device=device, dtype=torch.float64) - z
        vgaps.append(float(torch.linalg.vector_norm(diff)
                           / torch.linalg.vector_norm(z)))
    return {"residual_gap": max(gaps), "vcycle_gap": max(vgaps)}


@pytest.mark.parametrize("name,r", LATTICE)
def test_lattice_cells_keep_their_code_paths(tiny_cell, name, r):
    """Right-hand sides, finest facts and both compared numbers equal,
    bit for bit, what the frozen copies give; the program's points are
    never asked for."""
    cell = tiny_cell(name, r)
    answers = control.ProgramAnswers(cell, "cpu")
    assert answers.prog.finest == frozen_finest(answers.prog)

    def no_points():
        raise AssertionError("a lattice cell's program points were built")

    nb = harness.numbering(cell, no_points)
    assert nb.perm is None and nb.lattice is not None
    rhs = harness.right_hand_sides(cell, SEED, nb, "cpu")
    assert type(rhs) is traffic.RightHandSides
    prob = multigrid.Problem(cell["config"])
    old = FrozenRightHandSides(cell["traffic"], SEED,
                               [c * 2 ** prob.refinements for c in prob.base],
                               prob.degree, "cpu")
    for k in range(rhs.count):
        assert torch.equal(rhs(k), old(k))
    sample = harness.sample_of(SEED, rhs.count, harness.SAMPLE)
    kept, vcycles = answers(rhs, sample)
    assert (check.Judge(cell, "cpu").numbers(rhs, kept, vcycles)
            == frozen_numbers(cell["config"], "cpu", old, kept, vcycles))


@pytest.mark.parametrize("name,r", LATTICE)
def test_point_right_hand_sides_equal_the_lattice_ones(tiny_cell, monkeypatch,
                                                       name, r):
    """Fed the lattice's own points (several chunks), the point generator
    gives the lattice generator's vectors to 1e-14 relative, zero on the
    boundary."""
    monkeypatch.setattr(traffic.PointRightHandSides, "CHUNK", 100)
    cell = tiny_cell(name, r)
    _, free, unit = multigrid.points(cell["config"])
    cells, degree = multigrid.lattice(cell["config"])
    on_lattice = traffic.RightHandSides(cell["traffic"], SEED, cells, degree,
                                        "cpu")
    on_points = traffic.PointRightHandSides(cell["traffic"], SEED, unit, free,
                                            "cpu")
    assert on_points.count == on_lattice.count
    for k in range(on_lattice.count):
        a, b = on_lattice(k), on_points(k)
        assert float((a - b).abs().max()) <= 1e-14 * float(a.abs().max())
        assert not b[torch.as_tensor(~free)].any()


@pytest.mark.parametrize("name,r", LATTICE)
def test_a_reference_in_another_order_reads_the_same(tiny_cell, shuffled,
                                                     name, r):
    """The stand-in numbers its DoFs in a shuffled order and gives only its
    support points: matched by them, the comparison reads what the lattice
    reference reads on the same answers."""
    cell = tiny_cell(name, r)
    other = dict(cell, reference="shuffled")
    answers = control.ProgramAnswers(cell, "cpu")
    nb = harness.numbering(other, answers.points)
    assert nb.mismatch is None and nb.lattice is None
    n = answers.prog.n_dofs
    # program DoF i (lattice DoF i) is stand-in DoF j with order[j] = i
    assert torch.equal(shuffled._order(n)[nb.perm], torch.arange(n))
    rhs = harness.right_hand_sides(other, SEED, nb, "cpu")
    assert type(rhs) is traffic.PointRightHandSides
    sample = harness.sample_of(SEED, rhs.count, harness.SAMPLE)
    kept, vcycles = answers(rhs, sample)
    mine = check.Judge(other, "cpu", nb.perm).numbers(rhs, kept, vcycles)
    lattice = check.Judge(cell, "cpu").numbers(rhs, kept, vcycles)
    for key, value in lattice.items():
        assert mine[key] == pytest.approx(value, rel=1e-12, abs=0.0)


@pytest.mark.parametrize("moved", [0, 5])
def test_a_run_against_a_reference_in_another_order(tiny_cell, shuffled,
                                                    monkeypatch, moved):
    """``run.measure`` and ``run.result`` reach a verdict with the stand-in
    named by the cell: correct where its points are the program's, not
    correct, with the reason under ``checks``, where five of them moved."""
    monkeypatch.setattr(shuffled, "MOVED", moved)
    cell = dict(tiny_cell("aniso_q4_r7", 1), reference="shuffled")
    rec = frun.measure(cell, SEED, 0.2, False, device="cpu")
    line = frun.result(cell, rec, False, {"platform": "cpu"})
    if moved:
        assert not line["correct"] and line["attempted"] == 0
        assert "5 of the program's" in line["checks"]["numbering"]
    else:
        assert line["correct"], line["checks"]
        assert set(cell["end_to_end"]) <= set(line["metrics"])


def test_match_points_names_what_differs():
    pts = np.random.default_rng(3).random((50, 3))
    perm = np.random.default_rng(4).permutation(50)
    got, why = harness.match_points(pts, pts[np.argsort(perm)])
    assert why is None and np.array_equal(np.argsort(perm)[got], np.arange(50))
    assert "the reference 49" in harness.match_points(pts, pts[:49])[1]
    twin = pts.copy()
    twin[1] = twin[0]
    assert "no reference point" in harness.match_points(pts, twin)[1]


def ball_config(refinements: int) -> dict:
    cfg = json.loads((ROOT / "experiments" / "e2e_ball_q4.json").read_text())
    cfg["n refinements"] = refinements
    return cfg


def test_a_ball_level_is_general_and_its_shares_are_read():
    """The hyperball (kernel F's operator, the unstructured Schwarz apply)
    goes through the set-up and the traced stages; both roofline readers
    give a number from its finest level's facts."""
    prog = harness.set_up(ball_config(0), "cpu")
    f = prog.finest
    assert f["kind"] == "general" and f["patches"] == f["cells"]
    pts = prog.points()
    assert pts.shape == (prog.n_dofs, 3)
    unit = (pts + 1.0) / 2.0  # the ball lies in [-1, 1]³
    free = ~np.asarray(prog.A.__self__.dofs.boundary_mask)
    rhs = traffic.PointRightHandSides(traffic.load("smooth_rhs8"), SEED, unit,
                                      free, "cpu")
    sample = harness.sample_of(SEED, rhs.count, harness.SAMPLE)
    run = {"finest": f, "stages": harness.traced_stages(prog, rhs, sample, 1)}
    for name in ("level_vmult_roofline", "smoother_roofline"):
        value = frun.read_metric(name, run)
        assert value is not None and value > 0
