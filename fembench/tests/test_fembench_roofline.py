"""The frozen work counts against the shapes the program's finest level
really has: each byte count equals the input and output vectors plus the
tables the program holds for the call, read from its own tensors."""

import json
from pathlib import Path

import pytest
import torch

from fembench import harness, roofline

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def numel(*tensors):
    return sum(t.numel() for t in tensors)


def tiny_config(tiny_cell, name, r):
    """A cell's configuration, or the hyperball's published one
    (``experiments/e2e_ball_q4.json``, no cell yet), cut to ``r``."""
    if name != "ball":
        return tiny_cell(name, r)["config"]
    cfg = json.loads((ROOT / "experiments" / "e2e_ball_q4.json").read_text())
    cfg["n refinements"] = r
    return cfg


@pytest.mark.parametrize("name,r", [("aniso_q4_r7", 2), ("kershaw_q4", 0),
                                    ("ball", 0)])
def test_counts_are_the_finest_levels_tensors(tiny_cell, name, r):
    prog = harness.set_up(tiny_config(tiny_cell, name, r), "cpu")
    f = prog.finest
    op, sm = prog.finest_operator, prog.finest_smoother
    fdm = sm.M.__self__
    s = f["itemsize"]
    assert s == 4 and op.dtype == torch.float32
    n = op.n_dofs
    index_bytes = 0  # kernel F's int32 DoF table
    if f["kind"] == "cartesian":
        op_tables = numel(*op.tables.Mdiags, *op.tables.Kdiags)
        fdm_tables = numel(*[getattr(fdm, f"{k}{d}") for k in
                             ("V", "lam", "fin", "fout") for d in range(3)])
    else:
        assert f["kind"] == ("general" if name == "ball" else "deformed")
        op_tables = numel(op.coeff6) + 4 * (op.degree + 1) ** 2
        fdm_tables = numel(fdm.V0, fdm.V1, fdm.V2, fdm.inv_denom)
        assert f["patches"] == fdm.V0.shape[0] == op.dofs.mesh.n_cells_total
        if f["kind"] == "general":
            assert numel(op.shape_tabs) == 4 * (op.degree + 1) ** 2
            cd = op.tables.cell_dofs
            assert cd.dtype == torch.int32
            index_bytes = cd.numel() * cd.element_size()
    assert roofline.level_vmult_work(f)[0] == ((2 * n + op_tables) * s
                                               + index_bytes)
    assert roofline.smoother_step_work(f)[0] == ((3 * n + op_tables
                                                  + fdm_tables) * s
                                                 + index_bytes)
    assert f["degree"] == sm.degree


N64, N48, BALL = 257 ** 3, 193 ** 3, 8_438_273  # 64³, 48³ Q4; the ball r4 Q4
CHIP_BOUNDS = {  # (count, itemsize, ms) as the program's kernel table states
    "A f32 64³ Q4": (roofline.banded_work(N64, 4, 4), 4, 0.0406),
    "C 64³ Q4": (roofline.smoother_step_work(
        {"kind": "cartesian", "n": N64, "p": 4, "itemsize": 4, "degree": 1,
         "cells": 64 ** 3}), 4, 0.0622),
    "E f32 48³ Q4": (roofline.merged_work(48 ** 3, N48, 4, 4), 4, 0.1162),
    "F f32 131,072 cells Q4": (roofline.lanes_work(131_072, BALL, 4, 4), 4,
                               0.1571),
    "F f64 131,072 cells Q4": (roofline.lanes_work(131_072, BALL, 4, 8), 8,
                               0.2946),
}


@pytest.mark.parametrize("call", sorted(CHIP_BOUNDS))
def test_counts_give_the_programs_chip_bounds(call):
    """The copies give the bounds (ms) of the program's kernel table."""
    work, itemsize, ms = CHIP_BOUNDS[call]
    assert round(roofline.least_seconds(*work, itemsize) * 1e3, 4) == ms


@pytest.mark.parametrize("name,cells,n", [("aniso_q4", 128 ** 3, 135_005_697),
                                          ("kershaw_q4", 48 ** 3, 7_189_057),
                                          ("aniso_q4_r6", 64 ** 3, 16_974_593)])
def test_cells_at_their_timed_size(name, cells, n):
    data = harness.read_json(harness.ROOT / "configs" / f"{name}.json")
    ref = harness.reference(data)
    c, degree = ref.lattice(data["config"])
    assert c[0] * c[1] * c[2] == cells
    assert (degree * c[0] + 1) ** 3 == ref.n_dofs(data["config"]) == n


def test_per_patch_fdm_count():
    b, f = roofline.patch_fdm_work(10, 100, 5, 4)
    assert b == (2 * 100 + 10 * (3 * 25 + 125)) * 4
    assert f == 2.0 * 10 * (6 * 5 ** 4 + 5 ** 3)
