"""The frozen work counts against the shapes the program's finest level
really has: each byte count equals the input and output vectors plus the
tables the program holds for the call, read from its own tensors."""

import pytest
import torch

from fembench import harness, roofline
from fembench.reference.multigrid import Problem


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def numel(*tensors):
    return sum(t.numel() for t in tensors)


@pytest.mark.parametrize("name,r", [("aniso_q4_r7", 2), ("kershaw_q4", 0)])
def test_counts_are_the_finest_levels_tensors(tiny_cell, name, r):
    cell = tiny_cell(name, r)
    prog = harness.set_up(cell["config"], "cpu")
    f = prog.finest
    op, sm = prog.finest_operator, prog.finest_smoother
    fdm = sm.M.__self__
    s = f["itemsize"]
    assert s == 4 and op.dtype == torch.float32
    n = op.n_dofs
    if f["kind"] == "cartesian":
        op_tables = numel(*op.tables.Mdiags, *op.tables.Kdiags)
        fdm_tables = numel(*[getattr(fdm, f"{k}{d}") for k in
                             ("V", "lam", "fin", "fout") for d in range(3)])
    else:
        op_tables = numel(op.coeff6) + 4 * (op.degree + 1) ** 2
        fdm_tables = numel(fdm.V0, fdm.V1, fdm.V2, fdm.inv_denom)
        assert f["patches"] == fdm.V0.shape[0] == op.dofs.mesh.n_cells_total
    assert roofline.level_vmult_work(f)[0] == (2 * n + op_tables) * s
    assert roofline.smoother_step_work(f)[0] == (3 * n + op_tables
                                                 + fdm_tables) * s
    assert f["degree"] == sm.degree


def test_counts_give_the_programs_chip_bounds():
    """The copies give the bounds the program's kernel table states (ms):
    A f32 at 64³ Q4 0.0406, C 0.0622, E f32 at 48³ Q4 0.1162."""
    n64, n48 = 257 ** 3, 193 ** 3
    a = roofline.least_seconds(*roofline.banded_work(n64, 4, 4), 4)
    c = roofline.least_seconds(*roofline.smoother_step_work(
        {"kind": "cartesian", "n": n64, "p": 4, "itemsize": 4, "degree": 1,
         "cells": 64 ** 3}), 4)
    e = roofline.least_seconds(*roofline.merged_work(48 ** 3, n48, 4, 4), 4)
    assert round(a * 1e3, 4) == 0.0406
    assert round(c * 1e3, 4) == 0.0622
    assert round(e * 1e3, 4) == 0.1162


@pytest.mark.parametrize("name,cells,n", [("aniso_q4", 128 ** 3, 135_005_697),
                                          ("kershaw_q4", 48 ** 3, 7_189_057)])
def test_cells_at_their_timed_size(name, cells, n):
    from fembench.harness import read_json, ROOT

    prob = Problem(read_json(ROOT / "configs" / f"{name}.json")["config"])
    c = [b * 2 ** prob.refinements for b in prob.base]
    assert c[0] * c[1] * c[2] == cells
    assert (prob.degree * c[0] + 1) ** 3 == n


def test_per_patch_fdm_count():
    b, f = roofline.patch_fdm_work(10, 100, 5, 4)
    assert b == (2 * 100 + 10 * (3 * 25 + 125)) * 4
    assert f == 2.0 * 10 * (6 * 5 ** 4 + 5 ** 3)
