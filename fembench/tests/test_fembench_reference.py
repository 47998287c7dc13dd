"""The plain reference against the program's own pieces, on the CPU at
small sizes: operators, Schwarz applies, transfers and the V-cycle.  The
test imports the program; the reference does not."""

import copy
import json
from pathlib import Path

import pytest
import torch

from dealii_asm_tpu_torch.models import poisson
from dealii_asm_tpu_torch.ops.transfer import TwoLevelTransfer
from dealii_asm_tpu_torch.precond.asm import (ASMPreconditioner,
                                              CellASMPreconditioner)
from fembench.reference import multigrid as ref

ROOT = Path(__file__).resolve().parents[2]
CASES = [("aniso_q4", 2), ("kershaw_q4", 0)]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def config(name, refinements):
    with open(ROOT / "fembench" / "configs" / f"{name}.json") as f:
        cfg = copy.deepcopy(json.load(f)["config"])
    cfg["n refinements"] = refinements
    return cfg


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def pair(name, r, degree=4):
    cfg = config(name, r)
    fam = poisson.make_mesh_family(cfg)
    dofs = fam.dofs_at(r, degree)
    lv = ref.Problem(cfg).level(r, degree, torch.float64, "cpu")
    return cfg, fam, dofs, lv


@pytest.mark.parametrize("name,r", CASES)
def test_operator_matches_the_program(name, r):
    _, fam, dofs, lv = pair(name, r)
    op = fam.operator(dofs, torch.float64, "cpu")
    u = torch.randn(dofs.n_dofs, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(1))
    assert lv.n_dofs == dofs.n_dofs
    assert rel(lv.vmult(u), op.vmult(u)) < 1e-12


@pytest.mark.parametrize("name,r", CASES)
def test_schwarz_apply_matches_the_program(name, r):
    _, fam, dofs, lv = pair(name, r)
    cls = ASMPreconditioner if fam.transform is None else CellASMPreconditioner
    asm = cls(dofs, 1, "symm", torch.float64, "cpu")
    u = torch.randn(dofs.n_dofs, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(2))
    # the program rounds the Kershaw patch widths to 12 digits
    assert rel(ref.FDMSchwarz(lv).vmult(u), asm.vmult(u)) < 1e-10


@pytest.mark.parametrize("name,r,coarse", [("aniso_q4", 2, (1, 4)),
                                           ("kershaw_q4", 0, (0, 2))])
def test_transfer_matches_the_program(name, r, coarse):
    cfg, fam, dofs, lv = pair(name, r)
    rc, pc = coarse
    cd = fam.dofs_at(rc, pc)
    prog = TwoLevelTransfer(cd, dofs, torch.float64, "cpu")
    mine = ref.Transfer(ref.Problem(cfg).level(rc, pc, torch.float64, "cpu"), lv)
    g = torch.Generator().manual_seed(3)
    uc = torch.randn(cd.n_dofs, dtype=torch.float64, generator=g)
    uf = torch.randn(dofs.n_dofs, dtype=torch.float64, generator=g)
    assert rel(mine.prolongate(uc), prog.prolongate(uc)) < 1e-13
    assert rel(mine.restrict(uf), prog.restrict(uf)) < 1e-13


@pytest.mark.parametrize("name,r", CASES)
def test_vcycle_matches_the_program(name, r):
    """The whole V-cycle (levels, Chebyshev with its Lanczos estimates,
    transfers, dense coarse solve): equal to rounding against the program
    with float64 levels, and to float32 rounding against its float32
    levels."""
    cfg = config(name, r)
    quiet = dict(cfg, **{"print timing": False})
    _, V = ref.build(cfg, "cpu")
    n = ref.Problem(cfg).level(r, 4, torch.float64, "cpu").n_dofs
    b = torch.randn(n, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(4))
    for level_type, bound in (("float64", 1e-7), ("float32", 1e-5)):
        res = poisson.run_config(dict(quiet, **{"mg number type": level_type}),
                                 log=lambda *_: None, device="cpu")
        M = res["preconditioner"]
        lv = ref.Problem(cfg).level(r, 4, torch.float64, "cpu")
        b0 = torch.where(lv.free.reshape(-1), b, 0.0)
        assert rel(M.vmult(b0), V.vmult(b0)) < bound, level_type


def test_kershaw_map_keeps_the_cube():
    from fembench.reference.kershaw import kershaw

    corners = torch.tensor([[0.0, 0, 0], [1, 1, 1], [0, 1, 0], [1, 0, 1]]).numpy()
    assert (kershaw(corners, 0.3, 0.3) == corners).all()


def _published(name, refinements):
    cfg = json.loads((ROOT / "experiments" / f"{name}.json").read_text())
    cfg["n refinements"] = refinements
    return cfg


@pytest.mark.parametrize("edit", [
    None,  # e2e_kershaw_fdmv as published: vertex patches
    ("mg smoother", "ev algorithm", "power iteration"),
    ("mg smoother", "omega", 0.5),
    ("preconditioner", "sub mesh approximation", 1),
    ("preconditioner", "patch size", 3),
    (None, "one-sided v-cycle", True),
    (None, "mg intermediate smoother", {"type": "Chebyshev"}),
])
def test_options_the_reference_does_not_implement_raise(edit):
    """The vertex-patch Kershaw solve and other smoother or multigrid
    options are refused, not judged against element patches."""
    cfg = _published("e2e_kershaw_fdmv", 0)
    pre = cfg["preconditioner"]
    if edit is not None:
        pre["mg smoother"]["preconditioner"].pop("element centric")
        group, key, value = edit
        where = {None: pre, "mg smoother": pre["mg smoother"],
                 "preconditioner": pre["mg smoother"]["preconditioner"]}[group]
        where[key] = value
    with pytest.raises(ValueError,
                       match=edit[1] if edit else "element centric"):
        ref.build(cfg, "cpu")
