"""The hyperball's plain reference (``fembench/reference/ball.py``) on the
CPU at small sizes: its operator, Schwarz apply, transfers, support points
and V-cycle against the definitions and against the program, and the
cell ``ball_q4`` through ``run.measure``.  The test imports the program;
the reference does not.  (The harness's tiny runs of ``ball_q4`` take
their size from the repository's ``conftest.py``.)"""

import copy
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dealii_asm_tpu_torch.models import poisson
from dealii_asm_tpu_torch.ops.transfer_general import GeneralTwoLevelTransfer
from dealii_asm_tpu_torch.precond.asm_general import GeneralASMPreconditioner
from fembench import check, control, harness, run as frun
from fembench.reference import ball, multigrid
from fembench.reference.ball_numbering import program_order
from fembench.reference.fe import gll, lagrange

ROOT = Path(__file__).resolve().parents[2]
SEED = 2 ** 31 + 61


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def config(refinements: int, degree: int = 4) -> dict:
    cfg = json.loads((ROOT / "fembench" / "configs" / "ball_q4.json")
                     .read_text())["config"]
    cfg = copy.deepcopy(cfg)
    cfg["n refinements"], cfg["degree"] = refinements, degree
    cfg["print timing"] = False
    return cfg


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def program_dofs(r: int, p: int):
    """The program's DoF handler at (r, p) and ``perm``: program DoF i is
    the reference's DoF perm[i]."""
    dofs = poisson.make_mesh_family(config(r, p)).dofs_at(r, p)
    _, support, _ = ball.numbering(r, p)
    perm, why = harness.match_points(dofs.points, np.asarray(support))
    assert why is None, why
    return dofs, torch.as_tensor(perm)


def to_ref(u, perm):
    out = torch.empty_like(u)
    out[perm] = u
    return out


@pytest.mark.parametrize("r,p", [(0, 4), (1, 4), (2, 4), (0, 1), (1, 1),
                                 (2, 1), (1, 2), (2, 2)])
def test_points_match_the_program(r, p):
    """Every program support point has one reference point within the
    harness's tolerance, the sphere's DoFs are the program's Dirichlet
    DoFs, the count is the entity count's, and the reference's copy of the
    program's numbering (``ball_numbering``, the Lanczos start vector's)
    puts each reference DoF where the program has it."""
    dofs, perm = program_dofs(r, p)
    support, free, unit = ball.points(config(r, p))
    assert len(free) == dofs.n_dofs == ball.count_dofs(r, p)
    assert np.array_equal(free[perm.numpy()], ~dofs.boundary_mask)
    assert np.allclose(np.linalg.norm(support[~free], axis=1), 1.0)
    assert unit.min() >= 0.0 and unit.max() <= 1.0
    assert np.array_equal(program_order(r, p)[perm.numpy()],
                          np.arange(dofs.n_dofs))


def test_the_published_size_is_counted():
    assert ball.n_dofs(config(4)) == 8_438_273


@pytest.mark.parametrize("r,p", [(0, 2), (1, 1)])
def test_operator_is_spd_and_maps_a_constant_to_zero(r, p):
    lv = ball.BallLevel(r, p)
    A = lv.dense()
    free = lv.free
    assert rel(A, A.T) < 1e-13
    Af = A[free][:, free]
    assert float(torch.linalg.eigvalsh(Af)[0]) > 0.0
    ones = torch.ones(lv.n_dofs, dtype=torch.float64)
    # the cell integrals before the Dirichlet rows: ∇1 = 0 in every cell
    assert float(lv.cell_sum(ones, lv._cell_laplace).abs().max()) < (
        1e-13 * float(Af.abs().max()))


def test_patch_inverse_is_the_dense_inverse_of_its_tensor_matrix():
    """Cells inside a coarse cell, at a coarse face and at the sphere: the
    fast-diagonalization apply equals the dense inverse of
    K_z⊗M_y⊗M_x + M_z⊗K_y⊗M_x + M_z⊗M_y⊗K_x of the cell's 1D problems."""
    lv = ball.BallLevel(1, 3)
    S = ball.CellSchwarz(lv)
    ext = lv.extents()
    lo, hi = ball.neighbour_extents(lv, ext)
    ext = ext.numpy()
    n = lv.n1
    shell = int(np.flatnonzero(ball.coarse_cells()[1] >= 0)[0])
    u = torch.zeros((ball.N_COARSE, 2, 2, 2, n, n, n), dtype=torch.float64)
    for c, z, y, x in [(0, 0, 0, 0), (0, 1, 1, 1), (shell, 0, 1, 0),
                       (shell, 1, 1, 1)]:
        mats = []
        for d in range(3):
            at = (c, z, y, x, slice(d, d + 1))
            M, K = multigrid._fdm_1d(lv.p, lo[at], ext[at], hi[at])
            mats.append((M[0], K[0]))
        (Mx, Kx), (My, Ky), (Mz, Kz) = mats
        P = (np.kron(Kz, np.kron(My, Mx)) + np.kron(Mz, np.kron(Ky, Mx))
             + np.kron(Mz, np.kron(My, Kx)))
        cols = []
        for e in torch.eye(n ** 3, dtype=torch.float64):
            u.zero_()
            u[c, z, y, x] = e.reshape(n, n, n)
            cols.append(S._local(u, 0, ball.N_COARSE)[c, z, y, x].reshape(-1))
        assert rel(torch.stack(cols, 1),
                   torch.as_tensor(np.linalg.inv(P))) < 1e-11


@pytest.mark.parametrize("r,p", [(0, 4), (1, 4), (1, 1)])
def test_operator_and_schwarz_apply_match_the_program(r, p):
    dofs, perm = program_dofs(r, p)
    fam = poisson.make_mesh_family(config(r, p))
    op = fam.operator(dofs, torch.float64, "cpu")
    asm = GeneralASMPreconditioner(dofs, 1, "symm", torch.float64, "cpu")
    lv = ball.BallLevel(r, p)
    u = torch.randn(dofs.n_dofs, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(5))
    assert rel(lv.vmult(to_ref(u, perm))[perm], op.vmult(u)) < 1e-13
    # the program rounds the patch widths to 12 digits
    assert rel(ball.CellSchwarz(lv).vmult(to_ref(u, perm))[perm],
               asm.vmult(u)) < 1e-10


def evaluate(level: ball.BallLevel, u: torch.Tensor, cell: int,
             ref: np.ndarray) -> np.ndarray:
    """The level's FE function u at reference points ``ref`` (P, 3) of
    coarse cell ``cell``: the Lagrange basis of the sub-box holding each
    point, from its node values."""
    C, p = level.n_sub, level.p
    lat = u[level.gidx[cell]].numpy()  # [z, y, x]
    box = np.minimum(np.floor(ref * C).astype(int), C - 1)
    local = ref * C - box
    out = np.empty(len(ref))
    nodes = gll(p + 1)
    for i in range(len(ref)):
        vx, vy, vz = (lagrange(nodes, local[i, d:d + 1])[0][0]
                      for d in range(3))
        bx, by, bz = box[i] * p
        vals = lat[bz:bz + p + 1, by:by + p + 1, bx:bx + p + 1]
        out[i] = np.einsum("zyx,z,y,x->", vals, vz, vy, vx)
    return out


@pytest.mark.parametrize("coarse,fine", [((0, 1), (1, 1)), ((1, 1), (1, 2)),
                                         ((1, 2), (1, 4))])
def test_prolongation_reproduces_the_coarse_space(coarse, fine):
    """The prolongated vector is the coarse function itself, at random
    points of every coarse cell; restriction is its transpose."""
    lc, lf = ball.BallLevel(*coarse), ball.BallLevel(*fine)
    T = ball.Transfer(lc, lf)
    g = torch.Generator().manual_seed(6)
    uc = torch.where(lc.free, torch.randn(lc.n_dofs, dtype=torch.float64,
                                          generator=g), 0.0)
    uf = T.prolongate(uc)
    rng = np.random.default_rng(7)
    for cell in range(ball.N_COARSE):
        pts = rng.random((5, 3))
        a, b = evaluate(lf, uf, cell, pts), evaluate(lc, uc, cell, pts)
        assert np.allclose(a, b, rtol=0, atol=1e-13 * float(uc.abs().max()))
    vf = torch.randn(lf.n_dofs, dtype=torch.float64, generator=g)
    assert float(vf @ T.prolongate(uc)) == pytest.approx(
        float(T.restrict(vf) @ uc), rel=1e-13)


@pytest.mark.parametrize("coarse,fine", [((0, 1), (1, 1)), ((1, 2), (1, 4))])
def test_transfers_match_the_program(coarse, fine):
    fam = poisson.make_mesh_family(config(fine[0], fine[1]))
    dc, df = fam.dofs_at(*coarse), fam.dofs_at(*fine)
    prog = GeneralTwoLevelTransfer(dc, df, torch.float64, "cpu")
    mine = ball.Transfer(ball.BallLevel(*coarse), ball.BallLevel(*fine))
    pc = torch.as_tensor(harness.match_points(
        dc.points, np.asarray(ball.numbering(*coarse)[1]))[0])
    pf = torch.as_tensor(harness.match_points(
        df.points, np.asarray(ball.numbering(*fine)[1]))[0])
    g = torch.Generator().manual_seed(8)
    uc = torch.randn(dc.n_dofs, dtype=torch.float64, generator=g)
    uf = torch.randn(df.n_dofs, dtype=torch.float64, generator=g)
    assert rel(mine.prolongate(to_ref(uc, pc))[pf], prog.prolongate(uc)) < 1e-13
    assert rel(mine.restrict(to_ref(uf, pf))[pc], prog.restrict(uf)) < 1e-13


def _smoothers(mg):
    """The program's level smoothers, coarse → fine, nested layouts too."""
    out = []
    while True:
        out = list(mg.smoothers) + out
        inner = getattr(mg.coarse_solver, "__self__", None)
        if type(inner) is not type(mg):
            return out
        mg = inner


@pytest.mark.parametrize("r", [1, 2])
def test_vcycle_is_the_programs(r):
    """The reference's V-cycle (its own Lanczos estimates from the
    program's i mod 11, levels, Schwarz applies, transfers, dense coarse
    solve) is the program's float64 V-cycle to rounding."""
    cfg = config(r)
    res = poisson.run_config(dict(cfg, **{"mg number type": "float64"}),
                             log=lambda *_: None, device="cpu")
    M = res["preconditioner"]
    dofs, perm = program_dofs(r, 4)
    _, V = ball.build(cfg, "cpu")
    # both estimates stop at the same Lanczos step (the Q1 level at one
    # refinement converges within the 40): they agree to rounding
    for mine, theirs in zip(V.smoothers, _smoothers(M)):
        assert mine.lam == pytest.approx(
            theirs.eigenvalues.max_eigenvalue_estimate, rel=1e-10)
    b = torch.where(torch.as_tensor(~dofs.boundary_mask),
                    torch.randn(dofs.n_dofs, dtype=torch.float64,
                                generator=torch.Generator().manual_seed(9)),
                    0.0)
    # rounding of float64 applies; the widths' 12-digit rounding in the
    # program moves the patch inverses by about 1e-12
    assert rel(V.vmult(to_ref(b, perm))[perm], M.vmult(b)) < 1e-11


def test_the_program_against_the_reference_through_measure(tiny_cell):
    """The ball at one refinement through ``run.measure``'s path with
    float64 levels: the outer operators, answers and V-cycles agree to
    rounding; the float32 control fails the residual gap."""
    cell = tiny_cell("ball_q4", 1)
    cell["config"]["preconditioner"]["mg number type"] = "float64"
    rec = frun.measure(cell, SEED, 0.2, False, device="cpu")
    # float64 operators on both sides: ‖b − A x‖ differs from the solve's
    # recurrence residual by rounding alone
    assert rec["numbers"]["residual_gap"] <= 1e-10
    # float64 V-cycles on both sides, the same eigenvalue estimates (see
    # test_vcycle_is_the_programs): rounding, far below the float32
    # levels' 1e-7 that the cell's limit has to pass
    assert rec["numbers"]["vcycle_gap"] <= 1e-6
    assert frun.result(cell, rec, False, {})["correct"]
    ctl, = control.readings(tiny_cell("ball_q4", 1), [SEED], False, "cpu")
    limits = cell["workload"]["limits"]
    # a float32 outer CG reports a residual that the float64 operator
    # does not find, 1e-5 against 1e-7
    assert ctl["numbers"]["residual_gap"] > 10 * limits["residual_gap"]
    assert not check.judge(ctl["numbers"], limits)[0]


@pytest.mark.parametrize("edit", [
    ("mesh", "name", "hypercube"),
    (None, "dim", 2),
    ("preconditioner", "mg type", "h"),
    ("schwarz", "element centric", False),
    ("schwarz", "n overlap", 2),
    ("schwarz", "weighting type", "ras"),
    ("smoother", "ev algorithm", "power iteration"),
])
def test_options_the_reference_lacks_raise(edit):
    cfg = config(0)
    group, key, value = edit
    pre = cfg["preconditioner"]
    where = {None: cfg, "mesh": cfg["mesh"], "preconditioner": pre,
             "smoother": pre["mg smoother"],
             "schwarz": pre["mg smoother"]["preconditioner"]}[group]
    where[key] = value
    with pytest.raises(ValueError):
        ball.build(cfg, "cpu")


def test_the_reference_loads_nothing_of_the_program():
    code = ("import json, sys; from fembench.reference import ball; "
            "cfg = json.load(open('fembench/configs/ball_q4.json'))['config']; "
            "cfg['n refinements'] = 0; ball.build(cfg, 'cpu'); ball.points(cfg); "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    names = set(json.loads(out.stdout.splitlines()[-1]))
    assert not names & {"dealii_asm_tpu_torch", "dealii_asm_tpu", "jax",
                        "jaxlib", "flax"}
