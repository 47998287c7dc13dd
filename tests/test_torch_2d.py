"""2D meshes in the port against the JAX package: Cartesian, deformed
(Kershaw) and the unstructured ball.

The JAX package reaches no Pallas kernel in 2D (its kernels A-F require
dim 3), so the port's 2D path is plain torch on every device: the banded
separable operator or the merged form (three coefficients a quadrature
point), the global or per-patch FDM form, the general operator of the
ball with its fixed-order scatter, the transfers and the multigrid.  Inputs come from a seeded numpy generator and go to both
packages.

Tolerances (float64):
- operator apply: rel 1e-12 against the JAX ``kernel="banded"`` path (the
  same banded products summed in another order); the JAX default float64
  path is a double-single composition that XLA:CPU degrades to ~3e-8;
- inverse diagonal, rhs with its Dirichlet lift, FDM applies (overlap 1 and
  2, vertex patches, every weighting, RAS), transfers, the dense coarse
  inverse and a V-cycle over float64 levels: rel 1e-12;
- float32 operator: rel 1e-5 (float32 rounding).
Deformed and ball operators, per-patch FDM and ball transfers: rel 1e-12
(float64), the JAX general operator in its cell-major float64 form.
Counts: ``inputs/dummy.json`` (2D Q3, 625 DoFs, CG around Diagonal) takes
the JAX package's count (24), run live here, as are CG around Diagonal on
2D Kershaw and the 2D ball; the multigrid counts are the JAX package's.
"""

import copy
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dealii_asm_tpu.fem.dofs import DofHandler as JaxDofHandler
from dealii_asm_tpu.fem.functions import make_rhs_and_dbc as jax_rhs_and_dbc
from dealii_asm_tpu.mesh.grid import StructuredMesh as JaxMesh
from dealii_asm_tpu.models.poisson import run_config as jax_run_config
from dealii_asm_tpu.ops.laplace import LaplaceOperator as JaxLaplace
from dealii_asm_tpu.ops.transfer import TwoLevelTransfer as JaxTransfer
from dealii_asm_tpu.precond.asm import ASMPreconditioner as JaxASM
from dealii_asm_tpu.precond.factory import \
    create_system_preconditioner as jax_create
from dealii_asm_tpu.precond.multigrid import DirectCoarseSolver as JaxDirect
from dealii_asm_tpu.precond.multigrid import Multigrid as JaxMultigrid
from dealii_asm_tpu.fem.general_dofs import GeneralDofHandler as JaxGeneralDofs
from dealii_asm_tpu.mesh.transforms import kershaw_transform
from dealii_asm_tpu.mesh.unstructured import \
    hyper_ball_balanced as jax_hyper_ball
from dealii_asm_tpu.ops.laplace_general import \
    GeneralLaplaceOperator as JaxGeneralLaplace
from dealii_asm_tpu.ops.transfer_general import \
    GeneralTwoLevelTransfer as JaxGeneralTransfer
from dealii_asm_tpu.precond.asm_general import \
    GeneralASMPreconditioner as JaxGeneralASM
from dealii_asm_tpu_torch.interop import (dofs_from_jax,
                                          general_dofs_from_jax,
                                          general_laplace_from_jax,
                                          laplace_from_jax)
from dealii_asm_tpu_torch.kernels.merged_laplace import merged_laplace_plain
from dealii_asm_tpu_torch.ops.laplace_general import GeneralLaplaceOperator
from dealii_asm_tpu_torch.ops.transfer_general import GeneralTwoLevelTransfer
from dealii_asm_tpu_torch.precond.asm_general import GeneralASMPreconditioner
from dealii_asm_tpu_torch.fem.dofs import DofHandler
from dealii_asm_tpu_torch.fem.functions import make_rhs_and_dbc
from dealii_asm_tpu_torch.fem.patches import (element_patch_indices,
                                              vertex_patch_indices)
from dealii_asm_tpu_torch.mesh.grid import StructuredMesh
from dealii_asm_tpu_torch.models.poisson import run_config
from dealii_asm_tpu_torch.ops.laplace import LaplaceOperator
from dealii_asm_tpu_torch.ops.lattice import (grid_to_windows, window_layout,
                                              windows_to_grid)
from dealii_asm_tpu_torch.ops.transfer import TwoLevelTransfer
from dealii_asm_tpu_torch.precond.asm import (ASMPreconditioner,
                                              CellASMPreconditioner)
from dealii_asm_tpu_torch.precond.diagonal import DiagonalPreconditioner
from dealii_asm_tpu_torch.precond.factory import create_system_preconditioner
from dealii_asm_tpu_torch.precond.multigrid import (DirectCoarseSolver,
                                                    Multigrid)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test process (see tests/test_torch_gmres.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _quiet(*_):
    pass


def _dofs(cells, p, **mesh_kw):
    """(JAX DofHandler, port DofHandler) of the same 2D lattice."""
    return (JaxDofHandler(JaxMesh(2, cells, **mesh_kw), p),
            DofHandler(StructuredMesh(2, cells, **mesh_kw), p))


def _rel(a, b):
    b = np.asarray(b)
    return np.abs(np.asarray(a) - b).max() / np.abs(b).max()


def _vec(n, seed):
    return np.random.default_rng(seed).standard_normal(n)


CASES = [((2, 3), 1), ((3, 2), 2), ((4, 5), 3), ((3, 3), 4), ((2, 2), 7)]


@pytest.mark.parametrize("cells,p", CASES)
def test_operator_matches_jax(cells, p):
    jdofs, dofs = _dofs(cells, p, lengths=(1.0, 3.0))
    x = _vec(dofs.n_dofs, p)
    ref = np.asarray(JaxLaplace(jdofs, dtype=jnp.float64, kernel="banded")
                     .vmult(jnp.asarray(x)))
    op = LaplaceOperator(dofs, device="cpu")
    assert op.tables is not None and op.grid_shape == tuple(
        reversed(dofs.nodes_per_dim))
    assert _rel(op.vmult(torch.as_tensor(x)).numpy(), ref) < 1e-12
    r = op.residual(torch.ones(dofs.n_dofs, dtype=torch.float64),
                    torch.as_tensor(x))
    assert _rel(r.numpy(), 1.0 - ref) < 1e-12
    op32 = LaplaceOperator(dofs, dtype=torch.float32, device="cpu")
    got32 = op32.vmult(torch.as_tensor(x, dtype=torch.float32))
    assert got32.dtype == torch.float32 and _rel(got32.numpy(), ref) < 1e-5


@pytest.mark.parametrize("cells,p", CASES)
def test_inverse_diagonal_and_diagonal_preconditioner_match_jax(cells, p):
    jdofs, dofs = _dofs(cells, p)
    ref = np.asarray(JaxLaplace(jdofs, dtype=jnp.float64)
                     .compute_inverse_diagonal())
    op = LaplaceOperator(dofs, device="cpu")
    got = op.compute_inverse_diagonal()
    assert _rel(got.numpy(), ref) < 1e-12
    np.testing.assert_array_equal(got.numpy()[dofs.boundary_mask], 1.0)
    x = _vec(dofs.n_dofs, 3)
    assert _rel(DiagonalPreconditioner(op).vmult(torch.as_tensor(x)).numpy(),
                ref * x) < 1e-12


@pytest.mark.parametrize("rhs", ["constant", "gaussian", "gaussian-jw",
                                 "sin-mp"])
@pytest.mark.parametrize("origin,lengths", [((0.0, 0.0), (1.0, 1.0)),
                                            ((-1.0, -1.0), (2.0, 2.0))])
def test_rhs_with_lift_matches_jax(rhs, origin, lengths):
    """The JAX rhs with its constrained entries set to 0 (the homogeneous
    system the port solves); the Dirichlet data at the constrained nodes."""
    jdofs, dofs = _dofs((3, 4), 3, origin=origin, lengths=lengths)
    f, g = jax_rhs_and_dbc(rhs, 2)
    ref = np.array(JaxLaplace(jdofs, dtype=jnp.float64, kernel="banded")
                   .assemble_rhs(f, dirichlet=g))
    mask = dofs.boundary_mask
    g_ref = ref[mask].copy()
    ref[mask] = 0.0
    op = LaplaceOperator(dofs, device="cpu")
    pf, pg = make_rhs_and_dbc(rhs, 2)
    got = op.assemble_rhs(pf, dirichlet=pg)
    assert got.dtype == torch.float64
    assert _rel(got.numpy(), ref) < 1e-12
    assert not got.numpy()[mask].any()
    gv = op.dirichlet_vector(pg)
    if rhs.startswith("gaussian"):
        np.testing.assert_allclose(gv.numpy()[mask], g_ref, rtol=1e-15,
                                   atol=0)
        assert not gv.numpy()[~mask].any()
    else:
        assert gv is None


@pytest.mark.parametrize("p,overlap,patch,wt", [
    (2, 1, "element", "symm"), (3, 1, "element", "post"),
    (4, 1, "element", "none"), (3, 1, "element", "pre"),
    (3, 2, "element", "symm"), (4, 3, "element", "ras"),
    (2, 1, "element", "ras"),
    (3, 1, "vertex", "symm"), (2, 1, "vertex", "ras"),
    (4, 1, "vertex", "post"),
])
def test_fdm_matches_jax(p, overlap, patch, wt):
    jdofs, dofs = _dofs((4, 5), p, lengths=(1.0, 2.5))
    x = _vec(dofs.n_dofs, 10 * p + overlap)
    jasm = JaxASM(jdofs, n_overlap=overlap, weighting_type=wt,
                  patch_type=patch, dtype=jnp.float64)
    ref = np.asarray(jasm.vmult(jnp.asarray(x)))
    asm = ASMPreconditioner(dofs, n_overlap=overlap, weighting_type=wt,
                            patch_type=patch, device="cpu")
    assert not asm.fused  # kernels B, C and D tile 3D meshes only
    assert asm.is_symmetric == (wt in ("none", "symm"))
    assert _rel(asm.vmult(torch.as_tensor(x)).numpy(), ref) < 1e-12
    asm32 = ASMPreconditioner(dofs, n_overlap=overlap, weighting_type=wt,
                              patch_type=patch, dtype=torch.float32,
                              device="cpu")
    assert _rel(asm32.vmult(torch.as_tensor(x, dtype=torch.float32)).numpy(),
                ref) < 1e-5


@pytest.mark.parametrize("p,overlap,patch", [(3, 1, "element"),
                                             (3, 2, "element"),
                                             (2, 1, "vertex")])
def test_lattice_windows_match_patch_tables(p, overlap, patch):
    """The strided windows of the 2D grid are the gathers through the patch
    tables, and the overlap-add their scatter-add."""
    _, dofs = _dofs((4, 3), p)
    n = dofs.n_dofs
    if patch == "vertex":
        idx = vertex_patch_indices(dofs)[0].astype(np.int64)
    else:
        idx = element_patch_indices(dofs, overlap).astype(np.int64)
    m, first = window_layout(p, overlap, patch)
    u = _vec(n, 5)
    grid = torch.as_tensor(u).reshape(tuple(reversed(dofs.nodes_per_dim)))
    W = grid_to_windows(grid, p, m, first)
    want = np.append(u, 0.0)[idx]
    np.testing.assert_array_equal(W.numpy(), want)
    y = _vec(W.numel(), 6).reshape(W.shape)
    ref = np.zeros(n + 1)
    np.add.at(ref, idx.reshape(-1), y.reshape(-1))
    got = windows_to_grid(torch.as_tensor(y), grid.shape, p, m, first)
    np.testing.assert_allclose(got.reshape(-1).numpy(), ref[:n], rtol=1e-13,
                               atol=1e-13)


@pytest.mark.parametrize("coarse,fine", [
    (((2, 3), 3), ((4, 6), 3)),   # h-transfer
    (((3, 2), 1), ((3, 2), 4)),   # p-transfer
])
def test_transfer_matches_jax(coarse, fine):
    (jc, c), (jf, f) = _dofs(*coarse), _dofs(*fine)
    jt = JaxTransfer(jc, jf, dtype=jnp.float64)
    t = TwoLevelTransfer(c, f, device="cpu")
    uc, rf = _vec(c.n_dofs, 1), _vec(f.n_dofs, 2)
    assert _rel(t.prolongate(torch.as_tensor(uc)).numpy(),
                jt.prolongate(jnp.asarray(uc))) < 1e-12
    assert _rel(t.restrict(torch.as_tensor(rf)).numpy(),
                jt.restrict(jnp.asarray(rf))) < 1e-12


@pytest.mark.parametrize("cells,p", [((2, 3), 2), ((1, 1), 4), ((4, 4), 1)])
def test_direct_coarse_solver_matches_jax(cells, p):
    jd, d = _dofs(cells, p)
    ref = np.asarray(JaxDirect(jd, dtype=jnp.float64).Ainv)
    got = DirectCoarseSolver(d, device="cpu")
    assert _rel(got.Ainv.numpy(), ref) < 1e-12


def test_vcycle_matches_jax():
    """Three-level h-multigrid, Chebyshev-2 around FDM overlap 1 "symm",
    float64 levels, dense coarse solve."""
    cfg = {"type": "Chebyshev", "degree": 2,
           "preconditioner": {"type": "FDM", "weighting type": "symm"}}
    levels = [_dofs((1, 1), 3), _dofs((2, 2), 3), _dofs((4, 4), 3)]
    jops = [JaxLaplace(j, dtype=jnp.float64, kernel="banded")
            for j, _ in levels]
    ops = [LaplaceOperator(d, device="cpu") for _, d in levels]
    jmg = JaxMultigrid([o.vmult for o in jops],
                       [jax_create(o, cfg) for o in jops[1:]],
                       [JaxTransfer(levels[i][0], levels[i + 1][0],
                                    dtype=jnp.float64) for i in range(2)],
                       JaxDirect(levels[0][0], dtype=jnp.float64).vmult)
    mg = Multigrid(ops, [create_system_preconditioner(o, cfg)
                         for o in ops[1:]],
                   [TwoLevelTransfer(levels[i][1], levels[i + 1][1],
                                     device="cpu") for i in range(2)],
                   DirectCoarseSolver(levels[0][1], device="cpu").vmult)
    fine = levels[-1][1]
    b = _vec(fine.n_dofs, 13)
    b[fine.boundary_mask] = 0.0
    assert _rel(mg.vmult(torch.as_tensor(b)).numpy(),
                jmg.vmult(jnp.asarray(b))) < 1e-12


def _input(name):
    with open(os.path.join(ROOT, "inputs", f"{name}.json")) as f:
        return json.load(f)


def test_dummy_json_count_matches_jax():
    params = _input("dummy")
    ref = jax_run_config(copy.deepcopy(params), log=_quiet)
    got = run_config(copy.deepcopy(params), log=_quiet, device="cpu")
    assert got["n_dofs"] == ref["n_dofs"] == 625
    assert got["converged"] and got["it"] == ref["it"] == 24
    assert _rel(got["solution"].numpy(), ref["solution"]) < 1e-10


def test_mg_solve_2d_matches_jax():
    """A 2D hypercube with h-multigrid, Chebyshev-2 around FDM overlap 1 and
    the gaussian-jw rhs on the symmetric square: the port's count equals the
    JAX package's composed on the homogeneous system."""
    params = {
        "dim": 2, "degree": 3, "n refinements": 3, "rhs": "gaussian-jw",
        "mesh": {"name": "symmetric hypercube"},
        "solver": {"type": "CG", "rel tolerance": 1e-8},
        "preconditioner": {
            "type": "Multigrid", "mg type": "h",
            "mg smoother": {"type": "Chebyshev", "degree": 2,
                            "preconditioner": {"type": "FDM",
                                               "weighting type": "symm"}},
            "mg coarse grid solver": {"type": "AMG"}}}
    got = run_config(copy.deepcopy(params), log=_quiet, device="cpu")
    orig = JaxLaplace.assemble_rhs

    def homogeneous(self, f, dirichlet=None):
        b = np.array(orig(self, f, dirichlet))
        b[np.asarray(self.dofs.boundary_mask)] = 0.0
        return jnp.asarray(b, self.dtype)

    try:
        JaxLaplace.assemble_rhs = homogeneous
        ref = jax_run_config(copy.deepcopy(params), log=_quiet)
    finally:
        JaxLaplace.assemble_rhs = orig
    assert got["converged"] and got["it"] == ref["it"]


@pytest.mark.parametrize("mesh", [{"name": "kershaw", "eps": 0.3},
                                  {"name": "hyperball"}])
def test_unported_2d_meshes_raise(mesh):
    """2D deformed meshes and the 2D ball no longer raise (they were ROADMAP
    item 9 until the ports of ``ops/laplace.py``'s 2D merged form and of
    the 2D general operator, transfer and Schwarz): CG around the inverse
    diagonal at 1 refinement takes the JAX package's count, run live."""
    params = {"dim": 2, "degree": 2, "n refinements": 1, "mesh": mesh,
              "solver": {"type": "CG"},
              "preconditioner": {"type": "Diagonal"}}
    logged = []
    got = run_config(copy.deepcopy(params), log=logged.append, device="cpu")
    ref = jax_run_config(copy.deepcopy(params), log=_quiet)
    assert got["converged"] and got["it"] == ref["it"]
    assert got["it"] == {"kershaw": 68, "hyperball": 13}[mesh["name"]]
    # the JAX float64 deformed apply is double-single, which XLA:CPU
    # degrades to ~3e-8 a call (see the header); 68 iterations carry it
    assert _rel(got["solution"].numpy(), np.asarray(ref["solution"])) < 3e-5
    assert any("2D mesh: plain torch" in str(m) for m in logged)


def _kershaw_dofs(p, cells=(6, 6)):
    tf = kershaw_transform(0.3, 0.3)
    jd = JaxDofHandler(JaxMesh(2, cells, transform=tf), p)
    return jd, dofs_from_jax(jd)


@pytest.mark.parametrize("p", [1, 2, 3])
def test_deformed_2d_operator_matches_jax(p):
    """The 2D merged form (three coefficients [xx, yy, xy] a quadrature
    point, mapping degree min(p, 3)): apply, residual, inverse diagonal and
    the gaussian rhs with its lift at rel 1e-12 (float64), float32 at 1e-5,
    and the operator built from the JAX package's geometry (``interop``)."""
    jd, dofs = _kershaw_dofs(p)
    jop = JaxLaplace(jd, dtype=jnp.float64, kernel="banded")
    op = LaplaceOperator(dofs, device="cpu")
    assert op.coeff6.shape == (36, 3, (p + 1) ** 2)
    assert op._kernel is merged_laplace_plain
    x = _vec(dofs.n_dofs, 20 + p)
    ref = np.asarray(jop.vmult(jnp.asarray(x)))
    assert _rel(op.vmult(torch.as_tensor(x)).numpy(), ref) < 1e-12
    assert _rel(laplace_from_jax(jop, device="cpu").vmult(
        torch.as_tensor(x)).numpy(), ref) < 1e-12
    op32 = LaplaceOperator(dofs, dtype=torch.float32, device="cpu")
    assert _rel(op32.vmult(torch.as_tensor(x).float()).numpy(), ref) < 1e-5
    assert _rel(op.compute_inverse_diagonal().numpy(),
                np.asarray(jop.compute_inverse_diagonal())) < 1e-12
    f, g = jax_rhs_and_dbc("gaussian", 2)
    b = np.array(jop.assemble_rhs(f, dirichlet=g))
    b[dofs.boundary_mask] = 0.0
    pf, pg = make_rhs_and_dbc("gaussian", 2)
    assert _rel(op.assemble_rhs(pf, dirichlet=pg).numpy(), b) < 1e-12


@pytest.mark.parametrize("p,overlap,patch,wt", [
    (2, 1, "element", "symm"), (3, 2, "element", "post"),
    (3, 1, "vertex", "none"), (2, 1, "element", "ras")])
def test_deformed_2d_fdm_matches_jax(p, overlap, patch, wt):
    """Per-patch FDM Schwarz on 2D Kershaw against the JAX package (its
    tables do not factor per coordinate): rel 1e-12."""
    jd, dofs = _kershaw_dofs(p)
    jasm = JaxASM(jd, n_overlap=overlap, weighting_type=wt,
                  dtype=jnp.float64, patch_type=patch)
    asm = CellASMPreconditioner(dofs, n_overlap=overlap, weighting_type=wt,
                                device="cpu", patch_type=patch)
    x = np.where(dofs.boundary_mask, 0.0, _vec(dofs.n_dofs, 30 + p))
    assert _rel(asm.vmult(torch.as_tensor(x)).numpy(),
                np.asarray(jasm.vmult(jnp.asarray(x)))) < 1e-12


_BALL = [jax_hyper_ball(2)]


def _ball_dofs(p, refinements=1):
    """(JAX, port) DoF handlers on the 2D ball refined ``refinements``
    times; one JAX mesh object per refinement, so that a p-transfer sees
    the same mesh on both sides."""
    while len(_BALL) <= refinements:
        _BALL.append(_BALL[-1].refine())
    jd = JaxGeneralDofs(_BALL[refinements], p)
    return jd, general_dofs_from_jax(jd)


@pytest.mark.parametrize("p", [1, 2, 3])
def test_ball_2d_operator_matches_jax(p):
    """The 2D ball's general operator (plain torch, fixed-order scatter)
    against the JAX package's cell-major float64 form: apply, inverse
    diagonal, constant rhs at rel 1e-12; from the JAX coefficients
    (``interop``, component order [xx, xy, yy] there)."""
    jd, dofs = _ball_dofs(p)
    jop = JaxGeneralLaplace(jd, dtype=jnp.float64, kernel="cells")
    op = GeneralLaplaceOperator(dofs, device="cpu")
    assert op.coeff6.shape[1] == 3
    x = _vec(dofs.n_dofs, 40 + p)
    ref = np.asarray(jop.vmult(jnp.asarray(x)))
    assert _rel(op.vmult(torch.as_tensor(x)).numpy(), ref) < 1e-12
    lanes = JaxGeneralLaplace(jd, dtype=jnp.float64)
    assert _rel(general_laplace_from_jax(lanes, device="cpu").vmult(
        torch.as_tensor(x)).numpy(), ref) < 1e-12
    assert _rel(op.compute_inverse_diagonal().numpy(),
                np.asarray(jop.compute_inverse_diagonal())) < 1e-12
    b = np.array(jop.assemble_rhs(lambda pts: np.ones(pts.shape[0])))
    assert _rel(op.assemble_rhs("constant").numpy(), b) < 1e-12


@pytest.mark.parametrize("p,overlap,patch", [(2, 1, "element"),
                                             (3, 2, "element"),
                                             (2, 1, "vertex")])
def test_ball_2d_fdm_and_transfers_match_jax(p, overlap, patch):
    """The 2D ball's per-patch FDM Schwarz (symm) and its h- and
    p-transfers against the JAX package: rel 1e-12."""
    jd, dofs = _ball_dofs(p)
    jasm = JaxGeneralASM(jd, n_overlap=overlap, weighting_type="symm",
                         dtype=jnp.float64, patch_type=patch)
    asm = GeneralASMPreconditioner(dofs, n_overlap=overlap,
                                   weighting_type="symm", device="cpu",
                                   patch_type=patch)
    x = np.where(dofs.boundary_mask, 0.0, _vec(dofs.n_dofs, 50 + p))
    assert _rel(asm.vmult(torch.as_tensor(x)).numpy(),
                np.asarray(jasm.vmult(jnp.asarray(x)))) < 1e-12
    jc, coarse = _ball_dofs(p, 0)
    jl, low = _ball_dofs(1)
    for (jcd, cd), (jfd, fd) in (((jc, coarse), (jd, dofs)),
                                 ((jl, low), (jd, dofs))):
        jtr = JaxGeneralTransfer(jcd, jfd, dtype=jnp.float64)
        tr = GeneralTwoLevelTransfer(cd, fd, device="cpu")
        uc = _vec(cd.n_dofs, 60 + p)
        assert _rel(tr.prolongate(torch.as_tensor(uc)).numpy(),
                    np.asarray(jtr.prolongate(jnp.asarray(uc)))) < 1e-12
        assert _rel(tr.restrict(torch.as_tensor(x)).numpy(),
                    np.asarray(jtr.restrict(jnp.asarray(x)))) < 1e-12


@pytest.mark.parametrize("mesh,degree,mg_type,expected", [
    ({"name": "kershaw", "eps": 0.3}, 3, "h", 26),
    ({"name": "hyperball"}, 2, "ph", 7),
])
def test_2d_multigrid_counts(mesh, degree, mg_type, expected):
    """2D Kershaw (eps 0.3, Q3, h-multigrid) and the 2D ball (Q2,
    ph-multigrid), Chebyshev-2 around FDM, dense coarse solve, at 2
    refinements, CG to rel 1e-5: the JAX package's counts (26 and 7, its
    run_config on these parameters)."""
    params = {"dim": 2, "degree": degree, "n refinements": 2, "mesh": mesh,
              "solver": {"type": "CG", "rel tolerance": 1e-5},
              "preconditioner": {
                  "type": "Multigrid", "mg type": mg_type,
                  "mg smoother": {"type": "Chebyshev", "degree": 2,
                                  "preconditioner": {"type": "FDM"}},
                  "mg coarse grid solver": {"type": "AMG"}}}
    got = run_config(params, log=_quiet, device="cpu")
    assert got["converged"] and got["it"] == expected
