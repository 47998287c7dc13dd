"""Port's multigrid pieces (transfers, direct coarse solver, V-cycle) vs the
JAX package on the same inputs.

Tolerances: the transfers and the coarse solve are float64 products of the
same tables in another summation order: rel 1e-13 (the coarse inverse comes
from a matrix assembled another way, rel 1e-10); the V-cycle over float32
levels against the JAX one: rel 1e-5 (float32 level arithmetic).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dealii_asm_tpu.fem.dofs import DofHandler as JaxDofHandler
from dealii_asm_tpu.mesh.grid import StructuredMesh as JaxMesh
from dealii_asm_tpu.ops.laplace import LaplaceOperator as JaxLaplace
from dealii_asm_tpu.ops.transfer import TwoLevelTransfer as JaxTransfer
from dealii_asm_tpu.precond.factory import \
    create_system_preconditioner as jax_create
from dealii_asm_tpu.precond.multigrid import DirectCoarseSolver as JaxDirect
from dealii_asm_tpu.precond.multigrid import Multigrid as JaxMultigrid
from dealii_asm_tpu_torch.fem.dofs import DofHandler
from dealii_asm_tpu_torch.interop import transfer_from_jax
from dealii_asm_tpu_torch.mesh.grid import StructuredMesh
from dealii_asm_tpu_torch.ops.laplace import LaplaceOperator
from dealii_asm_tpu_torch.ops.transfer import TwoLevelTransfer, p_sequence
from dealii_asm_tpu_torch.precond.factory import create_system_preconditioner
from dealii_asm_tpu_torch.precond.multigrid import (DirectCoarseSolver,
                                                    Multigrid)


def _dofs(cells, p):
    return (JaxDofHandler(JaxMesh(3, cells), p),
            DofHandler(StructuredMesh(3, cells), p))


def _rel(a, b):
    b = np.asarray(b)
    return np.abs(np.asarray(a) - b).max() / np.abs(b).max()


@pytest.mark.parametrize("coarse,fine", [
    (((1, 2, 1), 3), ((2, 4, 2), 3)),   # h-transfer
    (((2, 2, 3), 1), ((2, 2, 3), 4)),   # p-transfer
])
def test_transfer_matches_jax(coarse, fine):
    jc, c = _dofs(*coarse)
    jf, f = _dofs(*fine)
    jtr = JaxTransfer(jc, jf, dtype=jnp.float64)
    tr = TwoLevelTransfer(c, f, dtype=torch.float64, device="cpu")
    for d in range(3):
        np.testing.assert_array_equal(tr.P1d[d], np.asarray(jtr.P1d[d]))
    rng = np.random.default_rng(11)
    uc = rng.standard_normal(c.n_dofs)
    rf = rng.standard_normal(f.n_dofs)
    assert _rel(tr.prolongate(torch.as_tensor(uc)).numpy(),
                jtr.prolongate(jnp.asarray(uc))) < 1e-13
    assert _rel(tr.restrict(torch.as_tensor(rf)).numpy(),
                jtr.restrict(jnp.asarray(rf))) < 1e-13
    via = transfer_from_jax(jtr, device="cpu")
    assert torch.equal(via.restrict(torch.as_tensor(rf)),
                       tr.restrict(torch.as_tensor(rf)))


@pytest.mark.parametrize("kind", ["bisect", "decrease by one", "go to one"])
def test_p_sequence_matches_jax(kind):
    from dealii_asm_tpu.ops.transfer import p_sequence as jax_p_sequence

    for p in range(1, 8):
        assert p_sequence(p, kind) == jax_p_sequence(p, kind)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_direct_coarse_solver_matches_jax(dtype):
    jd, d = _dofs((1, 1, 1), 4)
    ref = JaxDirect(jd, dtype=getattr(jnp, dtype))
    got = DirectCoarseSolver(d, dtype=getattr(torch, dtype), device="cpu")
    tol = 1e-10 if dtype == "float64" else 1e-5
    assert _rel(got.Ainv.numpy(), np.asarray(ref.Ainv)) < tol
    b = np.random.default_rng(12).standard_normal(d.n_dofs)
    assert _rel(got.vmult(torch.as_tensor(b, dtype=getattr(torch, dtype)))
                .numpy(), ref.vmult(jnp.asarray(b, getattr(jnp, dtype)))) < tol


def test_vcycle_matches_jax():
    """Two-level h-multigrid with Chebyshev-FDM smoothing, float32 levels."""
    cfg = {"type": "Chebyshev", "degree": 1,
           "preconditioner": {"type": "FDM", "weighting type": "symm"}}
    (jc, c), (jf, f) = _dofs((1, 1, 1), 3), _dofs((2, 2, 2), 3)
    jops = [JaxLaplace(x, dtype=jnp.float32) for x in (jc, jf)]
    ops = [LaplaceOperator(x, dtype=torch.float32, device="cpu")
           for x in (c, f)]
    jmg = JaxMultigrid([o.vmult for o in jops], [jax_create(jops[1], cfg)],
                       [JaxTransfer(jc, jf, dtype=jnp.float32)],
                       JaxDirect(jc, dtype=jnp.float32).vmult)
    mg = Multigrid(ops, [create_system_preconditioner(ops[1], cfg)],
                   [TwoLevelTransfer(c, f, dtype=torch.float32, device="cpu")],
                   DirectCoarseSolver(c, dtype=torch.float32,
                                      device="cpu").vmult)
    b = np.random.default_rng(13).standard_normal(f.n_dofs).astype(np.float32)
    b[f.boundary_mask] = 0.0
    assert _rel(mg.vmult(torch.as_tensor(b)).numpy(),
                jmg.vmult(jnp.asarray(b))) < 1e-5


def _kershaw_dofs(cells, p):
    from dealii_asm_tpu.mesh.transforms import kershaw_transform as jk
    from dealii_asm_tpu_torch.mesh.transforms import kershaw_transform

    return (JaxDofHandler(JaxMesh(3, cells, transform=jk(0.3, 0.3)), p),
            DofHandler(StructuredMesh(3, cells,
                                      transform=kershaw_transform(0.3, 0.3)),
                       p))


@pytest.mark.parametrize("cells,p", [((3, 3, 3), 1), ((2, 2, 2), 2)])
def test_direct_coarse_solver_matches_jax_on_kershaw(cells, p):
    """The coarse matrix maps with min(p, 3) (1 on a Q1 coarse level), as the
    JAX assembly does, whatever the level operators use: rel 1e-10."""
    jd, d = _kershaw_dofs(cells, p)
    ref = JaxDirect(jd, dtype=jnp.float64)
    got = DirectCoarseSolver(d, dtype=torch.float64, device="cpu")
    assert _rel(got.Ainv.numpy(), np.asarray(ref.Ainv)) < 1e-10
    if p < 3:  # a mapping of degree 3 gives another matrix
        other = LaplaceOperator(d, mapping_degree=3, device="cpu")
        e = torch.zeros(d.n_dofs, dtype=torch.float64)
        j = int(np.flatnonzero(~d.boundary_mask)[0])
        e[j] = 1.0
        A = np.linalg.inv(got.Ainv.numpy())
        assert _rel(other.vmult(e).numpy(), A[:, j]) > 1e-6


def test_ph_junction_transfers_match_jax():
    """The ph hierarchy's junction on a Kershaw mesh: an h-transfer at degree
    1, then p-transfers 1 → 2 → 4 on the fine mesh (rel 1e-13)."""
    pairs = [(((2, 2, 2), 1), ((4, 4, 4), 1)),
             (((4, 4, 4), 1), ((4, 4, 4), 2)),
             (((4, 4, 4), 2), ((4, 4, 4), 4))]
    rng = np.random.default_rng(14)
    for coarse, fine in pairs:
        (jc, c), (jf, f) = _kershaw_dofs(*coarse), _kershaw_dofs(*fine)
        jtr = JaxTransfer(jc, jf, dtype=jnp.float64)
        tr = TwoLevelTransfer(c, f, dtype=torch.float64, device="cpu")
        uc = rng.standard_normal(c.n_dofs)
        rf = rng.standard_normal(f.n_dofs)
        assert _rel(tr.prolongate(torch.as_tensor(uc)).numpy(),
                    jtr.prolongate(jnp.asarray(uc))) < 1e-13
        assert _rel(tr.restrict(torch.as_tensor(rf)).numpy(),
                    jtr.restrict(jnp.asarray(rf))) < 1e-13


# -- the hyperball: gather → ⊗T1 → fixed-order scatter (GeneralTwoLevelTransfer)


def _ball_dofs(refinements, p):
    from dealii_asm_tpu.fem.general_dofs import GeneralDofHandler as JaxGD
    from dealii_asm_tpu.mesh.unstructured import hyper_ball_balanced as jball
    from dealii_asm_tpu_torch.fem.general_dofs import GeneralDofHandler
    from dealii_asm_tpu_torch.mesh.unstructured import hyper_ball_balanced

    return (JaxGD(jball(3).refine_global(refinements), p),
            GeneralDofHandler(hyper_ball_balanced(3).refine_global(refinements),
                              p))


@pytest.fixture(scope="module")
def ball_levels():
    """The ball's ph junction at 1 refinement: (r, p) → (JAX, port) dofs,
    the coarse and fine meshes shared as in run_config."""
    from dealii_asm_tpu.fem.general_dofs import GeneralDofHandler as JaxGD
    from dealii_asm_tpu.mesh.unstructured import hyper_ball_balanced as jball
    from dealii_asm_tpu_torch.fem.general_dofs import GeneralDofHandler
    from dealii_asm_tpu_torch.mesh.unstructured import hyper_ball_balanced

    jm = [jball(3)]
    m = [hyper_ball_balanced(3)]
    jm.append(jm[0].refine())
    m.append(m[0].refine())
    return {(r, p): (JaxGD(jm[r], p), GeneralDofHandler(m[r], p))
            for r, p in [(0, 1), (0, 2), (1, 1), (1, 2), (1, 4)]}


@pytest.mark.parametrize("coarse,fine", [((0, 1), (1, 1)),   # h, p = 1
                                         ((0, 2), (1, 2)),   # h, p = 2
                                         ((1, 1), (1, 2)),   # p 1 → 2
                                         ((1, 2), (1, 4))])  # p 2 → 4
def test_general_transfer_matches_jax_on_ball(ball_levels, coarse, fine):
    from dealii_asm_tpu.ops.transfer_general import \
        GeneralTwoLevelTransfer as JaxGT
    from dealii_asm_tpu_torch.interop import general_transfer_from_jax
    from dealii_asm_tpu_torch.ops.transfer_general import \
        GeneralTwoLevelTransfer

    (jc, c), (jf, f) = ball_levels[coarse], ball_levels[fine]
    jtr = JaxGT(jc, jf, dtype=jnp.float64)
    tr = GeneralTwoLevelTransfer(c, f, dtype=torch.float64, device="cpu")
    np.testing.assert_array_equal(tr.T1.numpy(), np.asarray(jtr.T1))
    np.testing.assert_array_equal(tr.fine_lat.numpy(), np.asarray(jtr.fine_lat))
    np.testing.assert_array_equal(tr.fine_inv_valence.numpy(),
                                  np.asarray(jtr.fine_inv_valence))
    rng = np.random.default_rng(15)
    uc = rng.standard_normal(c.n_dofs)
    rf = rng.standard_normal(f.n_dofs)
    for t in (tr, general_transfer_from_jax(jtr, device="cpu")):
        assert _rel(t.prolongate(torch.as_tensor(uc)).numpy(),
                    jtr.prolongate(jnp.asarray(uc))) < 1e-13
        assert _rel(t.restrict(torch.as_tensor(rf)).numpy(),
                    jtr.restrict(jnp.asarray(rf))) < 1e-13
    # restriction is the exact transpose of prolongation
    lhs = float(tr.prolongate(torch.as_tensor(uc)) @ torch.as_tensor(rf))
    rhs = float(torch.as_tensor(uc) @ tr.restrict(torch.as_tensor(rf)))
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)


@pytest.mark.parametrize("p", [1, 2])
def test_direct_coarse_solver_matches_jax_on_ball(p):
    """The ball's coarse matrix maps with degree 2, as
    ``assemble_laplace_general`` does: rel 1e-10."""
    jd, d = _ball_dofs(0, p)
    ref = JaxDirect(jd, dtype=jnp.float64)
    got = DirectCoarseSolver(d, dtype=torch.float64, device="cpu")
    assert _rel(got.Ainv.numpy(), np.asarray(ref.Ainv)) < 1e-10
    b = np.random.default_rng(16).standard_normal(d.n_dofs)
    assert _rel(got.vmult(torch.as_tensor(b)).numpy(),
                ref.vmult(jnp.asarray(b))) < 1e-10
