"""Inverse diagonals of the deformed and unstructured operators, and the
preconditioners built on them, against the JAX package.

Inputs come from a seeded numpy generator and go to both packages; the port
runs its plain PyTorch path here (CPU tensors).

Tolerances:
- float64 inverse diagonal: rel 1e-12 against ``compute_inverse_diagonal``
  (the same per-cell sums Σ_q Σ_ab C_ab ∂_a φ ∂_b φ in another order and
  coordinate scaling; observed ~1e-15); constrained rows exactly 1; two
  calls bit-identical (fixed-order sums);
- float32 inverse diagonal: rel 1e-5 (float32 rounding of the same sums);
- CoarseCG on a Kershaw level (float64): rel 1e-10 against the JAX
  ``IterativeCoarseSolver`` (its traceable float64 apply): the same
  diagonal-preconditioned CG recurrence to a reduction of 1e-8, dot
  products summed in another order (observed ~4e-15).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dealii_asm_tpu.fem.dofs import DofHandler as JaxDofHandler
from dealii_asm_tpu.fem.general_dofs import GeneralDofHandler as JaxDofs
from dealii_asm_tpu.mesh.grid import StructuredMesh as JaxMesh
from dealii_asm_tpu.mesh.transforms import kershaw_transform as jax_kershaw
from dealii_asm_tpu.mesh.unstructured import hyper_ball_balanced as jax_ball
from dealii_asm_tpu.ops.laplace import LaplaceOperator as JaxLaplace
from dealii_asm_tpu.ops.laplace_general import \
    GeneralLaplaceOperator as JaxGeneral
from dealii_asm_tpu.precond.multigrid import \
    IterativeCoarseSolver as JaxCoarseCG
from dealii_asm_tpu_torch.fem.dofs import DofHandler
from dealii_asm_tpu_torch.fem.general_dofs import GeneralDofHandler
from dealii_asm_tpu_torch.mesh.grid import StructuredMesh
from dealii_asm_tpu_torch.mesh.transforms import kershaw_transform
from dealii_asm_tpu_torch.mesh.unstructured import hyper_ball_balanced
from dealii_asm_tpu_torch.ops.laplace import LaplaceOperator
from dealii_asm_tpu_torch.ops.laplace_general import GeneralLaplaceOperator
from dealii_asm_tpu_torch.precond.diagonal import DiagonalPreconditioner
from dealii_asm_tpu_torch.precond.multigrid import IterativeCoarseSolver

KERSHAW_CASES = [((2, 2, 3), 1), ((2, 3, 4), 2), ((3, 3, 3), 4)]


def _kershaw(cells, p):
    """(JAX DofHandler, port DofHandler) of the same Kershaw mesh (eps
    0.3)."""
    return (JaxDofHandler(JaxMesh(3, cells, transform=jax_kershaw(0.3, 0.3)),
                          p),
            DofHandler(StructuredMesh(3, cells,
                                      transform=kershaw_transform(0.3, 0.3)),
                       p))


@pytest.fixture(scope="module")
def balls():
    """(port mesh, JAX mesh) of the 256-cell ball."""
    return hyper_ball_balanced(3).refine(), jax_ball(3).refine()


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _check_diagonal(op, ref, mask, bound):
    got = op.compute_inverse_diagonal()
    assert got.dtype == op.dtype and got.shape == (op.n_dofs,)
    assert _rel(got.numpy(), ref) < bound
    np.testing.assert_array_equal(got.numpy()[mask], 1.0)
    assert torch.equal(got, op.compute_inverse_diagonal())


@pytest.mark.parametrize("cells,p", KERSHAW_CASES)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kershaw_inverse_diagonal_matches_jax(cells, p, dtype):
    jdofs, dofs = _kershaw(cells, p)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    ref = np.asarray(JaxLaplace(jdofs, mapping_degree=min(p, 3), dtype=jdt)
                     .compute_inverse_diagonal())
    op = LaplaceOperator(dofs, dtype=dtype, device="cpu")
    _check_diagonal(op, ref, dofs.boundary_mask,
                    1e-12 if dtype == torch.float64 else 1e-5)


@pytest.mark.parametrize("p", [1, 2, 4])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_ball_inverse_diagonal_matches_jax(balls, p, dtype):
    m, j = balls
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    jdofs = JaxDofs(j, p)
    ref = np.asarray(JaxGeneral(jdofs, dtype=jdt).compute_inverse_diagonal())
    dofs = GeneralDofHandler(m, p)
    op = GeneralLaplaceOperator(dofs, dtype=dtype, device="cpu")
    _check_diagonal(op, ref, np.asarray(dofs.boundary_mask),
                    1e-12 if dtype == torch.float64 else 1e-5)


def test_ball_diagonal_preconditioner_matches_jax(balls):
    """Diagonal on the ball applies the JAX package's inverse diagonal."""
    m, j = balls
    ref = JaxGeneral(JaxDofs(j, 2), dtype=jnp.float64)
    op = GeneralLaplaceOperator(GeneralDofHandler(m, 2), device="cpu")
    x = np.random.default_rng(3).standard_normal(op.n_dofs)
    got = DiagonalPreconditioner(op).vmult(torch.as_tensor(x))
    want = np.asarray(ref.compute_inverse_diagonal()) * x
    assert _rel(got.numpy(), want) < 1e-12


def test_kershaw_coarse_cg_matches_jax():
    jdofs, dofs = _kershaw((2, 3, 4), 2)
    jop = JaxLaplace(jdofs, mapping_degree=2, dtype=jnp.float64)
    op = LaplaceOperator(dofs, device="cpu")
    b = np.random.default_rng(4).standard_normal(dofs.n_dofs)
    b[dofs.boundary_mask] = 0.0
    ref = np.asarray(JaxCoarseCG(jop, reduction=1e-8).vmult(jnp.asarray(b)))
    got = IterativeCoarseSolver(op, reduction=1e-8).vmult(torch.as_tensor(b))
    assert _rel(got.numpy(), ref) < 1e-10
    r = torch.as_tensor(b) - op.vmult(got)
    assert float(r.norm()) <= 1e-8 * float(np.linalg.norm(b))
