"""Port's smoother step x' = x + ω·P⁻¹(b − A x)
(dealii_asm_tpu_torch.kernels.smoother_step, plain PyTorch path on CPU) vs
the JAX package.

Tolerances (max |difference| / max |reference|):
- vs the JAX float32 composition x + ω·asm.vmult(b − op.vmult(x)): 1e-5,
  float32 rounding of the same products in another order (observed ~2e-7);
- vs ``SmootherStepKernel(op, asm).step(..., interpret=True)``: 3e-2.  The
  TPU kernel runs its FDM transforms in bfloat16 (``smoother_step.py``
  :1056-1076; unit roundoff 2^-8 ≈ 3.9e-3 per rounding, over two transform
  stages), while the port's step is float32 (observed ~6e-3).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dealii_asm_tpu.fem.dofs import DofHandler as JaxDofHandler
from dealii_asm_tpu.mesh.grid import StructuredMesh as JaxMesh
from dealii_asm_tpu.ops.laplace import LaplaceOperator as JaxLaplace
from dealii_asm_tpu.ops.pallas.smoother_step import SmootherStepKernel
from dealii_asm_tpu.precond.asm import ASMPreconditioner as JaxASM
from dealii_asm_tpu_torch.fem.dofs import DofHandler
from dealii_asm_tpu_torch.kernels import launch_counts
from dealii_asm_tpu_torch.kernels.smoother_step import (smoother_step,
                                                        smoother_step_plain)
from dealii_asm_tpu_torch.mesh.grid import StructuredMesh
from dealii_asm_tpu_torch.ops.laplace import LaplaceOperator
from dealii_asm_tpu_torch.precond.asm import ASMPreconditioner

CASES = [((3, 3, 3), 2, "symm"), ((2, 3, 4), 3, "post"),
         ((4, 4, 4), 4, "symm")]


def _setup(cells, p, wt, seed):
    dofs = DofHandler(StructuredMesh(3, cells), p)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(dofs.n_dofs).astype(np.float32)
    b = rng.standard_normal(dofs.n_dofs).astype(np.float32)
    op = LaplaceOperator(dofs, dtype=torch.float32, device="cpu")
    asm = ASMPreconditioner(dofs, weighting_type=wt, dtype=torch.float32,
                            device="cpu")
    out = smoother_step(torch.as_tensor(x), torch.as_tensor(b), op.tables,
                        asm.tables, 0.37)
    return JaxDofHandler(JaxMesh(3, cells), p), dofs, x, b, out.numpy()


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(b).max()


@pytest.mark.parametrize("cells,p,wt", CASES)
def test_step_matches_jax_composition(cells, p, wt):
    jdofs, dofs, x, b, got = _setup(cells, p, wt, 30 + p)
    jop = JaxLaplace(jdofs, dtype=jnp.float32)
    jasm = JaxASM(jdofs, n_overlap=1, weighting_type=wt, dtype=jnp.float32)
    xj, bj = jnp.asarray(x), jnp.asarray(b)
    ref = np.asarray(xj + 0.37 * jasm.vmult(bj - jop.vmult(xj)))
    assert _rel(got, ref) < 1e-5
    # constrained nodes keep x
    np.testing.assert_array_equal(got[dofs.boundary_mask],
                                  x[dofs.boundary_mask])


@pytest.mark.parametrize("cells,p,wt", CASES)
def test_step_matches_tpu_kernel_interpret(cells, p, wt):
    jdofs, _, x, b, got = _setup(cells, p, wt, 40 + p)
    jop = JaxLaplace(jdofs, dtype=jnp.float32)
    jasm = JaxASM(jdofs, n_overlap=1, weighting_type=wt, dtype=jnp.float32)
    kern = SmootherStepKernel(jop, jasm)
    ref = np.asarray(kern.step(jnp.asarray(x), jnp.asarray(b), 0.37,
                               interpret=True))
    assert _rel(got, ref) < 3e-2


def test_cpu_tensor_takes_plain_path_without_launching():
    dofs = DofHandler(StructuredMesh(3, (2, 2, 3)), 2)
    op = LaplaceOperator(dofs, dtype=torch.float32, device="cpu")
    asm = ASMPreconditioner(dofs, weighting_type="symm", dtype=torch.float32,
                            device="cpu")
    rng = np.random.default_rng(7)
    x = torch.as_tensor(rng.standard_normal(dofs.n_dofs), dtype=torch.float32)
    b = torch.as_tensor(rng.standard_normal(dofs.n_dofs), dtype=torch.float32)
    before = launch_counts()
    got = smoother_step(x, b, op.tables, asm.tables, 0.5)
    assert launch_counts() == before
    assert torch.equal(got, smoother_step_plain(x, b, op.tables, asm.tables,
                                                0.5))
