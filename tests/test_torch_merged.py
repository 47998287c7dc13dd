"""The port's deformed-geometry Laplace operator (kernel E's plain version
on CPU tensors, ``dealii_asm_tpu_torch.kernels.merged_laplace``) against the
JAX package, on Kershaw meshes (eps 0.3, mapping degree 3).

Inputs come from a seeded numpy generator and go to both packages; the
CUDA kernel is held against the same plain version on the GPU by
chip_smoke.py.

Tolerances:
- float64 apply: 1e-12 of max |v| against JAX ``kernel="pallas-dd"``, the
  TPU kernel MergedDDVmultKernel in interpret mode (double-single, ~47
  bits; observed ~1e-15).  The JAX default CPU float64 path is the XLA
  double-single composition, which XLA:CPU fusion degrades, so it is not
  the oracle;
- float32 apply: 1e-5 of max |v| against the JAX float32 operator (the
  dense ``merged_laplace_apply`` at matmul precision "highest"): float32
  rounding of the same products in another order (observed ~1e-7);
- right-hand side: rel 1e-13 (the same float64 sums; observed ~2e-15).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dealii_asm_tpu.fem.dofs import DofHandler as JaxDofHandler
from dealii_asm_tpu.fem.functions import make_rhs_and_dbc
from dealii_asm_tpu.mesh.grid import StructuredMesh as JaxMesh
from dealii_asm_tpu.mesh.transforms import kershaw_transform as jax_kershaw
from dealii_asm_tpu.ops.laplace import LaplaceOperator as JaxLaplace
from dealii_asm_tpu_torch.fem.dofs import DofHandler
from dealii_asm_tpu_torch.interop import laplace_from_jax
from dealii_asm_tpu_torch.kernels import launch_counts
from dealii_asm_tpu_torch.kernels.merged_laplace import (merged_laplace,
                                                         merged_laplace_plain)
from dealii_asm_tpu_torch.mesh.grid import StructuredMesh
from dealii_asm_tpu_torch.mesh.transforms import kershaw_transform
from dealii_asm_tpu_torch.ops.laplace import LaplaceOperator


def _dofs(cells, p):
    """(JAX DofHandler, port DofHandler) of the same Kershaw mesh."""
    return (JaxDofHandler(JaxMesh(3, cells, transform=jax_kershaw(0.3, 0.3)),
                          p),
            DofHandler(StructuredMesh(3, cells,
                                      transform=kershaw_transform(0.3, 0.3)),
                       p))


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(b).max()


@pytest.mark.parametrize("cells,p", [((2, 3, 4), 2), ((3, 3, 3), 4),
                                     ((2, 2, 3), 1)])
def test_f64_apply_matches_jax_kernel_e(cells, p):
    jdofs, dofs = _dofs(cells, p)
    jop = JaxLaplace(jdofs, mapping_degree=3, dtype=jnp.float64,
                     kernel="pallas-dd")
    assert jop._merged_dd_pallas is not None and jop._merged_dd_pallas.interpret
    x = np.random.default_rng(11 + p).standard_normal(dofs.n_dofs)
    ref = np.asarray(jop.vmult(jnp.asarray(x)))
    op = LaplaceOperator(dofs, mapping_degree=3, device="cpu")
    got = op.vmult(torch.as_tensor(x))
    assert got.dtype == torch.float64
    assert _rel(got.numpy(), ref) < 1e-12
    b = np.random.default_rng(12).standard_normal(dofs.n_dofs)
    r = op.residual(torch.as_tensor(b), torch.as_tensor(x))
    assert _rel(r.numpy(), b - ref) < 1e-12


@pytest.mark.parametrize("cells,p", [((2, 3, 4), 2), ((3, 2, 2), 4),
                                     ((3, 3, 2), 1)])
def test_f32_apply_matches_jax(cells, p):
    jdofs, dofs = _dofs(cells, p)
    x = np.random.default_rng(21 + p).standard_normal(
        dofs.n_dofs).astype(np.float32)
    jop = JaxLaplace(jdofs, mapping_degree=3, dtype=jnp.float32,
                     matmul_precision="highest")
    ref = np.asarray(jop.vmult(jnp.asarray(x)))
    op = LaplaceOperator(dofs, dtype=torch.float32, mapping_degree=3,
                         device="cpu")
    got = op.vmult(torch.as_tensor(x))
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), ref) < 1e-5


@pytest.mark.parametrize("cells,p", [((3, 4, 2), 3), ((2, 2, 2), 1)])
def test_rhs_matches_jax(cells, p):
    jdofs, dofs = _dofs(cells, p)
    rhs_fn, dbc_fn = make_rhs_and_dbc("constant", 3)
    ref = np.asarray(JaxLaplace(jdofs, mapping_degree=3).assemble_rhs(
        rhs_fn, dirichlet=dbc_fn))
    got = LaplaceOperator(dofs, mapping_degree=3,
                          device="cpu").assemble_rhs("constant")
    assert got.dtype == torch.float64
    assert _rel(got.numpy(), ref) < 1e-13


def test_default_mapping_degree_and_interop():
    """The mapping degree defaults to min(p, 3) as in the JAX package, and
    the port driven with the JAX geometry tables gives the same apply."""
    jdofs, dofs = _dofs((2, 3, 2), 2)
    jop = JaxLaplace(jdofs, dtype=jnp.float64)
    op = LaplaceOperator(dofs, device="cpu")
    assert op.mapping_degree == jop.mapping_degree == 2
    via_jax = laplace_from_jax(jop, device="cpu")
    x = torch.as_tensor(np.random.default_rng(7).standard_normal(dofs.n_dofs))
    assert _rel(via_jax.vmult(x).numpy(), op.vmult(x).numpy()) < 1e-13
    assert _rel(via_jax.assemble_rhs().numpy(),
                op.assemble_rhs().numpy()) < 1e-13


def test_identity_rows_and_cpu_wrapper():
    """Constrained rows return the input; a CPU tensor runs the plain
    version and counts no launch; another device raises."""
    _, dofs = _dofs((2, 2, 2), 2)
    op = LaplaceOperator(dofs, dtype=torch.float32, device="cpu")
    x = torch.as_tensor(np.random.default_rng(8).standard_normal(
        dofs.n_dofs).astype(np.float32))
    before = launch_counts()
    v = merged_laplace(x, op.tables)
    assert launch_counts() == before
    assert torch.equal(v, merged_laplace_plain(x, op.tables))
    fixed = ~op.free.reshape(-1)
    assert torch.equal(v[fixed], x[fixed])
    with pytest.raises(TypeError, match="unsupported device"):
        merged_laplace(torch.empty(dofs.n_dofs, device="meta"), op.tables)
