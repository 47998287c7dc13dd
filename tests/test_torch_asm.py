"""Port's FDM Schwarz preconditioner (dealii_asm_tpu_torch.precond.asm) vs
the JAX ASMPreconditioner and its TPU kernel FDMSlabKernel.

Inputs come from a seeded numpy generator and go to both packages; the port
runs its plain PyTorch path on CPU tensors.

Tolerances:
- float64 vs the JAX global-FDM path: rel 1e-12 (the same folded transforms
  in float64; observed ~2e-16);
- float32 vs ``FDMSlabKernel(asm).apply(x, interpret=True)``: rel 1e-5
  (relative to max |y|): float32 rounding of the same products in another
  contraction order (observed ~2e-7).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dealii_asm_tpu.fem.dofs import DofHandler as JaxDofHandler
from dealii_asm_tpu.mesh.grid import StructuredMesh as JaxMesh
from dealii_asm_tpu.ops.pallas.fdm_slab import FDMSlabKernel
from dealii_asm_tpu.precond.asm import ASMPreconditioner as JaxASM
from dealii_asm_tpu_torch.fem.dofs import DofHandler
from dealii_asm_tpu_torch.interop import asm_from_jax, global_fdm_numpy
from dealii_asm_tpu_torch.mesh.grid import StructuredMesh
from dealii_asm_tpu_torch.precond.asm import ASMPreconditioner

WEIGHTINGS = ["none", "pre", "post", "symm"]
SHAPES = {2: (3, 3, 3), 3: (2, 3, 4), 4: (3, 2, 2)}


def _dofs(cells, p):
    """(JAX DofHandler, port DofHandler) of the same lattice."""
    return (JaxDofHandler(JaxMesh(3, cells), p),
            DofHandler(StructuredMesh(3, cells), p))


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(b).max()


@pytest.mark.parametrize("p", [2, 3, 4])
@pytest.mark.parametrize("wt", WEIGHTINGS)
def test_fdm_apply_matches_jax_global_fdm(p, wt):
    jdofs, dofs = _dofs(SHAPES[p], p)
    x = np.random.default_rng(10 + p).standard_normal(dofs.n_dofs)
    jasm = JaxASM(jdofs, n_overlap=1, weighting_type=wt, dtype=jnp.float64)
    assert jasm.global_fdm is not None
    ref = np.asarray(jasm.vmult(jnp.asarray(x)))
    asm = ASMPreconditioner(dofs, weighting_type=wt, dtype=torch.float64)
    assert asm.is_symmetric == (wt in ("none", "symm"))
    assert _rel(asm.vmult(torch.as_tensor(x)).numpy(), ref) < 1e-12


@pytest.mark.parametrize("cells,p,wt", [
    ((4, 4, 4), 2, "symm"),
    ((4, 3, 5), 3, "symm"),
    ((3, 4, 2), 2, "post"),
    ((2, 3, 4), 4, "pre"),
])
def test_fdm_apply_matches_fdm_slab_kernel(cells, p, wt):
    jdofs, dofs = _dofs(cells, p)
    x = np.random.default_rng(20 + p).standard_normal(
        dofs.n_dofs).astype(np.float32)
    jasm = JaxASM(jdofs, n_overlap=1, weighting_type=wt, dtype=jnp.float32)
    ref = np.asarray(FDMSlabKernel(jasm).apply(jnp.asarray(x), interpret=True))
    asm = ASMPreconditioner(dofs, weighting_type=wt, dtype=torch.float32)
    got = asm.vmult(torch.as_tensor(x))
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), ref) < 1e-5


@pytest.mark.parametrize("p,wt", [(2, "post"), (4, "symm")])
def test_tables_match_jax(p, wt):
    """Per-coordinate eigen-tables and folded transforms, entry by entry."""
    jdofs, dofs = _dofs((4, 3, 2), p)
    jasm = JaxASM(jdofs, n_overlap=1, weighting_type=wt, dtype=jnp.float64)
    asm = ASMPreconditioner(dofs, weighting_type=wt, dtype=torch.float64)
    for d in range(3):
        np.testing.assert_array_equal(asm.percoord[d][0],
                                      np.asarray(jasm.percoord[d][0]))
        np.testing.assert_array_equal(asm.percoord[d][1],
                                      np.asarray(jasm.percoord[d][1]))
    for mine, theirs in zip(global_fdm_numpy(asm), global_fdm_numpy(jasm)):
        for a, b in zip(mine, theirs):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-15)


def test_interop_drives_port_with_jax_tables():
    jdofs, dofs = _dofs((3, 2, 3), 3)
    jasm = JaxASM(jdofs, n_overlap=1, weighting_type="symm", dtype=jnp.float64)
    x = torch.as_tensor(np.random.default_rng(6).standard_normal(dofs.n_dofs))
    via_jax = asm_from_jax(jasm).vmult(x)
    ref = np.asarray(jasm.vmult(jnp.asarray(x.numpy())))
    assert _rel(via_jax.numpy(), ref) < 1e-12


def test_unported_options_raise():
    dofs = DofHandler(StructuredMesh(3, (2, 2, 2)), 3)
    with pytest.raises(NotImplementedError, match="ROADMAP item 10"):
        ASMPreconditioner(dofs, weighting_type="ras")
    with pytest.raises(NotImplementedError, match="ROADMAP item 10"):
        ASMPreconditioner(dofs, n_overlap=2)
