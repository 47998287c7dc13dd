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
    tr = TwoLevelTransfer(c, f, dtype=torch.float64)
    for d in range(3):
        np.testing.assert_array_equal(tr.P1d[d], np.asarray(jtr.P1d[d]))
    rng = np.random.default_rng(11)
    uc = rng.standard_normal(c.n_dofs)
    rf = rng.standard_normal(f.n_dofs)
    assert _rel(tr.prolongate(torch.as_tensor(uc)).numpy(),
                jtr.prolongate(jnp.asarray(uc))) < 1e-13
    assert _rel(tr.restrict(torch.as_tensor(rf)).numpy(),
                jtr.restrict(jnp.asarray(rf))) < 1e-13
    via = transfer_from_jax(jtr)
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
    got = DirectCoarseSolver(d, dtype=getattr(torch, dtype))
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
    ops = [LaplaceOperator(x, dtype=torch.float32) for x in (c, f)]
    jmg = JaxMultigrid([o.vmult for o in jops], [jax_create(jops[1], cfg)],
                       [JaxTransfer(jc, jf, dtype=jnp.float32)],
                       JaxDirect(jc, dtype=jnp.float32).vmult)
    mg = Multigrid(ops, [create_system_preconditioner(ops[1], cfg)],
                   [TwoLevelTransfer(c, f, dtype=torch.float32)],
                   DirectCoarseSolver(c, dtype=torch.float32).vmult)
    b = np.random.default_rng(13).standard_normal(f.n_dofs).astype(np.float32)
    b[f.boundary_mask] = 0.0
    assert _rel(mg.vmult(torch.as_tensor(b)).numpy(),
                jmg.vmult(jnp.asarray(b))) < 1e-5
