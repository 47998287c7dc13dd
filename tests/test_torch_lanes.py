"""Kernel F's plain version (dealii_asm_tpu_torch.kernels.lanes_laplace, via
the port's GeneralLaplaceOperator on CPU tensors) against the JAX package's
GeneralLaplaceOperator on the balanced ball, same inputs from a numpy seed.

Tolerances (max |port - JAX| / max |JAX|):
- float64 vs ``kernel="sumfac"`` (exact float64) and vs ``"lanes-pallas"``
  (the TPU kernel LanesDDVmultKernel in interpret mode, double-single with
  an exact float64 scatter): 1e-12, the same products summed in another
  order (the JAX package's default CPU float64 "lanes" operator is its
  double-single XLA composition, about 1e-8, so it is not the oracle);
- float32 vs the JAX float32 "lanes" operator (the ball's level operator):
  1e-5, float32 rounding in another contraction order;
- the right-hand side: 1e-13 (float64, another summation order).
The port computes its own geometry; the interop test drives it with the JAX
package's coefficient tables, whose component order differs.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dealii_asm_tpu.fem.functions import make_rhs_and_dbc
from dealii_asm_tpu.fem.general_dofs import GeneralDofHandler as JaxDofs
from dealii_asm_tpu.mesh.unstructured import hyper_ball_balanced as jax_ball
from dealii_asm_tpu.ops.laplace_general import \
    GeneralLaplaceOperator as JaxGeneral
from dealii_asm_tpu_torch.fem.general_dofs import GeneralDofHandler
from dealii_asm_tpu_torch.interop import (coeff6_from_jax,
                                          general_dofs_from_jax,
                                          general_laplace_from_jax)
from dealii_asm_tpu_torch.kernels import launch_counts
from dealii_asm_tpu_torch.kernels.lanes_laplace import (lanes_laplace,
                                                        lanes_laplace_plain)
from dealii_asm_tpu_torch.mesh.unstructured import hyper_ball_balanced
from dealii_asm_tpu_torch.ops.laplace_general import GeneralLaplaceOperator
from dealii_asm_tpu_torch.ops.fixed_sum import FixedOrderSum

CASES = [(r, p) for r in (0, 1) for p in (1, 2, 3, 4)]


@pytest.fixture(scope="module")
def meshes():
    """{refinements: (port mesh, JAX mesh)} of the 32- and 256-cell balls."""
    m, j = hyper_ball_balanced(3), jax_ball(3)
    return {0: (m, j), 1: (m.refine(), j.refine())}


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _ops(meshes, r, p, dtype, kernel="sumfac"):
    m, j = meshes[r]
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    port = GeneralLaplaceOperator(GeneralDofHandler(m, p), dtype=dtype,
                                  device="cpu")
    ref = JaxGeneral(JaxDofs(j, p), dtype=jdt, kernel=kernel)
    return port, ref


def _vectors(n, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n), rng.standard_normal(n)


@pytest.mark.parametrize("r,p", CASES)
def test_float64_matches_jax_sumfac(meshes, r, p):
    port, ref = _ops(meshes, r, p, torch.float64)
    x, b = _vectors(port.n_dofs, 10 * r + p)
    got = port.vmult(torch.as_tensor(x))
    assert got.dtype == torch.float64
    assert _rel(got, ref.vmult(jnp.asarray(x))) < 1e-12
    res = port.residual(torch.as_tensor(b), torch.as_tensor(x))
    assert _rel(res, ref.residual(jnp.asarray(b), jnp.asarray(x))) < 1e-12
    # constrained rows act as identity
    mask = port.dofs.boundary_mask
    np.testing.assert_array_equal(got.numpy()[mask], x[mask])


@pytest.mark.parametrize("p", [2, 3, 4])
def test_float64_matches_jax_lanes_pallas_interpret(meshes, p):
    port, ref = _ops(meshes, 0, p, torch.float64, kernel="lanes-pallas")
    assert ref._lanes_dd_pallas is not None
    x, _ = _vectors(port.n_dofs, 100 + p)
    assert _rel(port.vmult(torch.as_tensor(x)), ref.vmult(jnp.asarray(x))) < 1e-12


@pytest.mark.parametrize("r,p", CASES)
def test_float32_matches_jax_lanes(meshes, r, p):
    port, ref = _ops(meshes, r, p, torch.float32, kernel="lanes")
    x, b = _vectors(port.n_dofs, 200 + 10 * r + p)
    x32, b32 = x.astype(np.float32), b.astype(np.float32)
    got = port.vmult(torch.as_tensor(x32))
    assert got.dtype == torch.float32
    assert _rel(got, ref.vmult(jnp.asarray(x32))) < 1e-5
    res = port.residual(torch.as_tensor(b32), torch.as_tensor(x32))
    assert _rel(res, ref.residual(jnp.asarray(b32), jnp.asarray(x32))) < 1e-5
    # a float64 input is cast in and out (the Lanczos estimate's vectors)
    got64 = port.vmult(torch.as_tensor(x))
    assert got64.dtype == torch.float64
    assert _rel(got64, got.double()) < 1e-6


@pytest.mark.parametrize("r,p", [(0, 2), (0, 4), (1, 1), (1, 4)])
def test_assemble_rhs_matches_jax(meshes, r, p):
    port, ref = _ops(meshes, r, p, torch.float64)
    f, dbc = make_rhs_and_dbc("constant", 3)
    got = port.assemble_rhs("constant")
    want = np.asarray(ref.assemble_rhs(f, dirichlet=dbc))
    assert got.dtype == torch.float64
    assert _rel(got, want) < 1e-13
    assert not got.numpy()[port.dofs.boundary_mask].any()


@pytest.mark.parametrize("kernel", ["lanes", "sumfac"])
def test_interop_coefficient_order(meshes, kernel):
    """The JAX coefficients, [xx, xy, xz, yy, yz, zz] lane-major or a full
    (C, Q, 3, 3) tensor, arrive in the port's [xx, yy, zz, xy, xz, yz]
    cell-major order and equal the port's own geometry."""
    _, j = meshes[1]
    ref = JaxGeneral(JaxDofs(j, 3), dtype=jnp.float64, kernel=kernel)
    op = general_laplace_from_jax(ref, dtype=torch.float64, device="cpu")
    own = GeneralLaplaceOperator(general_dofs_from_jax(ref.dofs),
                                 dtype=torch.float64, device="cpu")
    assert coeff6_from_jax(ref).shape == (256, 6, 64)
    assert _rel(op.coeff6, own.coeff6) < 1e-12
    assert _rel(op.jxw, own.jxw) < 1e-12
    x, _ = _vectors(op.n_dofs, 7)
    assert _rel(op.vmult(torch.as_tensor(x)),
                JaxGeneral(JaxDofs(j, 3), dtype=jnp.float64,
                           kernel="sumfac").vmult(jnp.asarray(x))) < 1e-12


def test_index_tables(meshes):
    """gather = cell_dofs with -1 at constrained DoFs; the CSR lists every
    free DoF's slots in ascending order and no constrained DoF."""
    m, _ = meshes[1]
    op = GeneralLaplaceOperator(GeneralDofHandler(m, 2), device="cpu")
    t = op.tables
    cd = op.dofs.cell_dofs.reshape(-1)
    free = ~op.dofs.boundary_mask
    np.testing.assert_array_equal(t.gather.reshape(-1).numpy(),
                                  np.where(free[cd], cd, -1))
    assert t.gather.dtype == t.row_ptr.dtype == t.slots.dtype == torch.int32
    row_ptr, slots = t.row_ptr.numpy(), t.slots.numpy()
    counts = np.diff(row_ptr)
    np.testing.assert_array_equal(counts > 0, free)
    np.testing.assert_array_equal(counts[free], np.bincount(cd)[free])
    for i in np.flatnonzero(free)[::37]:
        s = slots[row_ptr[i]:row_ptr[i + 1]]
        np.testing.assert_array_equal(s, np.flatnonzero(cd == i))


def test_fixed_order_sum_matches_index_add():
    rng = np.random.default_rng(3)
    index = torch.as_tensor(rng.integers(-2, 40, size=500))
    values = torch.as_tensor(rng.standard_normal(500))
    got = FixedOrderSum(index, 37)(values)
    keep = (index >= 0) & (index < 37)
    want = torch.zeros(37, dtype=torch.float64).index_add_(
        0, index[keep], values[keep])
    assert torch.allclose(got, want, rtol=1e-14, atol=1e-14)


def test_wrapper_takes_plain_path_on_cpu(meshes):
    m, _ = meshes[0]
    op = GeneralLaplaceOperator(GeneralDofHandler(m, 2),
                                dtype=torch.float32, device="cpu")
    x = torch.as_tensor(np.random.default_rng(1).standard_normal(op.n_dofs),
                        dtype=torch.float32)
    before = launch_counts()
    got = lanes_laplace(x, op.tables)
    assert launch_counts() == before
    assert torch.equal(got, lanes_laplace_plain(x, op.tables))
    with pytest.raises(TypeError, match="unsupported device"):
        lanes_laplace(torch.empty(op.n_dofs, device="meta"), op.tables)
