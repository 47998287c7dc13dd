"""Port's Laplace operator (dealii_asm_tpu_torch.ops.laplace) vs the JAX one.

Inputs come from a seeded numpy generator and go to both packages.  The port
runs its plain PyTorch path here (CPU tensors); the CUDA kernel is checked
against that same plain path on the GPU by chip_smoke.py.

Tolerances:
- float64 apply: rel 1e-12 against the JAX ``kernel="banded"`` path, which
  sums the same banded products in float64 (observed ~2e-16).  The JAX
  default CPU float64 path runs a double-single composition that XLA:CPU
  fusion degrades to ~3e-8, so it is not the oracle.
- float32 apply: rel 1e-5 (relative to max |v|) against ``kernel="pallas-f32"``,
  the TPU F32VmultKernel in interpret mode: float32 rounding of the same
  products in another order (observed ~1e-7).
- inverse diagonal, float64: rel 1e-14 against ``compute_inverse_diagonal``
  (the same outer products of the 1D diagonals, in the same order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dealii_asm_tpu.fem.dofs import DofHandler as JaxDofHandler
from dealii_asm_tpu.fem.functions import make_rhs_and_dbc
from dealii_asm_tpu.mesh.grid import StructuredMesh as JaxMesh
from dealii_asm_tpu.ops.laplace import LaplaceOperator as JaxLaplace
from dealii_asm_tpu_torch.fem.dofs import DofHandler
from dealii_asm_tpu_torch.interop import laplace_from_jax
from dealii_asm_tpu_torch.mesh.grid import StructuredMesh
from dealii_asm_tpu_torch.ops.laplace import LaplaceOperator

CASES = [((2, 2, 2), 1), ((3, 3, 3), 2), ((2, 3, 4), 3), ((4, 4, 4), 4)]


def _dofs(cells, p):
    """(JAX DofHandler, port DofHandler) of the same lattice."""
    return (JaxDofHandler(JaxMesh(3, cells), p),
            DofHandler(StructuredMesh(3, cells), p))


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(b).max()


@pytest.mark.parametrize("cells,p", CASES)
def test_f64_apply_matches_jax_banded(cells, p):
    jdofs, dofs = _dofs(cells, p)
    x = np.random.default_rng(1).standard_normal(dofs.n_dofs)
    ref = np.asarray(JaxLaplace(jdofs, dtype=jnp.float64,
                                kernel="banded").vmult(jnp.asarray(x)))
    got = LaplaceOperator(dofs, dtype=torch.float64,
                          device="cpu").vmult(torch.as_tensor(x))
    assert got.dtype == torch.float64
    assert _rel(got.numpy(), ref) < 1e-12


@pytest.mark.parametrize("cells,p", CASES)
def test_f32_apply_matches_jax_pallas_f32(cells, p):
    jdofs, dofs = _dofs(cells, p)
    x = np.random.default_rng(2).standard_normal(dofs.n_dofs).astype(np.float32)
    jop = JaxLaplace(jdofs, dtype=jnp.float32, kernel="pallas-f32")
    assert jop._f32_pallas is not None  # the TPU kernel, interpret mode
    ref = np.asarray(jop.vmult(jnp.asarray(x)))
    got = LaplaceOperator(dofs, dtype=torch.float32,
                          device="cpu").vmult(torch.as_tensor(x))
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), ref) < 1e-5


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-14),
                                       (torch.float32, 1e-6)])
def test_residual_and_identity_rows(dtype, tol):
    _, dofs = _dofs((3, 2, 4), 3)
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.standard_normal(dofs.n_dofs), dtype=dtype)
    b = torch.as_tensor(rng.standard_normal(dofs.n_dofs), dtype=dtype)
    op = LaplaceOperator(dofs, dtype=dtype, device="cpu")
    v = op.vmult(x)
    mask = torch.as_tensor(dofs.boundary_mask)
    assert torch.equal(v[mask], x[mask])  # constrained rows act as identity
    r = op.residual(b, x)
    assert float((r - (b - v)).abs().max() / (b - v).abs().max()) < tol


def test_mixed_dtype_apply_matches_jax():
    """float64 vectors on a float32 operator (the Lanczos estimates): cast
    in, apply in float32, cast out, as the JAX operator does."""
    jdofs, dofs = _dofs((3, 3, 3), 4)
    x = np.random.default_rng(4).standard_normal(dofs.n_dofs)
    x[dofs.boundary_mask] = 0.0
    ref = np.asarray(JaxLaplace(jdofs, dtype=jnp.float32).vmult(jnp.asarray(x)))
    got = LaplaceOperator(dofs, dtype=torch.float32,
                          device="cpu").vmult(torch.as_tensor(x))
    assert got.dtype == torch.float64
    assert _rel(got.numpy(), ref) < 1e-5


@pytest.mark.parametrize("cells,p", [((2, 3, 4), 2), ((4, 4, 4), 4)])
def test_assemble_rhs_matches_jax(cells, p):
    jdofs, dofs = _dofs(cells, p)
    rhs_fn, dbc_fn = make_rhs_and_dbc("constant", 3)
    ref = np.asarray(JaxLaplace(jdofs, dtype=jnp.float64).assemble_rhs(
        rhs_fn, dirichlet=dbc_fn))
    got = LaplaceOperator(dofs, dtype=torch.float64,
                          device="cpu").assemble_rhs("constant")
    assert _rel(got.numpy(), ref) < 1e-13


def test_assemble_rhs_other_functions_not_ported():
    """Every rhs of the solver program is ported (tests/test_torch_rhs.py):
    a name resolves to its function and gives the JAX vector (constrained
    entries 0); an unknown name raises, as in the JAX package."""
    jdofs, dofs = _dofs((2, 2, 2), 2)
    op = LaplaceOperator(dofs, device="cpu")
    ref = np.array(JaxLaplace(jdofs, dtype=jnp.float64).assemble_rhs(
        make_rhs_and_dbc("sin-mp", 3)[0]))
    assert _rel(op.assemble_rhs("sin-mp").numpy(), ref) < 1e-12
    with pytest.raises(ValueError, match="unknown rhs"):
        op.assemble_rhs("cosine")


@pytest.mark.parametrize("cells,p", [((3, 2, 4), 2), ((4, 4, 4), 4)])
def test_setup_tables_match_jax(cells, p):
    """The port's jax-free NumPy setup gives the JAX tables entry by entry."""
    jdofs, dofs = _dofs(cells, p)
    jop = JaxLaplace(jdofs, dtype=jnp.float64, kernel="banded")
    op = LaplaceOperator(dofs, dtype=torch.float64, device="cpu")
    for d in range(3):
        np.testing.assert_array_equal(op.M1d_global[d],
                                      np.asarray(jop.M1d_global[d]))
        np.testing.assert_array_equal(op.K1d_global[d],
                                      np.asarray(jop.K1d_global[d]))
        np.testing.assert_array_equal(op.tables.Mdiags[d].numpy(),
                                      np.asarray(jop.Mdiags[d]))
        np.testing.assert_array_equal(op.tables.Kdiags[d].numpy(),
                                      np.asarray(jop.Kdiags[d]))


def test_interop_drives_port_with_jax_tables():
    jdofs, dofs = _dofs((2, 3, 2), 3)
    jop = JaxLaplace(jdofs, dtype=jnp.float64, kernel="banded")
    x = torch.as_tensor(np.random.default_rng(5).standard_normal(dofs.n_dofs))
    via_jax = laplace_from_jax(jop, device="cpu").vmult(x)
    own = LaplaceOperator(dofs, device="cpu").vmult(x)
    assert torch.equal(via_jax, own)


def test_unported_meshes_raise():
    # 2D Cartesian meshes are ported (tests/test_torch_2d.py) and so are
    # periodic ones (tests/test_torch_periodic.py, test_torch_benchmark.py:
    # here a mesh periodic in x builds and equals the JAX operator) and 2D
    # deformed ones (here an identity-deformed 2D mesh equals the JAX
    # operator; Kershaw in tests/test_torch_2d.py)
    jdofs = JaxDofHandler(JaxMesh(3, (2, 2, 2), periodic=(True, False, False)),
                          2)
    op = LaplaceOperator(DofHandler(StructuredMesh(
        3, (2, 2, 2), periodic=(True, False, False)), 2), device="cpu")
    x = np.random.default_rng(2).standard_normal(op.n_dofs)
    ref = np.asarray(JaxLaplace(jdofs, dtype=jnp.float64, kernel="banded")
                     .vmult(jnp.asarray(x)))
    assert _rel(op.vmult(torch.as_tensor(x)).numpy(), ref) < 1e-12
    ident = lambda pts: pts
    jdofs2 = JaxDofHandler(JaxMesh(2, (2, 2), transform=ident), 2)
    op2 = LaplaceOperator(DofHandler(StructuredMesh(
        2, (2, 2), transform=ident), 2), device="cpu")
    x = np.random.default_rng(3).standard_normal(op2.n_dofs)
    ref = np.asarray(JaxLaplace(jdofs2, dtype=jnp.float64, kernel="banded")
                     .vmult(jnp.asarray(x)))
    assert _rel(op2.vmult(torch.as_tensor(x)).numpy(), ref) < 1e-12


@pytest.mark.parametrize("p", [2, 4])
def test_inverse_diagonal_matches_jax(p):
    jdofs, dofs = _dofs((3, 4, 5), p)
    ref = np.asarray(JaxLaplace(jdofs, dtype=jnp.float64)
                     .compute_inverse_diagonal())
    got = LaplaceOperator(dofs, device="cpu").compute_inverse_diagonal()
    assert got.dtype == torch.float64 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-14, atol=0)
    np.testing.assert_array_equal(got.numpy()[dofs.boundary_mask], 1.0)


def test_inverse_diagonal_of_deformed_operator_not_ported():
    """The deformed inverse diagonal is ported: it equals the JAX one to
    rel 1e-12 (more cases in ``test_torch_diagonal.py``)."""
    from dealii_asm_tpu.mesh.transforms import kershaw_transform as jk
    from dealii_asm_tpu_torch.mesh.transforms import kershaw_transform

    mesh = StructuredMesh(3, (2, 2, 2), transform=kershaw_transform(0.3, 0.3))
    dofs = DofHandler(mesh, 2)
    op = LaplaceOperator(dofs, device="cpu")
    ref = np.asarray(JaxLaplace(
        JaxDofHandler(JaxMesh(3, (2, 2, 2), transform=jk(0.3, 0.3)), 2),
        mapping_degree=2, dtype=jnp.float64).compute_inverse_diagonal())
    got = op.compute_inverse_diagonal()
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12, atol=0)
    np.testing.assert_array_equal(got.numpy()[dofs.boundary_mask], 1.0)
