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
    asm = ASMPreconditioner(dofs, weighting_type=wt, dtype=torch.float64,
                             device="cpu")
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
    asm = ASMPreconditioner(dofs, weighting_type=wt, dtype=torch.float32,
                             device="cpu")
    got = asm.vmult(torch.as_tensor(x))
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), ref) < 1e-5


@pytest.mark.parametrize("p,wt", [(2, "post"), (4, "symm")])
def test_tables_match_jax(p, wt):
    """Per-coordinate eigen-tables and folded transforms, entry by entry."""
    jdofs, dofs = _dofs((4, 3, 2), p)
    jasm = JaxASM(jdofs, n_overlap=1, weighting_type=wt, dtype=jnp.float64)
    asm = ASMPreconditioner(dofs, weighting_type=wt, dtype=torch.float64,
                             device="cpu")
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
    via_jax = asm_from_jax(jasm, device="cpu").vmult(x)
    ref = np.asarray(jasm.vmult(jnp.asarray(x.numpy())))
    assert _rel(via_jax.numpy(), ref) < 1e-12


def test_unported_options_raise():
    """RAS and overlap 2 run on Cartesian meshes
    (``test_torch_asm_overlap.py``) and, per cell, on deformed ones: there
    they equal the JAX ASMPreconditioner's per-cell forms (rel 1e-12); an
    unknown patch type still raises."""
    from dealii_asm_tpu.mesh.transforms import kershaw_transform as jk
    from dealii_asm_tpu_torch.mesh.transforms import kershaw_transform
    from dealii_asm_tpu_torch.precond.asm import CellASMPreconditioner

    jdofs = JaxDofHandler(JaxMesh(3, (2, 2, 2), transform=jk(0.3, 0.3)), 3)
    dofs = DofHandler(StructuredMesh(3, (2, 2, 2),
                                     transform=kershaw_transform(0.3, 0.3)), 3)
    x = np.random.default_rng(7).standard_normal(dofs.n_dofs)
    for kw in ({"weighting_type": "ras"}, {"n_overlap": 2}):
        ref = np.asarray(JaxASM(jdofs, dtype=jnp.float64, **kw).vmult(
            jnp.asarray(x)))
        got = CellASMPreconditioner(dofs, device="cpu", **kw)
        assert _rel(got.vmult(torch.as_tensor(x)).numpy(), ref) < 1e-12
    with pytest.raises(ValueError, match="patch type"):
        CellASMPreconditioner(dofs, patch_type="edge", device="cpu")


# -- deformed meshes: per-cell FDM tables (CellASMPreconditioner) ------------
# float64 against the JAX ASMPreconditioner on a Kershaw mesh (eps 0.3): rel
# 1e-12, the same per-cell transforms summed in another order (observed
# ~1e-15).


def _kershaw_dofs(cells, p):
    from dealii_asm_tpu.mesh.transforms import kershaw_transform as jk
    from dealii_asm_tpu_torch.mesh.transforms import kershaw_transform

    return (JaxDofHandler(JaxMesh(3, cells, transform=jk(0.3, 0.3)), p),
            DofHandler(StructuredMesh(3, cells,
                                      transform=kershaw_transform(0.3, 0.3)),
                       p))


@pytest.mark.parametrize("p,cells", [(1, (4, 3, 3)), (2, (3, 3, 2)),
                                     (4, (2, 3, 2))])
@pytest.mark.parametrize("wt", ["symm", "none"])
def test_cell_fdm_apply_matches_jax_on_kershaw(p, cells, wt):
    from dealii_asm_tpu_torch.precond.asm import CellASMPreconditioner

    jdofs, dofs = _kershaw_dofs(cells, p)
    jasm = JaxASM(jdofs, n_overlap=1, weighting_type=wt, dtype=jnp.float64)
    assert jasm.global_fdm is None  # the tables do not factor per coordinate
    x = np.random.default_rng(30 + p).standard_normal(dofs.n_dofs)
    ref = np.asarray(jasm.vmult(jnp.asarray(x)))
    asm = CellASMPreconditioner(dofs, weighting_type=wt, dtype=torch.float64,
                                device="cpu")
    assert asm.is_symmetric
    assert _rel(asm.vmult(torch.as_tensor(x)).numpy(), ref) < 1e-12
    # its eigen-tables are the JAX collection's, entry by entry
    np.testing.assert_array_equal(asm.collection.ids, jasm.collection.ids)
    for d in range(3):
        np.testing.assert_allclose(asm.collection.eigvals[d],
                                   np.asarray(jasm.collection.eigvals[d]),
                                   rtol=1e-13, atol=0)
        np.testing.assert_allclose(np.abs(asm.collection.eigvecs[d]),
                                   np.abs(np.asarray(
                                       jasm.collection.eigvecs[d])),
                                   rtol=0, atol=1e-12)


def test_cell_fdm_interop_and_float32():
    """asm_from_jax carries the JAX per-cell collection; the float32 apply
    agrees with the float64 one to float32 rounding (rel 1e-5)."""
    from dealii_asm_tpu_torch.precond.asm import CellASMPreconditioner

    jdofs, dofs = _kershaw_dofs((3, 2, 3), 3)
    jasm = JaxASM(jdofs, n_overlap=1, weighting_type="symm",
                  dtype=jnp.float64)
    x = np.random.default_rng(40).standard_normal(dofs.n_dofs)
    via_jax = asm_from_jax(jasm, device="cpu")
    assert isinstance(via_jax, CellASMPreconditioner)
    ref = np.asarray(jasm.vmult(jnp.asarray(x)))
    assert _rel(via_jax.vmult(torch.as_tensor(x)).numpy(), ref) < 1e-12
    asm32 = CellASMPreconditioner(dofs, weighting_type="symm",
                                  dtype=torch.float32, device="cpu")
    y32 = asm32.vmult(torch.as_tensor(x, dtype=torch.float32))
    assert y32.dtype == torch.float32
    assert _rel(y32.numpy(), ref) < 1e-5
    with pytest.raises(ValueError, match="CellASMPreconditioner"):
        ASMPreconditioner(dofs, device="cpu")


# -- the hyperball: element patches through cell_dofs (GeneralASMPreconditioner)
# float64 against the JAX GeneralASMPreconditioner (its lane-major XLA apply)
# on the 32- and 256-cell balls: rel 1e-12, the same per-cell transforms
# summed in another order.


def _ball_dofs(refinements, p):
    from dealii_asm_tpu.fem.general_dofs import GeneralDofHandler as JaxGD
    from dealii_asm_tpu.mesh.unstructured import hyper_ball_balanced as jball
    from dealii_asm_tpu_torch.fem.general_dofs import GeneralDofHandler
    from dealii_asm_tpu_torch.mesh.unstructured import hyper_ball_balanced

    return (JaxGD(jball(3).refine_global(refinements), p),
            GeneralDofHandler(hyper_ball_balanced(3).refine_global(refinements),
                              p))


@pytest.mark.parametrize("refinements,p", [(0, 2), (0, 4), (1, 1)])
@pytest.mark.parametrize("wt", WEIGHTINGS)
def test_general_fdm_matches_jax_on_ball(refinements, p, wt):
    from dealii_asm_tpu.precond.asm_general import \
        GeneralASMPreconditioner as JaxGeneralASM
    from dealii_asm_tpu_torch.precond.asm_general import \
        GeneralASMPreconditioner

    jdofs, dofs = _ball_dofs(refinements, p)
    jasm = JaxGeneralASM(jdofs, n_overlap=1, weighting_type=wt,
                         dtype=jnp.float64)
    x = np.random.default_rng(50 + p).standard_normal(dofs.n_dofs)
    ref = np.asarray(jasm.vmult(jnp.asarray(x)))
    asm = GeneralASMPreconditioner(dofs, weighting_type=wt,
                                   dtype=torch.float64, device="cpu")
    assert asm.is_symmetric == (wt in ("none", "symm"))
    assert _rel(asm.vmult(torch.as_tensor(x)).numpy(), ref) < 1e-12
    np.testing.assert_array_equal(asm.collection.ids, jasm.collection.ids)
    np.testing.assert_array_equal(asm.weights.numpy(),
                                  np.asarray(jasm.weights))


def test_general_fdm_interop_float32_and_options():
    """general_asm_from_jax carries the JAX collection; float32 agrees to
    float32 rounding (rel 1e-5); RAS, overlap 2 and vertex patches (the
    factory's "element centric": false) agree with the JAX
    GeneralASMPreconditioner to rel 1e-12."""
    from dealii_asm_tpu.precond.asm_general import \
        GeneralASMPreconditioner as JaxGeneralASM
    from dealii_asm_tpu_torch.interop import general_asm_from_jax
    from dealii_asm_tpu_torch.precond.asm_general import \
        GeneralASMPreconditioner
    from dealii_asm_tpu_torch.precond.factory import \
        create_system_preconditioner

    jdofs, dofs = _ball_dofs(1, 3)
    jasm = JaxGeneralASM(jdofs, n_overlap=1, weighting_type="symm",
                         dtype=jnp.float64)
    x = np.random.default_rng(60).standard_normal(dofs.n_dofs)
    ref = np.asarray(jasm.vmult(jnp.asarray(x)))
    via_jax = general_asm_from_jax(jasm, device="cpu")
    assert _rel(via_jax.vmult(torch.as_tensor(x)).numpy(), ref) < 1e-12
    asm32 = GeneralASMPreconditioner(dofs, weighting_type="symm",
                                     dtype=torch.float32, device="cpu")
    y32 = asm32.vmult(torch.as_tensor(x, dtype=torch.float32))
    assert y32.dtype == torch.float32
    assert _rel(y32.numpy(), ref) < 1e-5
    for kw in ({"weighting_type": "ras"}, {"n_overlap": 2}):
        jref = np.asarray(JaxGeneralASM(jdofs, dtype=jnp.float64, **kw).vmult(
            jnp.asarray(x)))
        got = GeneralASMPreconditioner(dofs, device="cpu", **kw)
        assert _rel(got.vmult(torch.as_tensor(x)).numpy(), jref) < 1e-12

    class Op:  # what the factory reads of a level operator
        pass

    op = Op()
    op.dofs, op.degree, op.dtype, op.device = dofs, 3, torch.float64, "cpu"
    made = create_system_preconditioner(op, {"type": "FDM"})
    assert isinstance(made, GeneralASMPreconditioner)
    vertex = create_system_preconditioner(op, {"type": "FDM",
                                               "element centric": False})
    assert vertex.patch_type == "vertex"
    jref = np.asarray(JaxGeneralASM(jdofs, weighting_type="symm",
                                    patch_type="vertex",
                                    dtype=jnp.float64).vmult(jnp.asarray(x)))
    assert _rel(vertex.vmult(torch.as_tensor(x)).numpy(), jref) < 1e-12
