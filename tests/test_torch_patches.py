"""Patch tables, vertex 1D builders and strided windows of the port
(dealii_asm_tpu_torch.fem.patches, fem.general_patches, precond.fdm,
ops.tensorops, ops.lattice) against the JAX package.

- ``element_patch_indices`` (overlap 1..p), ``vertex_patch_indices`` and the
  vertex anchors on 3 x 4 x 5 Cartesian cells at p = 1..4 and on the
  Kershaw mesh at 0 refinements (6^3 cells): equal entry by entry;
- ``general_element_patch_indices`` (overlap 2..p) and
  ``general_vertex_patch_indices`` (tables and anchor-frame extents) on the
  ball at 0 and 1 refinements: equal entry by entry;
- the vertex 1D builders, their per-coordinate eigen-tables and
  ``fdm_direction_transform(patch="vertex")``: to 1e-13;
- ``ops.lattice.grid_to_windows`` equals the gather through the tables, and
  ``windows_to_grid`` the scatter-add through them (to 1e-13), bit-identical
  on repeat.
"""

import numpy as np
import pytest
import torch

from dealii_asm_tpu.fem import patches as jpatches
from dealii_asm_tpu.fem.dofs import DofHandler as JaxDofHandler
from dealii_asm_tpu.mesh.grid import StructuredMesh as JaxMesh
from dealii_asm_tpu_torch.fem import patches
from dealii_asm_tpu_torch.fem.dofs import DofHandler
from dealii_asm_tpu_torch.mesh.grid import StructuredMesh
from dealii_asm_tpu_torch.ops import lattice

CELLS = (3, 4, 5)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test process (see tests/test_torch_gmres.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dofs(cells, p, kershaw=False):
    """(JAX DofHandler, port DofHandler) of the same lattice."""
    from dealii_asm_tpu.mesh.transforms import kershaw_transform as jk
    from dealii_asm_tpu_torch.mesh.transforms import kershaw_transform

    return (JaxDofHandler(JaxMesh(3, cells, transform=jk(0.3, 0.3)
                                  if kershaw else None), p),
            DofHandler(StructuredMesh(3, cells, transform=kershaw_transform(
                0.3, 0.3) if kershaw else None), p))


@pytest.mark.parametrize("cells,kershaw", [(CELLS, False), ((6, 6, 6), True)])
@pytest.mark.parametrize("p", [1, 2, 3, 4])
def test_structured_patch_tables_match_jax(cells, kershaw, p):
    jdofs, dofs = _dofs(cells, p, kershaw)
    for o in range(1, p + 1):
        np.testing.assert_array_equal(
            patches.element_patch_indices(dofs, o),
            jpatches.element_patch_indices(jdofs, o))
    idx, anchors = patches.vertex_patch_indices(dofs)
    jidx, janchors = jpatches.vertex_patch_indices(jdofs)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(anchors, janchors)
    assert idx.dtype == np.int32 and idx.shape == (
        np.prod([c - 1 for c in cells]), (2 * p - 1) ** 3)


@pytest.mark.parametrize("p", [1, 2, 3, 4])
def test_strided_windows_equal_the_tables(p):
    """The strided windows gather what the tables gather, and their
    overlap-add sums what the tables scatter."""
    _, dofs = _dofs(CELLS, p)
    rng = np.random.default_rng(p)
    x = rng.standard_normal(dofs.n_dofs)
    xpad = np.append(x, 0.0)
    grid = torch.as_tensor(x).reshape(tuple(reversed(dofs.nodes_per_dim)))
    cases = [("element", o, patches.element_patch_indices(dofs, o))
             for o in range(1, p + 1)]
    cases.append(("vertex", 1, patches.vertex_patch_indices(dofs)[0]))
    for patch, o, idx in cases:
        m, first = lattice.window_layout(p, o, patch)
        W = lattice.grid_to_windows(grid, p, m, first)
        np.testing.assert_array_equal(W.numpy(), xpad[idx])
        y = torch.as_tensor(rng.standard_normal(W.shape))
        ref = np.zeros(dofs.n_dofs + 1)
        np.add.at(ref, idx.reshape(-1), y.numpy().reshape(-1))
        got = lattice.windows_to_grid(y, grid.shape, p, m, first)
        np.testing.assert_allclose(got.reshape(-1).numpy(), ref[:-1],
                                   rtol=0, atol=1e-13)
        assert torch.equal(got, lattice.windows_to_grid(y, grid.shape, p, m,
                                                        first))


def _ball(refinements, p):
    from dealii_asm_tpu.fem.general_dofs import GeneralDofHandler as JaxGD
    from dealii_asm_tpu.mesh.unstructured import hyper_ball_balanced as jball
    from dealii_asm_tpu_torch.fem.general_dofs import GeneralDofHandler
    from dealii_asm_tpu_torch.mesh.unstructured import hyper_ball_balanced

    return (JaxGD(jball(3).refine_global(refinements), p),
            GeneralDofHandler(hyper_ball_balanced(3).refine_global(refinements),
                              p))


@pytest.mark.parametrize("refinements,p", [(0, 1), (0, 2), (0, 3), (0, 4),
                                           (1, 1), (1, 2)])
def test_general_patch_tables_match_jax(refinements, p):
    from dealii_asm_tpu.fem import general_patches as jgp
    from dealii_asm_tpu_torch.fem import general_patches as gp

    jdofs, dofs = _ball(refinements, p)
    for o in range(2, p + 1):
        np.testing.assert_array_equal(
            gp.general_element_patch_indices(dofs, o),
            jgp.general_element_patch_indices(jdofs, o))
    idx, ext = gp.general_vertex_patch_indices(dofs)
    jidx, jext = jgp.general_vertex_patch_indices(jdofs)
    assert idx.shape[0] > 0 and idx.dtype == np.int32
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(ext, jext)


@pytest.mark.parametrize("p", range(1, 8))
def test_vertex_1d_builders_match_jax(p):
    from dealii_asm_tpu.precond import fdm as jfdm
    from dealii_asm_tpu_torch.precond import fdm

    ext = np.random.default_rng(p).uniform(0.1, 2.0, (5, 2))
    M, K = fdm.vertex_patch_1d_matrices_batched(p, ext)
    jM, jK = jfdm.vertex_patch_1d_matrices_batched(p, ext)
    np.testing.assert_allclose(M, jM, rtol=0, atol=1e-13)
    np.testing.assert_allclose(K, jK, rtol=0, atol=1e-13)
    for u in range(5):
        for got, ref in zip(fdm.vertex_patch_1d_matrices(p, ext[u]),
                            jfdm.vertex_patch_1d_matrices(p, ext[u])):
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-13)


@pytest.mark.parametrize("p", [1, 2, 3, 4])
def test_vertex_percoord_and_direction_transform_match_jax(p):
    """The per-coordinate vertex tables equal the JAX ``percoord`` (its
    deduplicated collection picked per coordinate), and the vertex
    direction transform the JAX one."""
    import jax.numpy as jnp

    from dealii_asm_tpu.ops.tensorops import \
        fdm_direction_transform as jtransform
    from dealii_asm_tpu.precond.asm import ASMPreconditioner as JaxASM
    from dealii_asm_tpu_torch.ops.tensorops import fdm_direction_transform
    from dealii_asm_tpu_torch.precond.fdm import \
        vertex_percoord_eigendecomposition

    jdofs, dofs = _dofs(CELLS, p)
    jasm = JaxASM(jdofs, patch_type="vertex", dtype=jnp.float64)
    tables = vertex_percoord_eigendecomposition(dofs.mesh, p)
    for d, (V, lam) in enumerate(tables):
        jV, jlam = (np.asarray(a) for a in jasm.percoord[d])
        assert V.shape == (CELLS[d] - 1, 2 * p - 1, 2 * p - 1)
        np.testing.assert_allclose(lam, jlam, rtol=1e-13, atol=0)
        np.testing.assert_allclose(V, jV, rtol=0, atol=1e-13)
        n_d = dofs.nodes_per_dim[d]
        np.testing.assert_allclose(
            fdm_direction_transform(V, n_d, p, 1, False, "vertex"),
            jtransform(jV, n_d, p, 1, False, patch="vertex"), rtol=0,
            atol=1e-13)


def test_a_mesh_without_interior_vertex_raises():
    from dealii_asm_tpu_torch.precond.fdm import (
        NoVertexPatches, vertex_percoord_eigendecomposition)

    with pytest.raises(NoVertexPatches, match="no interior vertex"):
        vertex_percoord_eigendecomposition(StructuredMesh(3, (1, 1, 1)), 2)
    assert issubclass(NoVertexPatches, ValueError)
