"""The port's unstructured mesh and DoF handler (NumPy copies in
dealii_asm_tpu_torch) against the JAX package's: the balanced ball and its
refinements, the face tables, the mapping support points, the harmonic
extents and the GeneralDofHandler tables.

Contract: exact equality at 0, 1 and 2 refinements (the same arithmetic in
the same order), at p = 1, 2 and 4.
"""

import numpy as np
import pytest

from dealii_asm_tpu.fem.general_dofs import GeneralDofHandler as JaxDofs
from dealii_asm_tpu.mesh.unstructured import hyper_ball_balanced as jax_ball
from dealii_asm_tpu_torch.fem.general_dofs import GeneralDofHandler
from dealii_asm_tpu_torch.mesh.unstructured import hyper_ball_balanced

REFINEMENTS = (0, 1, 2)


@pytest.fixture(scope="module")
def meshes():
    """{refinements: (port mesh, JAX mesh)}."""
    out = {}
    m, j = hyper_ball_balanced(3), jax_ball(3)
    for r in range(max(REFINEMENTS) + 1):
        if r:
            m, j = m.refine(), j.refine()
        out[r] = (m, j)
    return out


@pytest.mark.parametrize("r", REFINEMENTS)
def test_mesh_topology_equal(meshes, r):
    m, j = meshes[r]
    assert m.n_cells_total == 32 * 8 ** r
    np.testing.assert_array_equal(m.cells, j.cells)
    np.testing.assert_array_equal(m.vertices, j.vertices)
    np.testing.assert_array_equal(m.face_neighbors(), j.face_neighbors())
    np.testing.assert_array_equal(m.face_neighbor_faces(),
                                  j.face_neighbor_faces())
    np.testing.assert_array_equal(m.boundary_vertex_mask(),
                                  j.boundary_vertex_mask())
    if r:
        np.testing.assert_array_equal(m.parent_cells, j.parent_cells)
        np.testing.assert_array_equal(m.child_index, j.child_index)
        np.testing.assert_array_equal(m.chart_cell, j.chart_cell)
        np.testing.assert_array_equal(m.chart_lo, j.chart_lo)
        np.testing.assert_array_equal(m.chart_h, j.chart_h)


@pytest.mark.parametrize("r", REFINEMENTS)
def test_mesh_geometry_equal(meshes, r):
    m, j = meshes[r]
    for deg in (1, 2):
        np.testing.assert_array_equal(m.cell_mapping_points(deg),
                                      j.cell_mapping_points(deg))
    q = np.array([0.2, 0.7])
    Bm, spm = m.jacobian_factors(2, q)
    Bj, spj = j.jacobian_factors(2, q)
    np.testing.assert_array_equal(Bm, Bj)
    np.testing.assert_array_equal(spm, spj)
    for nq in (2, 5):
        np.testing.assert_array_equal(m.harmonic_cell_extents(nq),
                                      j.harmonic_cell_extents(nq))
        np.testing.assert_array_equal(m.harmonic_patch_extents(nq),
                                      j.harmonic_patch_extents(nq))
    assert m.max_aspect_ratio() == j.max_aspect_ratio()


@pytest.mark.parametrize("p", [1, 2, 4])
@pytest.mark.parametrize("r", REFINEMENTS)
def test_general_dofs_equal(meshes, r, p):
    m, j = meshes[r]
    d, jd = GeneralDofHandler(m, p), JaxDofs(j, p)
    assert d.n_dofs == jd.n_dofs
    assert d.cell_dofs.dtype == np.int32
    np.testing.assert_array_equal(d.cell_dofs, jd.cell_dofs)
    np.testing.assert_array_equal(d.boundary_mask, jd.boundary_mask)
    np.testing.assert_array_equal(d.points, jd.points)


def test_ball_dof_counts(meshes):
    # the reference counts of the ball at Q4 (2,273 / 17,217 / 134,273)
    counts = [GeneralDofHandler(meshes[r][0], 4).n_dofs for r in REFINEMENTS]
    assert counts == [2273, 17217, 134273]


def test_refined_children_share_parent_frame(meshes):
    """Children are 2^dim consecutive cells per parent, octant x fastest."""
    m = meshes[1][0]
    np.testing.assert_array_equal(m.parent_cells, np.repeat(np.arange(32), 8))
    np.testing.assert_array_equal(m.child_index, np.tile(np.arange(8), 32))
