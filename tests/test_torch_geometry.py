"""The port's deformed-mesh host layer and merged geometry against the JAX
package: the Kershaw transform, the mapping support points, the harmonic
patch extents, the aspect ratio, the 1D shape data and tensor helpers, the
element windows of the lattice, and the geometry coefficient.

Tolerances:
- NumPy host code carried over with the same arithmetic: equal, or rel
  1e-13 where a reduction may sum in another order (observed 0);
- the geometry coefficient w|J|J⁻¹J⁻ᵀ and w·det J, computed in torch
  float64 against the JAX package's XLA pipeline: rel 1e-13 of the table's
  max (the Jacobian contraction sums in another order; observed ~2e-14);
- the packed box-coordinate coefficient against the JAX ``coeff6`` q-grids:
  rel 1e-13 (observed ~2e-14).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dealii_asm_tpu.fem import lagrange as jax_lagrange
from dealii_asm_tpu.fem.dofs import DofHandler as JaxDofHandler
from dealii_asm_tpu.mesh import grid as jax_grid
from dealii_asm_tpu.mesh.transforms import kershaw_transform as jax_kershaw
from dealii_asm_tpu.ops import lattice as jax_lattice
from dealii_asm_tpu.ops import tensorops as jax_tensorops
from dealii_asm_tpu.ops.geometry import compute_geometry as jax_geometry
from dealii_asm_tpu.ops.laplace import LaplaceOperator as JaxLaplace
from dealii_asm_tpu_torch.fem import lagrange
from dealii_asm_tpu_torch.fem.dofs import DofHandler
from dealii_asm_tpu_torch.mesh.grid import StructuredMesh
from dealii_asm_tpu_torch.mesh.transforms import kershaw_transform
from dealii_asm_tpu_torch.ops import lattice, tensorops
from dealii_asm_tpu_torch.ops.geometry import compute_geometry
from dealii_asm_tpu_torch.ops.laplace import LaplaceOperator

EPS = [(0.3, 0.3, False), (0.5, 0.2, True), (1.0, 1.0, False)]


def _meshes(cells, eps=0.3, mp=False):
    """(JAX mesh, port mesh) of the same Kershaw geometry."""
    return (jax_grid.StructuredMesh(3, cells,
                                    transform=jax_kershaw(eps, eps, mp)),
            StructuredMesh(3, cells, transform=kershaw_transform(eps, eps,
                                                                 mp)))


def _rel(a, b):
    b = np.asarray(b)
    return np.abs(np.asarray(a) - b).max() / np.abs(b).max()


@pytest.mark.parametrize("epsy,epsz,mp", EPS)
def test_kershaw_transform_matches_jax(epsy, epsz, mp):
    pts = np.random.default_rng(3).random((2000, 3))
    pts[:7] = [[0, 0, 0], [1, 1, 1], [1 / 6, 0.5, 0.5], [0.5, 0.25, 1],
               [5 / 6, 1, 0], [2 / 6, 0.5, 0.75], [1, 0, 0.5]]
    got = kershaw_transform(epsy, epsz, mp)(pts)
    ref = jax_kershaw(epsy, epsz, mp)(pts)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("cells,md", [((3, 4, 5), 3), ((2, 2, 3), 1)])
def test_mesh_geometry_queries_match_jax(cells, md):
    jm, m = _meshes(cells)
    np.testing.assert_array_equal(m.cell_multi_index(), jm.cell_multi_index())
    np.testing.assert_array_equal(m.neighbors(), jm.neighbors())
    np.testing.assert_array_equal(m.mapping_support_points(md),
                                  jm.mapping_support_points(md))
    q = lagrange.gauss_points(md + 1)[0]
    for a, b in zip(m.jacobian_factors(md, q), jm.jacobian_factors(md, q)):
        np.testing.assert_array_equal(a, b)
    for nq in (2, 5):
        assert _rel(m.harmonic_patch_extents(nq),
                    jm.harmonic_patch_extents(nq)) <= 1e-13
    assert m.max_aspect_ratio() == pytest.approx(jm.max_aspect_ratio(),
                                                 rel=1e-13)


def test_cartesian_mesh_queries_match_jax():
    jm = jax_grid.StructuredMesh(3, (2, 3, 4), lengths=(1.0, 2.0, 3.0))
    m = StructuredMesh(3, (2, 3, 4), lengths=(1.0, 2.0, 3.0))
    np.testing.assert_array_equal(m.harmonic_patch_extents(3),
                                  jm.harmonic_patch_extents(3))
    assert m.max_aspect_ratio() == jm.max_aspect_ratio()


@pytest.mark.parametrize("p", [1, 2, 4, 7])
def test_shape_1d_and_tensor_helpers_match_jax(p):
    s, js = lagrange.shape_1d(p), jax_lagrange.shape_1d(p)
    for name in ("nodes", "q", "w", "N", "D"):
        np.testing.assert_array_equal(getattr(s, name), getattr(js, name))
    pts = [np.arange(2.0), np.arange(3.0) + 0.5, np.arange(4.0) * 2]
    np.testing.assert_array_equal(lagrange.tensor_lattice_nd(pts),
                                  jax_grid._tensor_lattice_nd(pts))
    np.testing.assert_array_equal(lagrange.tensor_lattice(s.q, 3),
                                  jax_grid._tensor_lattice(s.q, 3))
    np.testing.assert_array_equal(lagrange.tensor_weights([s.w] * 3),
                                  jax_grid._tensor_weights([s.w] * 3))
    np.testing.assert_array_equal(lagrange.tensor_gradient(s.N, s.D, 3),
                                  jax_grid._tensor_gradient(s.N, s.D, 3))


@pytest.mark.parametrize("cells,p", [((2, 3, 4), 2), ((3, 2, 2), 4),
                                     ((4, 3, 2), 1)])
def test_element_windows_match_jax(cells, p):
    n = tuple(c * p + 1 for c in reversed(cells))
    u = np.random.default_rng(4).standard_normal(n)
    m = p + 1
    ref = np.asarray(jax_lattice.grid_to_cells_sliced(
        jnp.asarray(u), cells, p, m, 1, (False,) * 3))  # (L, C)
    got = lattice.grid_to_cells_sliced(torch.as_tensor(u), p)  # (C, L)
    np.testing.assert_array_equal(got.numpy(), ref.T)
    v = np.random.default_rng(5).standard_normal(ref.shape)
    ref = np.asarray(jax_lattice.cells_to_grid_sliced(
        jnp.asarray(v), n, cells, p, m, 1, (False,) * 3))
    got = lattice.cells_to_grid_sliced(torch.as_tensor(v.T.copy()), cells, p)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-14)


@pytest.mark.parametrize("cells,p,md", [((3, 4, 5), 4, 3), ((2, 3, 2), 1, 3),
                                        ((3, 3, 3), 2, 1)])
def test_geometry_coefficient_matches_jax(cells, p, md):
    jm, m = _meshes(cells)
    ref = jax_geometry(jm, p + 1, md)
    assert ref.kind == "merged"
    geo = compute_geometry(m, p + 1, md, torch.device("cpu"))
    assert geo.coeff.dtype == torch.float64
    assert _rel(geo.coeff.numpy(), ref.coeff) <= 1e-13
    assert _rel(geo.jxw.numpy(), ref.jxw) <= 1e-13


def test_geometry_rejects_inverted_cells():
    flip = lambda pts: pts * np.array([-1.0, 1.0, 1.0])
    mesh = StructuredMesh(3, (2, 2, 2), transform=flip)
    with pytest.raises(ValueError, match="non-positive"):
        compute_geometry(mesh, 3, 1, torch.device("cpu"))


@pytest.mark.parametrize("cells,p", [((3, 4, 2), 3), ((2, 2, 2), 4)])
def test_packed_coefficient_and_evaluation_matrices_match_jax(cells, p):
    jm, m = _meshes(cells)
    jop = JaxLaplace(JaxDofHandler(jm, p), mapping_degree=3,
                     dtype=jnp.float64)
    op = LaplaceOperator(DofHandler(m, p), mapping_degree=3, device="cpu")
    grids = tensorops.merged_coeff_qgrid(op.coeff6, tuple(reversed(cells)),
                                         p + 1)
    for mine, theirs in zip(grids, jop.coeff6):
        assert _rel(mine.numpy(), theirs) <= 1e-13
    for d in range(3):
        np.testing.assert_array_equal(op.tables.Ev[d].numpy(),
                                      np.asarray(jop.Ev[d]))
        np.testing.assert_array_equal(op.tables.Ed[d].numpy(),
                                      np.asarray(jop.Ed[d]))
    s = lagrange.shape_1d(p)
    for d in range(3):
        args = (s.D / m.h[d], op.dofs.nodes_per_dim[d], p, m.n_cells[d], False)
        np.testing.assert_array_equal(
            tensorops.interp_direction_transform(*args),
            jax_tensorops.interp_direction_transform(*args))
