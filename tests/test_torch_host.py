"""The port's own NumPy host layer (1D elements, DoF lattice, mesh, FDM 1D
setup functions, config helpers, convergence table) against the JAX package's,
entry by entry: the same arithmetic gives the same numbers."""

import numpy as np
import pytest

from dealii_asm_tpu.fem import lagrange as jax_lagrange
from dealii_asm_tpu.fem.dofs import DofHandler as JaxDofHandler
from dealii_asm_tpu.mesh.grid import StructuredMesh as JaxMesh
from dealii_asm_tpu.precond import fdm as jax_fdm
from dealii_asm_tpu.utils.config import get_param as jax_get_param
from dealii_asm_tpu.utils.table import ConvergenceTable as JaxTable
from dealii_asm_tpu_torch.fem import lagrange
from dealii_asm_tpu_torch.fem.dofs import DofHandler
from dealii_asm_tpu_torch.mesh.grid import StructuredMesh
from dealii_asm_tpu_torch.precond import fdm
from dealii_asm_tpu_torch.utils.config import get_param
from dealii_asm_tpu_torch.utils.table import ConvergenceTable


@pytest.mark.parametrize("p", range(1, 8))
def test_reference_mass_stiffness_match_jax(p):
    M, K = lagrange.reference_mass_stiffness_1d(p)
    jM, jK = jax_lagrange.reference_mass_stiffness_1d(p)
    np.testing.assert_array_equal(M, jM)
    np.testing.assert_array_equal(K, jK)
    nodes = lagrange.gauss_lobatto_points(p + 1)
    np.testing.assert_array_equal(nodes, jax_lagrange.gauss_lobatto_points(p + 1))


@pytest.mark.parametrize("cells,p,lengths", [((2, 3, 4), 2, (1.0, 1.0, 1.0)),
                                             ((4, 4, 4), 4, (1.0, 1.0, 50.0))])
def test_dofs_and_mesh_match_jax(cells, p, lengths):
    d = DofHandler(StructuredMesh(3, cells, lengths), p)
    jd = JaxDofHandler(JaxMesh(3, cells, lengths), p)
    assert d.nodes_per_dim == jd.nodes_per_dim and d.n_dofs == jd.n_dofs
    np.testing.assert_array_equal(d.boundary_mask, jd.boundary_mask)
    np.testing.assert_array_equal(d.mesh.h, jd.mesh.h)
    assert d.mesh.n_cells_total == jd.mesh.n_cells_total
    assert d.mesh.max_aspect_ratio() == jd.mesh.max_aspect_ratio()


@pytest.mark.parametrize("p,ov", [(2, 1), (4, 1), (3, 2)])
def test_fdm_1d_matrices_match_jax(p, ov):
    h = 0.25
    for left, right in ((True, True), (False, True), (True, False)):
        ext = (h if left else 0.0, h, h if right else 0.0)
        bc = lambda has: "internal" if has else "dirichlet"
        M, K = fdm.fdm_1d_matrices(p, ov, ext, bc(left), bc(right))
        jM, jK = jax_fdm.fdm_1d_matrices(p, ov, ext, bc(left), bc(right))
        np.testing.assert_array_equal(M, jM)
        np.testing.assert_array_equal(K, jK)
        Mb, Kb = fdm.fdm_1d_matrices_batched(p, ov, np.array([ext]),
                                             np.array([left]),
                                             np.array([right]))
        np.testing.assert_allclose(Mb[0], M, rtol=0, atol=1e-15)
        np.testing.assert_allclose(Kb[0], K, rtol=0, atol=1e-12)
    mats = [[fdm.fdm_1d_matrices(p, ov, (0.0 if c == 0 else h, h, h))
             for c in range(3)]] * 3
    coll = fdm.build_fdm_collection(mats)
    jcoll = jax_fdm.build_fdm_collection(mats)
    np.testing.assert_array_equal(coll.ids, jcoll.ids)
    for d in range(3):
        np.testing.assert_array_equal(coll.eigvals[d], jcoll.eigvals[d])
        np.testing.assert_array_equal(coll.eigvecs[d], jcoll.eigvecs[d])


def test_config_and_table_match_jax():
    params = {"a": "3", "b": "true", "c": 2.5}
    for key, default in (("a", 1), ("b", False), ("c", 1.0), ("d", "x")):
        assert get_param(params, key, default) == jax_get_param(params, key,
                                                                default)
    t, jt = ConvergenceTable(), JaxTable()
    for tab in (t, jt):
        tab.add_value("name", "run")
        tab.add_value("it", 5)
        tab.add_value("time", 0.0663)
        tab.end_row()
    assert t.to_string() == jt.to_string()


@pytest.mark.parametrize("n,n_dev,band,periodic", [
    (12, 2, 2, False), (20, 4, 4, False), (16, 4, 3, True), (9, 1, 4, False)])
def test_halo_host_helpers_match_jax(n, n_dev, band, periodic):
    """The NumPy host part of parallel/halo.py (``halo.py:36-131``):
    halo widths, banded blocks, padding and the grouped row layout."""
    from dealii_asm_tpu.parallel import halo as jax_halo
    from dealii_asm_tpu_torch.parallel import halo

    rng = np.random.default_rng(n + band)
    i, j = np.indices((n, n))
    dist = np.abs(i - j)
    if periodic:
        dist = np.minimum(dist, n - dist)
    A = np.where(dist <= band, rng.standard_normal((n, n)), 0.0)
    n_pad = -(-n // n_dev) * n_dev
    Ap = halo.pad_to(A, n_pad, n_pad)
    np.testing.assert_array_equal(Ap, jax_halo.pad_to(A, n_pad, n_pad))
    assert halo.min_halo_width(Ap, n_dev) == jax_halo.min_halo_width(
        Ap, n_dev)
    st, hw = halo.banded_stack(Ap, n_dev)
    jst, jhw = jax_halo.banded_stack(Ap, n_dev)
    assert hw == jhw and hw >= (band if n_dev > 1 else 0)
    np.testing.assert_array_equal(st, jst)
    # grouped rows: groups of 3 rows anchored every 2 nodes
    n_groups, gs = n_pad // 2, 3
    anchors = np.arange(n_groups) * 2
    owner = halo.group_owners(anchors, n_pad // n_dev, n_dev)
    np.testing.assert_array_equal(owner, jax_halo.group_owners(
        anchors, n_pad // n_dev, n_dev))
    pos, g_max = halo.grouped_row_layout(n_groups, owner, n_dev)
    jpos, jg_max = jax_halo.grouped_row_layout(n_groups, owner, n_dev)
    np.testing.assert_array_equal(pos, jpos)
    assert g_max == jg_max
    R = rng.standard_normal((n_groups * gs, n_pad))
    np.testing.assert_array_equal(
        halo.place_grouped_rows(R, gs, pos, g_max, n_dev),
        jax_halo.place_grouped_rows(R, gs, pos, g_max, n_dev))
    v = R[:, 0]
    np.testing.assert_array_equal(
        halo.place_grouped_vec(v, gs, pos, g_max, n_dev, fill=1.0),
        jax_halo.place_grouped_vec(v, gs, pos, g_max, n_dev, fill=1.0))
