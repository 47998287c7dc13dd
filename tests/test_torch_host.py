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
