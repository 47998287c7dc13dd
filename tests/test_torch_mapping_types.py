"""The compact "operator mapping type" forms of the outer operator
("linear geometry", "quadratic geometry", "construct q") against the JAX
package's LaplaceOperator with the same ``mapping_type``.

Both rebuild the Jacobians at every quadrature point from per-cell mapping
support points (or stored quadrature points) in each apply; the JAX package
runs these forms in XLA, the port in plain torch.  Inputs come from a seeded
numpy generator and go to both packages, on Kershaw-mp meshes (eps 0.3).

Tolerances (float64): vmult, residual, inverse diagonal and the rhs with its
Dirichlet lift rel 1e-12 (the same cell integrals summed in another order);
the harmonic patch extents through the isoparametric mapping rel 1e-14.
``inputs/mp_04.json`` (linear geometry, Chebyshev-5 around per-cell
overlap-2 RAS, GMRES) at 2 subdivisions and 0 refinements (3,375 DoFs):
the port's count equals the JAX package's ``run_config``, run live here
(6; about a minute of JAX compiles).
"""

import copy
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dealii_asm_tpu.fem.dofs import DofHandler as JaxDofHandler
from dealii_asm_tpu.fem.functions import make_rhs_and_dbc as jax_rhs_and_dbc
from dealii_asm_tpu.mesh.grid import StructuredMesh as JaxMesh
from dealii_asm_tpu.mesh.transforms import kershaw_transform as jax_kershaw
from dealii_asm_tpu.models.poisson import run_config as jax_run_config
from dealii_asm_tpu.ops.laplace import LaplaceOperator as JaxLaplace
from dealii_asm_tpu_torch.fem.dofs import DofHandler
from dealii_asm_tpu_torch.fem.functions import make_rhs_and_dbc
from dealii_asm_tpu_torch.mesh.grid import StructuredMesh
from dealii_asm_tpu_torch.mesh.transforms import kershaw_transform
from dealii_asm_tpu_torch.models.poisson import run_config
from dealii_asm_tpu_torch.ops.laplace import (COMPACT_MAPPING_TYPES,
                                              LaplaceOperator)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TYPES = list(COMPACT_MAPPING_TYPES)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test process (see tests/test_torch_gmres.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _quiet(*_):
    pass


def _rel(a, b):
    b = np.asarray(b)
    return np.abs(np.asarray(a) - b).max() / np.abs(b).max()


def _dofs(cells, p):
    return (JaxDofHandler(JaxMesh(3, cells, transform=jax_kershaw(
                0.3, 0.3, shift_mp=True)), p),
            DofHandler(StructuredMesh(3, cells, transform=kershaw_transform(
                0.3, 0.3, shift_mp=True)), p))


def _ops(cells, p, mapping_type, mapping_degree=None):
    jdofs, dofs = _dofs(cells, p)
    jop = JaxLaplace(jdofs, dtype=jnp.float64, mapping_type=mapping_type,
                     mapping_degree=mapping_degree)
    op = LaplaceOperator(dofs, device="cpu", mapping_type=mapping_type,
                         mapping_degree=mapping_degree)
    return jop, op, dofs


CASES = [((2, 2, 2), 1), ((2, 2, 2), 3), ((4, 2, 2), 2), ((2, 2, 2), 7)]


@pytest.mark.parametrize("mapping_type", TYPES)
@pytest.mark.parametrize("cells,p", CASES)
def test_vmult_and_residual_match_jax(cells, p, mapping_type):
    jop, op, dofs = _ops(cells, p, mapping_type)
    assert op.compact == COMPACT_MAPPING_TYPES[mapping_type]
    assert op.mapping_degree == jop.mapping_degree
    rng = np.random.default_rng(10 * p + len(mapping_type))
    x, b = rng.standard_normal(dofs.n_dofs), rng.standard_normal(dofs.n_dofs)
    ref = np.asarray(jop.vmult(jnp.asarray(x)))
    got = op.vmult(torch.as_tensor(x))
    assert _rel(got.numpy(), ref) < 1e-12
    np.testing.assert_array_equal(got.numpy()[dofs.boundary_mask],
                                  x[dofs.boundary_mask])
    res = op.residual(torch.as_tensor(b), torch.as_tensor(x))
    assert _rel(res.numpy(), np.asarray(jop.residual(jnp.asarray(b),
                                                     jnp.asarray(x)))) < 1e-12


@pytest.mark.parametrize("mapping_type", TYPES)
@pytest.mark.parametrize("cells,p", CASES[1:3])
def test_inverse_diagonal_matches_jax(cells, p, mapping_type):
    jop, op, dofs = _ops(cells, p, mapping_type)
    ref = np.asarray(jop.compute_inverse_diagonal())
    got = op.compute_inverse_diagonal()
    assert got.dtype == torch.float64
    assert _rel(got.numpy(), ref) < 1e-12


@pytest.mark.parametrize("mapping_type", TYPES)
@pytest.mark.parametrize("name", ["sin-mp", "gaussian"])
def test_rhs_and_lift_match_jax(name, mapping_type):
    """The JAX rhs with its constrained entries set to 0 (the homogeneous
    system); "gaussian" has non-zero Dirichlet data, so the lift runs
    through the compact cell integrals."""
    jop, op, dofs = _ops((2, 2, 2), 3, mapping_type)
    ref = np.array(jop.assemble_rhs(*jax_rhs_and_dbc(name, 3)))
    ref[dofs.boundary_mask] = 0.0
    f, g = make_rhs_and_dbc(name, 3)
    assert _rel(op.assemble_rhs(f, dirichlet=g).numpy(), ref) < 1e-12


def test_construct_q_takes_the_mapping_degree():
    """construct q maps with the operator's mapping degree (capped at p for
    the stored points); linear and quadratic with 1 and 2."""
    for md in (1, 2, 3):
        jop, op, dofs = _ops((2, 2, 2), 2, "construct q", mapping_degree=md)
        assert op.mapping_degree == jop.mapping_degree == md
        x = np.random.default_rng(md).standard_normal(dofs.n_dofs)
        assert _rel(op.vmult(torch.as_tensor(x)).numpy(),
                    jop.vmult(jnp.asarray(x))) < 1e-12


@pytest.mark.parametrize("mapping_degree", [None, 1, 2, 3])
def test_harmonic_extents_through_the_mapping_match_jax(mapping_degree):
    """The FDM patch extents from face points through the analytic
    transform (None) or the isoparametric Q_m mapping: rel 1e-14."""
    jdofs, dofs = _dofs((3, 2, 4), 2)
    ref = jdofs.mesh.harmonic_patch_extents(3, mapping_degree)
    got = dofs.mesh.harmonic_patch_extents(3, mapping_degree)
    assert _rel(got, ref) < 1e-14
    if mapping_degree == 1:  # a degree-1 mapping differs from the transform
        assert _rel(dofs.mesh.harmonic_patch_extents(3), got) > 1e-6


def test_cartesian_mesh_ignores_the_mapping_type():
    dofs = DofHandler(StructuredMesh(3, (2, 2, 2)), 2)
    op = LaplaceOperator(dofs, device="cpu", mapping_type="linear geometry")
    assert op.compact is None and not op.deformed


def _mp(name):
    with open(os.path.join(ROOT, "inputs", f"{name}.json")) as f:
        p = json.load(f)
    p["n refinements"] = 0
    p["mesh"]["n subdivisions"] = 2
    p["print timing"] = False
    p["solver"]["best of"] = 1
    return p


def test_mp_04_count_matches_jax():
    params = _mp("mp_04")
    got = run_config(copy.deepcopy(params), log=_quiet, device="cpu")
    assert got["n_dofs"] == 3375
    assert got["converged"] and got["it"] == 6
    ref = jax_run_config(copy.deepcopy(params), log=_quiet)
    assert ref["it"] == got["it"]
    # only the outer operator takes the compact form
    assert got["preconditioner"].inner.operators[-1].compact is None
