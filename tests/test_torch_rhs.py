"""Right-hand sides, Dirichlet lifts and the gaussian-jw study configs
(``inputs/jw_*.json``) in the port against the JAX package.

The port solves deal.II's homogeneous system: b = ∫ f φ − A g on the free
rows, 0 on the constrained ones, and g added to the solution after the
solve.  The JAX package writes g into the constrained rows of b, which its
FDM Schwarz smoothers never reduce: its ``run_config`` does not converge on
the gaussian-jw configs (ROADMAP queue 3).  So the JAX side here is its own
``assemble_rhs`` with the constrained entries set to 0, and its
``run_config`` composed on that homogeneous system (``assemble_rhs``
replaced for the test by a wrapper that zeroes them; nothing changes on
disk).

Tolerances:
- rhs vectors with their lifts, float64, on Cartesian, symmetric-hypercube,
  Kershaw-mp and ball meshes: rel 1e-12 (the same quadrature sums and cell
  integrals in another order);
- the Dirichlet data at the constrained nodes: rel 1e-15 (the same NumPy
  function at the same points);
- counts: equal to the JAX package's on the homogeneous system (jw_01 8 at
  2 refinements; jw_02 8 and 8 at 1 and 2; jw_03 8 at 1);
- the jw_02 solution at 1 refinement with g, both solves run to rel 1e-12:
  rel-l2 1e-6 of the JAX package's Diagonal-preconditioned solve of the
  original system, which converges (the two discrete solutions are the
  same; the tolerance covers the solves' residual).
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
from dealii_asm_tpu.fem.general_dofs import GeneralDofHandler as JaxGeneralDofs
from dealii_asm_tpu.mesh.grid import StructuredMesh as JaxMesh
from dealii_asm_tpu.mesh.transforms import kershaw_transform as jax_kershaw
from dealii_asm_tpu.mesh.unstructured import hyper_ball_balanced as jax_ball
from dealii_asm_tpu.models.poisson import run_config as jax_run_config
from dealii_asm_tpu.ops.laplace import LaplaceOperator as JaxLaplace
from dealii_asm_tpu.ops.laplace_general import \
    GeneralLaplaceOperator as JaxGeneral
from dealii_asm_tpu_torch.fem import functions
from dealii_asm_tpu_torch.fem.dofs import DofHandler
from dealii_asm_tpu_torch.fem.general_dofs import GeneralDofHandler
from dealii_asm_tpu_torch.mesh.grid import StructuredMesh
from dealii_asm_tpu_torch.mesh.transforms import kershaw_transform
from dealii_asm_tpu_torch.mesh.unstructured import hyper_ball_balanced
from dealii_asm_tpu_torch.models.poisson import run_config
from dealii_asm_tpu_torch.ops.laplace import LaplaceOperator
from dealii_asm_tpu_torch.ops.laplace_general import GeneralLaplaceOperator

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RHS = ["constant", "gaussian", "gaussian-jw", "sin-mp"]


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


def _homogeneous(ref, mask):
    """(JAX b with its constrained entries 0, g at the constrained nodes)."""
    b = np.array(ref)
    g = b[mask].copy()
    b[mask] = 0.0
    return b, g


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("name", RHS)
def test_functions_match_jax(name, dim):
    pts = np.random.default_rng(dim).uniform(-1.0, 1.0, (50, dim))
    for a, b in zip(functions.make_rhs_and_dbc(name, dim),
                    jax_rhs_and_dbc(name, dim)):
        np.testing.assert_array_equal(a(pts), b(pts))
    with pytest.raises(ValueError, match="unknown rhs"):
        functions.make_rhs_and_dbc("cosine", dim)


MESHES = {
    "hypercube": dict(),
    "symmetric hypercube": dict(lengths=(2.0,) * 3, origin=(-1.0,) * 3),
    "kershaw-mp": dict(transform="mp"),
}


def _structured(kind, cells, p):
    kw = dict(MESHES[kind])
    tf = kw.pop("transform", None)
    jt = pt = None
    if tf:
        jt = jax_kershaw(0.3, 0.3, shift_mp=True)
        pt = kershaw_transform(0.3, 0.3, shift_mp=True)
    return (JaxDofHandler(JaxMesh(3, cells, transform=jt, **kw), p),
            DofHandler(StructuredMesh(3, cells, transform=pt, **kw), p))


@pytest.mark.parametrize("name", RHS)
@pytest.mark.parametrize("kind,cells,p", [
    ("hypercube", (2, 3, 2), 3),
    ("symmetric hypercube", (3, 3, 3), 2),
    ("symmetric hypercube", (2, 2, 2), 7),
    ("kershaw-mp", (2, 2, 2), 3),
    ("kershaw-mp", (4, 4, 4), 2),
])
def test_structured_rhs_and_lift_match_jax(kind, cells, p, name):
    jdofs, dofs = _structured(kind, cells, p)
    f, g = jax_rhs_and_dbc(name, 3)
    jop = JaxLaplace(jdofs, dtype=jnp.float64, kernel="banded")
    ref, g_ref = _homogeneous(jop.assemble_rhs(f, dirichlet=g),
                              dofs.boundary_mask)
    op = LaplaceOperator(dofs, device="cpu")
    pf, pg = functions.make_rhs_and_dbc(name, 3)
    got = op.assemble_rhs(pf, dirichlet=pg)
    assert got.dtype == torch.float64
    assert _rel(got.numpy(), ref) < 1e-12
    gv = op.dirichlet_vector(pg)
    if name.startswith("gaussian"):
        np.testing.assert_allclose(gv.numpy()[dofs.boundary_mask], g_ref,
                                   rtol=1e-15, atol=0)
    else:
        assert gv is None and not g_ref.any()
    # a name resolves to the same function
    assert torch.equal(op.assemble_rhs(name, dirichlet=pg), got)


def test_node_points_match_jax():
    jdofs, dofs = _structured("kershaw-mp", (2, 2, 2), 3)
    ids = np.arange(dofs.n_dofs)[::7]
    np.testing.assert_array_equal(dofs.node_points(ids),
                                  np.asarray(jdofs.points)[ids])
    jdofs, dofs = _structured("symmetric hypercube", (2, 3, 2), 4)
    np.testing.assert_array_equal(dofs.node_points(ids),
                                  np.asarray(jdofs.points)[ids])


@pytest.fixture(scope="module")
def ball():
    return hyper_ball_balanced(3), jax_ball(3)


@pytest.mark.parametrize("name", RHS)
@pytest.mark.parametrize("p", [1, 3])
def test_ball_rhs_and_lift_match_jax(ball, p, name):
    m, j = ball
    jop = JaxGeneral(JaxGeneralDofs(j, p), dtype=jnp.float64, kernel="sumfac")
    dofs = GeneralDofHandler(m, p)
    f, g = jax_rhs_and_dbc(name, 3)
    ref, _ = _homogeneous(jop.assemble_rhs(f, dirichlet=g), dofs.boundary_mask)
    op = GeneralLaplaceOperator(dofs, device="cpu")
    pf, pg = functions.make_rhs_and_dbc(name, 3)
    got = op.assemble_rhs(pf, dirichlet=pg)
    assert got.dtype == torch.float64
    assert _rel(got.numpy(), ref) < 1e-12
    assert not got.numpy()[dofs.boundary_mask].any()


def test_homogeneous_dirichlet_data_needs_no_points(ball):
    """The zero Dirichlet data skips the support points (on the ball a
    mapping of every cell); other data that vanishes gives no vector."""
    dofs = GeneralDofHandler(ball[0], 4)
    assert functions.dirichlet_values(dofs, functions.zero) is None
    assert "points" not in vars(dofs)
    sdofs = DofHandler(StructuredMesh(3, (2, 2, 2)), 2)
    assert functions.dirichlet_values(
        sdofs, lambda p: np.zeros(p.shape[0])) is None


def _jw(name, r):
    with open(os.path.join(ROOT, "inputs", f"{name}.json")) as f:
        p = json.load(f)
    p["n refinements"] = r
    p["print timing"] = False
    p["solver"]["best of"] = 1
    return p


def _jax_homogeneous_run(params, monkeypatch):
    orig = JaxLaplace.assemble_rhs

    def homogeneous(self, f, dirichlet=None):
        b = np.array(orig(self, f, dirichlet))
        b[np.asarray(self.dofs.boundary_mask)] = 0.0
        return jnp.asarray(b, self.dtype)

    with monkeypatch.context() as mp:
        mp.setattr(JaxLaplace, "assemble_rhs", homogeneous)
        return jax_run_config(copy.deepcopy(params), log=_quiet)


@pytest.mark.parametrize("name,r,it", [("jw_01", 2, 8), ("jw_02", 1, 8),
                                       ("jw_02", 2, 8), ("jw_03", 1, 8)])
def test_jw_counts_match_jax_on_the_homogeneous_system(name, r, it,
                                                       monkeypatch):
    params = _jw(name, r)
    ref = _jax_homogeneous_run(params, monkeypatch)
    got = run_config(copy.deepcopy(params), log=_quiet, device="cpu")
    assert got["n_dofs"] == ref["n_dofs"]
    assert got["converged"] and got["it"] == ref["it"] == it


def test_jw_solution_matches_jax_diagonal_solve():
    params = _jw("jw_02", 1)
    params["solver"]["rel tolerance"] = 1e-12
    got = run_config(copy.deepcopy(params), log=_quiet, device="cpu")
    params["preconditioner"] = {"type": "Diagonal"}
    ref = jax_run_config(copy.deepcopy(params), log=_quiet)
    assert got["converged"] and ref["converged"]
    x, y = got["solution"].numpy(), np.asarray(ref["solution"])
    assert np.linalg.norm(x - y) / np.linalg.norm(y) < 1e-6
    # the constrained entries carry g exactly
    dofs = DofHandler(StructuredMesh(3, (2, 2, 2), lengths=(2.0,) * 3,
                                     origin=(-1.0,) * 3), 4)
    ids = np.flatnonzero(dofs.boundary_mask)
    g = functions.make_rhs_and_dbc("gaussian-jw", 3)[1]
    np.testing.assert_array_equal(x[ids], g(dofs.node_points(ids)))
