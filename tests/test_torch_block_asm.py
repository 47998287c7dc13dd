"""The matrix-based preconditioners of the port against the JAX package:
the sparse assembly (``fem/assemble.py``), the Restrictor, the block
preconditioners (AdditiveSchwarz, SubMesh, CG; element, vertex and
vertex_all restrictions; the iso-Q1 approximations), the Thomas solve, the
subdomain preconditioner and their counts through ``run_config``.

Inputs come from seeded NumPy generators and go to both packages.
Tolerances (float64): assembled matrices entry by entry to 1e-12 of their
largest entry; block applies rel 1e-12; the Thomas solve rel 1e-12 against
``np.linalg.solve``; the FDM Schwarz comparison on a Cartesian mesh (where
the dense patch inverse is the separable FDM inverse) rel 1e-12; counts
equal.
"""

import copy

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dealii_asm_tpu.fem import assemble as jax_assemble
from dealii_asm_tpu.fem.dofs import DofHandler as JaxDofHandler
from dealii_asm_tpu.fem.general_dofs import GeneralDofHandler as JaxGeneral
from dealii_asm_tpu.mesh.grid import StructuredMesh as JaxMesh
from dealii_asm_tpu.mesh.transforms import kershaw_transform
from dealii_asm_tpu.mesh.unstructured import hyper_ball_balanced
from dealii_asm_tpu.models.poisson import run_config as jax_run_config
from dealii_asm_tpu.ops.laplace import LaplaceOperator as JaxLaplace
from dealii_asm_tpu.precond.block_asm import BlockTriDiagonal as JaxTri
from dealii_asm_tpu.precond.block_asm import Restrictor as JaxRestrictor
from dealii_asm_tpu.precond.block_asm import \
    create_block_preconditioner as jax_block
from dealii_asm_tpu.precond.domain import DomainPreconditioner as JaxDomain
from dealii_asm_tpu_torch import interop
from dealii_asm_tpu_torch.fem import assemble
from dealii_asm_tpu_torch.models.poisson import run_config
from dealii_asm_tpu_torch.ops.laplace import LaplaceOperator
from dealii_asm_tpu_torch.precond.asm import ASMPreconditioner
from dealii_asm_tpu_torch.precond.block_asm import (BlockDiagonal,
                                                    BlockTriDiagonal,
                                                    Restrictor,
                                                    create_block_preconditioner)
from dealii_asm_tpu_torch.precond.domain import DomainPreconditioner
from dealii_asm_tpu_torch.solvers.krylov import ReductionControl, cg


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
    return np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(
        np.asarray(b))


MESHES = {
    "cartesian-2d": (2, (4, 4), (2.0, 0.5), None),
    "cartesian-3d": (3, (2, 3, 2), None, None),
    "kershaw-2d": (2, (6, 6), None, kershaw_transform(0.3, 0.3)),
}


def _dofs(name, p):
    dim, cells, lengths, tf = MESHES[name]
    jd = JaxDofHandler(JaxMesh(dim, cells, lengths=lengths, transform=tf), p)
    return jd, interop.dofs_from_jax(jd)


def _vector(dofs, seed):
    x = np.random.default_rng(seed).standard_normal(dofs.n_dofs)
    return np.where(dofs.boundary_mask, 0.0, x)


@pytest.mark.parametrize("name", list(MESHES))
@pytest.mark.parametrize("p", [1, 3])
def test_assembly_matches_jax(name, p):
    jd, dofs = _dofs(name, p)
    np.testing.assert_array_equal(dofs.cell_dofs, np.asarray(jd.cell_dofs))
    for port, ref in ((assemble.assemble_laplace(dofs),
                       jax_assemble.assemble_laplace(jd)),
                      (assemble.assemble_laplace(dofs, constrained="raw"),
                       jax_assemble.assemble_laplace(jd, constrained="raw")),
                      (assemble.assemble_laplace_iso_q1(dofs, "equidistant"),
                       jax_assemble.assemble_laplace_iso_q1(
                           jd, "equidistant"))):
        a, b = port.toarray(), ref.toarray()
        assert np.abs(a - b).max() <= 1e-12 * np.abs(b).max()


@pytest.mark.parametrize("dim", [2, 3])
def test_general_assembly_matches_jax(dim):
    mesh = hyper_ball_balanced(dim)
    jd = JaxGeneral(mesh.refine() if dim == 2 else mesh, 2)
    a = assemble.assemble_laplace_general(
        interop.general_dofs_from_jax(jd)).toarray()
    b = jax_assemble.assemble_laplace_general(jd).toarray()
    assert np.abs(a - b).max() <= 1e-12 * np.abs(b).max()


@pytest.mark.parametrize("rtype,overlap", [("element", 1), ("element", 2),
                                           ("element", 4), ("vertex", 1),
                                           ("vertex_all", 1)])
def test_restrictor_matches_jax(rtype, overlap):
    jd, dofs = _dofs("cartesian-2d", 3)
    ref = JaxRestrictor(jd, overlap, "symm", rtype)
    got = Restrictor(dofs, overlap, "symm", rtype)
    np.testing.assert_array_equal(got.indices, np.asarray(ref.indices))
    np.testing.assert_array_equal(got.inv_multiplicity,
                                  np.asarray(ref.inv_multiplicity))


PARAMS = [
    {"type": "AdditiveSchwarzPreconditioner", "n overlap": 1},
    {"type": "AdditiveSchwarzPreconditioner", "n overlap": 2,
     "weighting type": "post"},
    {"type": "AdditiveSchwarzPreconditioner", "restriction type": "vertex",
     "weighting type": "none", "matrix approximation": "lobatto"},
    {"type": "AdditiveSchwarzPreconditioner",
     "restriction type": "vertex_all", "weighting type": "pre"},
    {"type": "SubMeshPreconditioner", "n overlap": 2},
    {"type": "CGPreconditioner", "n overlap": 1, "n iterations": 3,
     "matrix approximation": "equidistant"},
]


@pytest.mark.parametrize("name,k", [(n, k) for n in ("cartesian-2d",
                                                       "kershaw-2d")
                                    for k in range(len(PARAMS))]
                         + [("cartesian-3d", 0)])
def test_block_preconditioners_match_jax(name, k):
    """Each block preconditioner against the JAX one built from the same
    config (blocks extracted and inverted by each package), and the port's
    apply on the JAX package's blocks (``interop``)."""
    params = PARAMS[k]
    jd, dofs = _dofs(name, 3)
    jprec = jax_block(JaxLaplace(jd), dict(params))
    prec = create_block_preconditioner(LaplaceOperator(dofs, device="cpu"),
                                       dict(params))
    x = _vector(dofs, 10 + k)
    ref = np.asarray(jprec.vmult(jnp.asarray(x)))
    assert _rel(prec.vmult(torch.as_tensor(x)).numpy(), ref) < 1e-12
    carried = interop.block_preconditioner_from_jax(jprec, device="cpu")
    assert _rel(carried.vmult(torch.as_tensor(x)).numpy(), ref) < 1e-12


@pytest.mark.parametrize("overlap", [1, 2])
@pytest.mark.parametrize("weighting", ["none", "post", "symm"])
def test_block_asm_equals_fdm_asm_on_cartesian(overlap, weighting):
    """On a Cartesian mesh the separable FDM patch inverse is the dense
    patch block's inverse, so both Schwarz forms agree (the check of
    ``tests/test_block_asm.py:24``)."""
    jd, dofs = _dofs("cartesian-2d", 3)
    op = LaplaceOperator(dofs, device="cpu")
    blk = create_block_preconditioner(
        op, {"type": "AdditiveSchwarzPreconditioner", "n overlap": overlap,
             "weighting type": weighting})
    fdm = ASMPreconditioner(dofs, n_overlap=overlap, weighting_type=weighting,
                            device="cpu")
    x = torch.as_tensor(_vector(dofs, 0))
    assert _rel(blk.vmult(x).numpy(), fdm.vmult(x).numpy()) < 1e-12


def test_block_tridiagonal_thomas_and_diagonal():
    rng = np.random.default_rng(2)
    P, L = 5, 9
    blocks = np.zeros((P, L, L))
    for k in range(P):
        a = rng.uniform(0.5, 1.0, L - 1)
        blocks[k] = (np.diag(rng.uniform(3.0, 4.0, L)) - np.diag(a, -1)
                     - np.diag(a, 1))
    r = rng.standard_normal((P, L))
    got = BlockTriDiagonal(blocks, device="cpu").apply(torch.as_tensor(r))
    ref = np.stack([np.linalg.solve(blocks[k], r[k]) for k in range(P)])
    assert _rel(got.numpy(), ref) < 1e-12
    assert _rel(got.numpy(), np.asarray(JaxTri(blocks).apply(
        jnp.asarray(r)))) < 1e-12
    d = BlockDiagonal(blocks, device="cpu").apply(torch.as_tensor(r))
    assert _rel(d.numpy(), r / np.einsum("pii->pi", blocks)) < 1e-15


@pytest.mark.parametrize("name", ["cartesian-2d", "kershaw-2d"])
def test_domain_preconditioner_matches_jax(name):
    """Slab subdomains with 0, 1 and 2 halo layers against the JAX package
    (partition and apply); CG around it converges, and one subdomain
    without halo solves in at most two iterations."""
    jd, dofs = _dofs(name, 2)
    op = LaplaceOperator(dofs, device="cpu")
    b = op.assemble_rhs("constant")
    x = _vector(dofs, 5)
    for halo in (0, 1, 2):
        ref = JaxDomain(jd, n_subdomains=2, n_halo_layers=halo)
        dp = DomainPreconditioner(dofs, n_subdomains=2, n_halo_layers=halo)
        for (ids, _), rids in zip(dp.blocks,
                                  interop.domain_partition_from_jax(ref)):
            np.testing.assert_array_equal(ids, rids)
        assert _rel(dp.vmult(torch.as_tensor(x)).numpy(),
                    np.asarray(ref.vmult(jnp.asarray(x)))) < 1e-12
        res = cg(op.vmult, b, M=dp.vmult,
                 control=ReductionControl(200, 1e-12, 1e-8))
        assert res.converged
    dp1 = DomainPreconditioner(dofs, n_subdomains=1, n_halo_layers=0,
                               weighting_type="none")
    res = cg(op.vmult, b, M=dp1.vmult,
             control=ReductionControl(200, 1e-12, 1e-8))
    assert res.n_iterations <= 2


@pytest.mark.parametrize("ptype,expected", [
    ("AdditiveSchwarzPreconditioner", 10), ("SubMeshPreconditioner", 10),
    ("CGPreconditioner", 13)])
def test_block_run_config_counts_match_jax(ptype, expected):
    """GMRES around each block type through run_config (2D Q3, 4×4 cells,
    overlap 2, CG with 2 block iterations at overlap 1), the JAX package's
    count and solution."""
    params = {"dim": 2, "degree": 3, "n refinements": 2,
              "mesh": {"name": "hypercube"},
              "solver": {"type": "GMRES", "rel tolerance": 1e-8},
              "preconditioner": {"type": ptype, "weighting type": "symm",
                                 "n overlap": 1 if ptype[0] == "C" else 2,
                                 "n iterations": 2}}
    got = run_config(copy.deepcopy(params), log=_quiet, device="cpu")
    ref = jax_run_config(copy.deepcopy(params), log=_quiet)
    assert got["converged"] and got["it"] == ref["it"] == expected
    assert _rel(got["solution"].numpy(), np.asarray(ref["solution"])) < 1e-10
