"""Mixed-precision iterative refinement (``solvers/refinement.py``,
``"mixed precision solve"``) in the port against the JAX package.

Inputs come from seeded NumPy generators or the constant right-hand side
and go to both packages.  Checks: each refinement cycle contracts the true
float64 residual (below half the last, the check of
``tests/test_refinement.py``), the result reaches rel 1e-9 of the true
residual, and the port takes the JAX package's cycles, each cycle's
float32 inner count within one of its count (see the test);
``run_config`` takes refinement on exactly the JAX package's condition,
under which JSON true reads as the string "True" and never engages it.
"""

import copy

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dealii_asm_tpu.fem.dofs import DofHandler as JaxDofHandler
from dealii_asm_tpu.fem.functions import constant_rhs as jax_constant
from dealii_asm_tpu.mesh.grid import StructuredMesh as JaxMesh
from dealii_asm_tpu.ops.laplace import LaplaceOperator as JaxLaplace
from dealii_asm_tpu.precond.asm import ASMPreconditioner as JaxASM
from dealii_asm_tpu.solvers.chebyshev import \
    ChebyshevPreconditioner as JaxChebyshev
from dealii_asm_tpu.solvers.refinement import refined_solve as jax_refined
from dealii_asm_tpu_torch import interop
from dealii_asm_tpu_torch.models.poisson import _use_refinement, run_config
from dealii_asm_tpu_torch.ops.laplace import LaplaceOperator
from dealii_asm_tpu_torch.precond.asm import ASMPreconditioner
from dealii_asm_tpu_torch.solvers.chebyshev import ChebyshevPreconditioner
from dealii_asm_tpu_torch.solvers.refinement import refined_solve


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test process (see tests/test_torch_gmres.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _quiet(*_):
    pass


def test_refined_solve_contracts_and_matches_jax():
    """2D Q3 on 8×8 cells, a float32 Chebyshev-2 around FDM as the inner
    preconditioner (the problem of ``tests/test_refinement.py``)."""
    jd = JaxDofHandler(JaxMesh(2, (8, 8)), 3)
    dofs = interop.dofs_from_jax(jd)
    op64 = LaplaceOperator(dofs, device="cpu")
    op32 = LaplaceOperator(dofs, dtype=torch.float32, device="cpu")
    asm = ASMPreconditioner(dofs, weighting_type="symm",
                            dtype=torch.float32, device="cpu")
    cheb = ChebyshevPreconditioner(op32.vmult, asm.vmult, dofs.n_dofs,
                                   degree=2,
                                   constrained_mask=dofs.boundary_mask,
                                   device="cpu")
    b = op64.assemble_rhs("constant")
    res = refined_solve(op64.vmult, op32.vmult, b, cheb.vmult,
                        rel_tolerance=1e-9, max_outer=12)
    assert res.converged
    ratios = [b_ / a_ for a_, b_ in zip(res.residuals, res.residuals[1:])]
    assert max(ratios) < 0.5
    r = (op64.vmult(res.x) - b).numpy()
    assert np.linalg.norm(r) < 1e-9 * np.linalg.norm(b.numpy()) * 1.01

    j64 = JaxLaplace(jd, dtype=jnp.float64)
    j32 = JaxLaplace(jd, dtype=jnp.float32)
    jasm = JaxASM(jd, n_overlap=1, weighting_type="symm", dtype=jnp.float32)
    jcheb = JaxChebyshev(j32.vmult, jasm.vmult, jd.n_dofs, degree=2,
                         constrained_mask=jd.boundary_mask)
    jb = j64.assemble_rhs(jax_constant)
    ref = jax_refined(j64.vmult, j32.vmult, jb, jcheb.vmult,
                      rel_tolerance=1e-9, max_outer=12)
    # the same cycles; each cycle's float32 inner CG stops at the first
    # iteration under 3e-4 of its start, which moves by one with float32
    # rounding (the packages' float32 applies differ by about 1e-7; alone
    # the counts agree, 30 against 31 was seen beside other test files)
    assert res.outer_cycles == ref.outer_cycles
    assert abs(res.n_iterations - ref.n_iterations) <= res.outer_cycles
    h, hr = np.asarray(res.residuals), np.asarray(ref.residuals)
    assert h.shape == hr.shape and h[0] == pytest.approx(hr[0], rel=1e-14)
    assert max(hr[1:] / hr[:-1]) < 0.5


def _mg_params(solver, mp=True):
    return {"dim": 2, "degree": 3, "n refinements": 3,
            "mesh": {"name": "hypercube"}, "mixed precision solve": mp,
            "solver": {"type": solver, "rel tolerance": 1e-8},
            "preconditioner": {
                "type": "Multigrid", "mg type": "h",
                "mg smoother": {"type": "Chebyshev", "degree": 2,
                                "preconditioner": {"type": "FDM"}},
                "mg coarse grid solver": {"type": "AMG"}}}


@pytest.mark.parametrize("solver,expected", [("CG", 11), ("GMRES", 10)])
def test_run_config_json_true_is_the_plain_solve(solver, expected):
    """"mixed precision solve": true as the JAX run_config reads it: its
    ``get_param`` with the default "auto" turns JSON true into the string
    "True", so ``mp_solve is True`` never holds and the solve is the plain
    float64 Krylov one, with the JAX package's counts (11 and 10, its
    run_config on these parameters)."""
    logged = []
    got = run_config(_mg_params(solver), log=logged.append, device="cpu")
    assert got["converged"] and got["it"] == expected
    assert not any("mixed-precision refinement" in str(m) for m in logged)


@pytest.mark.parametrize("solver", ["CG", "GMRES"])
def test_run_config_refinement_path(monkeypatch, solver):
    """Where the condition holds (forced here: "auto" needs more than 2M
    DoFs at most 80 nodes a direction), run_config refines with the level
    operator and the float-level multigrid: it converges, logs the cycles,
    and its solution is the plain float64 solve's to rel 1e-6."""
    import dealii_asm_tpu_torch.models.poisson as poisson

    monkeypatch.setattr(poisson, "_use_refinement", lambda *a: True)
    logged = []
    got = run_config(_mg_params(solver), log=logged.append, device="cpu")
    assert got["converged"]
    assert any("refinement cycle 1" in str(m) for m in logged)
    monkeypatch.undo()
    plain = run_config(_mg_params(solver, mp=False), log=_quiet,
                       device="cpu")
    x, xp = got["solution"].numpy(), plain["solution"].numpy()
    assert np.linalg.norm(x - xp) <= 1e-6 * np.linalg.norm(xp)


@pytest.mark.parametrize("mp,solver,n_dofs,dim,mg,expected", [
    (True, "CG", 100, 2, True, False),           # JSON true reads "True"
    (True, "GMRES", 2_097_152, 4, True, False),
    ("auto", "CG", 100, 3, True, False),
    ("auto", "CG", 2_097_152, 3, True, False),   # 128 nodes a direction
    ("auto", "CG", 2_097_152, 2, True, False),
    ("auto", "CG", 2_097_152, 4, True, True),    # 38 nodes a direction
    ("auto", "GMRES", 2_097_152, 4, True, True),
    ("auto", "Bicgstab", 2_097_152, 4, True, False),
    ("auto", "CG", 2_097_152, 4, False, False),
])
def test_refinement_condition_is_the_jax_one(mp, solver, n_dofs, dim, mg,
                                             expected):
    """``dealii_asm_tpu/models/poisson.py:516-521`` as written: a
    float-level multigrid, CG or GMRES, and "mixed precision solve" (read
    with ``get_param`` and the default "auto") identical to True, or
    "auto" with more than 2M DoFs and at most 80 nodes a direction."""
    mg_inner = object() if mg else None
    assert _use_refinement({"mixed precision solve": mp}, mg_inner, solver,
                           n_dofs, dim) is expected
