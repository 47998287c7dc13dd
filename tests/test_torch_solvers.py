"""Port's CG and Chebyshev smoother (dealii_asm_tpu_torch.solvers) vs the
JAX package, on the same inputs.

Tolerances:
- CG on a small dense SPD system: identical iteration counts, solutions to
  rel 1e-10 and Lanczos eigenvalues to rel 1e-9 (the same float64 recurrences;
  only the dot-product summation order differs);
- Chebyshev eigenvalue estimates from the same i%11 start vector on a float64
  level: rel 1e-12 (observed ~1e-15); on a float32 level: rel 1e-6
  (observed ~2e-8).  There the JAX package applies its float32 tables to
  float64 vectors (jnp promotes), while the port casts the vectors to
  float32 for its kernels, so the Lanczos coefficients differ at float32
  rounding;
- Chebyshev smoother applies with the same eigenvalue data: rel 1e-12;
- the sweep coefficient rows and Relaxation's ω from the same estimates:
  rel 1e-15 (the same float64 recurrences);
- ``cg_traceable`` on a small dense SPD system: rel 1e-10 (the same
  float64 recurrence; only the dot-product summation order differs).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dealii_asm_tpu.fem.dofs import DofHandler as JaxDofHandler
from dealii_asm_tpu.mesh.grid import StructuredMesh as JaxMesh
from dealii_asm_tpu.ops.laplace import LaplaceOperator as JaxLaplace
from dealii_asm_tpu.precond.asm import ASMPreconditioner as JaxASM
from dealii_asm_tpu.solvers import chebyshev as jcheb
from dealii_asm_tpu.solvers import krylov as jkrylov
from dealii_asm_tpu_torch.fem.dofs import DofHandler
from dealii_asm_tpu_torch.mesh.grid import StructuredMesh
from dealii_asm_tpu_torch.ops.laplace import LaplaceOperator
from dealii_asm_tpu_torch.precond.asm import ASMPreconditioner
from dealii_asm_tpu_torch.solvers import chebyshev, krylov


def _dofs(cells, p):
    """(JAX DofHandler, port DofHandler) of the same lattice."""
    return (JaxDofHandler(JaxMesh(3, cells), p),
            DofHandler(StructuredMesh(3, cells), p))


def _spd(n=60, seed=0):
    rng = np.random.default_rng(seed)
    Q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    A = (Q * np.linspace(0.5, 50.0, n)) @ Q.T
    return A, rng.standard_normal(n)


@pytest.mark.parametrize("reduce", [1e-2, 1e-6, 1e-10])
def test_cg_iterations_match_jax(reduce):
    A, b = _spd()
    d = 1.0 / np.diag(A)
    ref = jkrylov.cg(lambda x: jnp.asarray(A) @ x, jnp.asarray(b),
                     M=lambda x: jnp.asarray(d) * x,
                     control=jkrylov.ReductionControl(500, 1e-14, reduce),
                     device_loop=False)
    At, dt = torch.as_tensor(A), torch.as_tensor(d)
    got = krylov.cg(lambda x: At @ x, torch.as_tensor(b), M=lambda x: dt * x,
                    control=krylov.ReductionControl(500, 1e-14, reduce))
    assert got.converged and ref.converged
    assert got.n_iterations == ref.n_iterations
    x_ref = np.asarray(ref.x)
    assert np.linalg.norm(got.x.numpy() - x_ref) / np.linalg.norm(x_ref) < 1e-10


def test_cg_lanczos_eigenvalues_match_jax():
    A, b = _spd(40, 1)
    ctl = lambda m: m.IterationNumberControl(25, 1e-14)
    ref = jkrylov.cg(lambda x: jnp.asarray(A) @ x, jnp.asarray(b),
                     control=ctl(jkrylov), track_eigenvalues=True)
    At = torch.as_tensor(A)
    got = krylov.cg(lambda x: At @ x, torch.as_tensor(b), control=ctl(krylov),
                    track_eigenvalues=True)
    assert got.n_iterations == ref.n_iterations
    np.testing.assert_allclose(got.tridiag_eigenvalues,
                               ref.tridiag_eigenvalues, rtol=1e-9)
    lam = np.linalg.eigvalsh(A)
    assert abs(got.tridiag_eigenvalues[-1] / lam[-1] - 1) < 1e-6


@pytest.mark.parametrize("step,value,state", [
    (0, 1.0, "iterate"), (0, 1e-11, "success"), (3, 0.009, "success"),
    (3, 0.01, "iterate"), (5, 0.5, "failure")])
def test_reduction_control_semantics(step, value, state):
    for mod in (krylov, jkrylov):
        c = mod.ReductionControl(max_steps=5, tolerance=1e-10, reduce=1e-2)
        if step > 0:
            c.check(0, 1.0)
        assert c.check(step, value) == state


def test_solve_dispatch_cg_only():
    """Every solver of the reference program dispatches (each against the
    JAX package in ``test_torch_krylov_breadth.py``, GMRES also in
    ``test_torch_gmres.py``) and solves a small SPD system; an unknown
    name raises."""
    A, b = _spd(10, 2)
    At = torch.as_tensor(A)
    for name in ("CG", "FCG", "GMRES", "FGMRES", "Bicgstab", "IDR"):
        r = krylov.solve(name, lambda x: At @ x, torch.as_tensor(b),
                         rel_tolerance=1e-8)
        assert r.converged and r.n_iterations <= 20, name  # IDR: 14
        assert np.linalg.norm(r.x.numpy() - np.linalg.solve(A, b)) < 1e-6
    with pytest.raises(ValueError, match="not known"):
        krylov.solve("Jacobi", lambda x: At @ x, torch.as_tensor(b))


def test_eig_initial_guess_matches_jax():
    jdofs, dofs = _dofs((2, 3, 2), 2)
    ref = np.asarray(jcheb.eig_initial_guess(jdofs.n_dofs, jdofs.boundary_mask))
    got = chebyshev.eig_initial_guess(dofs.n_dofs, dofs.boundary_mask,
                                      device="cpu")
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("dtype,tol", [("float64", 1e-12), ("float32", 1e-6)])
@pytest.mark.parametrize("wt", ["symm", "post"])
def test_eigenvalue_estimates_match_jax(dtype, tol, wt):
    jdofs, dofs = _dofs((4, 4, 4), 4)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jop, jasm = (JaxLaplace(jdofs, dtype=jdt),
                 JaxASM(jdofs, n_overlap=1, weighting_type=wt, dtype=jdt))
    if dtype == "float64":  # the exact banded float64 path (see laplace tests)
        jop = JaxLaplace(jdofs, dtype=jdt, kernel="banded")
    op = LaplaceOperator(dofs, dtype=tdt, device="cpu")
    asm = ASMPreconditioner(dofs, weighting_type=wt, dtype=tdt, device="cpu")
    algo = "lanczos" if wt == "symm" else "power iteration"
    ref = jcheb.ChebyshevPreconditioner(
        jop.vmult, jasm.vmult, jdofs.n_dofs, degree=1,
        constrained_mask=jdofs.boundary_mask, ev_algorithm=algo)
    got = chebyshev.ChebyshevPreconditioner(
        op.vmult, asm.vmult, dofs.n_dofs, degree=1,
        constrained_mask=dofs.boundary_mask, ev_algorithm=algo, device="cpu")
    for attr in ("min_eigenvalue_estimate", "max_eigenvalue_estimate"):
        a = getattr(got.eigenvalues, attr)
        b = getattr(ref.eigenvalues, attr)
        assert abs(a / b - 1) < tol, (attr, a, b)
    assert abs(got.theta / ref.theta - 1) < tol


@pytest.mark.parametrize("kind,degree", [("1st kind", 1), ("1st kind", 3),
                                         ("4th kind", 2)])
def test_chebyshev_apply_matches_jax(kind, degree):
    jdofs, dofs = _dofs((3, 2, 3), 3)
    jop = JaxLaplace(jdofs, dtype=jnp.float64, kernel="banded")
    jasm = JaxASM(jdofs, n_overlap=1, weighting_type="symm", dtype=jnp.float64)
    op = LaplaceOperator(dofs, device="cpu")
    asm = ASMPreconditioner(dofs, weighting_type="symm", device="cpu")
    ev = jcheb.EigenvalueInfo(1.6, 1.92, 40)
    ref = jcheb.ChebyshevPreconditioner(jop.vmult, jasm.vmult, dofs.n_dofs,
                                        degree=degree, polynomial_type=kind,
                                        eigenvalues=ev)
    got = chebyshev.ChebyshevPreconditioner(
        op.vmult, asm.vmult, dofs.n_dofs, degree=degree, polynomial_type=kind,
        eigenvalues=chebyshev.EigenvalueInfo(1.6, 1.92, 40), device="cpu")
    rng = np.random.default_rng(8)
    b = rng.standard_normal(dofs.n_dofs)
    x = rng.standard_normal(dofs.n_dofs)
    for mine, theirs in ((got.vmult(torch.as_tensor(b)),
                          ref.vmult(jnp.asarray(b))),
                         (got.step(torch.as_tensor(x), torch.as_tensor(b)),
                          ref.step(jnp.asarray(x), jnp.asarray(b)))):
        t = np.asarray(theirs)
        assert np.abs(mine.numpy() - t).max() / np.abs(t).max() < 1e-12


@pytest.mark.parametrize("degree", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("kind", ["1st kind", "4th kind"])
def test_sweep_coefficients_match_jax(kind, degree):
    ref = jcheb.chebyshev_sweep_coefficients(degree, 1.008, 0.912, kind,
                                             lam_max=1.92)
    got = chebyshev.chebyshev_sweep_coefficients(degree, 1.008, 0.912, kind,
                                                 lam_max=1.92)
    assert len(got) == len(ref) == degree
    np.testing.assert_allclose(got, ref, rtol=1e-15, atol=0)


@pytest.mark.parametrize("smoothing_range", [20.0, 0.5])
def test_relaxation_omega_matches_jax(smoothing_range):
    ev = (1.6, 1.92, 40)
    ref = jcheb.RelaxationPreconditioner(
        None, None, 10, n_iterations=2, eigenvalues=jcheb.EigenvalueInfo(*ev),
        smoothing_range=smoothing_range)
    got = chebyshev.RelaxationPreconditioner(
        None, None, 10, n_iterations=2,
        eigenvalues=chebyshev.EigenvalueInfo(*ev),
        smoothing_range=smoothing_range, device="cpu")
    assert abs(got.omega / ref.omega - 1) < 1e-15
    assert got.sweep_coefficients() == ref.sweep_coefficients()


@pytest.mark.parametrize("reduction,max_it", [(1e-4, 200), (1e-12, 200),
                                              (1e-12, 7)])
def test_cg_traceable_matches_jax(reduction, max_it):
    A, b = _spd(50, 3)
    d = 1.0 / np.diag(A)
    ref = jkrylov.cg_traceable(lambda x: jnp.asarray(A) @ x, jnp.asarray(b),
                               lambda x: jnp.asarray(d) * x,
                               reduction=reduction, max_iterations=max_it)
    At, dt = torch.as_tensor(A), torch.as_tensor(d)
    got = krylov.cg_traceable(lambda x: At @ x, torch.as_tensor(b),
                              lambda x: dt * x, reduction=reduction,
                              max_iterations=max_it)
    x_ref = np.asarray(ref)
    assert np.linalg.norm(got.numpy() - x_ref) / np.linalg.norm(x_ref) < 1e-10


def test_cg_traceable_zero_rhs_stops_before_dividing():
    calls = []
    x = krylov.cg_traceable(lambda v: calls.append(v) or v,
                            torch.zeros(8, dtype=torch.float32))
    assert calls == [] and not x.any()
