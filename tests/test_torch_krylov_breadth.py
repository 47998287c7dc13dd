"""The solver breadth of the port against the JAX package: FCG, FGMRES,
BiCGStab, IDR(s) and Richardson beside CG and GMRES, the
IterationNumberControl dispatch, IDR's shadow space, and the solvers in
``run_config``.

Inputs come from seeded NumPy generators and go to both packages.
Tolerances (float64): iterates rel 1e-10 and residual histories 1e-10 of
the initial residual on small dense systems (eigenvalues in [1, 10], a
nonsymmetric part of norm 0.3 for the non-CG solvers); iteration counts
equal.

The multigrid cases share one preconditioner per package: a module fixture
runs each package's ``run_config`` once (2D Q3 hypercube at 2 refinements,
h-multigrid with Chebyshev-2 around FDM, rel 1e-8) and keeps the operator,
right-hand side and V-cycle that its ``run_config`` hands to the solver;
every solver then runs on them through each package's ``solve`` as
``run_config`` calls it, and must take the JAX package's count.  IDR runs
there with float64 levels: with float32 levels its count moves by one
between the packages (13 against 12 on this problem at 3 refinements; 29
against 30 on 2D Kershaw at 2), because IDR's recurrences amplify the float32 V-cycle's rounding,
in which the two packages' applies differ by 1.7e-7 relative; with float64
levels the applies agree to 1e-15 and the counts are equal.
"""

import copy

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import dealii_asm_tpu.models.poisson as jax_poisson
import dealii_asm_tpu_torch.models.poisson as poisson
from dealii_asm_tpu.solvers import krylov as jkrylov
from dealii_asm_tpu_torch.solvers import krylov

ALL = ("CG", "FCG", "GMRES", "FGMRES", "Bicgstab", "IDR", "Richardson")
NONSYMMETRIC = ("GMRES", "FGMRES", "Bicgstab", "IDR", "Richardson")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test process (see tests/test_torch_gmres.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _quiet(*_):
    pass


def _system(kind: str, n: int = 40, seed: int = 0):
    rng = np.random.default_rng(seed)
    Q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    A = (Q * np.linspace(1.0, 10.0, n)) @ Q.T
    if kind == "nonsymmetric":
        S = rng.standard_normal((n, n))
        A = A + 0.3 * (S - S.T) / np.linalg.norm(S - S.T, 2)
    return A, rng.standard_normal(n)


def _preconditioner(name: str, A: np.ndarray) -> np.ndarray:
    """Jacobi, or ω = 2/(1 + 10) for Richardson (the spectrum's optimum)."""
    if name == "Richardson":
        return np.full(A.shape[0], 2.0 / 11.0)
    return 1.0 / np.diag(A)


@pytest.mark.parametrize("name,kind", [(n, "spd") for n in ALL]
                         + [(n, "nonsymmetric") for n in NONSYMMETRIC])
def test_solvers_match_jax_on_small_systems(name, kind):
    A, b = _system(kind, seed=3)
    d = _preconditioner(name, A)
    At, dt = torch.as_tensor(A), torch.as_tensor(d)
    Aj, dj = jnp.asarray(A), jnp.asarray(d)
    kw = dict(max_iterations=400, abs_tolerance=1e-30, rel_tolerance=1e-10)
    got = krylov.solve(name, lambda x: At @ x, torch.as_tensor(b),
                       M=lambda x: dt * x, **kw)
    ref = jkrylov.solve(name, lambda x: Aj @ x, jnp.asarray(b),
                        M=lambda x: dj * x, **kw)
    assert got.converged and ref.converged
    assert got.n_iterations == ref.n_iterations
    h, hr = np.asarray(got.residuals), np.asarray(ref.residuals)
    assert h.shape == hr.shape
    assert np.abs(h - hr).max() <= 1e-10 * hr[0]
    x, xr = got.x.numpy(), np.asarray(ref.x)
    assert np.linalg.norm(x - xr) <= 1e-10 * np.linalg.norm(xr)


@pytest.mark.parametrize("name", ALL)
def test_iteration_number_control_runs_every_step(name):
    """``control_type`` other than ReductionControl: exactly max_iterations
    steps (tolerance 0), as the JAX package counts them."""
    A, b = _system("nonsymmetric" if name in NONSYMMETRIC else "spd",
                   seed=4)
    d = _preconditioner(name, A)
    At, dt = torch.as_tensor(A), torch.as_tensor(d)
    Aj, dj = jnp.asarray(A), jnp.asarray(d)
    kw = dict(max_iterations=7, abs_tolerance=0.0,
              control_type="IterationNumberControl")
    got = krylov.solve(name, lambda x: At @ x, torch.as_tensor(b),
                       M=lambda x: dt * x, **kw)
    ref = jkrylov.solve(name, lambda x: Aj @ x, jnp.asarray(b),
                        M=lambda x: dj * x, **kw)
    assert got.converged and got.n_iterations == ref.n_iterations == 7
    x, xr = got.x.numpy(), np.asarray(ref.x)
    assert np.linalg.norm(x - xr) <= 1e-12 * np.linalg.norm(xr)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_idr_shadow_space_is_the_jax_one_bit_for_bit(dtype):
    """The port's P: Q of np.linalg.qr of default_rng(seed).standard_normal
    ((n, s)), cast to b's dtype, as ``dealii_asm_tpu/solvers/krylov.py:
    994-996`` builds it."""
    n, s, seed = 1000, 2, 42
    P = krylov.idr_shadow_space(n, s, seed)
    ref = np.linalg.qr(np.random.default_rng(seed).standard_normal((n, s)))[0]
    np.testing.assert_array_equal(P, ref)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    for j in range(s):
        port = torch.as_tensor(P[:, j]).to(dtype).numpy()
        np.testing.assert_array_equal(port, np.asarray(jnp.asarray(ref[:, j],
                                                                   jdt)))


def _mg_params(level_type=None):
    p = {"dim": 2, "degree": 3, "n refinements": 2,
         "mesh": {"name": "hypercube"},
         "solver": {"type": "CG", "rel tolerance": 1e-8,
                    "max iterations": 300},
         "preconditioner": {
             "type": "Multigrid", "mg type": "h",
             "mg smoother": {"type": "Chebyshev", "degree": 2,
                             "preconditioner": {"type": "FDM",
                                                "n overlap": 1,
                                                "weighting type": "symm"}},
             "mg coarse grid solver": {"type": "AMG"}}}
    if level_type:
        p["mg number type"] = level_type
    return p


class _Captured(Exception):
    """Stops a run_config at its first solve."""


def _captured(module, attr, run):
    """(A, b, M) that ``run()`` hands to ``module.<attr>`` (the package's
    solve as its run_config calls it); the solve itself is not run."""
    seen = {}
    orig = getattr(module, attr)

    def capture(solver_type, A, b, M=None, **kw):
        seen.update(A=A, b=b, M=M)
        raise _Captured
    setattr(module, attr, capture)
    try:
        run()
    except _Captured:
        pass
    finally:
        setattr(module, attr, orig)
    return seen["A"], seen["b"], seen["M"]


@pytest.fixture(scope="module")
def mg_systems():
    """Per level precision: the port's and the JAX package's (A, b, M)."""
    out = {}
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    for level in ("float32", "float64"):
        params = _mg_params(None if level == "float32" else level)
        port = _captured(poisson, "krylov_solve", lambda: poisson.run_config(
            copy.deepcopy(params), log=_quiet, device="cpu"))
        ref = _captured(jax_poisson, "krylov_solve",
                        lambda: jax_poisson.run_config(copy.deepcopy(params),
                                                       log=_quiet))
        out[level] = (port, ref)
    torch.set_num_threads(n)
    return out


@pytest.mark.parametrize("name,level,expected", [
    ("CG", "float32", 10), ("FCG", "float32", 10), ("GMRES", "float32", 10),
    ("FGMRES", "float32", 10), ("Bicgstab", "float32", 6),
    ("Richardson", "float32", 24), ("IDR", "float64", 12)])
def test_multigrid_solves_match_jax(mg_systems, name, level, expected):
    (A, b, M), (Aj, bj, Mj) = mg_systems[level]
    kw = dict(max_iterations=300, abs_tolerance=1e-10, rel_tolerance=1e-8)
    got = krylov.solve(name, A, b, M=M, **kw)
    ref = jkrylov.solve(name, Aj, bj, M=Mj, **kw)
    assert got.converged and ref.converged
    assert got.n_iterations == ref.n_iterations == expected
    x, xr = got.x.numpy(), np.asarray(ref.x)
    # GMRES: the JAX package's device cycle (one solve per restart)
    tol = 1e-6 if name == "GMRES" else 1e-9
    assert np.linalg.norm(x - xr) <= tol * np.linalg.norm(xr)


def test_run_config_routes_the_new_solvers():
    """The solvers through run_config: FGMRES takes no "max n tmp vectors"
    (GMRES only, as ``poisson.py:488-498``), Bicgstab converges with the
    count of the shared-system case; an unknown solver raises."""
    for name, expected in (("FGMRES", 10), ("Bicgstab", 6)):
        params = _mg_params()
        params["solver"]["type"] = name
        params["solver"]["max n tmp vectors"] = 5  # restart 3 for GMRES
        got = poisson.run_config(params, log=_quiet, device="cpu")
        assert got["converged"] and got["it"] == expected
    params = _mg_params()
    params["solver"]["type"] = "Jacobi"
    with pytest.raises(ValueError, match="not known"):
        poisson.run_config(params, log=_quiet, device="cpu")
