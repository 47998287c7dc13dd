"""The port's GMRES (dealii_asm_tpu_torch.solvers.krylov.gmres) and the
run_config paths it opens, against the JAX package.

Unit cases: small dense operators from a numpy seed, an SPD one and a
nonsymmetric one (SPD plus a skew part), through both packages' ``gmres``
with classical (CGS2) and modified Gram-Schmidt, left and right
preconditioning (Jacobi), and a restart smaller than the iteration count.
Plain callables take the JAX host loop (``krylov.py:780-851``), one history
entry per iteration like the port's: the counts are equal, the solutions
agree to rel 1e-10 and the histories to rel 1e-12 in the first cycle (the
same float64 recurrences, dot products summed in another order) and to rel
1e-6 after it: each restart starts from the true residual b − A x, and
rounding differences in x reach it multiplied by A (observed up to 3e-7).  Classical
orthogonalization also runs through the JAX device cycle (``_gmres_device``,
the path the JAX run_config takes, one history entry per restart cycle):
the same count and solution.

run_config: the port's GMRES counts equal the JAX package's on the CPU, at
reduced "n refinements":
- sweep_cartesian (hypercube Q3, ph-multigrid, Chebyshev-1, GMRES restart
  15, CGS2, right preconditioning) at 2 refinements (2,197 DoFs): 0210
  (FDM overlap 1 post) 4, 0120 (none) 11, 0165 (pre) 4, 0105 (Diagonal) 8
  and 0300 (FDM overlap 2 RAS) 9;
- sweep_ball (ball Q2, h-multigrid, Chebyshev-1) at 1 refinement (2,273
  DoFs): 0060 (GMRES, FDM post) 5, 0000 (CG, Diagonal) 5;
- default.json (Kershaw eps 0.2 Q4, ph-multigrid, per-cell FDM post, GMRES
  restart 15) at 0 refinements (15,625 DoFs): 101, across seven restart
  cycles.
0210 runs the JAX run_config in the test (its device cycle), and so does
default.json cut to degree 2 (48 iterations, three restarts); their
solutions agree within rel-l2 1e-6 (observed 1.3e-7 and 4.7e-8).  With
right preconditioning the solution is x = M(V y) of the last cycle, so the
float32 rounding of the V-cycle M, which differs between the packages'
level applies (~1e-7), goes into x directly.  The other counts, default.json
at degree 4 included, are pinned from one run each of
``dealii_asm_tpu.models.poisson.run_config`` on the CPU with the config and
"n refinements" above ("print timing" false, "best of" 1).

The Kershaw run restarts six times, and restarts amplify the float32
rounding of the levels: the update x += M(V y) carries the V-cycle's
float32 rounding, and the next cycle's true residual b − A x sees it times
A.  The first cycle's residual estimates agree to ~3e-8; from the first
restart on they differ by ~1% (with float64 levels, 1e-8 throughout, and
131 iterations at 1 refinement in both packages).  At 1 refinement with
float32 levels the port takes 133 iterations and the JAX package 132, for
that reason.
"""

import copy
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dealii_asm_tpu.models.poisson import run_config as jax_run_config
from dealii_asm_tpu.solvers import krylov as jkrylov
from dealii_asm_tpu_torch.models.poisson import run_config
from dealii_asm_tpu_torch.solvers import krylov

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXP = os.path.join(ROOT, "experiments")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test process: under pytest-xdist every
    worker's torch would otherwise start a thread per core, and the many
    small operations of a V-cycle then wait on each other's spinning pools
    (default.json's 101 iterations took 171 s in a 6-worker run, 2 s
    alone, 8 s in one thread beside five other such processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _operator(kind, n=48, seed=0):
    """(A, b, 1/diag(A)) of a dense SPD or nonsymmetric operator."""
    rng = np.random.default_rng(seed)
    Q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    A = (Q * np.geomspace(1.0, 20.0, n)) @ Q.T
    if kind == "nonsymmetric":
        S = rng.standard_normal((n, n))
        A = A + 3.0 * (S - S.T) / np.sqrt(n)
    return A, rng.standard_normal(n), 1.0 / np.diag(A)


def _rel(a, b):
    return np.linalg.norm(np.asarray(a) - b) / np.linalg.norm(b)


@pytest.mark.parametrize("kind", ["spd", "nonsymmetric"])
@pytest.mark.parametrize("ortho", ["classical", "modified"])
@pytest.mark.parametrize("right", [True, False])
def test_gmres_matches_jax_host_loop(kind, ortho, right):
    A, b, d = _operator(kind)
    restart = 7
    ctl = lambda m: m.ReductionControl(400, 1e-14, 1e-9)
    ref = jkrylov.gmres(lambda x: jnp.asarray(A) @ x, jnp.asarray(b),
                        M=lambda x: jnp.asarray(d) * x, control=ctl(jkrylov),
                        restart=restart, right_preconditioning=right,
                        orthogonalization=ortho, device_loop=False)
    At, dt = torch.as_tensor(A), torch.as_tensor(d)
    got = krylov.gmres(lambda x: At @ x, torch.as_tensor(b),
                       M=lambda x: dt * x, control=ctl(krylov),
                       restart=restart, right_preconditioning=right,
                       orthogonalization=ortho)
    assert got.converged and ref.converged
    assert got.n_iterations == ref.n_iterations > 2 * restart
    assert len(got.residuals) == got.n_iterations + 1
    first = restart + 1
    np.testing.assert_allclose(got.residuals[:first], ref.residuals[:first],
                               rtol=1e-12)
    np.testing.assert_allclose(got.residuals, ref.residuals, rtol=1e-6)
    assert _rel(got.x.numpy(), np.asarray(ref.x)) < 1e-10


@pytest.mark.parametrize("kind", ["spd", "nonsymmetric"])
def test_gmres_matches_jax_device_cycle(kind):
    A, b, d = _operator(kind, seed=1)
    Aj, dj = jnp.asarray(A), jnp.asarray(d)
    ref = jkrylov.gmres(lambda x: Aj @ x, jnp.asarray(b), M=lambda x: dj * x,
                        control=jkrylov.ReductionControl(400, 1e-14, 1e-8),
                        restart=9, device_loop=True)
    At, dt = torch.as_tensor(A), torch.as_tensor(d)
    got = krylov.gmres(lambda x: At @ x, torch.as_tensor(b),
                       M=lambda x: dt * x,
                       control=krylov.ReductionControl(400, 1e-14, 1e-8),
                       restart=9)
    assert got.converged and ref.converged
    assert got.n_iterations == ref.n_iterations > 9
    # the device cycle records the residual estimate at each cycle's end
    assert got.residuals[9] == pytest.approx(ref.residuals[0], rel=1e-9)
    assert _rel(got.x.numpy(), np.asarray(ref.x)) < 1e-10


def test_gmres_stops_at_step_zero_and_on_breakdown():
    A, b, _ = _operator("spd", n=6)
    At = torch.as_tensor(A)
    r0 = krylov.gmres(lambda x: At @ x, torch.zeros(6, dtype=torch.float64))
    assert r0.converged and r0.n_iterations == 0
    assert torch.equal(r0.x, torch.zeros(6, dtype=torch.float64))
    # n = 6: the Krylov space is exhausted (h_k+1,k = 0) by step 6 at the
    # latest, and the breakdown step counts
    got = krylov.gmres(lambda x: At @ x, torch.as_tensor(b),
                       control=krylov.ReductionControl(50, 0.0, 0.0),
                       restart=10)
    ref = jkrylov.gmres(lambda x: jnp.asarray(A) @ x, jnp.asarray(b),
                        control=jkrylov.ReductionControl(50, 0.0, 0.0),
                        restart=10, device_loop=False)
    assert got.n_iterations == ref.n_iterations
    assert _rel(got.x.numpy(), np.linalg.solve(A, b)) < 1e-10


def test_solve_dispatches_gmres_options():
    A, b, d = _operator("nonsymmetric", seed=2)
    At, dt = torch.as_tensor(A), torch.as_tensor(d)
    opts = dict(restart=10, right_preconditioning=False,
                orthogonalization="modified")
    got = krylov.solve("GMRES", lambda x: At @ x, torch.as_tensor(b),
                       M=lambda x: dt * x, max_iterations=300,
                       abs_tolerance=1e-14, rel_tolerance=1e-8, **opts)
    direct = krylov.gmres(lambda x: At @ x, torch.as_tensor(b),
                          M=lambda x: dt * x,
                          control=krylov.ReductionControl(300, 1e-14, 1e-8),
                          **opts)
    assert got.converged and got.n_iterations == direct.n_iterations
    assert torch.equal(got.x, direct.x)


def _config(path, refinements):
    with open(os.path.join(EXP, path)) as f:
        p = json.load(f)
    p["n refinements"] = refinements
    p["print timing"] = False
    p["solver"]["best of"] = 1
    return p


def _quiet(*_):
    pass


@pytest.mark.parametrize("path,refinements,expected_it,n_dofs,bound", [
    ("sweep_cartesian/input_0210.json", 2, 4, 2197, 1e-6),
    ("sweep_cartesian/input_0120.json", 2, 11, 2197, None),
    ("sweep_cartesian/input_0165.json", 2, 4, 2197, None),
    ("sweep_cartesian/input_0105.json", 2, 8, 2197, None),
    ("sweep_cartesian/input_0300.json", 2, 9, 2197, None),
    ("sweep_ball/input_0060.json", 1, 5, 2273, None),
    ("sweep_ball/input_0000.json", 1, 5, 2273, None),
    ("default.json", 0, 101, 15625, None),
])
def test_run_config_counts_match_jax(path, refinements, expected_it, n_dofs,
                                     bound):
    params = _config(path, refinements)
    got = run_config(copy.deepcopy(params), log=_quiet, device="cpu")
    assert got["converged"] and got["it"] == expected_it
    assert got["n_dofs"] == n_dofs
    assert len(got["residuals"]) == expected_it + 1
    if bound is not None:
        ref = jax_run_config(copy.deepcopy(params), log=_quiet)
        assert ref["converged"] and ref["it"] == expected_it
        assert _rel(got["solution"].numpy(), np.asarray(ref["solution"])) < bound


def test_kershaw_gmres_solution_matches_jax():
    """default.json (Kershaw eps 0.2, GMRES restart 15) cut to degree 2 at
    0 refinements (2,197 DoFs, three restarts): the JAX run_config in the
    test, the same count (48) and solutions within rel-l2 1e-6 (observed
    4.7e-8).  Degree 2 keeps the JAX compile of the device cycle small."""
    params = _config("default.json", 0)
    params["degree"] = 2
    got = run_config(copy.deepcopy(params), log=_quiet, device="cpu")
    ref = jax_run_config(copy.deepcopy(params), log=_quiet)
    assert got["converged"] and ref["converged"]
    assert got["it"] == ref["it"] == 48
    assert _rel(got["solution"].numpy(), np.asarray(ref["solution"])) < 1e-6
