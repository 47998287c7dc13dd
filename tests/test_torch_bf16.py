"""bfloat16 multigrid levels ("mg number type": "bfloat16") in the port
against the JAX package.

Every JAX kernel gate requires float32 (``precond/factory.py:69``,
``precond/asm.py:550``, ``ops/laplace.py:252``), so bfloat16 levels run XLA
there; the port's kernels are float and double templates, so bfloat16
levels run plain torch, chosen by dtype (``device.KERNEL_DTYPES``).

In bfloat16 the rounding points decide the result, and the port follows
the JAX package's: a banded axis apply sums in float32 and rounds once (as
XLA's bfloat16 dot does), the FDM transforms fold the weights into V as
held in bfloat16, a wider vector (the float64 Lanczos vectors of the
eigenvalue estimate) meets the bfloat16 FDM tables in its own dtype, the
per-patch FDM runs the JAX lanes form's unrolled multiply-adds, and Python
scalars are rounded to bfloat16 before they scale a vector.  With these the
V-cycle output equals the JAX package's on the Cartesian and the 2D
Kershaw hierarchies below (2D Q3 at 2 refinements: 4² and 24² cells); the
stated tolerance is rel 1e-2 (bfloat16's unit roundoff is 2^-8).  Counts
equal the JAX package's.

Not covered by the equality: on a mesh with at most 64 distinct patch
patterns the JAX package applies the per-patch FDM as dense local inverses
(``asm.py:283-285, 584-597``), another rounding order, which in bfloat16
moves a count by one (3D Kershaw at 1 subdivision and 1 refinement: 22 in
the port, 23 in the JAX package); the port keeps its one per-patch form.
"""

import copy

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import dealii_asm_tpu.models.poisson as jax_poisson
from dealii_asm_tpu_torch.kernels.banded_laplace import banded_laplace_plain
from dealii_asm_tpu_torch.kernels.merged_laplace import merged_laplace_plain
from dealii_asm_tpu_torch.models.poisson import run_config


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test process (see tests/test_torch_gmres.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _quiet(*_):
    pass


def _params(mesh, dim=2, degree=3, refinements=2, mg_type="h",
            rel=1e-8):
    return {"dim": dim, "degree": degree, "n refinements": refinements,
            "mesh": mesh, "mg number type": "bfloat16",
            "solver": {"type": "CG", "rel tolerance": rel,
                       "max iterations": 300},
            "preconditioner": {
                "type": "Multigrid", "mg type": mg_type,
                "mg smoother": {"type": "Chebyshev", "degree": 2,
                                "preconditioner": {"type": "FDM",
                                                   "n overlap": 1,
                                                   "weighting type": "symm"}},
                "mg coarse grid solver": {"type": "AMG"}}}


CASES = {
    "cartesian-2d": (_params({"name": "hypercube"}), 10),
    "kershaw-2d": (_params({"name": "kershaw", "eps": 0.3}), 51),
}


class _Built(Exception):
    """Stops the JAX run_config once its multigrid is built."""


@pytest.fixture(scope="module")
def runs():
    """Per case: the port's run_config result and log, and the JAX
    package's multigrid as its run_config builds it (``_build_multigrid``;
    the JAX solve is not run: its counts are the ones in CASES)."""
    out = {}
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    orig = jax_poisson._build_multigrid
    for name, (params, _) in CASES.items():
        seen = {}

        def build(*a, **k):
            seen["mg"] = orig(*a, **k)
            raise _Built
        jax_poisson._build_multigrid = build
        try:
            jax_poisson.run_config(copy.deepcopy(params), log=_quiet)
        except _Built:
            pass
        finally:
            jax_poisson._build_multigrid = orig
        logged = []
        got = run_config(copy.deepcopy(params), log=logged.append,
                         device="cpu")
        out[name] = (got, seen["mg"], logged)
    torch.set_num_threads(n)
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_counts_match_jax(runs, name):
    """The JAX package's counts (10 and 51, its run_config on these
    parameters), the bfloat16 choice logged."""
    got, _, logged = runs[name]
    assert got["converged"] and got["it"] == CASES[name][1]
    assert any("bfloat16 levels: plain torch" in str(m) for m in logged)


@pytest.mark.parametrize("name", list(CASES))
def test_vcycle_matches_jax(runs, name):
    """The bfloat16 V-cycle on a seeded vector: rel 1e-2 (it is equal bit
    for bit on these hierarchies)."""
    got, jmg, _ = runs[name]
    mg = got["preconditioner"].inner
    x = torch.as_tensor(np.random.default_rng(7).standard_normal(
        mg.operators[-1].n_dofs)).to(torch.bfloat16)
    y = mg.vmult(x)
    assert y.dtype == torch.bfloat16
    ref = np.asarray(jmg.vmult(jnp.asarray(x.float().numpy()).astype(
        jnp.bfloat16)).astype(jnp.float32), np.float64)
    out = y.double().numpy()
    assert np.linalg.norm(out - ref) <= 1e-2 * np.linalg.norm(ref)


@pytest.mark.parametrize("name", list(CASES))
def test_bfloat16_levels_take_no_kernel(runs, name):
    """Kernels A-F are float and double only: every bfloat16 level takes a
    plain form, chosen by dtype, and no FDM level is fused."""
    mg = runs[name][0]["preconditioner"].inner
    for op in mg.operators:
        assert op.dtype == torch.bfloat16
        assert op._kernel in (banded_laplace_plain, merged_laplace_plain)
    for sm in mg.smoothers:
        assert sm.fused_step is None and sm.fused_sweep is None
        assert not getattr(sm.M.__self__, "fused", False)


@pytest.mark.parametrize("mesh,dim,degree,mg_type,expected", [
    ({"name": "hyperball"}, 2, 2, "ph", 12),
    ({"name": "hypercube"}, 3, 2, "h", 10),
])
def test_ball_and_3d_counts(mesh, dim, degree, mg_type, expected):
    """The 2D ball (general operator and per-patch FDM, plain torch) and 3D
    Cartesian levels in bfloat16 at 2 refinements: the JAX package's
    counts (12 and 10, its run_config on these parameters)."""
    params = _params(mesh, dim=dim, degree=degree, mg_type=mg_type)
    got = run_config(params, log=_quiet, device="cpu")
    assert got["converged"] and got["it"] == expected
