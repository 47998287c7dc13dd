"""The port's run_config on the hyperball (experiments/e2e_ball_q4.json:
3D Q4 on the balanced ball, ph-multigrid with float32 levels, Chebyshev-1
around element FDM overlap-1 "symm" Schwarz, dense coarse solve) against the
JAX package's, both run in-test on the CPU at 0, 1 and 2 refinements.

Contract: the JAX iteration counts 5, 6 and 6, and solutions within rel-l2
1e-6.  The JAX package's CPU float64 outer operator on the ball is its
double-single composition (about 1e-8 relative), the port's is native
float64, and the float32 level applies differ at float32 rounding, so the
converged iterates differ by that perturbation scaled by the remaining
relative residual.
"""

import copy
import json
import os

import numpy as np
import pytest
import torch

from dealii_asm_tpu.models.poisson import run_config as jax_run_config
from dealii_asm_tpu_torch.models.poisson import run_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "experiments", "e2e_ball_q4.json")) as _f:
    BALL = json.load(_f)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test process (see tests/test_torch_gmres.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _quiet(*_):
    pass


@pytest.mark.parametrize("refinements,expected_it,n_dofs", [
    (0, 5, 2273), (1, 6, 17217), (2, 6, 134273)])
def test_ball_run_config_matches_jax(refinements, expected_it, n_dofs):
    params = copy.deepcopy(BALL)
    params["n refinements"] = refinements
    params["print timing"] = False
    params["solver"]["best of"] = 1
    ref = jax_run_config(copy.deepcopy(params), log=_quiet)
    got = run_config(copy.deepcopy(params), log=_quiet, device="cpu")
    assert got["converged"] and ref["converged"]
    assert got["it"] == ref["it"] == expected_it
    assert got["n_dofs"] == ref["n_dofs"] == n_dofs
    assert got["n_cells"] == ref["n_cells"] == 32 * 8 ** refinements
    assert got["L"] == ref["L"]
    x_ref = np.asarray(ref["solution"])
    x = got["solution"]
    assert x.dtype == torch.float64 and x.shape == x_ref.shape
    rel = np.linalg.norm(x.numpy() - x_ref) / np.linalg.norm(x_ref)
    assert rel < 1e-6
    jtab, tab = ref["table"], got["table"]
    assert tab.rows[-1]["aspect_ratio"] == jtab.rows[-1]["aspect_ratio"]
