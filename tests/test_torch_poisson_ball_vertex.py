"""run_config on experiments/e2e_ball_fdmv.json (the balanced ball, Q4,
ph-multigrid, Chebyshev-1 around vertex-star FDM "symm" Schwarz, float32
levels) in the port against the JAX package, on the CPU.

The JAX package takes 6 iterations at 0 refinements (2,273 DoFs, run in
both packages here; solutions within rel-l2 1e-6, observed 2.7e-12) and 6 at
1 (17,217 DoFs, pinned from one JAX run_config).  The ball's vertex patches
come from composed face-map walks in each anchor cell's rotated frame
(``fem/general_patches.py``), its 1D keys from the anchor-frame widths.
"""

import copy
import json
import os

import numpy as np
import pytest
import torch

from dealii_asm_tpu.models.poisson import run_config as jax_run_config
from dealii_asm_tpu_torch.models.poisson import run_config
from dealii_asm_tpu_torch.precond.asm_general import GeneralASMPreconditioner

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test process (see tests/test_torch_gmres.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _quiet(*_):
    pass


def _config(refinements):
    with open(os.path.join(ROOT, "experiments", "e2e_ball_fdmv.json")) as f:
        p = json.load(f)
    p["n refinements"] = refinements
    p["print timing"] = False
    p["solver"]["best of"] = 1
    return p


@pytest.mark.parametrize("refinements,expected_it,n_dofs,against_jax", [
    (0, 6, 2273, True), (1, 6, 17217, False)])
def test_ball_fdmv_run_config(refinements, expected_it, n_dofs, against_jax):
    params = _config(refinements)
    got = run_config(copy.deepcopy(params), log=_quiet, device="cpu")
    assert got["converged"] and got["it"] == expected_it
    assert got["n_dofs"] == n_dofs
    # every level's smoother wraps a vertex-patch FDM (its M, a bound vmult)
    inners = [s.M.__self__ for s in got["preconditioner"].inner.smoothers]
    assert inners and all(isinstance(a, GeneralASMPreconditioner)
                          and a.patch_type == "vertex" for a in inners)
    if against_jax:
        ref = jax_run_config(copy.deepcopy(params), log=_quiet)
        assert ref["converged"] and ref["it"] == expected_it
        x_ref = np.asarray(ref["solution"])
        rel = np.linalg.norm(got["solution"].numpy() - x_ref) / np.linalg.norm(
            x_ref)
        assert rel < 1e-6
