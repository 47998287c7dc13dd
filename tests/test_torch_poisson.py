"""The port's run_config (dealii_asm_tpu_torch.models.poisson) vs the JAX
package's, both run in-test on the CPU on the same config.

Contract: the same CG iteration counts (the flagship e2e_aniso_q4.json takes
4 iterations at 2 refinements and 5 at 3 in the JAX package), and solutions
equal to rel-l2 1e-8.  Both solve in float64 over float32 multigrid levels;
the level applies differ at float32 rounding, and the converged iterate
sees that perturbation scaled by the remaining relative residual (1e-5 here):
observed 1e-11 to 1e-14.
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
with open(os.path.join(ROOT, "experiments", "e2e_aniso_q4.json")) as _f:
    FLAGSHIP = json.load(_f)

HYPERCUBE_Q2 = {
    "dim": 3, "degree": 2, "n refinements": 3,
    "mesh": {"name": "hypercube", "n subdivisions": 1},
    "solver": {"type": "CG", "rel tolerance": 1e-8},
    "preconditioner": {
        "type": "Multigrid", "mg type": "h", "mg number type": "float32",
        "mg smoother": {
            "type": "Chebyshev", "degree": 2, "polynomial type": "4th kind",
            "preconditioner": {"type": "FDM", "n overlap": 1,
                               "weighting type": "post"}},
        "mg coarse grid solver": {"type": "AMG"}},
}


# degree 1: the intermediate-level split (every level has degree 1), with a
# one-sided V-cycle, two coarse cycles and float64 levels
HYPERCUBE_Q1 = {
    "dim": 3, "degree": 1, "n refinements": 3, "mg number type": "float64",
    "mesh": {"name": "hypercube", "n subdivisions": 2},
    "solver": {"type": "CG", "rel tolerance": 1e-6},
    "preconditioner": {
        "type": "Multigrid", "mg type": "h", "one-sided v-cycle": True,
        "n coarse cycles": 2,
        "mg smoother": {
            "type": "Chebyshev", "degree": 3,
            "preconditioner": {"type": "FDM", "weighting type": "none"}},
        "mg coarse grid solver": {"type": "AMG"}},
}


def _quiet(*_):
    pass


def _config(name):
    if name.startswith("hypercube"):
        p = copy.deepcopy(HYPERCUBE_Q2 if name == "hypercube-q2"
                          else HYPERCUBE_Q1)
    else:
        p = copy.deepcopy(FLAGSHIP)
        p["n refinements"] = int(name[-1])
    # one solve: "best of" only repeats the timed solve
    p["print timing"] = False
    p["solver"]["best of"] = 1
    return p


@pytest.mark.parametrize("name,expected_it", [
    ("e2e_aniso_q4 n refinements 2", 4),
    ("e2e_aniso_q4 n refinements 3", 5),
    ("hypercube-q2", None),
    ("hypercube-q1", None),
])
def test_run_config_matches_jax(name, expected_it):
    params = _config(name)
    ref = jax_run_config(copy.deepcopy(params), log=_quiet)
    got = run_config(copy.deepcopy(params), log=_quiet, device="cpu")
    assert got["converged"] and ref["converged"]
    assert got["it"] == ref["it"]
    if expected_it is not None:
        assert got["it"] == expected_it
    assert got["n_dofs"] == ref["n_dofs"] and got["L"] == ref["L"]
    x_ref = np.asarray(ref["solution"])
    x = got["solution"]
    assert x.dtype == torch.float64 and x.shape == x_ref.shape
    rel = np.linalg.norm(x.numpy() - x_ref) / np.linalg.norm(x_ref)
    assert rel < 1e-8


@pytest.mark.parametrize("path,value,item", [
    (("preconditioner", "mg type"), "p", "ROADMAP item 9"),
    (("mesh", "name"), "kershaw", "ROADMAP item 8"),
    (("solver", "type"), "GMRES", "ROADMAP item 11"),
    (("n devices",), 4, "ROADMAP item 14"),
    (("preconditioner", "mg smoother", "preconditioner", "weighting type"),
     "ras", "ROADMAP item 10"),
])
def test_unported_options_raise(path, value, item):
    params = _config("e2e_aniso_q4 n refinements 1")
    node = params
    for key in path[:-1]:
        node = node[key]
    node[path[-1]] = value
    with pytest.raises(NotImplementedError, match=item):
        run_config(params, log=_quiet, device="cpu")
