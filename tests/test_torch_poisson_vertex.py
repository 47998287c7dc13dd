"""run_config with vertex-star patches ("element centric": false) in the
port against the JAX package, on the CPU.

- experiments/e2e_kershaw_fdmv.json (Kershaw eps 0.3, Q4, ph-multigrid,
  Chebyshev-2 around vertex FDM "symm", float32 levels) at 0 refinements,
  15,625 DoFs, run in both packages here.  The JAX package takes 43
  iterations with its last residual at 0.9992 of the stopping threshold;
  the port takes 44, its 43rd residual at 1.04 of the threshold.  The two
  residual histories agree to float32 rounding (rel 1e-5, observed at most
  3e-6) over the first 28 iterations, after which CG's loss of
  orthogonality amplifies the levels' float32 rounding, as on any
  float32-level solve (4.8% apart at iteration 42).  With float64 levels
  both packages take 44 iterations and their solutions agree to 5e-14
  (one run each, ``"mg number type": "float64"``), so the one iteration is
  the float32 rounding of the level applies, not a difference of method.
  The test holds the port to within one iteration of the JAX count, the
  histories over the first 28 iterations and the solutions to rel-l2 1e-6
  (observed 3.6e-7).
- the large-scaling ladder's fdmv rung (sweep_large_scaling/input_0011.json,
  anisotropy stretch 50, Q4) with "mg type" "ph" in place of its "hp": 7
  iterations at 2 refinements, 11 at 3 (pinned from one JAX run_config
  each).  As written, with "hp", the rung's p-levels (degree 2 and 4) sit on
  the 1-cell coarse mesh, which has no interior vertex: both packages raise
  a ValueError (the JAX package in ``precond/asm.py:438``).
"""

import copy
import json
import os

import numpy as np
import pytest
import torch

import dealii_asm_tpu.models.poisson as jax_poisson
from dealii_asm_tpu_torch.models.poisson import run_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXP = os.path.join(ROOT, "experiments")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test process (see tests/test_torch_gmres.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _quiet(*_):
    pass


def _config(path, refinements, **precon):
    with open(os.path.join(EXP, path)) as f:
        p = json.load(f)
    p["n refinements"] = refinements
    p["print timing"] = False
    p["solver"]["best of"] = 1
    p["preconditioner"].update(precon)
    return p


def test_kershaw_fdmv_run_config_against_jax(monkeypatch):
    params = _config("e2e_kershaw_fdmv.json", 0)
    histories = []
    solve = jax_poisson.krylov_solve

    def recorded(*args, **kwargs):
        res = solve(*args, **kwargs)
        histories.append(np.asarray(res.residuals))
        return res

    monkeypatch.setattr(jax_poisson, "krylov_solve", recorded)
    ref = jax_poisson.run_config(copy.deepcopy(params), log=_quiet)
    got = run_config(copy.deepcopy(params), log=_quiet, device="cpu")
    assert ref["converged"] and ref["it"] == 43
    assert got["converged"] and got["it"] == 44
    assert got["n_dofs"] == ref["n_dofs"] == 15_625
    h_ref, h = histories[0], np.asarray(got["residuals"])
    thr = 1e-5 * h_ref[0]
    assert 0.99 < h_ref[-1] / thr < 1.0  # the JAX count's narrow margin
    np.testing.assert_allclose(h[:28], h_ref[:28], rtol=1e-5, atol=0)
    x_ref = np.asarray(ref["solution"])
    rel = np.linalg.norm(got["solution"].numpy() - x_ref) / np.linalg.norm(
        x_ref)
    assert rel < 1e-6


@pytest.mark.parametrize("r,expected_it", [(2, 7), (3, 11)])
def test_ladder_fdmv_ph_counts(r, expected_it):
    got = run_config(_config("sweep_large_scaling/input_0011.json", r,
                             **{"mg type": "ph"}), log=_quiet, device="cpu")
    assert got["converged"] and got["it"] == expected_it
    assert got["n_dofs"] == (4 * 2 ** r + 1) ** 3


def test_hp_ladder_fdmv_raises_in_both_packages():
    params = _config("sweep_large_scaling/input_0003.json", 0)
    with pytest.raises(ValueError, match="cannot reshape"):
        jax_poisson.run_config(copy.deepcopy(params), log=_quiet)
    with pytest.raises(ValueError, match=r"level \(refinement 0, degree 2\) "
                       "has no interior vertex"):
        run_config(copy.deepcopy(params), log=_quiet, device="cpu")
