"""The named study inputs (``inputs/``) through the port's run_config, and
the device-side dense coarse solve they lean on.

Kershaw-mp study (``inputs/mp_00..05.json``: Q7, GMRES(30), p-multigrid,
per-cell overlap-2 RAS FDM around Relaxation or Chebyshev, the sin-mp rhs)
at 2 subdivisions and 0 refinements (2³ cells, 3,375 DoFs):
- mp_02 (Chebyshev-1, merged geometry) runs live in both packages here
  (about a minute of JAX compiles); mp_04 (linear geometry) runs live in
  ``test_torch_mapping_types.py``;
- mp_00, mp_01, mp_03 and mp_05 are pinned to the counts of one JAX run
  each (6, 8, 14 and 15): ``JAX_PLATFORMS=cpu python -c "from
  dealii_asm_tpu.models.poisson import run_config; ..."`` on the config with
  "n refinements" 0, "mesh"/"n subdivisions" 2, "best of" 1;
- all six live sit behind the ``slow`` marker (several minutes).

Coarse solve: ``DirectCoarseSolver`` now assembles the constrained coarse
matrix on the operator's device (probing colours of unit vectors) and
inverts it there through a Cholesky factor, in blocks of columns (rel 1e-14
between block sizes: the triangular solves may group their sums by
block); against the host version it
replaces (unit vectors one by one, ``numpy.linalg.inv``): the matrix equal
entry by entry on structured meshes and within 1e-14, the inverse within
rel 1e-12, on Cartesian, Kershaw-mp and ball coarse levels.
"""

import copy
import json
import os

import numpy as np
import pytest
import torch

from dealii_asm_tpu.models.poisson import run_config as jax_run_config
from dealii_asm_tpu_torch.fem.dofs import DofHandler
from dealii_asm_tpu_torch.fem.general_dofs import GeneralDofHandler
from dealii_asm_tpu_torch.mesh.grid import StructuredMesh
from dealii_asm_tpu_torch.mesh.transforms import kershaw_transform
from dealii_asm_tpu_torch.mesh.unstructured import hyper_ball_balanced
from dealii_asm_tpu_torch.models.poisson import run_config
from dealii_asm_tpu_torch.ops.laplace import LaplaceOperator
from dealii_asm_tpu_torch.ops.laplace_general import GeneralLaplaceOperator
from dealii_asm_tpu_torch.precond.multigrid import (DirectCoarseSolver,
                                                    assemble_dense,
                                                    inverse_from_cholesky)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MP_COUNTS = {"mp_00": 6, "mp_01": 8, "mp_02": 8, "mp_03": 14, "mp_04": 6,
             "mp_05": 15}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test process (see tests/test_torch_gmres.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _quiet(*_):
    pass


def _mp(name):
    with open(os.path.join(ROOT, "inputs", f"{name}.json")) as f:
        p = json.load(f)
    p["n refinements"] = 0
    p["mesh"]["n subdivisions"] = 2
    p["print timing"] = False
    p["solver"]["best of"] = 1
    return p


@pytest.mark.parametrize("name", ["mp_00", "mp_01", "mp_03", "mp_05"])
def test_mp_counts_match_pinned_jax_counts(name):
    got = run_config(_mp(name), log=_quiet, device="cpu")
    assert got["n_dofs"] == 3375 and got["L"] == 1
    assert got["converged"] and got["it"] == MP_COUNTS[name]
    assert torch.isfinite(got["solution"]).all()


def test_mp_02_count_matches_jax():
    params = _mp("mp_02")
    got = run_config(copy.deepcopy(params), log=_quiet, device="cpu")
    ref = jax_run_config(copy.deepcopy(params), log=_quiet)
    assert got["converged"] and got["it"] == ref["it"] == MP_COUNTS["mp_02"]
    x, y = got["solution"].numpy(), np.asarray(ref["solution"])
    # float32 levels under GMRES at rel 1e-8: the iterates agree to the
    # levels' rounding times the remaining residual
    assert np.linalg.norm(x - y) / np.linalg.norm(y) < 1e-6


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(MP_COUNTS))
def test_mp_counts_match_jax_live(name):
    params = _mp(name)
    got = run_config(copy.deepcopy(params), log=_quiet, device="cpu")
    ref = jax_run_config(copy.deepcopy(params), log=_quiet)
    assert got["it"] == ref["it"] == MP_COUNTS[name]


def _host_inverse(op):
    """The host version: unit vectors one by one through the CPU float64
    operator, inverted by NumPy."""
    n = op.n_dofs
    eye = torch.eye(n, dtype=torch.float64)
    A = torch.stack([op.vmult(eye[j]) for j in range(n)], dim=1).numpy()
    return A, np.linalg.inv(A)


def _coarse(kind):
    if kind == "ball":
        return GeneralDofHandler(hyper_ball_balanced(3), 1)
    if kind == "kershaw-mp":
        return DofHandler(StructuredMesh(3, (4, 4, 4), transform=(
            kershaw_transform(1.0, 1.0, shift_mp=True))), 1)
    if kind == "symmetric square":
        return DofHandler(StructuredMesh(2, (5, 3), lengths=(2.0, 2.0),
                                         origin=(-1.0, -1.0)), 2)
    return DofHandler(StructuredMesh(3, (3, 2, 4)), 1)


@pytest.mark.parametrize("kind", ["cartesian", "kershaw-mp", "ball",
                                  "symmetric square"])
def test_direct_coarse_solver_matches_host_inverse(kind):
    dofs = _coarse(kind)
    cls = (GeneralLaplaceOperator if isinstance(dofs, GeneralDofHandler)
           else LaplaceOperator)
    op = cls(dofs, device="cpu")
    A_host, inv_host = _host_inverse(op)
    A = assemble_dense(op).numpy()
    if kind == "ball":
        assert np.abs(A - A_host).max() <= 1e-14 * np.abs(A_host).max()
    else:
        np.testing.assert_array_equal(A, A_host)
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-6)):
        got = DirectCoarseSolver(dofs, dtype=dtype, device="cpu")
        assert got.Ainv.dtype == dtype and got.Ainv.device.type == "cpu"
        err = np.abs(got.Ainv.double().numpy() - inv_host).max()
        assert err <= tol * np.abs(inv_host).max()


def test_inverse_blocks():
    """Column blocks smaller than the matrix give the same inverse."""
    dofs = _coarse("cartesian")
    L = torch.linalg.cholesky(assemble_dense(LaplaceOperator(dofs,
                                                             device="cpu")))
    whole = inverse_from_cholesky(L, torch.float64)
    blocks = inverse_from_cholesky(L, torch.float64, block=7)
    assert (blocks - whole).abs().max() <= 1e-14 * whole.abs().max()
