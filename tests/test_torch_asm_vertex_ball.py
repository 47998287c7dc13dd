"""Vertex-star patches and element overlap 2..p with every weighting on
the unstructured ball (dealii_asm_tpu_torch.precond.asm_general.
GeneralASMPreconditioner) against the JAX GeneralASMPreconditioner: a
gather through the patch table, per-patch FDM and a fixed-order scatter in
the port, the lane form with an atomic scatter-add in the JAX package.

Tolerances (as in tests/test_torch_asm_vertex.py): float64 rel 1e-12 against the JAX float64 vmult (observed
~4e-16); float32 rel 1e-5; two applies bit-identical; patch tables, FDM
ids and RAS masks equal entry by entry.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dealii_asm_tpu.precond.asm_general import \
    GeneralASMPreconditioner as JaxGeneralASM
from dealii_asm_tpu_torch.precond.asm_general import GeneralASMPreconditioner

WEIGHTINGS = ["none", "pre", "post", "symm", "ras"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test process (see tests/test_torch_gmres.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(b).max()


_BALLS = {}


def _ball(refinements, p):
    from dealii_asm_tpu.fem.general_dofs import GeneralDofHandler as JaxGD
    from dealii_asm_tpu.mesh.unstructured import hyper_ball_balanced as jball
    from dealii_asm_tpu_torch.fem.general_dofs import GeneralDofHandler
    from dealii_asm_tpu_torch.mesh.unstructured import hyper_ball_balanced

    key = (refinements, p)
    if key not in _BALLS:
        _BALLS[key] = (
            JaxGD(jball(3).refine_global(refinements), p),
            GeneralDofHandler(hyper_ball_balanced(3).refine_global(
                refinements), p))
    return _BALLS[key]


def _check_apply(make, jasm, n, seed):
    """float64 to 1e-12 and float32 to 1e-5 of the JAX float64 vmult; two
    applies bit-identical in each precision."""
    x = np.random.default_rng(seed).standard_normal(n)
    ref = np.asarray(jasm.vmult(jnp.asarray(x)))
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        asm = make(dtype)
        xt = torch.as_tensor(x, dtype=dtype)
        y = asm.vmult(xt)
        assert y.dtype == dtype
        assert _rel(y.numpy(), ref) < tol
        assert torch.equal(y, asm.vmult(xt))
    return asm


BALL = [(0, 2), (1, 1), (0, 4)]
BALL_FORMS = [(r, p, patch, o) for r, p in BALL
              for patch, o in [("vertex", 1)]
              + [("element", o) for o in range(2, p + 1)]]


@pytest.mark.parametrize("refinements,p,patch,overlap", BALL_FORMS)
@pytest.mark.parametrize("wt", WEIGHTINGS)
def test_ball_patches_match_jax(refinements, p, patch, overlap, wt):
    jdofs, dofs = _ball(refinements, p)
    jasm = JaxGeneralASM(jdofs, n_overlap=overlap, weighting_type=wt,
                         patch_type=patch, dtype=jnp.float64)
    asm = _check_apply(lambda dt: GeneralASMPreconditioner(
        dofs, n_overlap=overlap, weighting_type=wt, patch_type=patch,
        dtype=dt, device="cpu"), jasm, dofs.n_dofs, 30 * p + overlap)
    np.testing.assert_array_equal(asm.patch_idx.numpy(),
                                  np.asarray(jasm.patch_idx))
    np.testing.assert_array_equal(asm.collection.ids, jasm.collection.ids)
    if wt == "ras":
        np.testing.assert_array_equal(asm.ras_mask.numpy(),
                                      np.asarray(jasm.ras_mask))
