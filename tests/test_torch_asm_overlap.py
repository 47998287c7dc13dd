"""Overlap > 1 and restricted (RAS) FDM Schwarz on Cartesian meshes
(dealii_asm_tpu_torch.precond.asm.ASMPreconditioner) against the JAX
ASMPreconditioner.

Inputs come from a seeded numpy generator and go to both packages; the port
runs its plain global form (six dense per-axis products) on CPU tensors,
the form it also runs on the card for these options.

Tolerances:
- float64 apply: rel 1e-12 (relative to max |y|) against the JAX vmult: its
  global-FDM form for the multiplicity weightings (the same folded
  transforms), its per-cell masked form for RAS (the same local solves,
  summed in another order); observed ~1e-15;
- float32 apply: rel 1e-5 against the float64 JAX vmult (float32 rounding);
- tables (per-coordinate eigenvectors and eigenvalues, axis weights, RAS
  masks): equal entry by entry; the RAS mask's tensor product equals the
  JAX ``_ras_ownership`` mask entry by entry.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dealii_asm_tpu.fem.dofs import DofHandler as JaxDofHandler
from dealii_asm_tpu.mesh.grid import StructuredMesh as JaxMesh
from dealii_asm_tpu.precond.asm import ASMPreconditioner as JaxASM
from dealii_asm_tpu_torch.fem.dofs import DofHandler
from dealii_asm_tpu_torch.interop import asm_from_jax, ras_axis_masks
from dealii_asm_tpu_torch.mesh.grid import StructuredMesh
from dealii_asm_tpu_torch.precond.asm import (ASMPreconditioner,
                                              axis_weight, ras_axis_mask)

MESHES = [(3, 4, 5), (5, 7, 13)]
# (p, overlap) with 2 <= overlap <= p
OVERLAPS = [(2, 2), (3, 2), (3, 3), (4, 2), (4, 3)]


def _dofs(cells, p):
    """(JAX DofHandler, port DofHandler) of the same lattice."""
    return (JaxDofHandler(JaxMesh(3, cells), p),
            DofHandler(StructuredMesh(3, cells), p))


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(b).max()


def _apply_both(cells, p, overlap, wt, seed):
    jdofs, dofs = _dofs(cells, p)
    jasm = JaxASM(jdofs, n_overlap=overlap, weighting_type=wt,
                  dtype=jnp.float64)
    x = np.random.default_rng(seed).standard_normal(dofs.n_dofs)
    ref = np.asarray(jasm.vmult(jnp.asarray(x)))
    asm = ASMPreconditioner(dofs, n_overlap=overlap, weighting_type=wt,
                            device="cpu")
    return jasm, asm, x, ref


# every weighting on the small mesh, symm also on the ragged larger one
CASES = [((3, 4, 5), p, o, wt) for p, o in OVERLAPS
         for wt in ("none", "pre", "post", "symm")]
CASES += [((5, 7, 13), p, o, "symm") for p, o in OVERLAPS]


@pytest.mark.parametrize("cells,p,overlap,wt", CASES)
def test_overlap_apply_matches_jax(cells, p, overlap, wt):
    jasm, asm, x, ref = _apply_both(cells, p, overlap, wt, 10 * p + overlap)
    assert asm.is_symmetric == (wt in ("none", "symm")) and not asm.fused
    assert _rel(asm.vmult(torch.as_tensor(x)).numpy(), ref) < 1e-12
    for d in range(3):
        np.testing.assert_array_equal(asm.percoord[d][0],
                                      np.asarray(jasm.percoord[d][0]))
        np.testing.assert_array_equal(asm.percoord[d][1],
                                      np.asarray(jasm.percoord[d][1]))
        np.testing.assert_array_equal(
            axis_weight(asm.dofs.nodes_per_dim[d], cells[d], p, overlap),
            jasm._axis_free_and_weight(d)[1])


@pytest.mark.parametrize("cells", MESHES)
@pytest.mark.parametrize("p,overlap", [(1, 1), (2, 1), (2, 2), (3, 2),
                                       (3, 3), (4, 3)])
def test_ras_apply_and_mask_match_jax(cells, p, overlap):
    jasm, asm, x, ref = _apply_both(cells, p, overlap, "ras", 40 + p)
    assert not asm.is_symmetric and not asm.fused
    assert _rel(asm.vmult(torch.as_tensor(x)).numpy(), ref) < 1e-12
    masks = [ras_axis_mask(asm.dofs.free_1d(d), cells[d], p, overlap)
             for d in range(3)]
    for mine, factored in zip(masks, ras_axis_masks(jasm.ras_mask, cells)):
        np.testing.assert_array_equal(mine, factored)
    mx, my, mz = masks
    m = p - 1 + 2 * overlap
    prod = (mz[:, None, None, :, None, None] * my[None, :, None, None, :, None]
            * mx[None, None, :, None, None, :])
    np.testing.assert_array_equal(
        prod.reshape(-1, m ** 3), np.asarray(jasm._ras_ownership(
            jasm._patch_idx_np)))


@pytest.mark.parametrize("p,overlap,wt", [(3, 2, "symm"), (4, 3, "post"),
                                          (3, 2, "ras")])
def test_interop_carries_overlap_and_ras_tables(p, overlap, wt):
    jasm, _, x, ref = _apply_both((3, 4, 5), p, overlap, wt, 70 + p)
    via_jax = asm_from_jax(jasm, device="cpu")
    assert via_jax.n_overlap == overlap and via_jax.weighting_type == wt
    assert (via_jax.ras_masks is None) == (wt != "ras")
    assert _rel(via_jax.vmult(torch.as_tensor(x)).numpy(), ref) < 1e-12


@pytest.mark.parametrize("p,overlap,wt", [(3, 2, "symm"), (3, 1, "ras"),
                                          (4, 3, "ras")])
def test_float32_apply(p, overlap, wt):
    jasm, _, x, ref = _apply_both((5, 7, 13), p, overlap, wt, 80 + p)
    asm = ASMPreconditioner(DofHandler(StructuredMesh(3, (5, 7, 13)), p),
                            n_overlap=overlap, weighting_type=wt,
                            dtype=torch.float32, device="cpu")
    y = asm.vmult(torch.as_tensor(x, dtype=torch.float32))
    assert y.dtype == torch.float32
    assert _rel(y.numpy(), ref) < 1e-5


def test_options_outside_the_lattice_form_raise():
    dofs = DofHandler(StructuredMesh(3, (2, 2, 2)), 2)
    with pytest.raises(ValueError, match="n overlap 3"):
        ASMPreconditioner(dofs, n_overlap=3, device="cpu")
    with pytest.raises(ValueError, match="weighting"):
        ASMPreconditioner(dofs, weighting_type="sym", device="cpu")


@pytest.mark.parametrize("p,overlap,wt,fused", [
    (2, 1, "post", True), (2, 1, "ras", False), (2, 2, "symm", False),
    (3, 2, "ras", False), (1, 2, "symm", True), (1, 2, "ras", False)])
def test_fused_kernels_attach_to_overlap_one_only(p, overlap, wt, fused,
                                                   monkeypatch):
    """Kernels B, C and D tile overlap-1 windows with per-node folds: the
    factory attaches the fused step to such a level only.  A degree-1
    level clamps overlap 2 to 1 (``factory.py:261``) and keeps them unless
    it is RAS.  The level's device is set to CUDA by hand: attaching
    launches nothing."""
    from types import SimpleNamespace

    from dealii_asm_tpu_torch.ops.laplace import LaplaceOperator
    from dealii_asm_tpu_torch.precond import factory

    monkeypatch.delenv("DEALII_ASM_TPU_CHAIN_DEGREES", raising=False)
    dofs = DofHandler(StructuredMesh(3, (3, 2, 2)), p)
    op = LaplaceOperator(dofs, dtype=torch.float32, device="cpu")
    asm = factory.create_system_preconditioner(
        op, {"type": "FDM", "n overlap": overlap, "weighting type": wt})
    assert asm.n_overlap == min(overlap, p) and asm.fused == fused
    level = SimpleNamespace(device=torch.device("cuda"), tables=op.tables,
                            dtype=op.dtype)
    smoother = SimpleNamespace(fused_step=None, degree=1)
    factory._try_attach_fused_step(smoother, level, asm)
    assert (smoother.fused_step is not None) == fused
