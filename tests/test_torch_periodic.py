"""Periodic structured meshes in the port against the JAX package.

Inputs come from a seeded numpy generator and go to both packages; the port
runs its plain PyTorch paths on CPU tensors, the paths it also runs on the
card for periodic meshes (kernels A–E refuse them, as the JAX kernels do:
the gate tests below hold that on the CPU).

Cases: dim 2 and 3, p = 1..4, cells (2, 2, 2), (3, 1, 1) and (4, 2, 2)
(their first two in 2D), every axis periodic, and one mesh periodic in x
only.  A 1-cell periodic axis has N = p nodes: 2p + 1 band offsets alias
(the operator must count each column once) and a patch window wraps onto
itself.

Tolerances:
- host tables (node points, masks, extents, patch tables, assembled 1D
  factors): equal entry by entry;
- float64 operator: rel 1e-12 (max norm) against the JAX
  ``kernel="banded"`` path (the CPU float64 oracle: the default path is a
  double-single composition that XLA:CPU degrades to ~3e-8); the inverse
  diagonal rel 1e-14 (the same outer products in the same order);
- null space: constants are the operator's null space on a fully periodic
  box, so Σ_i (A x)_i = (A 1)·x is rounding only: below 2e-14·‖A x‖₁;
- float32 operator: rel 1e-5 against the JAX float32 vmult (its dense
  separable form: float32 rounding of the same products in another order);
- float64 FDM Schwarz applies (element overlap 1 and 2, vertex patches;
  none/pre/post/symm/RAS, symm and RAS alone at p = 4): rel 1e-12 against
  the JAX ``ASMPreconditioner``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dealii_asm_tpu.fem.dofs import DofHandler as JaxDofHandler
from dealii_asm_tpu.fem.patches import (element_patch_indices as jax_element,
                                        vertex_patch_indices as jax_vertex)
from dealii_asm_tpu.mesh.grid import StructuredMesh as JaxMesh
from dealii_asm_tpu.ops.laplace import LaplaceOperator as JaxLaplace
from dealii_asm_tpu.precond.asm import ASMPreconditioner as JaxASM
from dealii_asm_tpu_torch.fem.dofs import DofHandler
from dealii_asm_tpu_torch.fem.patches import (element_patch_indices,
                                              vertex_patch_indices)
from dealii_asm_tpu_torch.kernels.banded_laplace import banded_laplace_plain
from dealii_asm_tpu_torch.mesh.grid import StructuredMesh
from dealii_asm_tpu_torch.ops.laplace import LaplaceOperator
from dealii_asm_tpu_torch.ops.lattice import (axis_firsts, grid_to_windows,
                                              window_layout, windows_to_grid)
from dealii_asm_tpu_torch.precond.asm import ASMPreconditioner
from dealii_asm_tpu_torch.precond.factory import _try_attach_fused_step
from dealii_asm_tpu_torch.solvers.chebyshev import (ChebyshevPreconditioner,
                                                    EigenvalueInfo)

CELLS_3D = [(2, 2, 2), (3, 1, 1), (4, 2, 2)]
CASES = [(3, c, p) for c in CELLS_3D for p in range(1, 5)]
CASES += [(2, c[:2], p) for c in CELLS_3D[:2] for p in range(1, 5)]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test process (see tests/test_torch_gmres.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dofs(dim, cells, p, periodic=None):
    """(JAX DofHandler, port DofHandler) of the same periodic lattice."""
    per = periodic or (True,) * dim
    return (JaxDofHandler(JaxMesh(dim, cells, periodic=per), p),
            DofHandler(StructuredMesh(dim, cells, periodic=per), p))


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(b).max()


@pytest.mark.parametrize("periodic", [(True, True, True),
                                      (True, False, False)])
@pytest.mark.parametrize("cells,p", [((3, 1, 1), 2), ((4, 2, 2), 3)])
def test_host_tables_match_jax(cells, p, periodic):
    jdofs, dofs = _dofs(3, cells, p, periodic)
    assert dofs.nodes_per_dim == jdofs.nodes_per_dim
    np.testing.assert_array_equal(dofs.boundary_mask, jdofs.boundary_mask)
    np.testing.assert_array_equal(
        dofs.node_points(np.arange(dofs.n_dofs)), jdofs.points)
    free = np.ones(dofs.n_dofs, bool)
    for d in range(3):
        f = dofs.free_1d(d)
        assert f.all() == periodic[d]
        free &= (f[jdofs.node_multi_index[:, d]] > 0)
    np.testing.assert_array_equal(free, ~jdofs.boundary_mask)
    np.testing.assert_array_equal(dofs.mesh.harmonic_patch_extents(p + 1),
                                  jdofs.mesh.harmonic_patch_extents(p + 1))
    for o in range(1, p + 1):
        np.testing.assert_array_equal(element_patch_indices(dofs, o),
                                      jax_element(jdofs, o))
    if all(periodic):
        idx, anchors = vertex_patch_indices(dofs)
        jidx, janchors = jax_vertex(jdofs)
        np.testing.assert_array_equal(idx, jidx)
        np.testing.assert_array_equal(anchors, janchors)


@pytest.mark.parametrize("dim,cells,p", [c for c in CASES if c[2] > 1])
def test_windows_are_the_patch_tables(dim, cells, p):
    """The lattice's wrapped windows read the patch tables' nodes, and their
    overlap-add is the tables' scatter-add, for element overlap 1..p and
    vertex patches."""
    _, dofs = _dofs(dim, cells, p)
    n = dofs.n_dofs
    grid = torch.arange(n, dtype=torch.float64).reshape(
        tuple(reversed(dofs.nodes_per_dim)))
    rng = np.random.default_rng(p)
    kinds = [("element", o) for o in range(1, p + 1)]
    if dim == 3:
        kinds.append(("vertex", 1))
    for patch, o in kinds:
        idx = (vertex_patch_indices(dofs)[0] if patch == "vertex"
               else element_patch_indices(dofs, o))
        m, _ = window_layout(p, o, patch)
        first = axis_firsts(p, o, patch, dofs.mesh.periodic)
        per = dofs.mesh.periodic
        np.testing.assert_array_equal(
            grid_to_windows(grid, p, m, first, per).numpy(), idx)
        y = rng.standard_normal(idx.shape)
        ref = np.zeros(n)
        np.add.at(ref, idx.reshape(-1), y.reshape(-1))
        got = windows_to_grid(torch.as_tensor(y), grid.shape, p, m, first,
                              per).reshape(-1).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-13)


@pytest.mark.parametrize("dim,cells,p", CASES)
def test_f64_operator_and_diagonal_match_jax(dim, cells, p):
    jdofs, dofs = _dofs(dim, cells, p)
    jop = JaxLaplace(jdofs, dtype=jnp.float64, kernel="banded")
    op = LaplaceOperator(dofs, device="cpu")
    for d in range(dim):
        np.testing.assert_array_equal(op.M1d_global[d],
                                      np.asarray(jop.M1d_global[d]))
        np.testing.assert_array_equal(op.K1d_global[d],
                                      np.asarray(jop.K1d_global[d]))
        assert op.tables.offsets[d] == jop.band_offsets[d]
    x = np.random.default_rng(10 * p + dim).standard_normal(dofs.n_dofs)
    ref = np.asarray(jop.vmult(jnp.asarray(x)))
    got = op.vmult(torch.as_tensor(x)).numpy()
    assert _rel(got, ref) < 1e-12
    assert abs(got.sum()) < 2e-14 * np.abs(got).sum()
    assert abs(ref.sum()) < 2e-14 * np.abs(ref).sum()
    diag = op.compute_inverse_diagonal().numpy()
    np.testing.assert_allclose(diag, np.asarray(
        jop.compute_inverse_diagonal()), rtol=1e-14, atol=0)


@pytest.mark.parametrize("cells,p", [((2, 2, 2), 2), ((3, 1, 1), 3),
                                     ((4, 2, 2), 4)])
def test_f32_operator_matches_jax(cells, p):
    jdofs, dofs = _dofs(3, cells, p)
    x = np.random.default_rng(p).standard_normal(dofs.n_dofs).astype(
        np.float32)
    ref = np.asarray(JaxLaplace(jdofs, dtype=jnp.float32).vmult(
        jnp.asarray(x)))
    op = LaplaceOperator(dofs, dtype=torch.float32, device="cpu")
    got = op.vmult(torch.as_tensor(x))
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), ref) < 1e-5


def _asm_kinds(p):
    kinds = [("element", o) for o in (1, 2) if o <= p]
    return kinds + ([("vertex", 1)] if p > 1 else [])


@pytest.mark.parametrize("cells,p", [(c, p) for c in CELLS_3D
                                     for p in range(1, 5)])
def test_fdm_applies_match_jax(cells, p):
    jdofs, dofs = _dofs(3, cells, p)
    x = np.random.default_rng(p).standard_normal(dofs.n_dofs)
    weightings = ("symm", "ras") if p == 4 else ("none", "pre", "post",
                                                  "symm", "ras")
    for patch, o in _asm_kinds(p):
        for wt in weightings:
            jasm = JaxASM(jdofs, n_overlap=o, weighting_type=wt,
                          patch_type=patch, dtype=jnp.float64)
            asm = ASMPreconditioner(dofs, n_overlap=o, weighting_type=wt,
                                    patch_type=patch, device="cpu")
            assert not asm.fused
            ref = np.asarray(jasm.vmult(jnp.asarray(x)))
            got = asm.vmult(torch.as_tensor(x)).numpy()
            assert _rel(got, ref) < 1e-12, (patch, o, wt)


def test_periodic_meshes_take_no_kernel():
    """On a periodic 3D mesh the operator runs the plain banded form, the
    FDM apply is not kernel B's (``fused`` false), and the factory's gate
    attaches no fused step (kernels C and D) even on a CUDA operator; on
    the same mesh without periodicity all three take the kernels."""
    for periodic, fused in (((True, True, True), False),
                            ((False, True, False), False),
                            ((False, False, False), True)):
        dofs = DofHandler(StructuredMesh(3, (2, 3, 2), periodic=periodic), 2)
        op = LaplaceOperator(dofs, dtype=torch.float32, device="cpu")
        asm = ASMPreconditioner(dofs, dtype=torch.float32, device="cpu",
                                weighting_type="symm")
        assert (op._kernel is not banded_laplace_plain) == fused
        assert asm.fused == fused
        cheb = ChebyshevPreconditioner(op.vmult, asm.vmult, dofs.n_dofs,
                                       degree=1,
                                       eigenvalues=EigenvalueInfo(1, 1.2, 1),
                                       device="cpu")
        op.device = torch.device("cuda")  # the gate reads the device type
        _try_attach_fused_step(cheb, op, asm)
        assert (cheb.fused_step is not None) == fused


@pytest.mark.parametrize("cells,p,transform", [
    ((3, 1, 1), 2, False), ((4, 2, 2), 3, False), ((2, 2, 2), 2, True)])
def test_interop_carries_periodic_tables(cells, p, transform):
    """``interop.py`` drives the port with the JAX operator's 1D factors
    or merged geometry and the JAX preconditioner's per-coordinate or
    per-patch tables and RAS masks on periodic meshes; the RAS masks equal
    the port's own (``ras_axis_mask``) entry by entry."""
    from dealii_asm_tpu.mesh.transforms import sinusoidal_displacement
    from dealii_asm_tpu_torch.interop import (asm_from_jax, laplace_from_jax,
                                              ras_axis_masks)
    from dealii_asm_tpu_torch.precond.asm import ras_axis_mask

    tf = sinusoidal_displacement(0.1) if transform else None
    jdofs = JaxDofHandler(JaxMesh(3, cells, periodic=(True,) * 3,
                                  transform=tf), p)
    x = np.random.default_rng(p).standard_normal(jdofs.n_dofs)
    jop = JaxLaplace(jdofs, dtype=jnp.float64, kernel="banded")
    got = laplace_from_jax(jop, device="cpu").vmult(torch.as_tensor(x))
    assert _rel(got.numpy(), np.asarray(jop.vmult(jnp.asarray(x)))) < 1e-12
    for o, patch, wt in ((1, "element", "ras"), (2, "element", "symm"),
                         (1, "vertex", "ras"), (2, "element", "ras")):
        jasm = JaxASM(jdofs, n_overlap=o, weighting_type=wt,
                      patch_type=patch, dtype=jnp.float64)
        asm = asm_from_jax(jasm, device="cpu")
        ref = np.asarray(jasm.vmult(jnp.asarray(x)))
        assert _rel(asm.vmult(torch.as_tensor(x)).numpy(), ref) < 1e-12
        if wt == "ras" and not transform:
            for d, mask in enumerate(ras_axis_masks(
                    jasm.ras_mask, tuple(V.shape[0] for V, _ in asm.percoord))):
                np.testing.assert_array_equal(mask, ras_axis_mask(
                    asm.dofs.free_1d(d), cells[d], p, o, patch, True))
