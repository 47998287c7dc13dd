"""Vertex-star patches on every mesh, and element overlap 2..p and RAS on
deformed and unstructured meshes, against the JAX package's
ASMPreconditioner and GeneralASMPreconditioner.

Forms (the port runs each on CPU tensors as on the card):
- Cartesian vertex patches: ``ASMPreconditioner(patch_type="vertex")``,
  the plain global form (JAX: its global FDM, or its gather form for RAS);
- Kershaw vertex patches and element overlap 2..p:
  ``CellASMPreconditioner``, per-patch tables on strided windows of the
  node grid (JAX: its index-gather and lane forms);
- ball vertex patches and element overlap 2..p:
  ``GeneralASMPreconditioner``, a gather through the patch table and a
  fixed-order scatter (JAX: its lane form with an atomic scatter-add); its
  applies are held in tests/test_torch_asm_vertex_ball.py, its interop and
  factory here.

Each with the weightings none, pre, post, symm and ras.  Tolerances: float64
rel 1e-12 (relative to max |y|) against the JAX float64 vmult, the same
local solves summed in another order (observed ~5e-16); float32 rel 1e-5
against the same reference (float32 rounding); two applies bit-identical.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dealii_asm_tpu.fem.dofs import DofHandler as JaxDofHandler
from dealii_asm_tpu.mesh.grid import StructuredMesh as JaxMesh
from dealii_asm_tpu.precond.asm import ASMPreconditioner as JaxASM
from dealii_asm_tpu.precond.asm_general import \
    GeneralASMPreconditioner as JaxGeneralASM
from dealii_asm_tpu_torch.fem.dofs import DofHandler
from dealii_asm_tpu_torch.interop import asm_from_jax, general_asm_from_jax
from dealii_asm_tpu_torch.mesh.grid import StructuredMesh
from dealii_asm_tpu_torch.precond.asm import (ASMPreconditioner,
                                              CellASMPreconditioner)
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


def _structured(cells, p, kershaw):
    from dealii_asm_tpu.mesh.transforms import kershaw_transform as jk
    from dealii_asm_tpu_torch.mesh.transforms import kershaw_transform

    return (JaxDofHandler(JaxMesh(3, cells, transform=jk(0.3, 0.3)
                                  if kershaw else None), p),
            DofHandler(StructuredMesh(3, cells, transform=kershaw_transform(
                0.3, 0.3) if kershaw else None), p))


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


@pytest.mark.parametrize("p", [1, 2, 3, 4])
@pytest.mark.parametrize("wt", WEIGHTINGS)
def test_cartesian_vertex_apply_matches_jax(p, wt):
    jdofs, dofs = _structured((3, 4, 5), p, False)
    jasm = JaxASM(jdofs, weighting_type=wt, patch_type="vertex",
                  dtype=jnp.float64)
    asm = _check_apply(lambda dt: ASMPreconditioner(
        dofs, weighting_type=wt, patch_type="vertex", dtype=dt,
        device="cpu"), jasm, dofs.n_dofs, 10 * p)
    assert not asm.fused and asm.is_symmetric == (wt in ("none", "symm"))
    assert asm.inv_denom.shape == (4 * (2 * p - 1), 3 * (2 * p - 1),
                                   2 * (2 * p - 1))


# (p, cells) on the Kershaw mesh; every p's vertex patches and element
# overlaps 2..p
KERSHAW = [(1, (4, 3, 3)), (2, (3, 3, 2)), (4, (2, 3, 2))]
KERSHAW_FORMS = [(p, cells, patch, o) for p, cells in KERSHAW
                 for patch, o in [("vertex", 1)]
                 + [("element", o) for o in range(2, p + 1)]]


@pytest.mark.parametrize("p,cells,patch,overlap", KERSHAW_FORMS)
@pytest.mark.parametrize("wt", WEIGHTINGS)
def test_kershaw_patches_match_jax(p, cells, patch, overlap, wt):
    jdofs, dofs = _structured(cells, p, True)
    jasm = JaxASM(jdofs, n_overlap=overlap, weighting_type=wt,
                  patch_type=patch, dtype=jnp.float64)
    assert jasm.global_fdm is None
    asm = _check_apply(lambda dt: CellASMPreconditioner(
        dofs, n_overlap=overlap, weighting_type=wt, patch_type=patch,
        dtype=dt, device="cpu"), jasm, dofs.n_dofs, 20 * p + overlap)
    np.testing.assert_array_equal(asm.collection.ids, jasm.collection.ids)
    for d in range(3):
        np.testing.assert_allclose(asm.collection.eigvals[d],
                                   np.asarray(jasm.collection.eigvals[d]),
                                   rtol=1e-13, atol=0)
    if wt == "ras":
        np.testing.assert_array_equal(asm.ras_mask.numpy(),
                                      np.asarray(jasm.ras_mask))


@pytest.mark.parametrize("mesh,patch,overlap,wt", [
    ("cartesian", "vertex", 1, "symm"), ("cartesian", "vertex", 1, "ras"),
    ("kershaw", "vertex", 1, "ras"), ("kershaw", "element", 2, "ras"),
    ("kershaw", "element", 3, "post"), ("ball", "vertex", 1, "symm"),
    ("ball", "element", 2, "ras")])
def test_interop_carries_vertex_and_overlap_preconditioners(mesh, patch,
                                                            overlap, wt):
    """asm_from_jax and general_asm_from_jax carry the JAX tables across:
    the per-coordinate ones (Cartesian, RAS factored per axis), else the
    collection and RAS mask; the applies agree to 1e-12."""
    if mesh == "ball":
        jdofs, _ = _ball(0, 3)
        jasm = JaxGeneralASM(jdofs, n_overlap=overlap, weighting_type=wt,
                             patch_type=patch, dtype=jnp.float64)
        via_jax = general_asm_from_jax(jasm, device="cpu")
        cls = GeneralASMPreconditioner
    else:
        jdofs, _ = _structured((3, 3, 4), 3, mesh == "kershaw")
        jasm = JaxASM(jdofs, n_overlap=overlap, weighting_type=wt,
                      patch_type=patch, dtype=jnp.float64)
        via_jax = asm_from_jax(jasm, device="cpu")
        cls = CellASMPreconditioner if mesh == "kershaw" else ASMPreconditioner
    assert isinstance(via_jax, cls)
    assert (via_jax.patch_type, via_jax.weighting_type) == (patch, wt)
    x = np.random.default_rng(50 + overlap).standard_normal(
        jdofs.n_dofs)
    ref = np.asarray(jasm.vmult(jnp.asarray(x)))
    assert _rel(via_jax.vmult(torch.as_tensor(x)).numpy(), ref) < 1e-12


@pytest.mark.parametrize("mesh", ["cartesian", "kershaw", "ball"])
def test_factory_builds_vertex_patches_and_keeps_them_off_b_c_d(mesh,
                                                                  monkeypatch):
    """"element centric": false reaches the vertex-patch form of each
    mesh's class; a vertex level never takes kernels B, C or D (the JAX
    Pallas FDM kernel refuses vertex patches, ``fdm_slab.py:151-154``).
    The level's device is set to CUDA by hand: attaching launches
    nothing."""
    from types import SimpleNamespace

    from dealii_asm_tpu_torch.ops.laplace import LaplaceOperator
    from dealii_asm_tpu_torch.ops.laplace_general import \
        GeneralLaplaceOperator
    from dealii_asm_tpu_torch.precond import factory

    monkeypatch.setenv("DEALII_ASM_TPU_CHAIN_DEGREES", "1")
    if mesh == "ball":
        _, dofs = _ball(0, 2)
        op = GeneralLaplaceOperator(dofs, dtype=torch.float32, device="cpu")
        cls = GeneralASMPreconditioner
    else:
        _, dofs = _structured((6, 6, 6) if mesh == "kershaw" else (3, 3, 4),
                              2, mesh == "kershaw")
        op = LaplaceOperator(dofs, dtype=torch.float32, device="cpu")
        cls = CellASMPreconditioner if mesh == "kershaw" else ASMPreconditioner
    for wt in WEIGHTINGS:
        fdm = factory.create_system_preconditioner(
            op, {"type": "FDM", "element centric": False,
                 "weighting type": wt})
        assert isinstance(fdm, cls) and fdm.patch_type == "vertex"
        assert fdm.weighting_type == wt and fdm.dtype == torch.float32
        assert not getattr(fdm, "fused", False)
        level = SimpleNamespace(device=torch.device("cuda"), tables=op.tables,
                                dtype=op.dtype)
        smoother = SimpleNamespace(fused_step=None, degree=1)
        factory._try_attach_fused_step(smoother, level, fdm)
        assert smoother.fused_step is None
    if mesh == "cartesian":
        assert ASMPreconditioner(dofs, device="cpu").fused
