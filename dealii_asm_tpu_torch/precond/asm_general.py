"""Additive Schwarz with FDM local solves on unstructured meshes (PyTorch).

Counterpart of ``dealii_asm_tpu/precond/asm_general.py::
GeneralASMPreconditioner``, the hyperball's smoother, for element patches of
overlap 1..p and vertex-star patches:

- element overlap 1: the patch of a cell is its own DoF lattice
  (``asm_general.py:94-97``), gathered through the orientation-baked
  ``cell_dofs``;
- element overlap 2..p: the (p − 1 + 2·o)³ window reaches into the
  neighbours through composed face maps
  (``fem/general_patches.py::general_element_patch_indices``);
- vertex stars: the (2p − 1)³ interior nodes of the cells around each
  interior vertex, in its anchor cell's frame
  (``general_vertex_patch_indices``), with the two cell widths per axis as
  the 1D keys.

The local solves are per-patch tensor-product FDM inverses from the
deduplicated 1D eigenproblems (``:44-90``), applied by ``cell_fdm_apply`` as
for deformed structured meshes.  Multiplicity weights count each DoF's
patches; Dirichlet DoFs go to a sentinel slot that reads zero and is
dropped on the way back (``:94-114``); RAS keeps each DoF's value from the
lowest-index patch that holds it (``:114-121``).  The scatter sums in a
fixed order (``ops/fixed_sum.py``).  The JAX package applies all of this in
XLA, not in a Pallas kernel.

While tracing is on (``utils/profiling.py``) each apply marks two
spans: "asm.gather" (the patch gather through ``patch_idx``) and
"asm.scatter" (the fixed-order scatter); the per-patch solves between
them stay in the smoothing span around the apply.  A subclass that
replaces ``local_solves`` (the access study's chunked ``GatherASM``)
keeps only the scatter's.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..device import DEFAULT_DEVICE, resolve_device
from ..fem.general_patches import (general_element_patch_indices,
                                   general_vertex_patch_indices)
from ..ops.fixed_sum import FixedOrderSum
from ..utils.profiling import span
from .asm import (_check_options, element_fdm_collection, patch_apply,
                  ras_ownership, register_patch_tables,
                  vertex_fdm_collection, work_dtype)
from .fdm import NoVertexPatches


class GeneralASMPreconditioner(nn.Module):
    """Additive (or restricted) Schwarz with per-patch FDM local solves on a
    ``GeneralDofHandler``: element patches of overlap 1..p, or vertex-star
    patches (``patch_type="vertex"``); weighting none, pre, post, symm or
    ras.

    ``collection`` (optional): the NumPy ``FDMCollection`` (eigvecs[d]
    (U_d, m, m), eigvals[d] (U_d, m), ids (P, dim)); ``ras_mask``
    (optional): the (P, m³) RAS mask; by default both are built here
    (``interop.py`` passes the JAX ones).  ``patch_idx`` (optional, with
    ``collection``): the (P, m^dim) patch index table itself, constrained
    and missing entries n_dofs (the access study's Cartesian element
    patches, ``models/variant_bench.py``).
    """

    def __init__(self, dofs, n_overlap: int = 1, weighting_type: str = "post",
                 dtype=torch.float64, device=DEFAULT_DEVICE, collection=None,
                 patch_type: str = "element", ras_mask=None, patch_idx=None):
        super().__init__()
        mesh = dofs.mesh
        self.dofs = dofs
        self.dim = mesh.dim
        self.degree = p = dofs.degree
        n_overlap = min(n_overlap, p)
        _check_options(weighting_type, n_overlap, p, patch_type)
        self.n_overlap = n_overlap
        self.patch_type = patch_type
        self.m = 2 * p - 1 if patch_type == "vertex" else p - 1 + 2 * n_overlap
        self.weighting_type = weighting_type
        self.is_symmetric = weighting_type in ("none", "symm")
        self.dtype = dtype
        self.device = resolve_device(device)
        n = dofs.n_dofs
        if patch_idx is not None:
            idx = patch_idx
        elif patch_type == "vertex":
            idx, extents = general_vertex_patch_indices(dofs)
            if idx.shape[0] == 0:
                raise NoVertexPatches(
                    f"{mesh.n_cells_total} cells at degree {p}: no interior "
                    "vertex, so no vertex patch")
            if collection is None:
                collection = vertex_fdm_collection(extents, p)
        else:
            if n_overlap == 1:
                idx = dofs.cell_dofs.astype(np.int64)
                idx = np.where(dofs.boundary_mask[idx], n, idx)
            else:
                idx = general_element_patch_indices(dofs, n_overlap)
            if collection is None:
                nbr = mesh.face_neighbors()  # face 2d+s
                collection = element_fdm_collection(
                    mesh.harmonic_patch_extents(p + 1), nbr[:, 0::2] >= 0,
                    nbr[:, 1::2] >= 0, p, n_overlap)
        idx = idx.astype(np.int64)
        self.collection = collection
        register_patch_tables(self, collection)

        counts = np.bincount(idx.reshape(-1), minlength=n + 1)[:n].astype(
            np.float64)
        counts[counts == 0] = 1.0
        w = 1.0 / counts
        self.register_buffer("weights", torch.tensor(
            np.sqrt(w) if weighting_type == "symm" else w, dtype=dtype,
            device=self.device))
        if weighting_type == "ras" and ras_mask is None:
            ras_mask = ras_ownership(idx, n)
        self.ras_mask = (None if ras_mask is None else torch.tensor(
            np.asarray(ras_mask), dtype=dtype, device=self.device))
        self.register_buffer("patch_idx", torch.as_tensor(idx,
                                                          device=self.device))
        self._scatter = FixedOrderSum(self.patch_idx, n)

    def vmult(self, src: torch.Tensor) -> torch.Tensor:
        """x·w → gather → ⊗Vᵀ → 1/Σλ → ⊗V → (RAS mask) → scatter-add → ·w."""
        dt = work_dtype(self.dtype, src)
        x = src.to(dt)
        w = self.weights.to(dt)
        if self.weighting_type in ("pre", "symm"):
            x = x * w
        y = self.local_solves(torch.cat([x, x.new_zeros(1)]), dt)
        if self.ras_mask is not None:
            y = y.reshape(self.ras_mask.shape) * self.ras_mask.to(dt)
        with span("asm.scatter"):
            dst = self._scatter(y)
        if self.weighting_type in ("post", "symm"):
            dst = dst * w
        return dst.to(src.dtype)

    def local_solves(self, xpad: torch.Tensor, dt) -> torch.Tensor:
        """The (P, m, ..., m) patch solves of the zero-slot padded vector."""
        with span("asm.gather"):
            W = xpad[self.patch_idx].reshape((-1,) + (self.m,) * self.dim)
        return patch_apply(self, W, dt)

    def forward(self, src):
        return self.vmult(src)
