"""Additive Schwarz with FDM local solves on unstructured meshes (PyTorch).

Counterpart of ``dealii_asm_tpu/precond/asm_general.py::
GeneralASMPreconditioner`` for element patches of overlap 1, the
hyperball's smoother: the patch of a cell is its own DoF lattice
(``asm_general.py:94-97``), gathered through the orientation-baked
``cell_dofs``; the local solves are per-cell tensor-product FDM inverses
from the deduplicated 1D eigenproblems of the harmonic patch extents
(``:69-90``), applied by ``cell_fdm_apply`` as for deformed structured
meshes.  Multiplicity weights count each DoF's patches; Dirichlet DoFs go to
a sentinel slot that reads zero and is dropped on the way back (``:94-114``).
The scatter sums in a fixed order (``ops/fixed_sum.py``).  The JAX package
applies all of this in XLA, not in a Pallas kernel.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..device import DEFAULT_DEVICE, resolve_device
from ..ops.fixed_sum import FixedOrderSum
from .asm import (_check_overlap_one, cell_fdm_apply, cell_fdm_tables,
                  element_fdm_collection)


class GeneralASMPreconditioner(nn.Module):
    """Element-centric overlap-1 additive Schwarz with per-cell FDM local
    solves on a ``GeneralDofHandler``; weighting none, pre, post or symm.

    ``collection`` (optional): the NumPy ``FDMCollection`` (eigvecs[d]
    (U_d, m, m), eigvals[d] (U_d, m), ids (C, dim)); by default it is built
    here (``interop.py`` passes the JAX one).
    """

    def __init__(self, dofs, n_overlap: int = 1, weighting_type: str = "post",
                 dtype=torch.float64, device=DEFAULT_DEVICE, collection=None):
        super().__init__()
        _check_overlap_one(weighting_type, n_overlap)
        mesh = dofs.mesh
        if mesh.dim != 3:
            raise NotImplementedError(
                f"dim {mesh.dim}: the port runs 3D meshes only (ROADMAP item 9)")
        self.dofs = dofs
        self.degree = p = dofs.degree
        self.m = p + 1
        self.weighting_type = weighting_type
        self.is_symmetric = weighting_type in ("none", "symm")
        self.dtype = dtype
        self.device = resolve_device(device)
        if collection is None:
            nbr = mesh.face_neighbors()  # face 2d+s
            collection = element_fdm_collection(
                mesh.harmonic_patch_extents(p + 1), nbr[:, 0::2] >= 0,
                nbr[:, 1::2] >= 0, p, n_overlap)
        self.collection = collection
        V, inv_denom = cell_fdm_tables(collection, dtype, self.device)
        for d, Vd in enumerate(V):
            self.register_buffer(f"V{d}", Vd)
        self.register_buffer("inv_denom", inv_denom)

        n = dofs.n_dofs
        mask = np.asarray(dofs.boundary_mask)
        idx = dofs.cell_dofs.astype(np.int64)
        idx = np.where(mask[idx], n, idx)  # Dirichlet DoFs → sentinel n
        counts = np.bincount(idx.reshape(-1), minlength=n + 1)[:n].astype(
            np.float64)
        counts[counts == 0] = 1.0
        w = 1.0 / counts
        self.register_buffer("weights", torch.tensor(
            np.sqrt(w) if weighting_type == "symm" else w, dtype=dtype,
            device=self.device))
        self.register_buffer("patch_idx", torch.as_tensor(idx,
                                                          device=self.device))
        self._scatter = FixedOrderSum(self.patch_idx, n)

    def vmult(self, src: torch.Tensor) -> torch.Tensor:
        """x·w → gather by cell_dofs → ⊗Vᵀ → 1/Σλ → ⊗V → scatter-add → ·w."""
        x = src.to(self.dtype)
        if self.weighting_type in ("pre", "symm"):
            x = x * self.weights
        xpad = torch.cat([x, x.new_zeros(1)])
        m = self.m
        W = xpad[self.patch_idx].reshape(-1, m, m, m)
        y = cell_fdm_apply(W, [self.V0, self.V1, self.V2], self.inv_denom)
        dst = self._scatter(y)
        if self.weighting_type in ("post", "symm"):
            dst = dst * self.weights
        return dst.to(src.dtype)

    def forward(self, src):
        return self.vmult(src)
