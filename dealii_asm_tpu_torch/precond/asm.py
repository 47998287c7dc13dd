"""Additive Schwarz preconditioner with FDM local solves (PyTorch).

Counterpart of ``dealii_asm_tpu/precond/asm.py::ASMPreconditioner`` for
element-centric overlap-1 patches on structured meshes, in two forms:

- ``ASMPreconditioner``, uniform Cartesian meshes: the ``global_fdm`` form
  (``asm.py:287-313``, ``_vmult_global_fdm`` :527), whose tables come
  straight from the per-coordinate 1D eigenproblems
  (``precond/fdm.py::percoord_eigendecomposition``) in O(N_d) per axis; the
  apply is kernel B (``kernels/fdm_patch.py``).
- ``CellASMPreconditioner``, deformed meshes whose 1D patch matrices do not
  factor per coordinate (``asm.py:188-217``, ``:320-343``, ``:611-628``): one
  eigen-table per cell and direction, deduplicated by key, and the apply as
  batched per-cell (m × m) products in plain torch, the JAX ``_fdm_apply``
  form (``asm.py:466-490``).  The JAX package applies these tables in XLA,
  not in a Pallas kernel.

In both, the multiplicity weights (none/pre/post/symm) and the Dirichlet
masks are separable per axis on the lattice, so they fold into per-axis
vectors (``fin``/``fout``).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..device import DEFAULT_DEVICE, resolve_device
from ..kernels.fdm_patch import FDMTables, fdm_patch
from ..ops.laplace import check_structured_3d
from ..ops.lattice import cells_to_grid_sliced, grid_to_cells_sliced
from ..ops.tensorops import fdm_direction_transform, outer_grid
from .fdm import (FDMCollection, batched_generalized_eigh,
                  fdm_1d_matrices_batched, percoord_eigendecomposition)

_FOLD_EXPONENTS = {"none": (0.0, 0.0), "pre": (1.0, 0.0),
                   "post": (0.0, 1.0), "symm": (0.5, 0.5)}


def axis_weight(n_nodes: int, n_cells: int, degree: int) -> np.ndarray:
    """1D multiplicity weight of element windows along one axis
    (``asm.py:382``); the node weights are the tensor product ⊗_d w_d."""
    counts = np.zeros(n_nodes)
    for c in range(n_cells):
        counts[c * degree: c * degree + degree + 1] += 1.0
    counts[counts == 0] = 1.0
    return 1.0 / counts


def _check_options(weighting_type: str, n_overlap: int) -> None:
    if weighting_type not in _FOLD_EXPONENTS:
        raise NotImplementedError(
            f"weighting {weighting_type!r} is not ported yet "
            "(RAS: ROADMAP item 10)")
    if n_overlap != 1:
        raise NotImplementedError(
            f"n overlap {n_overlap}: the port has overlap 1 only "
            "(ROADMAP item 10)")


def _axis_folds(dofs, weighting_type: str, d: int):
    """(fin, fout) of direction d: free mask times the 1D multiplicity
    weight to the power the weighting gives each side."""
    a_in, a_out = _FOLD_EXPONENTS[weighting_type]
    free = dofs.free_1d(d)
    w = axis_weight(dofs.nodes_per_dim[d], dofs.mesh.n_cells[d], dofs.degree)
    return free * w ** a_in, free * w ** a_out


class ASMPreconditioner(nn.Module):
    """Element-centric overlap-1 additive Schwarz with FDM local solves.

    ``percoord`` (optional): per-direction (V (C_d, m, m), λ (C_d, m)) NumPy
    tables; by default they are built here (``interop.py`` passes the JAX
    ones).
    """

    is_symmetric = True

    def __init__(self, dofs, n_overlap: int = 1, weighting_type: str = "post",
                 dtype=torch.float64, device=DEFAULT_DEVICE, percoord=None):
        super().__init__()
        _check_options(weighting_type, n_overlap)
        check_structured_3d(dofs)
        if dofs.mesh.transform is not None:
            raise ValueError("a deformed mesh takes CellASMPreconditioner")
        self.dofs = dofs
        self.dim = dofs.mesh.dim
        self.degree = dofs.degree
        self.weighting_type = weighting_type
        self.is_symmetric = weighting_type in ("none", "symm")
        self.dtype = dtype
        self.device = resolve_device(device)
        mesh = dofs.mesh
        p = self.degree
        if percoord is None:
            percoord = percoord_eigendecomposition(mesh, p, n_overlap)
        self.percoord = [(np.asarray(V, np.float64), np.asarray(l, np.float64))
                         for V, l in percoord]
        names = ("V", "lam", "fin", "fout", "G", "Gt")
        lam_flat = []
        for d in range(self.dim):
            V, lam = self.percoord[d]
            fin, fout = _axis_folds(dofs, weighting_type, d)
            G = fdm_direction_transform(V, dofs.nodes_per_dim[d], p,
                                        n_overlap, False)
            for name, arr in zip(names, (V, lam, fin, fout, G * fin[None, :],
                                         (G * fout[None, :]).T)):
                self.register_buffer(f"{name}{d}", self._tensor(arr))
            lam_flat.append(getattr(self, f"lam{d}").reshape(-1))
        lx, ly, lz = lam_flat
        denom = lx[None, None, :] + ly[None, :, None] + lz[:, None, None]
        self.register_buffer("inv_denom", 1.0 / denom)
        per = {name: [getattr(self, f"{name}{d}") for d in range(self.dim)]
               for name in names}
        self.tables = FDMTables(per["V"], per["lam"], per["fin"], per["fout"],
                                per["G"], per["Gt"], self.inv_denom,
                                tuple(reversed(mesh.n_cells)), p)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.tensor(np.ascontiguousarray(a), dtype=self.dtype,
                            device=self.device)

    @property
    def global_fdm(self):
        """(Gs, Gts, lams) as the JAX class exposes them (plain-path tables)."""
        return (self.tables.G, self.tables.Gt,
                [l.reshape(-1) for l in self.tables.lam])

    def vmult(self, src: torch.Tensor) -> torch.Tensor:
        if src.dtype == self.dtype:
            return fdm_patch(src, self.tables)
        return fdm_patch(src.to(self.dtype), self.tables).to(src.dtype)

    def forward(self, src):
        return self.vmult(src)


def element_fdm_collection(extents: np.ndarray, has_lower: np.ndarray,
                           has_upper: np.ndarray, degree: int,
                           n_overlap: int = 1) -> FDMCollection:
    """Per-direction eigen-tables of the element patches of every cell,
    deduplicated by key (``asm.py:188-217`` with the batched builder of
    ``_dedup_collection``): the keys are the rounded harmonic patch
    ``extents`` (C, dim, 3) [lower, own, upper] and the neighbour flags
    ``has_lower``/``has_upper`` (C, dim)."""
    keys = np.concatenate([np.round(extents, 12),
                           np.asarray(has_lower, np.float64)[:, :, None],
                           np.asarray(has_upper, np.float64)[:, :, None]],
                          axis=2)
    eigvecs, eigvals = [], []
    ids = np.zeros(keys.shape[:2], dtype=np.int32)
    for d in range(keys.shape[1]):
        uniq, inv = np.unique(keys[:, d, :], axis=0, return_inverse=True)
        ids[:, d] = np.asarray(inv).reshape(-1)
        M, K = fdm_1d_matrices_batched(degree, n_overlap, uniq[:, 0:3],
                                       uniq[:, 3] > 0.5, uniq[:, 4] > 0.5)
        lam, V = batched_generalized_eigh(K, M)
        eigvecs.append(V)
        eigvals.append(lam)
    return FDMCollection(eigvecs, eigvals, ids)


def cell_fdm_tables(collection: FDMCollection, dtype, device):
    """Per-cell tables of a deduplicated collection on ``device``: V[d]
    (C, m, m) per direction (x first) and inv_denom (C, m, m, m), the
    reciprocal eigenvalue sums, all in ``dtype``."""
    ids = np.asarray(collection.ids)
    V, lams = [], []
    for d in range(ids.shape[1]):
        for tabs, out in ((collection.eigvecs, V), (collection.eigvals, lams)):
            out.append(torch.tensor(np.asarray(tabs[d], np.float64)[ids[:, d]],
                                    dtype=dtype, device=device))
    lx, ly, lz = lams
    return V, 1.0 / (lz[:, :, None, None] + ly[:, None, :, None]
                     + lx[:, None, None, :])


def cell_fdm_apply(u: torch.Tensor, V: list, inv_denom: torch.Tensor):
    """Batched tensor-product patch inverses: u (C, m, m, m) as [z, y, x],
    V[d] (C, m, m) as [node, mode] per direction (x first), inv_denom
    (C, m, m, m) the reciprocal eigenvalue sums."""
    Vx, Vy, Vz = V
    u = torch.einsum("czyx,cxk->czyk", u, Vx)
    u = torch.einsum("czyx,cyk->czkx", u, Vy)
    u = torch.einsum("czyx,czk->ckyx", u, Vz)
    u = u * inv_denom
    u = torch.einsum("czyk,cxk->czyx", u, Vx)
    u = torch.einsum("czkx,cyk->czyx", u, Vy)
    return torch.einsum("ckyx,czk->czyx", u, Vz)


class CellASMPreconditioner(nn.Module):
    """Element-centric overlap-1 additive Schwarz with per-cell FDM local
    solves, for deformed meshes.

    ``collection`` (optional): the NumPy ``FDMCollection`` (eigvecs[d]
    (U_d, m, m), eigvals[d] (U_d, m), ids (C, dim)); by default it is built
    here (``interop.py`` passes the JAX one).
    """

    def __init__(self, dofs, n_overlap: int = 1, weighting_type: str = "post",
                 dtype=torch.float64, device=DEFAULT_DEVICE, collection=None):
        super().__init__()
        _check_options(weighting_type, n_overlap)
        check_structured_3d(dofs)
        self.dofs = dofs
        self.dim = dofs.mesh.dim
        self.degree = dofs.degree
        self.weighting_type = weighting_type
        self.is_symmetric = weighting_type in ("none", "symm")
        self.dtype = dtype
        self.device = resolve_device(device)
        mesh = dofs.mesh
        if collection is None:
            nbr = mesh.neighbors()
            collection = element_fdm_collection(
                mesh.harmonic_patch_extents(self.degree + 1),
                nbr[:, :, 0] >= 0, nbr[:, :, 1] >= 0, self.degree, n_overlap)
        self.collection = collection
        V, inv_denom = cell_fdm_tables(collection, dtype, self.device)
        for d, Vd in enumerate(V):
            self.register_buffer(f"V{d}", Vd)
        self.register_buffer("inv_denom", inv_denom)
        folds = [_axis_folds(dofs, weighting_type, d) for d in range(self.dim)]
        for k, name in enumerate(("fin", "fout")):
            self.register_buffer(name, outer_grid(
                [self._tensor(f[k]) for f in folds]))
        self.grid_shape = tuple(reversed(dofs.nodes_per_dim))

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.tensor(np.ascontiguousarray(a), dtype=self.dtype,
                            device=self.device)

    def vmult(self, src: torch.Tensor) -> torch.Tensor:
        """x·w → element windows → ⊗Vᵀ → 1/Σλ → ⊗V → overlap-add → ·w."""
        x = src.to(self.dtype).reshape(self.grid_shape) * self.fin
        p, m = self.degree, self.degree + 1
        W = grid_to_cells_sliced(x, p).reshape(-1, m, m, m)
        y = cell_fdm_apply(W, [self.V0, self.V1, self.V2], self.inv_denom)
        y = cells_to_grid_sliced(y.reshape(-1, m ** 3), self.dofs.mesh.n_cells,
                                 p) * self.fout
        return y.reshape(-1).to(src.dtype)

    def forward(self, src):
        return self.vmult(src)
