"""Additive Schwarz preconditioner with FDM local solves (PyTorch).

Counterpart of ``dealii_asm_tpu/precond/asm.py::ASMPreconditioner`` for
element-centric patches on structured meshes, in two forms:

- ``ASMPreconditioner``, uniform Cartesian meshes: the ``global_fdm`` form
  (``asm.py:287-313``, ``_vmult_global_fdm`` :527), whose tables come
  straight from the per-coordinate 1D eigenproblems
  (``precond/fdm.py::percoord_eigendecomposition``) in O(N_d) per axis.  At
  overlap 1 with a multiplicity weighting the apply is kernel B
  (``kernels/fdm_patch.py``).  Overlap 2..p (patch size m = p − 1 + 2·o,
  ``asm.py:195-216``) and restricted Schwarz (RAS, each node written only
  by the lowest-index patch that holds it, ``_ras_ownership`` :448) take
  the plain global form, six dense per-axis products, on every device, as
  the JAX package does (its Pallas kernel refuses them,
  ``ops/pallas/fdm_slab.py:151-154``).
- ``CellASMPreconditioner``, deformed meshes whose 1D patch matrices do not
  factor per coordinate (``asm.py:188-217``, ``:320-343``, ``:611-628``): one
  eigen-table per cell and direction, deduplicated by key, and the apply as
  batched per-cell (m × m) products in plain torch, the JAX ``_fdm_apply``
  form (``asm.py:466-490``), at overlap 1.  The JAX package applies these
  tables in XLA, not in a Pallas kernel.

In both, the multiplicity weights (none/pre/post/symm) and the Dirichlet
masks are separable per axis on the lattice, so they fold into per-axis
vectors (``fin``/``fout``).  So does RAS on the lattice: with cells numbered
x fastest, the lowest-index window holding a node is the lowest window along
each axis, so the ownership mask is a tensor product of per-axis (window,
slot) masks (``ras_axis_mask``), folded into the output-side transforms.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..device import DEFAULT_DEVICE, resolve_device
from ..kernels.fdm_patch import FDMTables, fdm_patch, fdm_patch_plain
from ..ops.laplace import check_structured_3d
from ..ops.lattice import cells_to_grid_sliced, grid_to_cells_sliced
from ..ops.tensorops import fdm_direction_transform, outer_grid
from .fdm import (FDMCollection, batched_generalized_eigh,
                  fdm_1d_matrices_batched, percoord_eigendecomposition)

_FOLD_EXPONENTS = {"none": (0.0, 0.0), "pre": (1.0, 0.0),
                   "post": (0.0, 1.0), "symm": (0.5, 0.5), "ras": (0.0, 0.0)}


def axis_window_starts(n_cells: int, degree: int, n_overlap: int = 1):
    """First node of each element window along one axis (``asm.py:371``):
    c·p − (o − 1); slots before 0 or past the last node are ghosts."""
    return [c * degree - (n_overlap - 1) for c in range(n_cells)]


def axis_weight(n_nodes: int, n_cells: int, degree: int,
                n_overlap: int = 1) -> np.ndarray:
    """1D multiplicity weight of element windows of size p − 1 + 2·o along
    one axis (``asm.py:382-401``); the node weights are the tensor product
    ⊗_d w_d."""
    m = degree - 1 + 2 * n_overlap
    counts = np.zeros(n_nodes)
    for start in axis_window_starts(n_cells, degree, n_overlap):
        counts[max(start, 0):min(start + m, n_nodes)] += 1.0
    counts[counts == 0] = 1.0
    return 1.0 / counts


def ras_axis_mask(free: np.ndarray, n_cells: int, degree: int,
                  n_overlap: int = 1) -> np.ndarray:
    """(W, m) RAS mask of one axis: 1 where window w's slot s holds a free
    node and w is the lowest window holding it, else 0.  The (C, m³) mask
    of ``asm.py::_ras_ownership`` is the tensor product of the three."""
    m = degree - 1 + 2 * n_overlap
    n_nodes = free.shape[0]
    owner = np.full(n_nodes, -1)
    mask = np.zeros((n_cells, m))
    for w, start in enumerate(axis_window_starts(n_cells, degree, n_overlap)):
        for s in range(m):
            n = start + s
            if 0 <= n < n_nodes and owner[n] < 0:
                owner[n] = w
                mask[w, s] = free[n]
    return mask


def _check_options(weighting_type: str, n_overlap: int, degree: int) -> None:
    if weighting_type not in _FOLD_EXPONENTS:
        raise ValueError(f"weighting type {weighting_type!r}")
    if not 1 <= n_overlap <= degree:
        raise ValueError(f"n overlap {n_overlap} outside 1..{degree}")


def _check_overlap_one(weighting_type: str, n_overlap: int) -> None:
    """The per-cell forms (deformed and unstructured meshes) run overlap 1
    with a multiplicity weighting."""
    if weighting_type == "ras" or n_overlap != 1:
        raise NotImplementedError(
            f"n overlap {n_overlap}, weighting {weighting_type!r}: on "
            "deformed and unstructured meshes the port has overlap-1 "
            "multiplicity weightings only (ROADMAP item 10a, deformed and "
            "ball forms)")


def _axis_folds(dofs, weighting_type: str, d: int, n_overlap: int = 1):
    """(fin, fout) of direction d: free mask times the 1D multiplicity
    weight to the power the weighting gives each side (RAS: the free mask
    on both sides; its ownership goes into the output transform)."""
    a_in, a_out = _FOLD_EXPONENTS[weighting_type]
    free = dofs.free_1d(d)
    w = axis_weight(dofs.nodes_per_dim[d], dofs.mesh.n_cells[d], dofs.degree,
                    n_overlap)
    return free * w ** a_in, free * w ** a_out


class ASMPreconditioner(nn.Module):
    """Element-centric additive (or restricted, ``"ras"``) Schwarz with FDM
    local solves on a Cartesian mesh, overlap 1..p.

    ``percoord`` (optional): per-direction (V (C_d, m, m), λ (C_d, m)) NumPy
    tables; ``ras_masks`` (optional): per-direction (C_d, m) RAS masks; by
    default both are built here (``interop.py`` passes the JAX ones).
    ``fused`` says whether the apply is kernel B, and the level may take the
    fused smoother kernels C and D: overlap 1 with a multiplicity weighting.
    """

    is_symmetric = True

    def __init__(self, dofs, n_overlap: int = 1, weighting_type: str = "post",
                 dtype=torch.float64, device=DEFAULT_DEVICE, percoord=None,
                 ras_masks=None):
        super().__init__()
        _check_options(weighting_type, n_overlap, dofs.degree)
        check_structured_3d(dofs)
        if dofs.mesh.transform is not None:
            raise ValueError("a deformed mesh takes CellASMPreconditioner")
        self.dofs = dofs
        self.dim = dofs.mesh.dim
        self.degree = dofs.degree
        self.n_overlap = n_overlap
        self.weighting_type = weighting_type
        self.is_symmetric = weighting_type in ("none", "symm")
        self.fused = n_overlap == 1 and weighting_type != "ras"
        self.dtype = dtype
        self.device = resolve_device(device)
        mesh = dofs.mesh
        p = self.degree
        if percoord is None:
            percoord = percoord_eigendecomposition(mesh, p, n_overlap)
        self.percoord = [(np.asarray(V, np.float64), np.asarray(l, np.float64))
                         for V, l in percoord]
        if weighting_type == "ras" and ras_masks is None:
            ras_masks = [ras_axis_mask(dofs.free_1d(d), mesh.n_cells[d], p,
                                       n_overlap) for d in range(self.dim)]
        self.ras_masks = (None if ras_masks is None else
                          [np.asarray(r, np.float64) for r in ras_masks])
        names = ("V", "lam", "fin", "fout", "G", "Gt")
        lam_flat = []
        for d in range(self.dim):
            V, lam = self.percoord[d]
            n_d = dofs.nodes_per_dim[d]
            fin, fout = _axis_folds(dofs, weighting_type, d, n_overlap)
            G = fdm_direction_transform(V, n_d, p, n_overlap, False)
            if self.ras_masks is None:
                Gt = (G * fout[None, :]).T
            else:
                # the owner's slots only: V_w's row s scaled by mask[w, s]
                Gt = fdm_direction_transform(
                    V * self.ras_masks[d][:, :, None], n_d, p, n_overlap,
                    False).T
            for name, arr in zip(names, (V, lam, fin, fout, G * fin[None, :],
                                         Gt)):
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
        apply = fdm_patch if self.fused else fdm_patch_plain
        if src.dtype == self.dtype:
            return apply(src, self.tables)
        return apply(src.to(self.dtype), self.tables).to(src.dtype)

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
    solves, for deformed meshes (overlap > 1 and RAS raise: ROADMAP item
    10a, deformed form).

    ``collection`` (optional): the NumPy ``FDMCollection`` (eigvecs[d]
    (U_d, m, m), eigvals[d] (U_d, m), ids (C, dim)); by default it is built
    here (``interop.py`` passes the JAX one).
    """

    def __init__(self, dofs, n_overlap: int = 1, weighting_type: str = "post",
                 dtype=torch.float64, device=DEFAULT_DEVICE, collection=None):
        super().__init__()
        _check_overlap_one(weighting_type, n_overlap)
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
