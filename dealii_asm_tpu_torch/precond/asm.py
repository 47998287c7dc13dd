"""Additive Schwarz preconditioner with FDM local solves (PyTorch).

Counterpart of ``dealii_asm_tpu/precond/asm.py::ASMPreconditioner`` on
structured meshes, for element patches of overlap 1..p (window m =
p − 1 + 2·o starting at node c·p − (o − 1), ``asm.py:195-216``) and
vertex-star patches (m = 2p − 1, one window per interior vertex starting at
node v·p + 1, ``asm.py:218-234``, ``_axis_window_starts`` :371), in two
forms:

- ``ASMPreconditioner``, uniform Cartesian meshes: the ``global_fdm`` form
  (``asm.py:287-313``, ``_vmult_global_fdm`` :527), whose tables come
  straight from the per-coordinate 1D eigenproblems
  (``precond/fdm.py::percoord_eigendecomposition`` and its vertex twin) in
  O(N_d) per axis.  For element patches at overlap 1 with a multiplicity
  weighting the apply is kernel B (``kernels/fdm_patch.py``).  Overlap
  2..p, vertex patches and restricted Schwarz (RAS, each node written only
  by the lowest-index patch that holds it, ``_ras_ownership`` :448) take
  the plain global form, six dense per-axis products, on every device, as
  the JAX package does (its Pallas kernel refuses them,
  ``ops/pallas/fdm_slab.py:151-154``).
- ``CellASMPreconditioner``, deformed meshes whose 1D patch matrices do not
  factor per coordinate (``asm.py:188-234``, ``:320-345``, ``:611-660``):
  one eigen-table per patch and direction, deduplicated by key, and the
  apply as batched per-patch (m × m) products in plain torch, the JAX
  ``_fdm_apply`` form (``asm.py:466-490``), on strided windows of the node
  grid (``ops/lattice.py``).  The JAX package applies these tables in XLA,
  not in a Pallas kernel.

In both, the multiplicity weights (none/pre/post/symm) and the Dirichlet
masks are separable per axis on the lattice, so they fold into per-axis
vectors (``fin``/``fout``).  So does RAS: with patches numbered x fastest,
the lowest-index window holding a node is the lowest window along each
axis, so the ownership mask is a tensor product of per-axis (window, slot)
masks (``ras_axis_mask``), folded into the output-side transforms of the
global form and multiplied out into a (P, m³) mask in the per-patch form.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..device import DEFAULT_DEVICE, resolve_device
from ..fem.patches import vertex_anchors
from ..kernels.fdm_patch import FDMTables, fdm_patch, fdm_patch_plain
from ..ops.laplace import check_structured
from ..ops.lattice import grid_to_windows, window_layout, windows_to_grid
from ..ops.tensorops import fdm_direction_transform, outer_grid, outer_sum
from .fdm import (FDMCollection, batched_generalized_eigh,
                  check_has_interior_vertex, fdm_1d_matrices_batched,
                  percoord_eigendecomposition,
                  vertex_patch_1d_matrices_batched,
                  vertex_percoord_eigendecomposition)

_FOLD_EXPONENTS = {"none": (0.0, 0.0), "pre": (1.0, 0.0),
                   "post": (0.0, 1.0), "symm": (0.5, 0.5), "ras": (0.0, 0.0)}


def axis_window_starts(n_cells: int, degree: int, n_overlap: int = 1,
                       patch: str = "element"):
    """First node of each window along one axis (``asm.py:371``): element
    windows c·p − (o − 1), one per cell (slots before 0 or past the last
    node are ghosts); vertex windows v·p + 1, one per interior vertex."""
    _, first = window_layout(degree, n_overlap, patch)
    count = n_cells if patch == "element" else n_cells - 1
    return [first + w * degree for w in range(count)]


def axis_weight(n_nodes: int, n_cells: int, degree: int,
                n_overlap: int = 1, patch: str = "element") -> np.ndarray:
    """1D multiplicity weight of the windows along one axis
    (``asm.py:382-401``); the node weights are the tensor product ⊗_d w_d."""
    m, _ = window_layout(degree, n_overlap, patch)
    counts = np.zeros(n_nodes)
    for start in axis_window_starts(n_cells, degree, n_overlap, patch):
        counts[max(start, 0):min(start + m, n_nodes)] += 1.0
    counts[counts == 0] = 1.0
    return 1.0 / counts


def ras_axis_mask(free: np.ndarray, n_cells: int, degree: int,
                  n_overlap: int = 1, patch: str = "element") -> np.ndarray:
    """(W, m) RAS mask of one axis: 1 where window w's slot s holds a free
    node and w is the lowest window holding it, else 0.  The (P, m³) mask
    of ``asm.py::_ras_ownership`` is the tensor product of the three."""
    m, _ = window_layout(degree, n_overlap, patch)
    starts = axis_window_starts(n_cells, degree, n_overlap, patch)
    n_nodes = free.shape[0]
    owner = np.full(n_nodes, -1)
    mask = np.zeros((len(starts), m))
    for w, start in enumerate(starts):
        for s in range(m):
            n = start + s
            if 0 <= n < n_nodes and owner[n] < 0:
                owner[n] = w
                mask[w, s] = free[n]
    return mask


def ras_ownership(idx: np.ndarray, n_dofs: int) -> np.ndarray:
    """(P, L) 0/1 mask of a patch table (pad index n_dofs): each DoF
    belongs to the lowest-index patch that holds it (``asm.py:448-462``)."""
    P, L = idx.shape
    owner = np.full(n_dofs + 1, np.iinfo(np.int64).max)
    np.minimum.at(owner, idx.reshape(-1), np.repeat(np.arange(P), L))
    return ((idx < n_dofs) & (owner[idx] == np.arange(P)[:, None])).astype(
        np.float64)


def _check_options(weighting_type: str, n_overlap: int, degree: int,
                   patch_type: str) -> None:
    if weighting_type not in _FOLD_EXPONENTS:
        raise ValueError(f"weighting type {weighting_type!r}")
    if not 1 <= n_overlap <= degree:
        raise ValueError(f"n overlap {n_overlap} outside 1..{degree}")
    if patch_type not in ("element", "vertex"):
        raise ValueError(f"patch type {patch_type!r}")


def _axis_folds(dofs, weighting_type: str, d: int, n_overlap: int = 1,
                patch: str = "element"):
    """(fin, fout) of direction d: free mask times the 1D multiplicity
    weight to the power the weighting gives each side (RAS: the free mask
    on both sides; its ownership goes into the output side)."""
    a_in, a_out = _FOLD_EXPONENTS[weighting_type]
    free = dofs.free_1d(d)
    w = axis_weight(dofs.nodes_per_dim[d], dofs.mesh.n_cells[d], dofs.degree,
                    n_overlap, patch)
    return free * w ** a_in, free * w ** a_out


class ASMPreconditioner(nn.Module):
    """Additive (or restricted, ``"ras"``) Schwarz with FDM local solves on
    a Cartesian mesh: element patches of overlap 1..p, or vertex-star
    patches (``patch_type="vertex"``).

    2D meshes take the same global form (no kernel: the JAX package's FDM
    kernel is 3D only).  ``percoord`` (optional): per-direction (V (W_d, m,
    m), λ (W_d, m)) NumPy tables; ``ras_masks`` (optional): per-direction
    (W_d, m) RAS masks; by default both are built here (``interop.py`` passes the JAX
    ones).  ``fused`` says whether the apply is kernel B, and the level may
    take the fused smoother kernels C and D: element patches of overlap 1
    with a multiplicity weighting, in 3D.
    """

    is_symmetric = True

    def __init__(self, dofs, n_overlap: int = 1, weighting_type: str = "post",
                 dtype=torch.float64, device=DEFAULT_DEVICE, percoord=None,
                 ras_masks=None, patch_type: str = "element"):
        super().__init__()
        _check_options(weighting_type, n_overlap, dofs.degree, patch_type)
        check_structured(dofs)
        if dofs.mesh.transform is not None:
            raise ValueError("a deformed mesh takes CellASMPreconditioner")
        self.dofs = dofs
        self.dim = dofs.mesh.dim
        self.degree = dofs.degree
        self.n_overlap = n_overlap
        self.weighting_type = weighting_type
        self.patch_type = patch_type
        self.m, _ = window_layout(dofs.degree, n_overlap, patch_type)
        self.is_symmetric = weighting_type in ("none", "symm")
        # kernels B, C and D tile 3D overlap-1 element windows; the JAX
        # package reaches its FDM kernel in 3D only (``fdm_slab.py:151``)
        self.fused = (patch_type == "element" and n_overlap == 1
                      and weighting_type != "ras" and self.dim == 3)
        self.dtype = dtype
        self.device = resolve_device(device)
        mesh = dofs.mesh
        p = self.degree
        if percoord is None:
            percoord = (vertex_percoord_eigendecomposition(mesh, p)
                        if patch_type == "vertex" else
                        percoord_eigendecomposition(mesh, p, n_overlap))
        self.percoord = [(np.asarray(V, np.float64), np.asarray(l, np.float64))
                         for V, l in percoord]
        if weighting_type == "ras" and ras_masks is None:
            ras_masks = [ras_axis_mask(dofs.free_1d(d), mesh.n_cells[d], p,
                                       n_overlap, patch_type)
                         for d in range(self.dim)]
        self.ras_masks = (None if ras_masks is None else
                          [np.asarray(r, np.float64) for r in ras_masks])
        names = ("V", "lam", "fin", "fout", "G", "Gt")
        lam_flat = []
        for d in range(self.dim):
            V, lam = self.percoord[d]
            n_d = dofs.nodes_per_dim[d]
            fin, fout = _axis_folds(dofs, weighting_type, d, n_overlap,
                                    patch_type)
            G = fdm_direction_transform(V, n_d, p, n_overlap, False,
                                        patch_type)
            if self.ras_masks is None:
                Gt = (G * fout[None, :]).T
            else:
                # the owner's slots only: V_w's row s scaled by mask[w, s]
                Gt = fdm_direction_transform(
                    V * self.ras_masks[d][:, :, None], n_d, p, n_overlap,
                    False, patch_type).T
            for name, arr in zip(names, (V, lam, fin, fout, G * fin[None, :],
                                         Gt)):
                self.register_buffer(f"{name}{d}", self._tensor(arr))
            lam_flat.append(getattr(self, f"lam{d}").reshape(-1))
        self.register_buffer("inv_denom", 1.0 / outer_sum(lam_flat))
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


def _dedup_collection(keys: np.ndarray, build_batched) -> FDMCollection:
    """Per-direction eigen-tables for (P, dim, k) keys, one per unique key
    row (``asm.py::_dedup_collection``): ``build_batched(uniq)`` gives the
    (M, K) stacks of the unique rows."""
    eigvecs, eigvals = [], []
    ids = np.zeros(keys.shape[:2], dtype=np.int32)
    for d in range(keys.shape[1]):
        uniq, inv = np.unique(keys[:, d, :], axis=0, return_inverse=True)
        ids[:, d] = np.asarray(inv).reshape(-1)
        M, K = build_batched(uniq)
        lam, V = batched_generalized_eigh(K, M)
        eigvecs.append(V)
        eigvals.append(lam)
    return FDMCollection(eigvecs, eigvals, ids)


def element_fdm_collection(extents: np.ndarray, has_lower: np.ndarray,
                           has_upper: np.ndarray, degree: int,
                           n_overlap: int = 1) -> FDMCollection:
    """Per-direction eigen-tables of the element patches of every cell,
    deduplicated by key (``asm.py:188-217``): the keys are the rounded
    harmonic patch ``extents`` (C, dim, 3) [lower, own, upper] and the
    neighbour flags ``has_lower``/``has_upper`` (C, dim)."""
    keys = np.concatenate([np.round(extents, 12),
                           np.asarray(has_lower, np.float64)[:, :, None],
                           np.asarray(has_upper, np.float64)[:, :, None]],
                          axis=2)
    return _dedup_collection(keys, lambda u: fdm_1d_matrices_batched(
        degree, n_overlap, u[:, 0:3], u[:, 3] > 0.5, u[:, 4] > 0.5))


def vertex_fdm_collection(extents: np.ndarray, degree: int) -> FDMCollection:
    """Per-direction eigen-tables of vertex-star patches, deduplicated by
    key (``asm.py:218-234``): the keys are the rounded widths (P, dim, 2)
    of the two cells around the vertex along each axis."""
    return _dedup_collection(
        np.round(extents, 12),
        lambda u: vertex_patch_1d_matrices_batched(degree, u))


def cell_fdm_tables(collection: FDMCollection, dtype, device):
    """Per-patch tables of a deduplicated collection on ``device``: V[d]
    (P, m, m) per direction (x first) and inv_denom (P, m, m, m), the
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
    """Batched tensor-product patch inverses: u (P, m, m, m) as [z, y, x],
    V[d] (P, m, m) as [node, mode] per direction (x first), inv_denom
    (P, m, m, m) the reciprocal eigenvalue sums."""
    Vx, Vy, Vz = V
    u = torch.einsum("czyx,cxk->czyk", u, Vx)
    u = torch.einsum("czyx,cyk->czkx", u, Vy)
    u = torch.einsum("czyx,czk->ckyx", u, Vz)
    u = u * inv_denom
    u = torch.einsum("czyk,cxk->czyx", u, Vx)
    u = torch.einsum("czkx,cyk->czyx", u, Vy)
    return torch.einsum("ckyx,czk->czyx", u, Vz)


class CellASMPreconditioner(nn.Module):
    """Additive (or restricted) Schwarz with per-patch FDM local solves on a
    deformed structured mesh: element patches of overlap 1..p, or
    vertex-star patches (``patch_type="vertex"``).

    ``collection`` (optional): the NumPy ``FDMCollection`` (eigvecs[d]
    (U_d, m, m), eigvals[d] (U_d, m), ids (P, dim)); ``ras_mask``
    (optional): the (P, m³) RAS mask; by default both are built here
    (``interop.py`` passes the JAX ones).
    """

    def __init__(self, dofs, n_overlap: int = 1, weighting_type: str = "post",
                 dtype=torch.float64, device=DEFAULT_DEVICE, collection=None,
                 patch_type: str = "element", ras_mask=None):
        super().__init__()
        _check_options(weighting_type, n_overlap, dofs.degree, patch_type)
        check_structured(dofs)
        self.dofs = dofs
        self.dim = dofs.mesh.dim
        self.degree = p = dofs.degree
        self.n_overlap = n_overlap
        self.weighting_type = weighting_type
        self.patch_type = patch_type
        self.is_symmetric = weighting_type in ("none", "symm")
        self.dtype = dtype
        self.device = resolve_device(device)
        mesh = dofs.mesh
        self.m, self.first = window_layout(p, n_overlap, patch_type)
        if patch_type == "vertex":
            check_has_interior_vertex(mesh, p)
        if collection is None:
            extents = mesh.harmonic_patch_extents(p + 1)
            if patch_type == "vertex":
                # the anchor's own and upper extents (``asm.py:231``)
                collection = vertex_fdm_collection(
                    extents[vertex_anchors(mesh)][:, :, 1:3], p)
            else:
                nbr = mesh.neighbors()
                collection = element_fdm_collection(
                    extents, nbr[:, :, 0] >= 0, nbr[:, :, 1] >= 0, p,
                    n_overlap)
        self.collection = collection
        V, inv_denom = cell_fdm_tables(collection, dtype, self.device)
        for d, Vd in enumerate(V):
            self.register_buffer(f"V{d}", Vd)
        self.register_buffer("inv_denom", inv_denom)
        folds = [_axis_folds(dofs, weighting_type, d, n_overlap, patch_type)
                 for d in range(self.dim)]
        for k, name in enumerate(("fin", "fout")):
            self.register_buffer(name, outer_grid(
                [self._tensor(f[k]) for f in folds]))
        if weighting_type == "ras" and ras_mask is None:
            mx, my, mz = [ras_axis_mask(dofs.free_1d(d), mesh.n_cells[d], p,
                                        n_overlap, patch_type)
                          for d in range(self.dim)]
            m = self.m
            ras_mask = (mz[:, None, None, :, None, None]
                        * my[None, :, None, None, :, None]
                        * mx[None, None, :, None, None, :]).reshape(-1, m ** 3)
        self.ras_mask = (None if ras_mask is None
                         else self._tensor(ras_mask))
        self.grid_shape = tuple(reversed(dofs.nodes_per_dim))

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.tensor(np.ascontiguousarray(a), dtype=self.dtype,
                            device=self.device)

    def vmult(self, src: torch.Tensor) -> torch.Tensor:
        """x·w → windows → ⊗Vᵀ → 1/Σλ → ⊗V → (RAS mask) → overlap-add → ·w."""
        x = src.to(self.dtype).reshape(self.grid_shape) * self.fin
        p, m, first = self.degree, self.m, self.first
        W = grid_to_windows(x, p, m, first).reshape(-1, m, m, m)
        y = cell_fdm_apply(W, [self.V0, self.V1, self.V2],
                           self.inv_denom).reshape(-1, m ** 3)
        if self.ras_mask is not None:
            y = y * self.ras_mask
        y = windows_to_grid(y, self.grid_shape, p, m, first) * self.fout
        return y.reshape(-1).to(src.dtype)

    def forward(self, src):
        return self.vmult(src)
