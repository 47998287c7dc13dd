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
  one eigen-table per patch and direction, deduplicated by key.  For
  element patches at overlap 1 with a multiplicity weighting on a
  non-periodic 3D mesh in float32 or float64 the apply is kernel G
  (``kernels/cell_fdm_patch.py``), kernel B's tile walk with per-cell
  tables.  Every other case, and the CPU, takes the plain form: batched
  per-patch (m × m) products, the JAX ``_fdm_apply`` form
  (``asm.py:466-490``), on strided windows of the node grid
  (``ops/lattice.py``).  The JAX package applies these tables in XLA, not
  in a Pallas kernel.

Periodic axes (``asm.py:371-446``): every vertex is interior, window
starts wrap modulo N = p·C (a 1-cell axis wraps a window onto itself, so
its weights count a node once per slot), and the global form's G_d wraps
its columns.  Kernels B, C and D refuse periodic meshes, as the JAX FDM
kernel does (``fdm_slab.py:152``), so they take the plain global form.

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

from ..device import DEFAULT_DEVICE, KERNEL_DTYPES, resolve_device
from ..fem.patches import vertex_anchors
from ..kernels.cell_fdm_patch import CellFDMTables, cell_fdm_patch
from ..kernels.fdm_patch import FDMTables, fdm_patch, fdm_patch_plain
from ..ops.laplace import check_structured
from ..ops.lattice import (axis_firsts, grid_to_windows, window_layout,
                           windows_to_grid)
from ..ops.tensorops import fdm_direction_transform, outer_grid, outer_sum
from .fdm import (FDMCollection, batched_generalized_eigh,
                  check_has_interior_vertex, fdm_1d_matrices_batched,
                  percoord_eigendecomposition,
                  vertex_patch_1d_matrices_batched,
                  vertex_percoord_eigendecomposition)

_FOLD_EXPONENTS = {"none": (0.0, 0.0), "pre": (1.0, 0.0),
                   "post": (0.0, 1.0), "symm": (0.5, 0.5), "ras": (0.0, 0.0)}


def axis_window_starts(n_cells: int, degree: int, n_overlap: int = 1,
                       patch: str = "element", periodic: bool = False):
    """First node of each window along one axis (``asm.py:371``): element
    windows c·p − (o − 1), one per cell (slots before 0 or past the last
    node are ghosts, or wrap on a periodic axis); vertex windows v·p + 1,
    one per interior vertex, or v·p − (p − 1) for every vertex v of a
    periodic axis."""
    _, first = window_layout(degree, n_overlap, patch, periodic)
    count = n_cells if patch == "element" or periodic else n_cells - 1
    return [first + w * degree for w in range(count)]


def _axis_slots(n_nodes: int, n_cells: int, degree: int, n_overlap: int,
                patch: str, periodic: bool) -> np.ndarray:
    """(W, m) node of each window slot along one axis; −1 for a ghost."""
    m, _ = window_layout(degree, n_overlap, patch, periodic)
    starts = axis_window_starts(n_cells, degree, n_overlap, patch, periodic)
    k = np.asarray(starts)[:, None] + np.arange(m)[None, :]
    if periodic:
        return k % n_nodes
    return np.where((k >= 0) & (k < n_nodes), k, -1)


def axis_weight(n_nodes: int, n_cells: int, degree: int,
                n_overlap: int = 1, patch: str = "element",
                periodic: bool = False) -> np.ndarray:
    """1D multiplicity weight of the windows along one axis
    (``asm.py:382-401``; a slot that wraps onto a node its window already
    holds counts again); the node weights are the tensor product ⊗_d w_d."""
    k = _axis_slots(n_nodes, n_cells, degree, n_overlap, patch, periodic)
    counts = np.bincount(k[k >= 0], minlength=n_nodes).astype(np.float64)
    counts[counts == 0] = 1.0
    return 1.0 / counts


def ras_axis_mask(free: np.ndarray, n_cells: int, degree: int,
                  n_overlap: int = 1, patch: str = "element",
                  periodic: bool = False) -> np.ndarray:
    """(W, m) RAS mask of one axis: 1 where window w's slot s holds a free
    node and w is the lowest window holding it, else 0 (every slot of the
    owner that holds the node, where a periodic window wraps onto itself).
    The (P, m³) mask of ``asm.py::_ras_ownership`` is the tensor product of
    the three."""
    n_nodes = free.shape[0]
    k = _axis_slots(n_nodes, n_cells, degree, n_overlap, patch, periodic)
    W = k.shape[0]
    owner = np.full(n_nodes + 1, W)
    np.minimum.at(owner, np.where(k >= 0, k, n_nodes),
                  np.broadcast_to(np.arange(W)[:, None], k.shape))
    own = (k >= 0) & (owner[k] == np.arange(W)[:, None])
    return np.where(own, np.asarray(free, np.float64)[k], 0.0)


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
                    n_overlap, patch, dofs.mesh.periodic[d])
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
    with a multiplicity weighting, on a non-periodic 3D mesh, in float32 or
    float64.
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
        # kernels B, C and D tile non-periodic 3D overlap-1 element
        # windows; the JAX package reaches its FDM kernel only there
        # (``fdm_slab.py:151-154``, ``smoother_step.py:1086``)
        self.periodic = tuple(dofs.mesh.periodic)
        self.fused = (patch_type == "element" and n_overlap == 1
                      and weighting_type != "ras" and self.dim == 3
                      and not any(self.periodic) and dtype in KERNEL_DTYPES)
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
                                       n_overlap, patch_type,
                                       self.periodic[d])
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
            per = self.periodic[d]
            # a bfloat16 level folds the weights into V as held in
            # bfloat16, as the JAX package builds G from its stored
            # ``percoord``; the bfloat16 rounding of V decides the result
            Vl = (self._tensor(V).double().cpu().numpy()
                  if self.dtype == torch.bfloat16 else V)
            G = fdm_direction_transform(Vl, n_d, p, n_overlap, per,
                                        patch_type)
            if self.ras_masks is None:
                Gt = (G * fout[None, :]).T
            else:
                # the owner's slots only: V_w's row s scaled by mask[w, s]
                Gt = fdm_direction_transform(
                    Vl * self.ras_masks[d][:, :, None], n_d, p, n_overlap,
                    per, patch_type).T
            for name, arr in zip(names, (V, lam, fin, fout, G * fin[None, :],
                                         Gt)):
                self.register_buffer(f"{name}{d}", self._tensor(arr))
            lam_flat.append(getattr(self, f"lam{d}").reshape(-1))
        self.register_buffer("inv_denom", 1.0 / outer_sum(lam_flat))
        per = {name: [getattr(self, f"{name}{d}") for d in range(self.dim)]
               for name in names}
        self.tables = FDMTables(per["V"], per["lam"], per["fin"], per["fout"],
                                per["G"], per["Gt"], self.inv_denom,
                                tuple(reversed(mesh.n_cells)), p,
                                self.periodic)

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
        if self.dtype == torch.bfloat16:
            # the JAX package's einsums promote: a wider vector (the
            # eigenvalue estimate's float64 Lanczos vectors) meets the
            # bfloat16 tables in its own dtype
            return fdm_patch_plain(src, self._widened(src.dtype))
        return apply(src.to(self.dtype), self.tables).to(src.dtype)

    def _widened(self, dtype) -> FDMTables:
        """The plain form's tables cast to ``dtype`` (built once)."""
        if getattr(self, "_wide", None) is None or \
                self._wide.inv_denom.dtype != dtype:
            t = self.tables
            self._wide = FDMTables(
                t.V, t.lam, t.fin, t.fout, [g.to(dtype) for g in t.G],
                [g.to(dtype) for g in t.Gt], t.inv_denom.to(dtype), t.cells,
                t.p, t.periodic)
        return self._wide

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
    (P, m, m) and λ[d] (P, m) per direction (x first), and denom
    (P, m, m, m) ((P, m, m) in 2D), the eigenvalue sums λ_z + λ_y + λ_x
    added slowest direction first (the JAX package's ``fdm_apply_lanes``
    order), all in ``dtype``."""
    ids = np.asarray(collection.ids)
    V, lams = [], []
    for d in range(ids.shape[1]):
        for tabs, out in ((collection.eigvecs, V), (collection.eigvals, lams)):
            out.append(torch.tensor(np.asarray(tabs[d], np.float64)[ids[:, d]],
                                    dtype=dtype, device=device))
    if len(lams) == 2:
        lx, ly = lams
        return V, lams, ly[:, :, None] + lx[:, None, :]
    lx, ly, lz = lams
    return V, lams, (lz[:, :, None, None] + ly[:, None, :, None]
                     + lx[:, None, None, :])


def _unrolled_axis(u: torch.Tensor, V: torch.Tensor, axis: int,
                   to_modes: bool) -> torch.Tensor:
    """One direction of the per-patch transform as the JAX package's
    ``_axis_apply_lanes`` computes it: m² broadcast multiply-adds, summed
    in slot order, each rounded to u's dtype.  ``axis`` counts the local
    axes (0 slowest); V (P, m, m) as [node, mode]."""
    u = torch.movedim(u, axis + 1, 1)
    m = V.shape[1]
    shape = (V.shape[0],) + (1,) * (u.ndim - 2)
    outs = []
    for i in range(m):
        acc = None
        for j in range(m):
            c = (V[:, j, i] if to_modes else V[:, i, j]).reshape(shape)
            t = u[:, j] * c
            acc = t if acc is None else acc + t
        outs.append(acc)
    return torch.movedim(torch.stack(outs, 1), 1, axis + 1)


def cell_fdm_apply(u: torch.Tensor, V: list, inv_denom: torch.Tensor = None,
                   denom: torch.Tensor = None):
    """Batched tensor-product patch inverses: u (P, m, m, m) as [z, y, x]
    ((P, m, m) as [y, x] in 2D), V[d] (P, m, m) as [node, mode] per
    direction (x first), inv_denom the reciprocal eigenvalue sums, shaped
    as u.  Given ``denom`` (a bfloat16 level) instead, the apply runs as the
    JAX package's lanes form, whose rounding points decide a bfloat16
    result: each direction's multiply-adds unrolled, slowest direction
    first, and a division by the eigenvalue sums."""
    if denom is not None:
        dim = len(V)
        for a in range(dim):
            u = _unrolled_axis(u, V[dim - 1 - a], a, to_modes=True)
        u = u / denom
        for a in range(dim):
            u = _unrolled_axis(u, V[dim - 1 - a], a, to_modes=False)
        return u
    if len(V) == 2:
        Vx, Vy = V
        u = torch.einsum("cyx,cxk->cyk", u, Vx)
        u = torch.einsum("cyx,cyk->ckx", u, Vy)
        u = u * inv_denom
        u = torch.einsum("cyk,cxk->cyx", u, Vx)
        return torch.einsum("ckx,cyk->cyx", u, Vy)
    Vx, Vy, Vz = V
    u = torch.einsum("czyx,cxk->czyk", u, Vx)
    u = torch.einsum("czyx,cyk->czkx", u, Vy)
    u = torch.einsum("czyx,czk->ckyx", u, Vz)
    u = u * inv_denom
    u = torch.einsum("czyk,cxk->czyx", u, Vx)
    u = torch.einsum("czkx,cyk->czyx", u, Vy)
    return torch.einsum("ckyx,czk->czyx", u, Vz)


def _window_mask_product(masks: list) -> np.ndarray:
    """(P, m^dim) RAS mask of the windows from the per-axis (window, slot)
    masks (x first): window and slot both run z slowest, x fastest."""
    if len(masks) == 2:
        mx, my = masks
        prod = my[:, None, :, None] * mx[None, :, None, :]
    else:
        mx, my, mz = masks
        prod = (mz[:, None, None, :, None, None]
                * my[None, :, None, None, :, None]
                * mx[None, None, :, None, None, :])
    return prod.reshape(-1, masks[0].shape[1] ** len(masks))


def register_patch_tables(module: nn.Module, collection: FDMCollection):
    """V0..V{dim−1} and the eigenvalue sums of ``cell_fdm_tables`` as
    buffers of ``module`` in its dtype: ``inv_denom`` (the reciprocal), or
    ``denom`` itself on a bfloat16 level (see ``cell_fdm_apply``).  Returns
    the per-direction eigenvalues λ[d] (P, m) they were summed from."""
    V, lams, denom = cell_fdm_tables(collection, module.dtype, module.device)
    for d, Vd in enumerate(V):
        module.register_buffer(f"V{d}", Vd)
    if module.dtype == torch.bfloat16:
        module.register_buffer("denom", denom)
    else:
        module.register_buffer("inv_denom", 1.0 / denom)
    return lams


def work_dtype(dtype, src: torch.Tensor):
    """The dtype a per-patch FDM apply computes in: its own, except that a
    bfloat16 level meets a wider vector (the eigenvalue estimate's float64
    Lanczos vectors) in the vector's dtype, as the JAX package's einsums
    promote."""
    if dtype == torch.bfloat16 and src.dtype in KERNEL_DTYPES:
        return src.dtype
    return dtype


def patch_apply(module: nn.Module, W: torch.Tensor, dtype,
                rows: slice = slice(None)) -> torch.Tensor:
    """``cell_fdm_apply`` with ``module``'s tables (``register_patch_tables``)
    in ``dtype``; W holds the patches ``rows`` of them."""
    V = [getattr(module, f"V{d}")[rows].to(dtype) for d in range(module.dim)]
    if module.dtype == torch.bfloat16:
        return cell_fdm_apply(W, V, denom=module.denom[rows].to(dtype))
    return cell_fdm_apply(W, V, module.inv_denom[rows])


class CellASMPreconditioner(nn.Module):
    """Additive (or restricted) Schwarz with per-patch FDM local solves on a
    deformed structured mesh: element patches of overlap 1..p, or
    vertex-star patches (``patch_type="vertex"``).

    ``collection`` (optional): the NumPy ``FDMCollection`` (eigvecs[d]
    (U_d, m, m), eigvals[d] (U_d, m), ids (P, dim)); ``ras_mask``
    (optional): the (P, m³) RAS mask; by default both are built here
    (``interop.py`` passes the JAX ones).  ``fused`` says whether the apply
    is kernel G: element patches of overlap 1 with a multiplicity
    weighting, on a non-periodic 3D mesh, in float32 or float64, as kernel
    B's rule on Cartesian levels.
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
        self.periodic = tuple(mesh.periodic)
        self.m, _ = window_layout(p, n_overlap, patch_type)
        self.first = axis_firsts(p, n_overlap, patch_type, self.periodic)
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
        lams = register_patch_tables(self, collection)
        folds = [_axis_folds(dofs, weighting_type, d, n_overlap, patch_type)
                 for d in range(self.dim)]
        for k, name in enumerate(("fin", "fout")):
            self.register_buffer(name, outer_grid(
                [self._tensor(f[k]) for f in folds]))
        if weighting_type == "ras" and ras_mask is None:
            masks = [ras_axis_mask(dofs.free_1d(d), mesh.n_cells[d], p,
                                   n_overlap, patch_type, self.periodic[d])
                     for d in range(self.dim)]
            ras_mask = _window_mask_product(masks)
        self.ras_mask = (None if ras_mask is None
                         else self._tensor(ras_mask))
        self.grid_shape = tuple(reversed(dofs.nodes_per_dim))
        self.fused = (patch_type == "element" and n_overlap == 1
                      and weighting_type != "ras" and self.dim == 3
                      and not any(self.periodic) and dtype in KERNEL_DTYPES)
        if self.fused:
            self.register_buffer("lam", torch.stack(lams, 1))
            self.cell_tables = CellFDMTables(
                [getattr(self, f"V{d}") for d in range(3)], self.lam,
                [self._tensor(f[0]) for f in folds],
                [self._tensor(f[1]) for f in folds],
                tuple(reversed(mesh.n_cells)), p, self.vmult_plain)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.tensor(np.ascontiguousarray(a), dtype=self.dtype,
                            device=self.device)

    def vmult(self, src: torch.Tensor) -> torch.Tensor:
        """P⁻¹ src: kernel G where ``fused`` (its plain version on a CPU
        tensor), else ``vmult_plain``."""
        if self.fused:
            return cell_fdm_patch(src.to(self.dtype),
                                  self.cell_tables).to(src.dtype)
        return self.vmult_plain(src)

    def vmult_plain(self, src: torch.Tensor) -> torch.Tensor:
        """x·w → windows → ⊗Vᵀ → 1/Σλ → ⊗V → (RAS mask) → overlap-add → ·w."""
        dt = work_dtype(self.dtype, src)
        x = src.to(dt).reshape(self.grid_shape) * self.fin.to(dt)
        p, m, first, dim = self.degree, self.m, self.first, self.dim
        W = grid_to_windows(x, p, m, first, self.periodic).reshape(
            (-1,) + (m,) * dim)
        y = patch_apply(self, W, dt).reshape(-1, m ** dim)
        if self.ras_mask is not None:
            y = y * self.ras_mask.to(dt)
        y = windows_to_grid(y, self.grid_shape, p, m, first,
                            self.periodic) * self.fout.to(dt)
        return y.reshape(-1).to(src.dtype)

    def forward(self, src):
        return self.vmult(src)
