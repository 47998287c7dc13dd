"""Fast-diagonalization (FDM) 1D patch matrices and eigendecompositions.

NumPy, carried over from ``dealii_asm_tpu/precond/fdm.py`` (whose package
``__init__`` imports jax): the element-centric 1D patch mass/stiffness
assembly (``fdm_1d_matrices`` :56, ``fdm_1d_matrices_batched`` :124), the
vertex-star one (``vertex_patch_1d_matrices`` :202,
``vertex_patch_1d_matrices_batched`` :184), the batched generalized
eigensolver, and the deduplicated collection (``build_fdm_collection``
:240).

Semantics of the 1D patch matrices (direction d, extents [h_l, h_c, h_r]):
assemble the 3-cell 1D FE system scaled per cell (M by h, K by 1/h) and
restrict it to the window of m = p-1+2·overlap nodes centred on the middle
cell; at a missing neighbour (h = 0) ghost slots and the Dirichlet boundary
node are decoupled (zero row/column, unit diagonal).  A vertex patch
along d is the 2p − 1 interior nodes of the two cells [h_0, h_1] around the
vertex, both ends Dirichlet.  The patch inverse is
P⁻¹ = (⊗_d V_d) diag(1/Σ_d λ_d) (⊗_d V_d)ᵀ with K V = M V Λ, Vᵀ M V = I.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.linalg as sla

from ..fem.lagrange import reference_mass_stiffness_1d


def _assemble_3cell(M_ref, K_ref, extents):
    """1D mass/stiffness on up to 3 cells of widths ``extents`` (h = 0:
    absent); 3p+1 nodes."""
    n = M_ref.shape[0]
    p = n - 1
    size = 3 * p + 1
    M = np.zeros((size, size))
    K = np.zeros((size, size))
    for c, h in enumerate(extents):
        if h <= 0.0:
            continue
        sl = slice(c * p, c * p + n)
        M[sl, sl] += M_ref * h
        K[sl, sl] += K_ref / h
    return M, K


def fdm_1d_matrices(degree: int, n_overlap: int, extents,
                    bc_left: str = "dirichlet", bc_right: str = "dirichlet",
                    n_q_1d: int | None = None):
    """1D patch (M, K) of size m = p-1+2·overlap for one direction of one
    cell; bc_* is the domain boundary condition on a side without neighbour
    ("dirichlet" | "neumann"), "internal" where a neighbour exists."""
    p = degree
    m = p - 1 + 2 * n_overlap
    M_ref, K_ref = reference_mass_stiffness_1d(degree, n_q_1d)
    h_l, h_c, h_r = extents
    M3, K3 = _assemble_3cell(M_ref, K_ref, (h_l, h_c, h_r))
    lo = p - (n_overlap - 1)
    W = slice(lo, lo + m)
    Mw = M3[W, W].copy()
    Kw = K3[W, W].copy()

    def _decouple(i):
        Mw[i, :] = 0.0
        Mw[:, i] = 0.0
        Kw[i, :] = 0.0
        Kw[:, i] = 0.0
        Mw[i, i] = 1.0
        Kw[i, i] = 1.0

    def _fix(idx_ghost, idx_boundary, bc, h_nbr):
        if h_nbr <= 0.0:
            for i in idx_ghost:
                _decouple(i)
            if bc == "dirichlet":
                _decouple(idx_boundary)

    _fix(list(range(0, n_overlap - 1)), n_overlap - 1, bc_left, h_l)
    _fix(list(range(m - (n_overlap - 1), m)), m - n_overlap, bc_right, h_r)
    return Mw, Kw


def batched_generalized_eigh(K: np.ndarray, M: np.ndarray):
    """Batched K v = λ M v for stacks (U, m, m) of small SPD pairs: returns
    (lam (U, m) ascending, V (U, m, m)) with M-orthonormal columns, via the
    Cholesky reduction M = LLᵀ, A = L⁻¹KL⁻ᵀ, v = L⁻ᵀy."""
    L = np.linalg.cholesky(M)
    Linv = np.linalg.inv(L)
    LinvT = np.swapaxes(Linv, -1, -2)
    A = Linv @ K @ LinvT
    A = 0.5 * (A + np.swapaxes(A, -1, -2))
    lam, Y = np.linalg.eigh(A)
    return lam, LinvT @ Y


def fdm_1d_matrices_batched(degree: int, n_overlap: int, extents: np.ndarray,
                            internal_left: np.ndarray,
                            internal_right: np.ndarray,
                            n_q_1d: int | None = None, bc: str = "dirichlet"):
    """Vectorized ``fdm_1d_matrices`` over U keys → (M (U,m,m), K (U,m,m));
    sides without neighbour get Dirichlet treatment."""
    if bc != "dirichlet":
        raise NotImplementedError(
            f"fdm_1d_matrices_batched only supports bc='dirichlet', got {bc!r}")
    p = degree
    m = p - 1 + 2 * n_overlap
    M_ref, K_ref = reference_mass_stiffness_1d(degree, n_q_1d)
    n = p + 1
    size = 3 * p + 1
    U = extents.shape[0]
    M3 = np.zeros((U, size, size))
    K3 = np.zeros((U, size, size))
    for c in range(3):
        h = extents[:, c]
        present = h > 0.0
        hm = np.where(present, h, 0.0)
        hinv = np.where(present, 1.0 / np.where(present, h, 1.0), 0.0)
        sl = slice(c * p, c * p + n)
        M3[:, sl, sl] += M_ref[None] * hm[:, None, None]
        K3[:, sl, sl] += K_ref[None] * hinv[:, None, None]
    lo = p - (n_overlap - 1)
    Mw = np.ascontiguousarray(M3[:, lo:lo + m, lo:lo + m])
    Kw = np.ascontiguousarray(K3[:, lo:lo + m, lo:lo + m])

    def _clear(mask, i):
        Mw[mask, i, :] = 0.0
        Mw[mask, :, i] = 0.0
        Kw[mask, i, :] = 0.0
        Kw[mask, :, i] = 0.0
        Mw[mask, i, i] = 1.0
        Kw[mask, i, i] = 1.0

    internal_left = np.asarray(internal_left, dtype=bool)
    internal_right = np.asarray(internal_right, dtype=bool)
    absent_l = extents[:, 0] <= 0.0
    absent_r = extents[:, 2] <= 0.0
    for i in range(0, n_overlap - 1):
        _clear(absent_l, i)
    _clear(absent_l & ~internal_left, n_overlap - 1)
    for i in range(m - (n_overlap - 1), m):
        _clear(absent_r, i)
    _clear(absent_r & ~internal_right, m - n_overlap)
    return Mw, Kw


def vertex_patch_1d_matrices_batched(degree: int, extents: np.ndarray,
                                     n_q_1d: int | None = None):
    """1D vertex-patch (M, K), each (U, 2p − 1, 2p − 1), for extents (U, 2)
    [h_0, h_1]: the 2-cell assembly without its two end nodes (block
    [0:p, 0:p] from M_ref[1:, 1:]·h_0, block [p−1:, p−1:] from
    M_ref[:p, :p]·h_1; ``tensor_product_matrix_creator.h:29-58`` of the
    reference)."""
    p = degree
    M_ref, K_ref = reference_mass_stiffness_1d(degree, n_q_1d)
    extents = np.asarray(extents, np.float64)
    h0 = extents[:, 0, None, None]
    h1 = extents[:, 1, None, None]
    m = 2 * p - 1
    M = np.zeros((extents.shape[0], m, m))
    K = np.zeros_like(M)
    M[:, :p, :p] += M_ref[None, 1:, 1:] * h0
    K[:, :p, :p] += K_ref[None, 1:, 1:] / h0
    M[:, p - 1:, p - 1:] += M_ref[None, :p, :p] * h1
    K[:, p - 1:, p - 1:] += K_ref[None, :p, :p] / h1
    return M, K


def vertex_patch_1d_matrices(degree: int, extents, n_q_1d: int | None = None):
    """One vertex patch's 1D (M, K) for extents (h_0, h_1)."""
    M, K = vertex_patch_1d_matrices_batched(degree, np.asarray([extents]),
                                            n_q_1d)
    return M[0], K[0]


@dataclass
class FDMCollection:
    """Deduplicated per-direction eigendecompositions: eigvecs[d] (U_d, m, m),
    eigvals[d] (U_d, m), ids (C, dim) per-cell index into the tables."""

    eigvecs: list
    eigvals: list
    ids: np.ndarray

    @property
    def m(self) -> int:
        return self.eigvecs[0].shape[-1]


def build_fdm_collection(mk_per_cell_per_dim) -> FDMCollection:
    """Deduplicate (M, K) pairs per direction and eigendecompose once per
    unique pair; mk_per_cell_per_dim is a list over dims of lists over cells
    of (M, K)."""
    dim = len(mk_per_cell_per_dim)
    C = len(mk_per_cell_per_dim[0])
    eigvecs, eigvals = [], []
    ids = np.zeros((C, dim), dtype=np.int32)
    for d in range(dim):
        cache: dict[bytes, int] = {}
        unique = []
        for c in range(C):
            M, K = mk_per_cell_per_dim[d][c]
            key = np.round(np.concatenate([M.ravel(), K.ravel()]), 12).tobytes()
            if key not in cache:
                cache[key] = len(unique)
                unique.append((M, K))
            ids[c, d] = cache[key]
        V = np.zeros((len(unique),) + unique[0][0].shape)
        lam = np.zeros((len(unique), unique[0][0].shape[0]))
        for u, (M, K) in enumerate(unique):
            w, v = sla.eigh(K, M)
            lam[u] = w
            V[u] = v
        eigvecs.append(V)
        eigvals.append(lam)
    return FDMCollection(eigvecs, eigvals, ids)


def percoord_eigendecomposition(mesh, degree: int, n_overlap: int = 1):
    """Per-coordinate tables [(V_d (C_d, m, m), λ_d (C_d, m))] of element
    patches on a uniform Cartesian mesh, for each direction d (x first).

    The 1D patch problem along d depends only on the cell's d-coordinate, so
    setup is O(C_d) per axis.  Keys and their deduplication follow the JAX
    ``ASMPreconditioner`` (rounded extents and neighbour flags, unique rows
    eigendecomposed in one batch), so the tables equal its ``percoord``."""
    out = []
    for d in range(mesh.dim):
        C = mesh.n_cells[d]
        c = np.arange(C)
        h = float(mesh.h[d])
        has_l = (c > 0) | mesh.periodic[d]
        has_r = (c < C - 1) | mesh.periodic[d]
        keys = np.stack([np.where(has_l, h, 0.0), np.full(C, h),
                         np.where(has_r, h, 0.0), has_l.astype(np.float64),
                         has_r.astype(np.float64)], axis=1)
        keys[:, :3] = np.round(keys[:, :3], 12)
        uniq, inv = np.unique(keys, axis=0, return_inverse=True)
        M, K = fdm_1d_matrices_batched(degree, n_overlap, uniq[:, 0:3],
                                       uniq[:, 3] > 0.5, uniq[:, 4] > 0.5)
        lam, V = batched_generalized_eigh(K, M)
        inv = np.asarray(inv).reshape(-1)
        out.append((V[inv], lam[inv]))
    return out


class NoVertexPatches(ValueError):
    """A mesh without an interior vertex has no vertex-star patch (the JAX
    package raises a ValueError there too, ``asm.py:438``)."""


def check_has_interior_vertex(mesh, degree: int) -> None:
    """NoVertexPatches unless every non-periodic axis of the structured
    ``mesh`` has two cells or more (a periodic axis has a vertex per cell,
    its one-cell wrap included)."""
    if any(n < 2 and not per for n, per in zip(mesh.n_cells, mesh.periodic)):
        raise NoVertexPatches(
            f"{tuple(mesh.n_cells)} cells at degree {degree}: no interior "
            "vertex, so no vertex patch")


def vertex_percoord_eigendecomposition(mesh, degree: int):
    """Per-coordinate tables [(V_d (W_d, m, m), λ_d (W_d, m))] of vertex
    patches on a uniform Cartesian mesh, m = 2p − 1, one window per
    interior vertex of direction d: W_d = n_d − 1 windows (v = 1 .. n_d −
    1), or n_d on a periodic axis (v = 0 .. n_d − 1).  The key of every
    window is [h_d, h_d] (the anchor's own and upper extents,
    ``asm.py:231``), so each direction eigendecomposes one pair, as the
    JAX package's deduplication does.  A mesh with one cell along a
    non-periodic axis has no interior vertex: ``NoVertexPatches``."""
    check_has_interior_vertex(mesh, degree)
    out = []
    for d in range(mesh.dim):
        h = np.round(float(mesh.h[d]), 12)
        M, K = vertex_patch_1d_matrices_batched(degree, np.array([[h, h]]))
        lam, V = batched_generalized_eigh(K, M)
        W = mesh.n_cells[d] - (0 if mesh.periodic[d] else 1)
        out.append((np.repeat(V, W, axis=0), np.repeat(lam, W, axis=0)))
    return out
