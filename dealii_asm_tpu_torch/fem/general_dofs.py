"""Continuous FE_Q DoF numbering on unstructured meshes (NumPy).

Carried over from ``dealii_asm_tpu/fem/general_dofs.py`` so that the port
stands alone; the tables equal the JAX package's entry by entry.  Global
DoFs are numbered per entity: vertices, then line interiors in canonical
line order, then quad interiors, then cell interiors.  Each cell's
``cell_dofs`` row lists its (p+1)^dim DoFs in local lexicographic order
(x fastest) with the orientation permutation of every shared line and quad
applied, so the operators run plain gathers and scatters.

Canonical orientations: a line runs from its lower global vertex id to the
higher; a quad's origin is its corner with the smallest id, its u-axis
points to the origin's adjacent corner with the smaller id.

The tables are built on first use; while tracing is on
(``utils/profiling.py``) each build is the span "setup.dofs".
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np

from ..mesh.unstructured import (VERTEX_COORDS, UnstructuredMesh,
                                 edge_vertices, face_vertices)
from ..utils.profiling import spanned


@dataclass(frozen=True)
class GeneralDofHandler:
    mesh: UnstructuredMesh
    degree: int

    # -- entity enumeration --------------------------------------------------

    @cached_property
    @spanned("setup.dofs")
    def _lines(self):
        """(cell line ids (C, E), flip (C, E), n_lines); flip where the
        cell's local edge direction runs against the canonical one."""
        cv = self.mesh.cells
        edges = edge_vertices(self.mesh.dim)
        v0 = np.stack([cv[:, a] for (a, b, _ax) in edges], axis=1)
        v1 = np.stack([cv[:, b] for (a, b, _ax) in edges], axis=1)
        keys = np.stack([np.minimum(v0, v1), np.maximum(v0, v1)],
                        axis=2).reshape(-1, 2)
        uniq, inv = np.unique(keys, axis=0, return_inverse=True)
        return inv.reshape(v0.shape).astype(np.int64), v0 > v1, len(uniq)

    @cached_property
    @spanned("setup.dofs")
    def _quads(self):
        """(cell quad ids (C, 6), face corners (C, 6, 4) in face-lex order,
        n_quads); 3D only."""
        fv = face_vertices(3)
        corners = np.stack([self.mesh.cells[:, fv[f]] for f in range(6)],
                           axis=1)
        keys = np.sort(corners.reshape(-1, 4), axis=1)
        uniq, inv = np.unique(keys, axis=0, return_inverse=True)
        return inv.reshape(corners.shape[:2]).astype(np.int64), corners, len(uniq)

    @cached_property
    @spanned("setup.dofs")
    def _offsets(self):
        p = self.degree
        mesh = self.mesh
        n_lines = self._lines[2]
        n_quads = self._quads[2] if mesh.dim == 3 else 0
        off_line = mesh.n_vertices
        off_quad = off_line + (n_lines * (p - 1) if p > 1 else 0)
        off_cell = off_quad + (n_quads * (p - 1) ** 2 if p > 1 else 0)
        n_total = off_cell + (mesh.n_cells_total * (p - 1) ** mesh.dim
                              if p > 1 else 0)
        return off_line, off_quad, off_cell, n_total

    @property
    def n_dofs(self) -> int:
        return self._offsets[3]

    @property
    def dofs_per_cell(self) -> int:
        return (self.degree + 1) ** self.mesh.dim

    # -- the index table -----------------------------------------------------

    @cached_property
    @spanned("setup.dofs")
    def cell_dofs(self) -> np.ndarray:
        """(C, (p+1)^dim) int32 global DoFs per cell, local lexicographic
        (x fastest), orientation permutations applied; vectorised over
        cells, the loop runs over the local slots."""
        p = self.degree
        dim = self.mesh.dim
        mesh = self.mesh
        off_line, off_quad, off_cell, _ = self._offsets
        n1 = p + 1
        L = n1 ** dim
        C = mesh.n_cells_total
        lat = np.stack([np.arange(L) // n1 ** d % n1 for d in range(dim)],
                       axis=1)
        inner = (lat > 0) & (lat < p)
        vc = VERTEX_COORDS[dim]
        edges = edge_vertices(dim)
        line_ids, line_flip, _ = self._lines
        if dim == 3:
            quad_ids, quad_corners, _ = self._quads
            quad_canon = _canonical_quad_vec(quad_corners)

        def vlookup(coords01):
            return int(np.where((vc == coords01).all(axis=1))[0][0])

        out = np.empty((C, L), dtype=np.int64)
        cell_interior_base = (off_cell
                              + np.arange(C, dtype=np.int64) * (p - 1) ** dim)
        for l in range(L):
            coords = lat[l]
            k = int(inner[l].sum())
            if k == 0:
                out[:, l] = mesh.cells[:, vlookup(coords // p)]
            elif k == 1:
                d = int(np.where(inner[l])[0][0])
                t = int(coords[d])
                lo = coords.copy()
                lo[d] = 0
                hi = coords.copy()
                hi[d] = p
                va, vb = vlookup(lo // p), vlookup(hi // p)
                e = next(i for i, (a, b, _ax) in enumerate(edges)
                         if (a, b) == (va, vb) or (b, a) == (va, vb))
                idx = np.where(line_flip[:, e], p - 1 - t, t - 1)
                out[:, l] = off_line + line_ids[:, e] * (p - 1) + idx
            elif k == 2 and dim == 3:
                ds = np.where(inner[l])[0]
                a, b = int(ds[0]), int(ds[1])
                d_out = 3 - a - b
                f = 2 * d_out + int(coords[d_out]) // p
                # face-lex order: the fastest face axis is a (a < b)
                u, v = _quad_uv_vec(quad_canon[:, f], quad_corners[:, f],
                                    int(coords[a]), int(coords[b]), p)
                out[:, l] = (off_quad + quad_ids[:, f] * (p - 1) ** 2
                             + (v - 1) * (p - 1) + (u - 1))
            else:
                idx, mult = 0, 1
                for d in range(dim):
                    idx += (int(coords[d]) - 1) * mult
                    mult *= p - 1
                out[:, l] = cell_interior_base + idx
        return out.astype(np.int32)

    @cached_property
    @spanned("setup.dofs")
    def boundary_mask(self) -> np.ndarray:
        """(n_dofs,) True where the DoF lies on a boundary face."""
        p = self.degree
        dim = self.mesh.dim
        n1 = p + 1
        lat = np.stack([np.arange(n1 ** dim) // n1 ** d % n1
                        for d in range(dim)], axis=1)
        mask = np.zeros(self.n_dofs, dtype=bool)
        nbr = self.mesh.face_neighbors()
        cd = self.cell_dofs
        for f in range(2 * dim):
            cs = np.where(nbr[:, f] < 0)[0]
            if len(cs) == 0:
                continue
            on = lat[:, f // 2] == (0 if f % 2 == 0 else p)
            mask[cd[np.ix_(cs, np.where(on)[0])].reshape(-1)] = True
        return mask

    @cached_property
    @spanned("setup.dofs")
    def points(self) -> np.ndarray:
        """(n_dofs, dim) physical support points (isoparametric GLL
        lattice); shared DoFs get the same coordinates from every cell."""
        sp = self.mesh.cell_mapping_points(self.degree)
        pts = np.zeros((self.n_dofs, self.mesh.dim))
        pts[self.cell_dofs.reshape(-1)] = sp.reshape(-1, self.mesh.dim)
        return pts

    def node_points(self, ids: np.ndarray) -> np.ndarray:
        """(len(ids), dim) support points of the DoFs ``ids``."""
        return self.points[np.asarray(ids, np.int64)]


def _canonical_quad_vec(corners: np.ndarray) -> np.ndarray:
    """Canonical corner order (origin, u-neighbour, v-neighbour, diagonal)
    of face-lex corners (..., 4) = (c00, c10, c01, c11)."""
    stack = np.stack([corners[..., i] for i in range(4)], axis=-1)
    argmin = np.argmin(stack, axis=-1)
    adj = np.array([[1, 2], [0, 3], [3, 0], [2, 1]])
    diag = np.array([3, 2, 1, 0])
    o = np.take_along_axis(stack, argmin[..., None], axis=-1)[..., 0]
    n1 = np.take_along_axis(stack, adj[argmin][..., 0:1], axis=-1)[..., 0]
    n2 = np.take_along_axis(stack, adj[argmin][..., 1:2], axis=-1)[..., 0]
    d = np.take_along_axis(stack, diag[argmin][..., None], axis=-1)[..., 0]
    return np.stack([o, np.minimum(n1, n2), np.maximum(n1, n2), d], axis=-1)


def _quad_uv_vec(canon: np.ndarray, local: np.ndarray, s: int, t: int, p: int):
    """Canonical (u, v) of the local face coordinates (s, t): one of the 8
    symmetries of the square per face."""
    slot_uv = np.array([[0, 0], [p, 0], [0, p], [p, p]])
    match = np.argmax(local[..., :, None] == canon[..., None, :], axis=-1)
    pu = slot_uv[match][..., 0]
    pv = slot_uv[match][..., 1]
    u = pu[..., 0] + (s * (pu[..., 1] - pu[..., 0])
                      + t * (pu[..., 2] - pu[..., 0])) // p
    v = pv[..., 0] + (s * (pv[..., 1] - pv[..., 0])
                      + t * (pv[..., 2] - pv[..., 0])) // p
    return u, v
