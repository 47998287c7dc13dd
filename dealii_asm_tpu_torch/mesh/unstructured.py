"""Unstructured hexahedral meshes with manifold-aware refinement (NumPy).

Carried over from ``dealii_asm_tpu/mesh/unstructured.py`` so that the port
stands alone: the balanced hyperball of the reference program
(``hyper_ball_balanced`` :609), its transfinite ``BallChart`` (:548), the
face tables, refinement with ``parent_cells``/``child_index`` (:187), the
isoparametric mapping support points and the harmonic cell and patch
extents of the FDM smoother.  The arithmetic is the same, so every table
equals the JAX package's entry by entry (``tests/test_torch_unstructured.py``).

Layout: ``vertices`` (V, dim), ``cells`` (C, 2^dim) vertex ids in
lexicographic local order (x fastest); refinement splits every cell into
2^dim children numbered 2^dim·parent + octant.  Orientation bookkeeping is
resolved here and in ``fem/general_dofs.py`` on the host, so device code sees
plain gathers.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

from ..fem.lagrange import (gauss_lobatto_points, gauss_points,
                            lagrange_derivatives, lagrange_values,
                            tensor_gradient, tensor_lattice, tensor_lattice_nd,
                            tensor_weights)

# lexicographic local vertex coordinates (x fastest), dim 2 and 3
VERTEX_COORDS = {
    2: np.array([[0, 0], [1, 0], [0, 1], [1, 1]], dtype=np.int64),
    3: np.array(
        [[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0],
         [0, 0, 1], [1, 0, 1], [0, 1, 1], [1, 1, 1]], dtype=np.int64),
}


@functools.lru_cache(maxsize=None)
def face_vertices(dim: int) -> list[np.ndarray]:
    """Local vertex ids of each face in the face's own lexicographic order
    (lowest remaining axis fastest); face 2d+s is orthogonal to axis d on
    side s.  Cached: treat the arrays as read-only."""
    vc = VERTEX_COORDS[dim]
    faces = []
    for d in range(dim):
        for s in (0, 1):
            ids = np.where(vc[:, d] == s)[0]
            rem = [e for e in range(dim) if e != d]
            key = np.zeros(len(ids))
            mult = 1
            for e in rem:
                key = key + vc[ids, e] * mult
                mult *= 2
            faces.append(ids[np.argsort(key, kind="stable")])
    return faces


def edge_vertices(dim: int) -> list[tuple[int, int, int]]:
    """Local edges as (v0, v1, axis)."""
    vc = VERTEX_COORDS[dim]
    out = []
    n = len(vc)
    for a in range(n):
        for b in range(a + 1, n):
            diff = vc[b] - vc[a]
            if np.abs(diff).sum() == 1:
                out.append((a, b, int(np.argmax(np.abs(diff)))))
    return out


@dataclass
class UnstructuredMesh:
    """General quad/hex mesh; cells reference vertices in lexicographic order.

    The derived tables (face tables, mapping points, harmonic extents) are
    memoized and returned read-only; an in-place change of ``cells``,
    ``vertices`` or the chart must call ``invalidate_caches()``.
    """

    dim: int
    vertices: np.ndarray               # (V, dim) float64
    cells: np.ndarray                  # (C, 2^dim) int64
    project: object = None             # boundary projection (N, dim) -> (N, dim)
    parent_cells: np.ndarray | None = None  # (C,) parent cell after refine
    child_index: np.ndarray | None = None   # (C,) octant within the parent
    # transfinite chart over the COARSE cells; refined cells keep their
    # reference sub-box within the coarse ancestor
    chart: object = None               # .eval(cell_ids (N,), ref (N, dim))
    chart_cell: np.ndarray | None = None  # (C,) coarse ancestor id
    chart_lo: np.ndarray | None = None    # (C, dim) sub-box lower corner
    chart_h: np.ndarray | None = None     # (C,) sub-box size (1/2^level)

    # -- topology ------------------------------------------------------------

    @property
    def n_cells_total(self) -> int:
        return int(self.cells.shape[0])

    @property
    def n_vertices(self) -> int:
        return int(self.vertices.shape[0])

    def face_key(self, cell: int, face: int) -> tuple:
        return tuple(sorted(self.cells[cell, face_vertices(self.dim)[face]]))

    def invalidate_caches(self) -> None:
        for name in ("_face_tables_cache", "_mapping_points_cache",
                     "_cell_extents_cache"):
            if hasattr(self, name):
                delattr(self, name)

    def _face_tables(self):
        """(neighbour cell, neighbour face) per (cell, face): all C·2dim
        sorted face keys sorted lexicographically; an interior face appears
        as two adjacent rows."""
        cached = getattr(self, "_face_tables_cache", None)
        if cached is not None:
            return cached
        fv = face_vertices(self.dim)
        C = self.n_cells_total
        F = 2 * self.dim
        keys = np.sort(
            np.stack([self.cells[:, fv[f]] for f in range(F)], axis=1),
            axis=2).reshape(C * F, -1)
        order = np.lexsort(keys.T[::-1])
        s = keys[order]
        eq = np.all(s[1:] == s[:-1], axis=1)
        if np.any(eq[1:] & eq[:-1]):
            raise ValueError("non-manifold face")
        a, b = order[:-1][eq], order[1:][eq]
        nbr = np.full(C * F, -1, dtype=np.int64)
        nface = np.full(C * F, -1, dtype=np.int64)
        nbr[a], nbr[b] = b // F, a // F
        nface[a], nface[b] = b % F, a % F
        cached = (nbr.reshape(C, F), nface.reshape(C, F))
        for arr in cached:
            arr.flags.writeable = False
        self._face_tables_cache = cached
        return cached

    def face_neighbors(self) -> np.ndarray:
        """(C, 2*dim) neighbour cell across each face; -1 at the boundary."""
        return self._face_tables()[0]

    def face_neighbor_faces(self) -> np.ndarray:
        """(C, 2*dim) the neighbour's local face on each face; -1."""
        return self._face_tables()[1]

    def boundary_vertex_mask(self) -> np.ndarray:
        fv = face_vertices(self.dim)
        nbr = self.face_neighbors()
        mask = np.zeros(self.n_vertices, dtype=bool)
        for f in range(2 * self.dim):
            bc = nbr[:, f] < 0
            if bc.any():
                mask[self.cells[bc][:, fv[f]].ravel()] = True
        return mask

    # -- refinement ----------------------------------------------------------

    def refine(self) -> "UnstructuredMesh":
        """Split every cell into 2^dim children (isotropic refinement).

        New vertices (edge midpoints, face midpoints, cell centres) are
        shared through entity-key dictionaries, so the refined mesh is
        conforming; with a chart every new vertex is the chart's image of its
        reference point, else new boundary vertices go through ``project``.
        """
        dim = self.dim
        nbr = self.face_neighbors()
        fv = face_vertices(dim)
        vc_f = VERTEX_COORDS[dim].astype(np.float64)
        cc, clo, ch = self._chart_boxes()

        new_pts: list[np.ndarray] = []
        new_chart_cell: list[int] = []
        new_chart_ref: list[np.ndarray] = []
        next_id = self.n_vertices

        def _mk(point: np.ndarray, cell: int, local_ref: np.ndarray) -> int:
            nonlocal next_id
            new_pts.append(point)
            if self.chart is not None:
                new_chart_cell.append(int(cc[cell]))
                new_chart_ref.append(clo[cell] + ch[cell] * local_ref)
            next_id += 1
            return next_id - 1

        # edge midpoints; an edge is on the boundary iff it belongs to some
        # boundary face
        edge_mid: dict[tuple, int] = {}
        edges = edge_vertices(dim)
        bnd_edges: set[tuple] = set()
        for c in range(self.n_cells_total):
            for f in range(2 * dim):
                if nbr[c, f] >= 0:
                    continue
                face_glob = self.cells[c, fv[f]]
                if dim == 2:
                    bnd_edges.add(tuple(sorted(face_glob)))
                else:
                    for a, b in ((0, 1), (2, 3), (0, 2), (1, 3)):
                        bnd_edges.add(tuple(sorted((face_glob[a],
                                                    face_glob[b]))))
        for c in range(self.n_cells_total):
            cv = self.cells[c]
            for (a, b, _ax) in edges:
                key = tuple(sorted((cv[a], cv[b])))
                if key in edge_mid:
                    continue
                mid = 0.5 * (self.vertices[key[0]] + self.vertices[key[1]])
                if (key in bnd_edges and self.project is not None
                        and self.chart is None):
                    mid = np.asarray(self.project(mid[None, :]))[0]
                edge_mid[key] = _mk(mid, c, 0.5 * (vc_f[a] + vc_f[b]))

        # face midpoints (3D)
        face_mid: dict[tuple, int] = {}
        if dim == 3:
            for c in range(self.n_cells_total):
                for f in range(2 * dim):
                    key = self.face_key(c, f)
                    if key in face_mid:
                        continue
                    mid = self.vertices[list(key)].mean(axis=0)
                    if (nbr[c, f] < 0 and self.project is not None
                            and self.chart is None):
                        mid = np.asarray(self.project(mid[None, :]))[0]
                    face_mid[key] = _mk(mid, c, vc_f[fv[f]].mean(axis=0))

        # cell centres
        centers = {}
        mid_ref = np.full(dim, 0.5)
        for c in range(self.n_cells_total):
            centers[c] = _mk(self.vertices[self.cells[c]].mean(axis=0), c,
                             mid_ref)

        all_vertices = np.concatenate(
            [self.vertices, np.array(new_pts).reshape(-1, dim)], axis=0)
        if self.chart is not None and new_chart_cell:
            # the straight midpoints above were placeholders
            ids = np.asarray(new_chart_cell, dtype=np.int64)
            refs = np.asarray(new_chart_ref)
            all_vertices[self.n_vertices:] = self.chart.eval(ids, refs)

        # children: the local fine lattice {0,1,2}^dim of each cell
        vc = VERTEX_COORDS[dim]
        children, parents, child_idx = [], [], []
        n_child = 2 ** dim
        for c in range(self.n_cells_total):
            cv = self.cells[c]
            lat = {}
            for li, coords in enumerate(vc):
                lat[tuple(2 * coords)] = cv[li]
            for (a, b, _ax) in edges:
                lat[tuple(vc[a] + vc[b])] = edge_mid[tuple(sorted((cv[a],
                                                                   cv[b])))]
            if dim == 3:
                for f in range(2 * dim):
                    pos = tuple(vc[fv[f]].sum(axis=0) // 2)
                    lat[pos] = face_mid[self.face_key(c, f)]
            lat[tuple([1] * dim)] = centers[c]
            for ci in range(n_child):
                oc = vc[ci]
                children.append([lat[tuple(oc + vc[li])]
                                 for li in range(n_child)])
                parents.append(c)
                child_idx.append(ci)

        parents_a = np.asarray(parents, dtype=np.int64)
        child_a = np.asarray(child_idx, dtype=np.int64)
        kw = {}
        if self.chart is not None:
            oct_f = VERTEX_COORDS[dim].astype(np.float64)
            kw = dict(chart=self.chart,
                      chart_cell=cc[parents_a],
                      chart_lo=clo[parents_a]
                      + 0.5 * ch[parents_a, None] * oct_f[child_a],
                      chart_h=0.5 * ch[parents_a])
        return UnstructuredMesh(dim=dim, vertices=all_vertices,
                                cells=np.asarray(children, dtype=np.int64),
                                project=self.project, parent_cells=parents_a,
                                child_index=child_a, **kw)

    def _chart_boxes(self):
        """(chart_cell, chart_lo, chart_h) with coarse-level defaults."""
        C = self.n_cells_total
        cc = (self.chart_cell if self.chart_cell is not None
              else np.arange(C, dtype=np.int64))
        clo = (self.chart_lo if self.chart_lo is not None
               else np.zeros((C, self.dim)))
        ch = self.chart_h if self.chart_h is not None else np.ones(C)
        return cc, clo, ch

    def refine_global(self, n: int) -> "UnstructuredMesh":
        m = self
        for _ in range(n):
            m = m.refine()
        return m

    # -- geometry ------------------------------------------------------------

    def cell_mapping_points(self, mapping_degree: int) -> np.ndarray:
        """(C, (m+1)^dim, dim) isoparametric Q_m support points (GLL lattice):
        the chart's image where there is one, else the multilinear blend of
        the vertices with the boundary lattices projected."""
        cache = getattr(self, "_mapping_points_cache", None)
        if cache is None:
            cache = self._mapping_points_cache = {}
        hit = cache.get(mapping_degree)
        if hit is not None:
            return hit
        dim = self.dim
        unit = tensor_lattice(gauss_lobatto_points(mapping_degree + 1), dim)
        if self.chart is not None:
            cc, clo, ch = self._chart_boxes()
            C, L = self.n_cells_total, unit.shape[0]
            refs = clo[:, None, :] + ch[:, None, None] * unit[None, :, :]
            sp = self.chart.eval(np.repeat(cc, L),
                                 refs.reshape(C * L, dim)).reshape(C, L, dim)
        else:
            vc = VERTEX_COORDS[dim].astype(np.float64)
            w = np.ones((unit.shape[0], vc.shape[0]))
            for d in range(dim):
                xd = unit[:, d][:, None]
                w = w * np.where(vc[None, :, d] > 0.5, xd, 1.0 - xd)
            sp = np.einsum("lv,cvd->cld", w, self.vertices[self.cells])
            if self.project is not None:
                sp = self._project_boundary_lattices(sp, unit)
        sp.flags.writeable = False
        cache[mapping_degree] = sp
        return sp

    def _project_boundary_lattices(self, sp: np.ndarray,
                                   unit: np.ndarray) -> np.ndarray:
        """Snap mapping support points on boundary faces and boundary edges
        to the manifold (a cell touching the boundary only along an edge
        must agree with the neighbour that owns the boundary face)."""
        dim = self.dim
        nbr = self.face_neighbors()
        for c, f in zip(*np.where(nbr < 0)):
            on_face = np.isclose(unit[:, f // 2], float(f % 2))
            sp[c, on_face] = np.asarray(self.project(sp[c, on_face]))
        if dim == 3:
            V = self.n_vertices
            fv = face_vertices(dim)
            keys = []
            for c, f in zip(*np.where(nbr < 0)):
                fg = self.cells[c, fv[f]]
                for a, b in ((0, 1), (2, 3), (0, 2), (1, 3)):
                    lo, hi = sorted((int(fg[a]), int(fg[b])))
                    keys.append(lo * V + hi)
            bnd_edges = np.unique(np.asarray(keys, dtype=np.int64))
            for (a, b, ax) in edge_vertices(dim):
                va, vb = self.cells[:, a], self.cells[:, b]
                k = np.minimum(va, vb) * V + np.maximum(va, vb)
                cs = np.where(np.isin(k, bnd_edges))[0]
                if len(cs) == 0:
                    continue
                on = np.ones(unit.shape[0], dtype=bool)
                for d in range(dim):
                    if d != ax:
                        on &= np.isclose(unit[:, d],
                                         float(VERTEX_COORDS[dim][a][d]))
                idx = np.where(on)[0]
                pts = sp[np.ix_(cs, idx)].reshape(-1, dim)
                sp[np.ix_(cs, idx)] = np.asarray(self.project(pts)).reshape(
                    len(cs), len(idx), dim)
        return sp

    def jacobian_factors(self, mapping_degree: int, quad_pts_1d: np.ndarray):
        """(B, sp) with J[c,q,e,d] = Σ_l B[q,l,d]·sp[c,l,e]."""
        sp = self.cell_mapping_points(mapping_degree)
        gll = gauss_lobatto_points(mapping_degree + 1)
        B = tensor_gradient(lagrange_values(gll, quad_pts_1d),
                            lagrange_derivatives(gll, quad_pts_1d), self.dim)
        return B, sp

    def jacobians(self, mapping_degree: int,
                  quad_pts_1d: np.ndarray) -> np.ndarray:
        """(C, Q, dim, dim) J[c,q,e,d] = ∂x_e/∂ξ_d at the quadrature points."""
        B, sp = self.jacobian_factors(mapping_degree, quad_pts_1d)
        return np.einsum("qld,cle->cqed", B, sp, optimize=True)

    def _extents_mapping_degree(self) -> int:
        return 1 if self.project is None else 2

    def harmonic_cell_extents(self, n_q_1d: int = 2) -> np.ndarray:
        """(C, dim) quadrature-averaged distance between opposite faces."""
        cache = getattr(self, "_cell_extents_cache", None)
        if cache is None:
            cache = self._cell_extents_cache = {}
        hit = cache.get(n_q_1d)
        if hit is not None:
            return hit
        q, w = gauss_points(n_q_1d)
        out = np.empty((self.n_cells_total, self.dim))
        mdeg = self._extents_mapping_degree()
        for d in range(self.dim):
            face_pts = []
            for val in (0.0, 1.0):
                coords = [q] * self.dim
                coords[d] = np.array([val])
                face_pts.append(tensor_lattice_nd(coords))
            p0 = self._physical_points(face_pts[0], mdeg)
            p1 = self._physical_points(face_pts[1], mdeg)
            dist = np.linalg.norm(p1 - p0, axis=2)
            wf = tensor_weights([w if i != d else np.array([1.0])
                                 for i in range(self.dim)])
            out[:, d] = dist @ wf
        out.flags.writeable = False
        cache[n_q_1d] = out
        return out

    def _physical_points(self, unit_pts: np.ndarray,
                         mapping_degree: int) -> np.ndarray:
        """(C, P, dim) images of per-cell reference points under the
        isoparametric mapping."""
        sp = self.cell_mapping_points(mapping_degree)
        gll = gauss_lobatto_points(mapping_degree + 1)
        P = unit_pts.shape[0]
        per_dim = [lagrange_values(gll, unit_pts[:, d])
                   for d in range(self.dim)]
        w = per_dim[0]
        for d in range(1, self.dim):
            w = (per_dim[d][:, :, None] * w[:, None, :]).reshape(P, -1)
        return np.einsum("pl,cld->cpd", w, sp)

    def harmonic_patch_extents(self, n_q_1d: int = 2) -> np.ndarray:
        """(C, dim, 3) [lower neighbour, own, upper neighbour] extents along
        each local axis; 0 where there is no neighbour.  The neighbour's
        extent is taken along its own axis orthogonal to the shared face."""
        ext = self.harmonic_cell_extents(n_q_1d)
        nbr = self.face_neighbors()
        nf = self.face_neighbor_faces()
        out = np.zeros((self.n_cells_total, self.dim, 3))
        out[:, :, 1] = ext
        for f in range(2 * self.dim):
            valid = nbr[:, f] >= 0
            d, s = f // 2, f % 2
            out[valid, d, 2 * s] = ext[nbr[valid, f], nf[valid, f] // 2]
        return out

    def max_aspect_ratio(self, n_q_1d: int = 2) -> float:
        q, _ = gauss_points(n_q_1d)
        J = self.jacobians(self._extents_mapping_degree(), q)
        s = np.linalg.svd(J, compute_uv=False)
        return float((s[..., 0] / s[..., -1]).max())


# -- the balanced ball ---------------------------------------------------------


class BallChart:
    """Transfinite chart of the balanced ball (the role of deal.II's
    TransfiniteInterpolationManifold): centre-block cells are multilinear;
    each shell cell adds to its multilinear blend the radial projection of
    its outer face's bilinear point onto the sphere, faded linearly in the
    radial reference coordinate, so the refined mesh stays watertight."""

    def __init__(self, vertices: np.ndarray, cells: np.ndarray, radius: float):
        self.dim = int(vertices.shape[1])
        self.corners = vertices[cells]        # (C, 2^dim, dim)
        self.radius = float(radius)
        C = cells.shape[0]
        self.axis = np.full(C, -1, dtype=np.int64)   # radial local axis
        self.side = np.zeros(C, dtype=np.int64)      # 1 if outer face at ref 1
        fv = face_vertices(self.dim)
        on_sphere = np.isclose(np.linalg.norm(self.corners, axis=2), radius,
                               rtol=1e-9)
        for f in range(2 * self.dim):
            hit = on_sphere[:, fv[f]].all(axis=1)
            self.axis[hit] = f // 2
            self.side[hit] = f % 2

    @staticmethod
    def _blend(corners: np.ndarray, ref: np.ndarray) -> np.ndarray:
        """Multilinear blend of corners (N, 2^dim, dim) at ref (N, dim)."""
        dim = corners.shape[2]
        vc = VERTEX_COORDS[dim].astype(np.float64)
        w = np.ones((ref.shape[0], vc.shape[0]))
        for d in range(dim):
            xd = ref[:, d][:, None]
            w = w * np.where(vc[None, :, d] > 0.5, xd, 1.0 - xd)
        return np.einsum("nv,nvd->nd", w, corners)

    def eval(self, ids: np.ndarray, ref: np.ndarray) -> np.ndarray:
        corners = self.corners[ids]
        out = self._blend(corners, ref)
        ax = self.axis[ids]
        idx = np.where(ax >= 0)[0]
        if len(idx) == 0:
            return out
        a = ax[idx]
        s = self.side[ids][idx]
        rows = np.arange(len(idx))
        ref_out = ref[idx].copy()
        ref_out[rows, a] = s.astype(np.float64)
        b_out = self._blend(corners[idx], ref_out)
        p_out = b_out / np.linalg.norm(b_out, axis=1, keepdims=True) * self.radius
        ra = ref[idx][rows, a]
        w_rad = np.where(s > 0, ra, 1.0 - ra)
        out[idx] += w_rad[:, None] * (p_out - b_out)
        return out


def hyper_ball_balanced(dim: int, radius: float = 1.0) -> UnstructuredMesh:
    """Balanced ball: 2^dim centre cells and one shell cell on each outer
    face of the centre block, 12 cells in 2D and 32 in 3D (the cell counts of
    GridGenerator::hyper_ball_balanced)."""
    # inner half-width, swept in the JAX package for the smallest refined
    # max aspect ratio under the chart
    a = radius / (2.0 * np.sqrt(dim)) * 1.3
    grid_1d = np.array([-a, 0.0, a])
    pts = np.stack(np.meshgrid(*([grid_1d] * dim), indexing="ij"),
                   axis=-1).reshape(-1, dim)
    coords = np.stack(np.meshgrid(*([np.arange(3)] * dim), indexing="ij"),
                      axis=-1).reshape(-1, dim)
    flat = sum(coords[:, d] * 3 ** d for d in range(dim))  # x fastest
    vertices = np.zeros((3 ** dim, dim))
    vertices[flat] = pts

    vc = VERTEX_COORDS[dim]
    cells = [[int(sum((vc[ci] + vc[li])[d] * 3 ** d for d in range(dim)))
              for li in range(2 ** dim)] for ci in range(2 ** dim)]

    vertices = list(vertices)
    cache = {tuple(np.round(v, 12)): i for i, v in enumerate(vertices)}

    def vertex_id(pt: np.ndarray) -> int:
        key = tuple(np.round(pt, 12))
        if key not in cache:
            cache[key] = len(vertices)
            vertices.append(np.asarray(pt, dtype=np.float64))
        return cache[key]

    def proj(p):
        p = np.asarray(p, dtype=np.float64)
        return p / np.linalg.norm(p, axis=-1, keepdims=True) * radius

    # one shell cell between each outer face of the block and its spherical
    # projection; the lower side lists the outer face first, which keeps the
    # Jacobian positive
    block = UnstructuredMesh(dim, np.asarray(vertices),
                             np.asarray(cells, dtype=np.int64))
    nbr = block.face_neighbors()
    fv = face_vertices(dim)
    shell_cells = []
    for c in range(block.n_cells_total):
        for f in range(2 * dim):
            if nbr[c, f] >= 0:
                continue
            inner = block.cells[c, fv[f]]
            outer = [vertex_id(proj(np.asarray(vertices[v]))) for v in inner]
            shell_cells.append(list(inner) + outer if f % 2 == 1
                               else outer + list(inner))

    all_cells = np.concatenate([np.asarray(cells, dtype=np.int64),
                                np.asarray(shell_cells, dtype=np.int64)])
    mesh = UnstructuredMesh(dim, np.asarray(vertices, dtype=np.float64),
                            all_cells, project=proj)
    _fix_cell_orientations(mesh)
    # the chart reads the final vertex order; ``project`` stays attached as
    # the curved-geometry marker (mapping degree 2)
    mesh.chart = BallChart(mesh.vertices, mesh.cells, radius)
    mesh.invalidate_caches()
    return mesh


def _fix_cell_orientations(mesh: UnstructuredMesh) -> None:
    """Flip cells with a non-positive Jacobian determinant along local x."""
    q = np.array([0.5])
    det = np.linalg.det(mesh.jacobians(1, q)[:, 0])
    bad = np.where(det <= 0)[0]
    if len(bad) == 0:
        return
    vc = VERTEX_COORDS[mesh.dim]
    perm = np.empty(2 ** mesh.dim, dtype=np.int64)
    for i in range(2 ** mesh.dim):
        flipped = vc[i].copy()
        flipped[0] = 1 - flipped[0]
        perm[i] = int(np.where((vc == flipped).all(axis=1))[0][0])
    mesh.cells[bad] = mesh.cells[bad][:, perm]
    mesh.invalidate_caches()
    det = np.linalg.det(mesh.jacobians(1, q)[:, 0])
    if not (det > 0).all():
        raise ValueError("cell orientation fix failed")
