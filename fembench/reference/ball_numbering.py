"""The program's DoF numbering of the ball, which the reference needs for
one thing alone: the start vector of its eigenvalue estimates.

deal.II's Lanczos estimate, and the program's, starts from i mod 11 in the
level's DoF numbering, so the estimate, and with it each Chebyshev
smoother, depends on how the DoFs are numbered: from i mod 11 in two
numberings the estimates of the ball's Q1 levels differ by about 1.7%,
and the V-cycles by about 1e-3, far above their rounding.  So the
reference starts its Lanczos from i mod 11 in the program's numbering,
which ``program_order`` gives for each of the reference's DoFs; its
operators, patch inverses, transfers and coarse solve use its own
numbering and nothing of this module.  Were this numbering wrong, the two
estimates would part again and the run would read ``correct`` false: it
cannot hide a fault.

The numbering (the program's ``mesh/unstructured.py`` and
``fem/general_dofs.py``, as a description, not as code):

- coarse mesh: the 32 cells of the balanced ball with the vertex ids of
  ``CELLS`` (53 vertices); program cell c is the reference's coarse cell
  ``COARSE[c]``, and its local corner k (x fastest) sits at the
  reference's corner ``FRAME[c, k]`` of that cell, so the program's local
  axes are a symmetry of the reference's [0, 1]³;
- refinement: cell 8·parent + octant (octant x fastest in the parent's
  axes); the new vertices come after the old, numbered in order of first
  appearance: the edge midpoints over the cells and their 12 edges, then
  the face midpoints over the cells and their 6 faces (face 2d + s on
  side s of axis d), then the cell centres;
- Q_p DoFs: the vertices; then p − 1 on each line, the lines in the order
  of their (lower, higher) vertex ids and the nodes from the lower
  vertex; then (p − 1)² on each quad, the quads in the order of their
  sorted corner ids and the nodes u fastest, the origin at the corner of
  the lowest id and u towards its neighbour of the lower id; then
  (p − 1)³ in each cell, in cell order, x fastest in the cell's axes.
"""

from __future__ import annotations

import functools

import numpy as np

COARSE = (0, 4, 2, 6, 1, 5, 3, 7, 8, 9, 10, 20, 21, 22, 14, 15, 16, 26, 27,
          28, 11, 12, 13, 23, 24, 25, 17, 18, 19, 29, 30, 31)
CELLS = (
    (0, 1, 3, 4, 9, 10, 12, 13), (1, 2, 4, 5, 10, 11, 13, 14),
    (3, 4, 6, 7, 12, 13, 15, 16), (4, 5, 7, 8, 13, 14, 16, 17),
    (9, 10, 12, 13, 18, 19, 21, 22), (10, 11, 13, 14, 19, 20, 22, 23),
    (12, 13, 15, 16, 21, 22, 24, 25), (13, 14, 16, 17, 22, 23, 25, 26),
    (27, 28, 29, 30, 0, 3, 9, 12), (31, 27, 32, 29, 1, 0, 10, 9),
    (27, 31, 28, 33, 0, 1, 3, 4), (2, 5, 11, 14, 34, 35, 36, 37),
    (34, 31, 36, 32, 2, 1, 11, 10), (31, 34, 33, 35, 1, 2, 4, 5),
    (28, 38, 30, 39, 3, 6, 12, 15), (7, 6, 16, 15, 40, 38, 41, 39),
    (28, 33, 38, 40, 3, 4, 6, 7), (5, 8, 14, 17, 35, 42, 37, 43),
    (8, 7, 17, 16, 42, 40, 43, 41), (33, 35, 40, 42, 4, 5, 7, 8),
    (29, 30, 44, 45, 9, 12, 18, 21), (32, 29, 46, 44, 10, 9, 19, 18),
    (18, 19, 21, 22, 44, 46, 45, 47), (11, 14, 20, 23, 36, 37, 48, 49),
    (36, 32, 48, 46, 11, 10, 20, 19), (19, 20, 22, 23, 46, 48, 47, 49),
    (30, 39, 45, 50, 12, 15, 21, 24), (16, 15, 25, 24, 41, 39, 51, 50),
    (21, 22, 24, 25, 45, 47, 50, 51), (14, 17, 23, 26, 37, 43, 49, 52),
    (17, 16, 26, 25, 43, 41, 52, 51), (22, 23, 25, 26, 47, 49, 51, 52))
N_VERTICES = 53
_SAME = (0, 1, 2, 3, 4, 5, 6, 7)
_RADIAL_X = (0, 2, 4, 6, 1, 3, 5, 7)  # local z along the reference's x
_RADIAL_Y = (1, 0, 5, 4, 3, 2, 7, 6)  # local z along y, local x flipped
FRAME = (_SAME,) * 8 + (_RADIAL_X, _RADIAL_Y, _SAME) * 8

# local corners (x fastest), edges (corner pairs along one axis) and faces
# (face 2d + s: its corners, the lower remaining axis fastest)
CORNER = np.array([[k & 1, k >> 1 & 1, k >> 2 & 1] for k in range(8)])
EDGES = [(a, b) for a in range(8) for b in range(a + 1, 8)
         if np.abs(CORNER[a] - CORNER[b]).sum() == 1]
FACES = [np.flatnonzero(CORNER[:, d] == s) for d in range(3) for s in (0, 1)]


def frames() -> tuple:
    """(A (32, 3, 3), t (32, 3)) of the program's coarse cells: a point ξ of
    [0, 1]³ in the program cell's axes is A ξ + t in the reference cell's."""
    F = np.asarray(FRAME)
    t = CORNER[F[:, 0]]
    A = np.stack([CORNER[F[:, 1 << d]] - t for d in range(3)], axis=2)
    return A, t


def _locate(gidx: np.ndarray, N: int):
    """A function of (program coarse cell (K,), program-axis lattice
    coordinates (K, 3)) giving the reference's DoFs in ``gidx`` (32, N, N,
    N) [z, y, x]."""
    A, t = frames()
    coarse = np.asarray(COARSE)

    def at(pc: np.ndarray, X: np.ndarray) -> np.ndarray:
        Y = np.einsum("kij,kj->ki", A[pc], X) + t[pc] * (N - 1)
        return gidx[coarse[pc], Y[:, 2], Y[:, 1], Y[:, 0]]

    return at


@functools.lru_cache(maxsize=None)
def mesh(r: int) -> tuple:
    """(pc (C,), lo (C, 3), vid (n,)) at refinement r: each program cell's
    coarse cell and lower corner in its coarse cell's axes (lattice units
    of a cell), and the program's vertex id of each of the reference's Q1
    DoFs; read-only."""
    from .ball import numbering

    gidx = numbering(r, 1)[0]
    N = gidx.shape[1]
    at = _locate(gidx, N)
    vid = np.full(int(gidx.max()) + 1, -1, np.int64)
    pc = np.arange(32)
    lo = np.zeros((32, 3), np.int64)
    h = N - 1
    for k in range(8):
        vid[at(pc, lo + CORNER[k] * h)] = np.asarray(CELLS)[:, k]
    n = N_VERTICES
    for _ in range(r):
        half = h // 2

        def fresh(ids: np.ndarray) -> None:
            nonlocal n
            uniq, first = np.unique(ids.reshape(-1), return_index=True)
            uniq = uniq[np.argsort(first)]
            vid[uniq] = n + np.arange(len(uniq))
            n += len(uniq)

        rows = np.repeat(pc, len(EDGES))
        fresh(at(rows, np.concatenate(
            [lo + (CORNER[a] + CORNER[b]) * half for a, b in EDGES],
            axis=1).reshape(-1, 3)))
        face_mid = [np.where(np.arange(3) == d, s * h, half)
                    for d in range(3) for s in (0, 1)]
        fresh(at(np.repeat(pc, 6), (lo[:, None] + np.asarray(face_mid)[None])
                 .reshape(-1, 3)))
        fresh(at(pc, lo + half))
        lo = (lo[:, None] + CORNER[None] * half).reshape(-1, 3)
        pc = np.repeat(pc, 8)
        h = half
    assert (vid >= 0).all() and n == len(vid)
    for a in (pc, lo, vid):
        a.flags.writeable = False
    return pc, lo, vid


def program_order(r: int, degree: int) -> np.ndarray:
    """(n,) the program's index of each of the reference's Q_degree DoFs
    (``ball.numbering(r, degree)``) at refinement r."""
    from .ball import numbering

    p = int(degree)
    pc, lo, vid = mesh(r)
    if p == 1:
        return vid.copy()
    q1 = numbering(r, 1)[0]
    at1 = _locate(q1, q1.shape[1])
    cv = np.stack([vid[at1(pc, lo + CORNER[k])] for k in range(8)], axis=1)
    gidx = numbering(r, p)[0]
    C, q = len(pc), p - 1
    ends = np.stack([cv[:, [a, b]] for a, b in EDGES], axis=1)  # (C, 12, 2)
    _, line = np.unique(np.sort(ends, axis=2).reshape(-1, 2), axis=0,
                        return_inverse=True)
    line = line.reshape(C, len(EDGES))
    quad_corners = np.stack([cv[:, f] for f in FACES], axis=1)  # (C, 6, 4)
    _, quad = np.unique(np.sort(quad_corners, axis=2).reshape(-1, 4), axis=0,
                        return_inverse=True)
    quad = quad.reshape(C, 6)
    off_line = len(vid)
    off_quad = off_line + (int(line.max()) + 1) * q
    off_cell = off_quad + (int(quad.max()) + 1) * q * q
    at = _locate(gidx, gidx.shape[1])
    order = np.full(int(gidx.max()) + 1, -1, np.int64)
    rows = np.arange(C)
    for z in range(p + 1):
        for y in range(p + 1):
            for x in range(p + 1):
                X = np.array([x, y, z])
                inner = (X > 0) & (X < p)
                k = int(inner.sum())
                if k == 0:
                    prog = cv[:, int(x // p + 2 * (y // p) + 4 * (z // p))]
                elif k == 1:
                    d = int(np.flatnonzero(inner)[0])
                    ends_at = [int((X0 // p) @ [1, 2, 4])
                               for X0 in (np.where(inner, 0, X),
                                          np.where(inner, p, X))]
                    e = EDGES.index(tuple(ends_at))
                    pos = np.where(cv[:, ends_at[0]] < cv[:, ends_at[1]],
                                   X[d] - 1, p - 1 - X[d])
                    prog = off_line + line[:, e] * q + pos
                elif k == 2:
                    a, b = np.flatnonzero(inner)
                    out = 3 - a - b
                    f = 2 * out + int(X[out] // p)
                    prog = off_quad + quad[:, f] * q * q + _quad_slot(
                        quad_corners[:, f], int(X[a]), int(X[b]), p)
                else:
                    prog = off_cell + rows * q ** 3 + (
                        (x - 1) + (y - 1) * q + (z - 1) * q * q)
                order[at(pc, lo * p + X)] = prog
    assert (order >= 0).all()
    return order


def _quad_slot(corners: np.ndarray, s: int, t: int, p: int) -> np.ndarray:
    """(C,) the index (v − 1)(p − 1) + (u − 1) of the quad node at face
    coordinates (s, t) of face corners ``corners`` (C, 4) (corner i at
    (s, t) = p · (i & 1, i >> 1)): the origin the corner of the lowest id,
    u towards its neighbour (along s or t) of the lower id."""
    o = np.argmin(corners, axis=1)
    along_s, along_t = o ^ 1, o ^ 2
    rows = np.arange(len(o))
    u_on_s = corners[rows, along_s] < corners[rows, along_t]
    s_pos = np.where(o & 1, p - s, s)  # distance from the origin along s
    t_pos = np.where(o & 2, p - t, t)
    u = np.where(u_on_s, s_pos, t_pos)
    v = np.where(u_on_s, t_pos, s_pos)
    return (v - 1) * (p - 1) + (u - 1)
