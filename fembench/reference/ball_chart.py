"""The balanced ball and its transfinite chart (frozen copy, NumPy, float64).

The unit ball is cut into 32 hexahedra.  The cube [−a, a]³ with
a = 1.3 / (2√3) is split at the origin into 8 centre cells; on each of its
24 outer quarter faces sits one shell cell, between that face and its
radial projection onto the sphere.  Every cell is the image of the
reference cube [0, 1]³ under its chart:

- the trilinear blend B(ξ) of its eight corners (local corner v = (vx, vy,
  vz) ∈ {0, 1}³, x fastest);
- in a shell cell, plus w(ξ) · (P(B̂(ξ)) − B̂(ξ)): B̂ is the blend on the
  outer face (the radial coordinate ξ_d set to the outer side s), P the
  radial projection onto the sphere, and w the radial coordinate, faded
  linearly from the inner face (0) to the outer one (1).

Each cell's local axes follow the global ones (local x along global x, and
so on), so every chart has a positive Jacobian determinant; a shell cell's
radial axis d is the global axis normal to its face, with its outer face
at ξ_d = s.  The chart is continuous across cells: on a face two cells
share, both blends and both outer-face blends reduce to the same corners.
"""

from __future__ import annotations

import functools
import itertools

import numpy as np

RADIUS = 1.0
HALF_WIDTH = RADIUS * 1.3 / (2.0 * np.sqrt(3.0))  # a: the centre cube's half width
CORNERS = np.array(list(itertools.product((0, 1), repeat=3)))[:, ::-1]  # x fastest


@functools.lru_cache(maxsize=None)
def coarse_cells() -> tuple:
    """(corners (32, 8, 3), radial axis (32,), outer side (32,)) of the 32
    cells, the centre cells first (radial axis −1); read-only."""
    grid = np.array([-HALF_WIDTH, 0.0, HALF_WIDTH])
    corners, axis, side = [], [], []
    centre = list(itertools.product((0, 1), repeat=3))
    for idx in centre:  # (ix, iy, iz) of the centre cell
        corners.append([grid[np.add(idx, v)] for v in CORNERS])
        axis.append(-1)
        side.append(0)
    for idx in centre:
        for d in range(3):
            s = idx[d]  # the centre cell's face on the cube's boundary
            cell = []
            for v in CORNERS:
                q = grid[np.add(idx, v)]
                q[d] = grid[idx[d] + s]  # the point on the cube's face
                cell.append(q / np.linalg.norm(q) * RADIUS if v[d] == s else q)
            corners.append(cell)
            axis.append(d)
            side.append(s)
    out = (np.array(corners), np.array(axis), np.array(side))
    for a in out:
        a.flags.writeable = False
    return out


def blend(corners: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """Trilinear blend of ``corners`` (8, 3) at the reference points
    ``ref`` (P, 3)."""
    w = np.ones((ref.shape[0], 8))
    for d in range(3):
        w *= np.where(CORNERS[None, :, d] == 1, ref[:, d, None],
                      1.0 - ref[:, d, None])
    return w @ corners


def chart(cell: int, ref: np.ndarray) -> np.ndarray:
    """(P, 3) images of the reference points ``ref`` (P, 3) of [0, 1]³
    under the chart of coarse cell ``cell``."""
    corners, axis, side = coarse_cells()
    ref = np.asarray(ref, np.float64)
    out = blend(corners[cell], ref)
    d = int(axis[cell])
    if d < 0:
        return out
    s = int(side[cell])
    on_face = ref.copy()
    on_face[:, d] = float(s)
    b = blend(corners[cell], on_face)
    w = ref[:, d] if s == 1 else 1.0 - ref[:, d]
    proj = b / np.linalg.norm(b, axis=1, keepdims=True) * RADIUS
    return out + w[:, None] * (proj - b)
