"""The CEED Kershaw map of the unit cube (frozen copy, NumPy, float64).

The x-range is cut into six layers; in each, y and z are bent by the
piecewise-linear maps ``right``/``left`` of strength eps, blended across the
middle layers with the quintic smoothstep.  eps = 1 leaves the cube
uniform; the benchmark's Kershaw configuration takes eps = 0.3 in y and z.
"""

from __future__ import annotations

import numpy as np


def _right(eps: float, t: np.ndarray) -> np.ndarray:
    return np.where(t <= 0.5, (2.0 - eps) * t, 1.0 + eps * (t - 1.0))


def _left(eps: float, t: np.ndarray) -> np.ndarray:
    return 1.0 - _right(eps, 1.0 - t)


def _smoothstep(a: np.ndarray, b: np.ndarray, t: np.ndarray) -> np.ndarray:
    t = np.clip(t, 0.0, 1.0)
    return a + (b - a) * t * t * t * (t * (6.0 * t - 15.0) + 10.0)


def kershaw(points: np.ndarray, epsy: float, epsz: float) -> np.ndarray:
    """Map (P, 3) points of the unit cube to the Kershaw mesh's geometry."""
    p = np.asarray(points, np.float64)
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    layer = np.floor(6.0 * x).astype(np.int64)
    lam = 6.0 * x - layer
    ly, ry, lz, rz = _left(epsy, y), _right(epsy, y), _left(epsz, z), _right(epsz, z)
    Y = np.where(layer <= 0, ly, ry)
    Z = np.where(layer <= 0, lz, rz)
    for L, (a_y, b_y, a_z, b_z, t) in {
            1: (ly, ry, lz, rz, lam), 4: (ly, ry, lz, rz, lam),
            2: (ry, ly, rz, lz, lam / 2.0),
            3: (ry, ly, rz, lz, (1.0 + lam) / 2.0)}.items():
        m = layer == L
        Y[m] = _smoothstep(a_y[m], b_y[m], t[m])
        Z[m] = _smoothstep(a_z[m], b_z[m], t[m])
    return np.stack([x, Y, Z], axis=1)
