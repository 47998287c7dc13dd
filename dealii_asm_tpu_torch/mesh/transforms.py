"""Analytic mesh transformations (vectorized NumPy, unit-cube input).

Carried over from ``dealii_asm_tpu/mesh/transforms.py:16-75``: the Kershaw
deformation (quintic-smoothstep variant).  A transform maps an (N, dim)
array of box points to (N, dim) physical points.
"""

from __future__ import annotations

import numpy as np


def _right(eps: float, x: np.ndarray) -> np.ndarray:
    return np.where(x <= 0.5, (2.0 - eps) * x, 1.0 + eps * (x - 1.0))


def _left(eps: float, x: np.ndarray) -> np.ndarray:
    return 1.0 - _right(eps, 1.0 - x)


def _step(a: np.ndarray, b: np.ndarray, x: np.ndarray) -> np.ndarray:
    x = np.clip(x, 0.0, 1.0)
    s = x * x * x * (x * (6.0 * x - 15.0) + 10.0)
    return a + (b - a) * s


def kershaw_transform(epsy: float, epsz: float, shift_mp: bool = False):
    """Generalized 3D Kershaw mesh transformation (2D: z ignored).

    The x-range splits into 6 layers; epsy = epsz = 1 gives the uniform mesh.
    ``shift_mp`` subtracts 0.5 per coordinate (the "kershaw-mp" geometry).
    """

    def f(p: np.ndarray) -> np.ndarray:
        p = np.asarray(p, dtype=np.float64)
        dim = p.shape[1]
        x = p[:, 0]
        y = p[:, 1]
        z = p[:, 2] if dim == 3 else np.zeros_like(x)

        layer = np.floor(x * 6.0).astype(np.int64)
        lam = (x - layer / 6.0) * 6.0

        ly, ry = _left(epsy, y), _right(epsy, y)
        lz, rz = _left(epsz, z), _right(epsz, z)

        Y = np.empty_like(y)
        Z = np.empty_like(z)
        for L in range(7):
            m = layer == L
            if not m.any():
                continue
            if L == 0:
                Y[m], Z[m] = ly[m], lz[m]
            elif L in (1, 4):
                Y[m] = _step(ly[m], ry[m], lam[m])
                Z[m] = _step(lz[m], rz[m], lam[m])
            elif L == 2:
                Y[m] = _step(ry[m], ly[m], lam[m] / 2.0)
                Z[m] = _step(rz[m], lz[m], lam[m] / 2.0)
            elif L == 3:
                Y[m] = _step(ry[m], ly[m], (1.0 + lam[m]) / 2.0)
                Z[m] = _step(rz[m], lz[m], (1.0 + lam[m]) / 2.0)
            else:  # 5, 6 (x == 1.0 lands in layer 6)
                Y[m], Z[m] = ry[m], rz[m]

        out = np.stack([x, Y] + ([Z] if dim == 3 else []), axis=1)
        if shift_mp:
            out = out - 0.5
        return out

    return f
