"""1D finite-element tables on [0, 1] for the plain reference (NumPy, float64).

Gauss-Legendre quadrature, Gauss-Lobatto-Legendre (GLL) support points and
their lattice along one axis of a box, Lagrange basis values and
derivatives, and the 1D reference mass and stiffness matrices.  Written from the textbook definitions: the reference
shares no code with the program it judges.
"""

from __future__ import annotations

import numpy as np


def gauss(n: int) -> tuple[np.ndarray, np.ndarray]:
    """n-point Gauss-Legendre rule on [0, 1]: (points, weights)."""
    x, w = np.polynomial.legendre.leggauss(n)
    return 0.5 * (x + 1.0), 0.5 * w


def gll(n: int) -> np.ndarray:
    """n Gauss-Lobatto-Legendre points on [0, 1]: the ends and the roots of
    P'_{n-1}, ascending."""
    if n < 2:
        raise ValueError("GLL needs two points or more")
    inner = np.polynomial.legendre.Legendre.basis(n - 1).deriv().roots()
    return np.concatenate([[0.0], 0.5 * (np.sort(inner.real) + 1.0), [1.0]])


def node_coordinates(cells: int, degree: int) -> np.ndarray:
    """Unit-box coordinates of the GLL-node lattice along one axis."""
    nodes = gll(degree + 1)
    k = np.arange(cells * degree + 1)
    cell = np.minimum(k // degree, cells - 1)
    return (cell + nodes[k - cell * degree]) / cells


def lagrange(nodes: np.ndarray, x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(values, derivatives), each (len(x), len(nodes)), of the Lagrange
    basis on ``nodes`` at the points ``x``, from the product formulas."""
    nodes = np.asarray(nodes, np.float64)
    x = np.asarray(x, np.float64)
    n = len(nodes)
    val = np.ones((len(x), n))
    der = np.zeros((len(x), n))
    for j in range(n):
        others = [m for m in range(n) if m != j]
        denom = np.prod([nodes[j] - nodes[m] for m in others])
        for m in others:
            val[:, j] *= x - nodes[m]
        for k in others:
            term = np.ones(len(x))
            for m in others:
                if m != k:
                    term *= x - nodes[m]
            der[:, j] += term
        val[:, j] /= denom
        der[:, j] /= denom
    return val, der


def mass_stiffness_1d(degree: int) -> tuple[np.ndarray, np.ndarray]:
    """Reference 1D mass and stiffness on [0, 1] of the GLL-node basis,
    integrated with degree + 1 Gauss points (exact for both)."""
    q, w = gauss(degree + 1)
    N, D = lagrange(gll(degree + 1), q)
    return (N.T * w) @ N, (D.T * w) @ D
