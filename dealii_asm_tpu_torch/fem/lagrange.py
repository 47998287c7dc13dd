"""1D Lagrange finite elements on [0, 1] (NumPy).

Carried over from ``dealii_asm_tpu/fem/lagrange.py`` so that the port stands
alone: Gauss and Gauss-Lobatto points, Lagrange basis values and
derivatives, and the 1D reference mass/stiffness matrices that seed the
operator's factors, the FDM patch matrices and the transfers.  The
arithmetic is the same, so the tables equal the JAX package's.
"""

from __future__ import annotations

import functools

import numpy as np


def gauss_points(n: int) -> tuple[np.ndarray, np.ndarray]:
    """n-point Gauss-Legendre quadrature on [0, 1]: (points, weights)."""
    x, w = np.polynomial.legendre.leggauss(n)
    return 0.5 * (x + 1.0), 0.5 * w


def gauss_lobatto_points(n: int) -> np.ndarray:
    """n Gauss-Lobatto-Legendre points on [0, 1] (FE_Q support points)."""
    if n < 2:
        raise ValueError("need at least 2 GLL points")
    if n == 2:
        return np.array([0.0, 1.0])
    # interior GLL nodes: roots of Jacobi(1,1) of degree n-2
    from scipy.special import roots_jacobi

    xi, _ = roots_jacobi(n - 2, 1.0, 1.0)
    return np.concatenate([[0.0], 0.5 * (xi + 1.0), [1.0]])


def _barycentric_weights(nodes: np.ndarray) -> np.ndarray:
    diff = nodes[:, None] - nodes[None, :]
    np.fill_diagonal(diff, 1.0)
    return 1.0 / np.prod(diff, axis=1)


def lagrange_values(nodes: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Lagrange basis on ``nodes`` at points ``x``: (len(x), len(nodes))."""
    nodes = np.asarray(nodes, dtype=np.float64)
    x = np.asarray(x, dtype=np.float64)
    w = _barycentric_weights(nodes)
    out = np.empty((len(x), len(nodes)))
    for i, xi in enumerate(x):
        d = xi - nodes
        hit = np.isclose(d, 0.0, atol=1e-14)
        if hit.any():
            out[i] = hit.astype(np.float64)
        else:
            t = w / d
            out[i] = t / t.sum()
    return out


def lagrange_derivatives(nodes: np.ndarray, x: np.ndarray) -> np.ndarray:
    """First derivatives of the Lagrange basis at ``x``: (len(x), len(nodes)),
    by the product rule l_j'(x) = Σ_k Π_{m≠j,k} (x − n_m) / Π_{m≠j} (n_j − n_m)."""
    nodes = np.asarray(nodes, dtype=np.float64)
    x = np.asarray(x, dtype=np.float64)
    n = len(nodes)
    out = np.zeros((len(x), n))
    for q, xq in enumerate(x):
        for j in range(n):
            denom = np.prod([nodes[j] - nodes[m] for m in range(n) if m != j])
            s = 0.0
            for k in range(n):
                if k == j:
                    continue
                p = 1.0
                for m in range(n):
                    if m != j and m != k:
                        p *= xq - nodes[m]
                s += p
            out[q, j] = s / denom
    return out


@functools.lru_cache(maxsize=None)
def reference_mass_stiffness_1d(degree: int, n_q: int | None = None):
    """1D reference mass and stiffness on the unit interval (Gauss quadrature
    with n_q = degree+1 points by default): M_ij = ∫ N_i N_j, K_ij = ∫ N_i' N_j'.
    On a cell of width h, M scales by h and K by 1/h."""
    if n_q is None:
        n_q = degree + 1
    nodes = gauss_lobatto_points(degree + 1)
    q, w = gauss_points(n_q)
    N = lagrange_values(nodes, q)
    D = lagrange_derivatives(nodes, q)
    M = np.einsum("q,qi,qj->ij", w, N, N)
    K = np.einsum("q,qi,qj->ij", w, D, D)
    return M, K
