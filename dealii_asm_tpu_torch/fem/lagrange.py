"""1D Lagrange finite elements on [0, 1] and their tensor products (NumPy).

Carried over from ``dealii_asm_tpu/fem/lagrange.py`` so that the port stands
alone: Gauss and Gauss-Lobatto points, Lagrange basis values and
derivatives, the 1D shape data ``shape_1d``, and the 1D reference
mass/stiffness matrices that seed the operator's factors, the FDM patch
matrices and the transfers.  The tensor helpers (``tensor_lattice``,
``tensor_weights``, ``tensor_gradient``) come from
``dealii_asm_tpu/mesh/grid.py:241-272``.  The arithmetic is the same, so the
tables equal the JAX package's.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

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


@dataclass(frozen=True)
class Shape1D:
    """1D shape data on [0, 1]: GLL support points, Gauss points and weights,
    basis values N (n_q, p+1) and derivatives D (n_q, p+1)."""

    degree: int
    n_q: int
    nodes: np.ndarray
    q: np.ndarray
    w: np.ndarray
    N: np.ndarray
    D: np.ndarray


@functools.lru_cache(maxsize=None)
def shape_1d(degree: int, n_q: int | None = None) -> Shape1D:
    if n_q is None:
        n_q = degree + 1
    nodes = gauss_lobatto_points(degree + 1)
    q, w = gauss_points(n_q)
    return Shape1D(degree, n_q, nodes, q, w, lagrange_values(nodes, q),
                   lagrange_derivatives(nodes, q))


@functools.lru_cache(maxsize=None)
def reference_mass_stiffness_1d(degree: int, n_q: int | None = None):
    """1D reference mass and stiffness on the unit interval (Gauss quadrature
    with n_q = degree+1 points by default): M_ij = ∫ N_i N_j, K_ij = ∫ N_i' N_j'.
    On a cell of width h, M scales by h and K by 1/h."""
    s = shape_1d(degree, n_q)
    M = np.einsum("q,qi,qj->ij", s.w, s.N, s.N)
    K = np.einsum("q,qi,qj->ij", s.w, s.D, s.D)
    return M, K


def tensor_lattice_nd(pts: list) -> np.ndarray:
    """Tensor lattice of per-direction 1D point sets: (Π n_d, dim), x fastest
    in the flat index."""
    grids = np.meshgrid(*reversed(pts), indexing="ij")  # slowest = last dim
    return np.stack([g.ravel() for g in reversed(grids)], axis=1)


def tensor_lattice(pts_1d: np.ndarray, dim: int) -> np.ndarray:
    """Tensor lattice of identical 1D point sets: (n^dim, dim), x fastest."""
    return tensor_lattice_nd([pts_1d] * dim)


def tensor_weights(ws: list) -> np.ndarray:
    """Tensor-product quadrature weights, x fastest in the flat index."""
    w = ws[0]
    for wn in ws[1:]:
        w = (wn[:, None] * w[None, :]).ravel()
    return w


def tensor_values(N: np.ndarray, dim: int) -> np.ndarray:
    """(q^dim, n^dim) tensor-product basis values, x fastest."""
    out = np.array([[1.0]])
    for _ in range(dim):
        out = np.kron(out, N)
    return out


def tensor_gradient(N: np.ndarray, D: np.ndarray, dim: int) -> np.ndarray:
    """Gradient tensor B[q, l, d] (q^dim, n^dim, dim) from 1D values and
    derivatives, x fastest: direction d uses D, the others N."""
    mats = []
    for d in range(dim):
        m = np.array([[1.0]])
        for e in reversed(range(dim)):  # kron from slowest (z) to fastest (x)
            m = np.kron(m, D if e == d else N)
        mats.append(m)
    return np.stack(mats, axis=2)
