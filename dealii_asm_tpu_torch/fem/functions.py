"""Right-hand sides and Dirichlet data of the solver program (NumPy).

Carried over from ``dealii_asm_tpu/fem/functions.py`` (the reference's
GaussianSolution, GaussianRightHandSide and the solver program's constant and
sinus-mp functions).  Each function maps (P, dim) float64 points to (P,)
values; they run once at setup, on the host.
"""

from __future__ import annotations

import numpy as np


def constant_rhs(p: np.ndarray) -> np.ndarray:
    return np.ones(p.shape[0])


def sinus_mp_rhs(p: np.ndarray) -> np.ndarray:
    """The Phillips–Fischer rhs dim·π·Π_d sin(π x_d)."""
    dim = p.shape[1]
    v = dim * np.pi * np.ones(p.shape[0])
    for d in range(dim):
        v = v * np.sin(np.pi * p[:, d])
    return v


def gaussian_solution(centers: np.ndarray, width: float):
    """Sum of Gaussians of ``width`` around ``centers``, normalised."""
    centers = np.atleast_2d(np.asarray(centers, dtype=np.float64))

    def f(p: np.ndarray) -> np.ndarray:
        dim = p.shape[1]
        v = np.zeros(p.shape[0])
        for c in centers:
            r2 = ((p - c[None, :dim]) ** 2).sum(axis=1)
            v += np.exp(-r2 / width**2)
        return v / (np.sqrt(2.0 * np.pi) * width) ** dim

    return f


def gaussian_rhs(centers: np.ndarray, width: float):
    """−Δ of ``gaussian_solution(centers, width)``."""
    centers = np.atleast_2d(np.asarray(centers, dtype=np.float64))

    def f(p: np.ndarray) -> np.ndarray:
        dim = p.shape[1]
        v = np.zeros(p.shape[0])
        for c in centers:
            r2 = ((p - c[None, :dim]) ** 2).sum(axis=1)
            v += (2 * dim - 4 * r2 / width**2) / width**2 * np.exp(-r2 / width**2)
        return v / (np.sqrt(2.0 * np.pi) * width) ** dim

    return f


def zero(p: np.ndarray) -> np.ndarray:
    """Homogeneous Dirichlet data."""
    return np.zeros(p.shape[0])


def make_rhs_and_dbc(name: str, dim: int):
    """(rhs_fn, dirichlet_fn) of the config's "rhs" value
    (``dealii_asm_tpu/fem/functions.py:54``)."""
    if name == "constant":
        return constant_rhs, zero
    if name == "gaussian":
        centers = np.array([[-0.5] * dim])
        return gaussian_rhs(centers, 0.1), gaussian_solution(centers, 0.1)
    if name == "gaussian-jw":
        if dim == 2:
            centers = np.array([[0.0, 0.0], [0.25, 0.85], [0.6, 0.4]])
        else:
            centers = np.array([[0.0, 0.0, 0.0], [0.25, 0.85, 0.85],
                                [0.6, 0.4, 0.4]])
        return (gaussian_rhs(centers, 1.0 / 3.0),
                gaussian_solution(centers, 1.0 / 3.0))
    if name == "sin-mp":
        return sinus_mp_rhs, zero
    raise ValueError(f"unknown rhs '{name}'")


def dirichlet_values(dofs, fn) -> np.ndarray | None:
    """(n_dofs,) float64 vector g: ``fn`` at the constrained DoFs, zero
    elsewhere; None where g vanishes (no lift to assemble).  ``zero`` needs
    no support points (on the ball they cost a mapping of every cell at
    the DoFs' degree)."""
    if fn is zero:
        return None
    ids = np.flatnonzero(dofs.boundary_mask)
    vals = np.asarray(fn(dofs.node_points(ids)), np.float64)
    if not np.any(vals != 0.0):
        return None
    g = np.zeros(dofs.n_dofs)
    g[ids] = vals
    return g
