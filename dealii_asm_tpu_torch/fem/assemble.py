"""Sparse reference assembly of the Laplace matrix (NumPy/SciPy, host).

The port's copy of ``dealii_asm_tpu/fem/assemble.py``: the matrix-based
oracle (the reference program's ``LaplaceOperatorMatrixBased``) that the
matrix-based Schwarz preconditioners (``precond/block_asm.py``) and the
subdomain preconditioner (``precond/domain.py``) extract their blocks from.
Cell matrices come from the same geometry as the matrix-free operators
(``ops/geometry.py::compute_geometry``, evaluated on the CPU in float64) and
are summed into a CSR matrix by SciPy.  ``constrained="identity"`` gives
Z A Z + (I − Z), the matrix-free operators' identity rows at Dirichlet DoFs;
``"raw"`` the plain A.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..fem.lagrange import (gauss_lobatto_points, shape_1d, tensor_gradient,
                            tensor_weights)
from ..ops.geometry import compute_geometry


def _to_csr(A_loc: np.ndarray, dofs, constrained: str) -> sp.csr_matrix:
    """Sum the (C, L, L) cell matrices into the global CSR matrix through
    ``dofs.cell_dofs``; with ``constrained="identity"``, Dirichlet rows and
    columns become identity."""
    cd = np.asarray(dofs.cell_dofs, dtype=np.int64)
    L = cd.shape[1]
    rows = np.repeat(cd, L, axis=1).ravel()
    cols = np.tile(cd, (1, L)).ravel()
    A = sp.coo_matrix((A_loc.reshape(-1), (rows, cols)),
                      shape=(dofs.n_dofs, dofs.n_dofs)).tocsr()
    if constrained == "identity":
        mask = dofs.boundary_mask
        z = sp.diags((~mask).astype(np.float64))
        A = z @ A @ z + sp.diags(mask.astype(np.float64))
    return A


def assemble_laplace(dofs, n_q_1d: int | None = None,
                     mapping_degree: int | None = None,
                     constrained: str = "identity") -> sp.csr_matrix:
    """The Laplace matrix of a structured ``DofHandler``: on a Cartesian
    mesh the cell matrices w_q·Π h / h_d² ∂_d φ ∂_d φ, on a deformed one the
    merged coefficient of the Q_m mapping (default m = min(p, 3))."""
    p = dofs.degree
    dim = dofs.mesh.dim
    n_q_1d = n_q_1d or (p + 1)
    s = shape_1d(p, n_q_1d)
    B = tensor_gradient(s.N, s.D, dim)  # (Q, L, dim)
    if dofs.mesh.transform is None:
        h = np.broadcast_to(dofs.mesh.h, (dofs.mesh.n_cells_total, dim))
        scale = np.prod(h, axis=1)[:, None] / (h * h)  # (C, dim)
        wq = tensor_weights([s.w] * dim)
        # the reference stiffness per direction is the same in every cell
        K = np.einsum("q,qld,qmd->dlm", wq, B, B)
        A_loc = np.einsum("cd,dlm->clm", scale, K)
    else:
        if mapping_degree is None:
            mapping_degree = min(p, 3)
        coeff = compute_geometry(dofs.mesh, n_q_1d, mapping_degree,
                                 "cpu").coeff.numpy()
        A_loc = np.einsum("cqde,qld,qme->clm", coeff, B, B, optimize=True)
    return _to_csr(A_loc, dofs, constrained)


def iso_q1_reference_mass_stiffness_1d(degree: int, points: str = "lobatto"):
    """1D reference mass and stiffness of FE_Q_iso_Q1: p linear
    sub-elements on the Gauss-Lobatto ("lobatto") or equidistant
    subdivision of [0, 1]."""
    if points == "lobatto":
        x = gauss_lobatto_points(degree + 1)
    elif points == "equidistant":
        x = np.linspace(0.0, 1.0, degree + 1)
    else:
        raise ValueError(points)
    n = degree + 1
    M = np.zeros((n, n))
    K = np.zeros((n, n))
    for e in range(degree):
        h = x[e + 1] - x[e]
        M[e:e + 2, e:e + 2] += np.array([[2, 1], [1, 2]]) * h / 6.0
        K[e:e + 2, e:e + 2] += np.array([[1, -1], [-1, 1]]) / h
    return M, K


def assemble_laplace_iso_q1(dofs, points: str = "lobatto",
                            constrained: str = "identity") -> sp.csr_matrix:
    """The Laplace matrix of the FE_Q_iso_Q1 approximation space: per cell
    Σ_d ⊗ (K_d/h_d or M_e·h_e) of the 1D iso-Q1 matrices, with the cells'
    harmonic extents as widths (exact on Cartesian meshes)."""
    p = dofs.degree
    dim = dofs.mesh.dim
    M1, K1 = iso_q1_reference_mass_stiffness_1d(p, points)
    h = np.asarray(dofs.mesh.harmonic_cell_extents(p + 1))  # (C, dim)
    L = (p + 1) ** dim
    A_loc = np.zeros((h.shape[0], L, L))
    for d in range(dim):
        local = np.array([[1.0]])
        for e in reversed(range(dim)):  # slowest (last dim) to fastest (x)
            local = np.kron(local, K1 if e == d else M1)
        scale = np.ones(h.shape[0])
        for e in range(dim):
            scale = scale * (1.0 / h[:, e] if e == d else h[:, e])
        A_loc += scale[:, None, None] * local[None, :, :]
    return _to_csr(A_loc, dofs, constrained)


def assemble_laplace_general(dofs, n_q_1d: int | None = None,
                             mapping_degree: int | None = None,
                             constrained: str = "identity") -> sp.csr_matrix:
    """The Laplace matrix of an unstructured ``GeneralDofHandler`` (the
    hyperball), mapping degree 2 on a curved mesh by default."""
    p = dofs.degree
    mesh = dofs.mesh
    n_q_1d = n_q_1d or (p + 1)
    if mapping_degree is None:
        mapping_degree = 1 if mesh.project is None else 2
    s = shape_1d(p, n_q_1d)
    B = tensor_gradient(s.N, s.D, mesh.dim)
    coeff = compute_geometry(mesh, n_q_1d, mapping_degree, "cpu").coeff.numpy()
    A_loc = np.einsum("cqde,qld,qme->clm", coeff, B, B, optimize=True)
    return _to_csr(A_loc, dofs, constrained)
