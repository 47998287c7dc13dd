"""Merged geometry coefficient of the Laplace cell integral (PyTorch).

Counterpart of ``dealii_asm_tpu/ops/geometry.py::compute_geometry`` in its
merged kind (:131-173): per cell and quadrature point the symmetric
w_q·|J|·J⁻¹J⁻ᵀ in reference gradients, with J the Jacobian of the
isoparametric Q_m mapping.  The JAX package runs the contraction through XLA
on the host (``merged_det_coeff`` :96-128); here it runs in torch float64 on
the operator's device, where the (C, Q, 3, 3) tables of a 48³ Q4 mesh
(about 1 GB each) are cheap.  The mapping's support points come from the
mesh on the host: a deformed ``StructuredMesh`` (its NumPy transform) or an
``UnstructuredMesh`` (its chart or projected multilinear blend); both give
``jacobian_factors(mapping_degree, q)``.

``quadrature_points`` gives the physical points a right-hand side is
evaluated at, as the JAX package's ``GeometryData.q_points`` (:131-156) and
``GeneralLaplaceOperator.assemble_rhs`` (``laplace_general.py:446-448``)
place them.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..fem.lagrange import (gauss_points, shape_1d, tensor_lattice,
                            tensor_weights)
from ..mesh.grid import StructuredMesh


@dataclass
class MergedGeometry:
    """float64 tables on one device: ``coeff`` (C, Q, dim, dim) and ``jxw``
    (C, Q) = w_q·det J, quadrature points x fastest."""

    coeff: torch.Tensor
    jxw: torch.Tensor


def inv_det_2x2(J: torch.Tensor):
    """(det, inv) of (..., 2, 2) matrices (``_inv_det_batched``)."""
    a, b = J[..., 0, 0], J[..., 0, 1]
    c, d = J[..., 1, 0], J[..., 1, 1]
    det = a * d - b * c
    inv = torch.stack([torch.stack([d, -b], dim=-1),
                       torch.stack([-c, a], dim=-1)], dim=-2)
    return det, inv / det[..., None, None]


def inv_det_3x3(J: torch.Tensor):
    """(det, inv) of (..., 3, 3) matrices by cofactors (the JAX package's
    ``_inv_det_batched`` formulas)."""
    a, b, c = J[..., 0, 0], J[..., 0, 1], J[..., 0, 2]
    d, e, f = J[..., 1, 0], J[..., 1, 1], J[..., 1, 2]
    g, h, i = J[..., 2, 0], J[..., 2, 1], J[..., 2, 2]
    A = e * i - f * h
    B = f * g - d * i
    C = d * h - e * g
    det = a * A + b * B + c * C
    inv = torch.stack([
        torch.stack([A, c * h - b * i, b * f - c * e], dim=-1),
        torch.stack([B, a * i - c * g, c * d - a * f], dim=-1),
        torch.stack([C, b * g - a * h, a * e - b * d], dim=-1),
    ], dim=-2) / det[..., None, None]
    return det, inv


def compute_geometry(mesh, n_q_1d: int, mapping_degree: int,
                     device) -> MergedGeometry:
    """Merged geometry of a 2D or 3D structured or unstructured mesh; raises
    ValueError on a non-positive Jacobian determinant."""
    dim = mesh.dim
    s = shape_1d(max(mapping_degree, 1), n_q_1d)
    wq = torch.as_tensor(tensor_weights([s.w] * dim), device=device)
    B, sp = mesh.jacobian_factors(mapping_degree, s.q)
    B = torch.as_tensor(B, device=device)
    sp = torch.tensor(np.asarray(sp), device=device)  # copies: sp is read-only
    J = torch.einsum("qld,cle->cqed", B, sp)
    det, Jinv = (inv_det_3x3 if dim == 3 else inv_det_2x2)(J)
    del J
    if bool((det <= 0).any()):
        raise ValueError(
            "the mesh mapping produced non-positive Jacobian determinants")
    jxw = wq[None, :] * det
    coeff = (Jinv @ Jinv.transpose(-1, -2)) * jxw[:, :, None, None]
    return MergedGeometry(coeff, jxw)


def quadrature_points(mesh, n_q_1d: int, mapping_degree: int) -> np.ndarray:
    """(C, Q, dim) float64 physical Gauss points, x fastest: a structured
    mesh maps its box points (``origin`` included) through its analytic
    transform, an unstructured one through its Q_m mapping of
    ``mapping_degree`` (the curved ball's boundary)."""
    unit = tensor_lattice(gauss_points(n_q_1d)[0], mesh.dim)
    if isinstance(mesh, StructuredMesh):
        return mesh.physical_points(unit)
    return mesh._physical_points(unit, mapping_degree)
