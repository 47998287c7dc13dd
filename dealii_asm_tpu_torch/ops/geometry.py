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
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..fem.lagrange import shape_1d, tensor_weights


@dataclass
class MergedGeometry:
    """float64 tables on one device: ``coeff`` (C, Q, dim, dim) and ``jxw``
    (C, Q) = w_q·det J, quadrature points x fastest."""

    coeff: torch.Tensor
    jxw: torch.Tensor


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
    """Merged geometry of a 3D structured or unstructured mesh; raises
    ValueError on a non-positive Jacobian determinant."""
    if mesh.dim != 3:
        raise NotImplementedError(
            f"dim {mesh.dim}: the port runs 3D meshes only (ROADMAP item 9)")
    s = shape_1d(max(mapping_degree, 1), n_q_1d)
    wq = torch.as_tensor(tensor_weights([s.w] * 3), device=device)
    B, sp = mesh.jacobian_factors(mapping_degree, s.q)
    B = torch.as_tensor(B, device=device)
    sp = torch.tensor(np.asarray(sp), device=device)  # copies: sp is read-only
    J = torch.einsum("qld,cle->cqed", B, sp)
    det, Jinv = inv_det_3x3(J)
    del J
    if bool((det <= 0).any()):
        raise ValueError(
            "the mesh mapping produced non-positive Jacobian determinants")
    jxw = wq[None, :] * det
    coeff = (Jinv @ Jinv.transpose(-1, -2)) * jxw[:, :, None, None]
    return MergedGeometry(coeff, jxw)
