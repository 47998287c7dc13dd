"""Structured tensor-product meshes with analytic deformations (NumPy).

Carried over from ``dealii_asm_tpu/mesh/grid.py:30-238``: a grid of
``n_cells`` uniform cells over a box, cells lexicographic with x fastest,
optionally deformed by an analytic ``transform`` (Kershaw).  Geometry comes
from an isoparametric Q_m mapping whose support points are the transformed
GLL lattice of each cell.  The patch extents of the FDM smoother use the
analytic transform at the face quadrature points (the JAX package's default,
``mapping_degree=None``) or, when asked, the isoparametric mapping.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..fem.lagrange import (gauss_lobatto_points, gauss_points,
                            lagrange_derivatives, lagrange_values,
                            tensor_gradient, tensor_lattice,
                            tensor_lattice_nd, tensor_weights)


@dataclass(frozen=True)
class StructuredMesh:
    dim: int
    n_cells: tuple[int, ...]
    lengths: tuple[float, ...] = None  # box side lengths; default all 1.0
    periodic: tuple[bool, ...] = None
    transform: object = None  # callable (N, dim) -> (N, dim), or None
    origin: tuple[float, ...] = None  # box lower corner; default all 0.0

    def __post_init__(self):
        for name, default in (("lengths", 1.0), ("periodic", False),
                              ("origin", 0.0)):
            if getattr(self, name) is None:
                object.__setattr__(self, name, (default,) * self.dim)
        if len(self.n_cells) != self.dim:
            raise ValueError(f"n_cells {self.n_cells} for dim {self.dim}")

    # -- topology --------------------------------------------------------------

    @property
    def n_cells_total(self) -> int:
        return int(np.prod(self.n_cells))

    @property
    def h(self) -> np.ndarray:
        """Cell widths per direction in box coordinates (before transform)."""
        return np.array(self.lengths) / np.array(self.n_cells)

    def cell_multi_index(self) -> np.ndarray:
        """(C, dim) integer cell coordinates, lexicographic with x fastest."""
        return tensor_lattice_nd([np.arange(n) for n in self.n_cells])

    def cell_flat_index(self, mi: np.ndarray) -> np.ndarray:
        """Flatten (..., dim) multi-indices (x fastest)."""
        strides = np.cumprod([1] + list(self.n_cells[:-1]))
        return (mi * strides).sum(axis=-1)

    def neighbors(self) -> np.ndarray:
        """(C, dim, 2) flat index of the lower/upper neighbour; -1 if none."""
        mi = self.cell_multi_index()
        out = np.full((self.n_cells_total, self.dim, 2), -1, dtype=np.int64)
        for d in range(self.dim):
            for side, shift in ((0, -1), (1, +1)):
                nb = mi.copy()
                nb[:, d] += shift
                if self.periodic[d]:
                    nb[:, d] %= self.n_cells[d]
                    valid = np.ones(len(mi), dtype=bool)
                else:
                    valid = (nb[:, d] >= 0) & (nb[:, d] < self.n_cells[d])
                    nb[:, d] = np.clip(nb[:, d], 0, self.n_cells[d] - 1)
                out[:, d, side] = np.where(valid, self.cell_flat_index(nb), -1)
        return out

    # -- geometry --------------------------------------------------------------

    def box_points(self, unit_pts: np.ndarray) -> np.ndarray:
        """Per-cell reference points (P, dim) in [0,1]^dim to box
        coordinates (C, P, dim)."""
        mi = self.cell_multi_index().astype(np.float64)
        return np.asarray(self.origin)[None, None, :] + (
            mi[:, None, :] + unit_pts[None, :, :]) * self.h[None, None, :]

    def physical_points(self, unit_pts: np.ndarray) -> np.ndarray:
        """Physical coordinates of per-cell reference points: (C, P, dim)."""
        pts = self.box_points(unit_pts)
        if self.transform is None:
            return pts
        C, P, d = pts.shape
        return np.asarray(self.transform(pts.reshape(C * P, d))).reshape(
            C, P, d)

    def mapping_support_points(self, mapping_degree: int) -> np.ndarray:
        """(C, (m+1)^dim, dim) isoparametric Q_m support points (the GLL
        lattice of each cell through the transform), x fastest."""
        gll = gauss_lobatto_points(mapping_degree + 1)
        return self.physical_points(tensor_lattice(gll, self.dim))

    def jacobian_factors(self, mapping_degree: int, quad_pts_1d: np.ndarray):
        """(B, sp) with J[c,q,e,d] = Σ_l B[q,l,d]·sp[c,l,e]."""
        sp = self.mapping_support_points(mapping_degree)  # (C, L, dim)
        gll = gauss_lobatto_points(mapping_degree + 1)
        B = tensor_gradient(lagrange_values(gll, quad_pts_1d),
                            lagrange_derivatives(gll, quad_pts_1d), self.dim)
        return B, sp

    def jacobians(self, mapping_degree: int, quad_pts_1d: np.ndarray):
        """(C, Q, dim, dim) Jacobians J[c,q,e,d] = ∂x_e/∂ξ_d at the tensor
        quadrature points (x fastest)."""
        B, sp = self.jacobian_factors(mapping_degree, quad_pts_1d)
        return np.einsum("qld,cle->cqed", B, sp, optimize=True)

    def harmonic_cell_extents(self, n_q_1d: int = 2,
                              mapping_degree: int | None = None
                              ) -> np.ndarray:
        """(C, dim) quadrature-averaged distance between opposite face
        points (``dealii_asm_tpu/mesh/grid.py:145-197``).  The face points
        go through the analytic transform (``mapping_degree`` None, the
        JAX package's default) or through the isoparametric Q_m mapping of
        ``mapping_degree``, the geometry the reference's FEFaceValues
        sees."""
        C = self.n_cells_total
        if self.transform is None:
            return np.broadcast_to(self.h, (C, self.dim)).copy()
        q, w = gauss_points(n_q_1d)

        def to_physical(unit_pts):
            if mapping_degree is None:
                return self.physical_points(unit_pts)
            gll = gauss_lobatto_points(mapping_degree + 1)
            sp = self.mapping_support_points(mapping_degree)  # (C, L, dim)
            vals = [lagrange_values(gll, unit_pts[:, d])
                    for d in range(self.dim)]
            N = vals[0]
            for d in range(1, self.dim):
                # support lattice x fastest
                N = (vals[d][:, :, None] * N[:, None, :]).reshape(
                    N.shape[0], -1)
            return np.einsum("pl,cld->cpd", N, sp)

        out = np.empty((C, self.dim))
        for d in range(self.dim):
            faces = []
            for val in (0.0, 1.0):
                coords = [q] * self.dim
                coords[d] = np.array([val])
                faces.append(to_physical(tensor_lattice_nd(coords)))
            dist = np.linalg.norm(faces[1] - faces[0], axis=2)  # (C, Qf)
            wf = tensor_weights([w if i != d else np.array([1.0])
                                 for i in range(self.dim)])
            out[:, d] = dist @ wf
        return out

    def harmonic_patch_extents(self, n_q_1d: int = 2,
                               mapping_degree: int | None = None
                               ) -> np.ndarray:
        """(C, dim, 3) extents [lower neighbour, own, upper neighbour]; 0
        where there is no neighbour."""
        ext = self.harmonic_cell_extents(n_q_1d, mapping_degree)
        nbr = self.neighbors()
        out = np.zeros((self.n_cells_total, self.dim, 3))
        out[:, :, 1] = ext
        for d in range(self.dim):
            for side in (0, 1):
                n = nbr[:, d, side]
                valid = n >= 0
                out[valid, d, 2 * side] = ext[n[valid], d]
        return out

    def max_aspect_ratio(self, n_q_1d: int = 2) -> float:
        """Max ratio of the Jacobian's singular values over the quadrature
        points of the degree-1 mapping (the driver's aspect_ratio column)."""
        if self.transform is None:
            h = self.h
            return float(h.max() / h.min())
        q, _ = gauss_points(n_q_1d)
        s = np.linalg.svd(self.jacobians(1, q), compute_uv=False)
        return float((s[..., 0] / s[..., -1]).max())
