"""Continuous FE_Q DoF numbering on structured meshes (NumPy).

Carried over from ``dealii_asm_tpu/fem/dofs.py`` (the part the port uses):
the global numbering is the lexicographic node lattice (x fastest, grid
shape (Nz, Ny, Nx)), Dirichlet constraints are a boolean mask, and
constrained rows of the operators act as identity.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np

from ..mesh.grid import StructuredMesh


@dataclass(frozen=True)
class DofHandler:
    mesh: StructuredMesh
    degree: int

    @cached_property
    def nodes_per_dim(self) -> tuple[int, ...]:
        p = self.degree
        return tuple(p * n if per else p * n + 1
                     for n, per in zip(self.mesh.n_cells, self.mesh.periodic))

    @property
    def n_dofs(self) -> int:
        return int(np.prod(self.nodes_per_dim))

    def free_1d(self, d: int) -> np.ndarray:
        """(N_d,) float 0/1: free nodes along direction d (x = 0).  A node is
        constrained iff one of its coordinates is on a non-periodic
        boundary, so the node mask is the outer product of these."""
        f = np.ones(self.nodes_per_dim[d])
        if not self.mesh.periodic[d]:
            f[0] = f[-1] = 0.0
        return f

    @cached_property
    def boundary_mask(self) -> np.ndarray:
        """(n_dofs,) bool: True on a non-periodic domain boundary."""
        mask = np.zeros(self.n_dofs, dtype=bool)
        view = mask.reshape(tuple(reversed(self.nodes_per_dim)))
        for d in range(self.mesh.dim):
            if self.mesh.periodic[d]:
                continue
            sl = [slice(None)] * self.mesh.dim
            sl[self.mesh.dim - 1 - d] = 0
            view[tuple(sl)] = True
            sl[self.mesh.dim - 1 - d] = self.nodes_per_dim[d] - 1
            view[tuple(sl)] = True
        return mask
