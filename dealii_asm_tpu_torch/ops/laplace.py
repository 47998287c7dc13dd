"""Matrix-free Laplace operator on Cartesian structured meshes (PyTorch).

Counterpart of ``dealii_asm_tpu/ops/laplace.py::LaplaceOperator``, lattice
path of uniform Cartesian cells (``laplace.py:150-268``): the operator is the
separable Σ_d M̂⊗…K̂_d…⊗M̂ with assembled banded 1D factors, applied by
kernel A (``kernels/banded_laplace.py``) in float32 or native float64.
Constrained (Dirichlet) rows act as identity: ``vmult(u)`` is
``where(free, A·where(free, u, 0), u)``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..kernels.banded_laplace import BandedTables, banded_laplace
from .tensorops import banded_diagonals, global_laplace_1d_factors, outer_grid


def check_structured_cartesian(dofs) -> None:
    """The port's operators cover 3D non-periodic meshes."""
    mesh = dofs.mesh
    if mesh.dim != 3:
        raise NotImplementedError(
            f"dim {mesh.dim}: the port runs 3D meshes only (ROADMAP item 9)")
    if any(mesh.periodic):
        raise NotImplementedError(
            "periodic meshes are not ported yet (ROADMAP item 9)")


class LaplaceOperator(nn.Module):
    """Laplace operator on a ``dealii_asm_tpu.fem.dofs.DofHandler``.

    ``factors`` (optional) gives the per-direction (M̂_d, K̂_d) NumPy pair;
    by default it is assembled here (``interop.py`` passes the JAX ones).
    """

    def __init__(self, dofs, dtype=torch.float64, device="cpu", factors=None):
        super().__init__()
        check_structured_cartesian(dofs)
        self.dofs = dofs
        self.degree = dofs.degree
        self.dim = dofs.mesh.dim
        self.n_dofs = dofs.n_dofs
        self.dtype = dtype
        self.device = resolve_device(device)
        self.grid_shape = tuple(reversed(dofs.nodes_per_dim))  # (Nz, Ny, Nx)
        if factors is None:
            factors = global_laplace_1d_factors(dofs.mesh, self.degree)
        self.M1d_global = [np.asarray(M, np.float64) for M, _ in factors]
        self.K1d_global = [np.asarray(K, np.float64) for _, K in factors]
        for d in range(self.dim):
            md, _ = banded_diagonals(self.M1d_global[d], self.degree)
            kd, _ = banded_diagonals(self.K1d_global[d], self.degree)
            self.register_buffer(f"Mdiag{d}", self._tensor(md))
            self.register_buffer(f"Kdiag{d}", self._tensor(kd))
        free = [torch.as_tensor(dofs.free_1d(d) > 0, device=self.device)
                for d in range(self.dim)]
        self.register_buffer("free", outer_grid(free))  # (Nz, Ny, Nx) bool
        self.tables = BandedTables(
            [getattr(self, f"Mdiag{d}") for d in range(self.dim)],
            [getattr(self, f"Kdiag{d}") for d in range(self.dim)],
            self.degree, self.grid_shape, self.free)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.tensor(np.ascontiguousarray(a), dtype=self.dtype,
                            device=self.device)

    def vmult(self, u: torch.Tensor) -> torch.Tensor:
        """A·u in the operator's dtype; another input dtype is cast in and
        out (the Lanczos estimate drives float32 levels with float64
        vectors, as the JAX package does)."""
        if u.dtype == self.dtype:
            return banded_laplace(u, self.tables)
        return banded_laplace(u.to(self.dtype), self.tables).to(u.dtype)

    def residual(self, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """b − A·x in one kernel launch."""
        return banded_laplace(x, self.tables, rhs=b)

    def forward(self, u):
        return self.vmult(u)

    def assemble_rhs(self, rhs: str = "constant") -> torch.Tensor:
        """b_i = ∫ f φ_i, zero at constrained nodes (``laplace.py:808-835``).

        For the constant right-hand side f = 1 on a Cartesian mesh this is the
        outer product of the row sums of the global 1D mass matrices."""
        if rhs != "constant":
            raise NotImplementedError(
                f"rhs {rhs!r}: the port assembles the constant rhs only "
                "(ROADMAP item 9)")
        rows = [torch.as_tensor(self.M1d_global[d].sum(axis=1)
                                * self.dofs.free_1d(d), device=self.device)
                for d in range(self.dim)]
        return outer_grid(rows).reshape(-1).to(self.dtype)
