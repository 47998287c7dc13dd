"""Matrix-free Laplace operator on structured meshes (PyTorch).

Counterpart of ``dealii_asm_tpu/ops/laplace.py::LaplaceOperator`` on the
node lattice.  The geometry decides the form, as in the JAX package:
- Cartesian cells (``laplace.py:150-268``): the separable
  Σ_d M̂⊗…K̂_d…⊗M̂ with assembled banded 1D factors, applied by kernel A
  (``kernels/banded_laplace.py``);
- a deformed mesh (``mesh.transform`` set; ``laplace.py:323-417``): the
  merged form, the symmetric w|J|J⁻¹J⁻ᵀ per quadrature point of an
  isoparametric Q_m mapping, applied by kernel E
  (``kernels/merged_laplace.py``).
Both kernels run in float32 or native float64.  Constrained (Dirichlet) rows
act as identity: ``vmult(u)`` is ``where(free, A·where(free, u, 0), u)``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..device import DEFAULT_DEVICE, resolve_device
from ..fem.lagrange import shape_1d, tensor_values
from ..kernels.banded_laplace import BandedTables, banded_laplace
from ..kernels.merged_laplace import MergedTables, merged_laplace
from .geometry import compute_geometry
from .lattice import cells_to_grid_sliced
from .tensorops import (banded_diagonals, global_laplace_1d_factors,
                        interp_direction_transform, outer_grid,
                        pack_merged_coeff)


def check_structured_3d(dofs) -> None:
    """The port's operators cover 3D non-periodic meshes."""
    mesh = dofs.mesh
    if mesh.dim != 3:
        raise NotImplementedError(
            f"dim {mesh.dim}: the port runs 3D meshes only (ROADMAP item 9)")
    if any(mesh.periodic):
        raise NotImplementedError(
            "periodic meshes are not ported yet (ROADMAP item 9)")


class LaplaceOperator(nn.Module):
    """Laplace operator on a ``fem.dofs.DofHandler``.

    Cartesian meshes: ``factors`` (optional) gives the per-direction
    (M̂_d, K̂_d) NumPy pair; by default it is assembled here.  Deformed
    meshes: ``mapping_degree`` (default min(p, 3), as in the JAX package;
    Cartesian cells ignore it) sets the isoparametric mapping; ``geometry``
    (optional) gives the (coeff (C, Q, 3, 3), jxw (C, Q)) NumPy pair instead
    of computing it.
    ``interop.py`` passes the JAX package's tables through both.
    """

    def __init__(self, dofs, dtype=torch.float64, device=DEFAULT_DEVICE,
                 factors=None, mapping_degree=None, geometry=None):
        super().__init__()
        check_structured_3d(dofs)
        self.dofs = dofs
        self.degree = dofs.degree
        self.dim = dofs.mesh.dim
        self.n_dofs = dofs.n_dofs
        self.dtype = dtype
        self.device = resolve_device(device)
        self.grid_shape = tuple(reversed(dofs.nodes_per_dim))  # (Nz, Ny, Nx)
        free = [torch.as_tensor(dofs.free_1d(d) > 0, device=self.device)
                for d in range(self.dim)]
        self.register_buffer("free", outer_grid(free))  # (Nz, Ny, Nx) bool
        self.deformed = dofs.mesh.transform is not None
        if self.deformed:
            self._init_merged(mapping_degree, geometry)
        else:
            self._init_banded(factors)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.tensor(np.ascontiguousarray(a), dtype=self.dtype,
                            device=self.device)

    def _init_banded(self, factors):
        dofs = self.dofs
        if factors is None:
            factors = global_laplace_1d_factors(dofs.mesh, self.degree)
        self.M1d_global = [np.asarray(M, np.float64) for M, _ in factors]
        self.K1d_global = [np.asarray(K, np.float64) for _, K in factors]
        for d in range(self.dim):
            md, _ = banded_diagonals(self.M1d_global[d], self.degree)
            kd, _ = banded_diagonals(self.K1d_global[d], self.degree)
            self.register_buffer(f"Mdiag{d}", self._tensor(md))
            self.register_buffer(f"Kdiag{d}", self._tensor(kd))
        self.tables = BandedTables(
            [getattr(self, f"Mdiag{d}") for d in range(self.dim)],
            [getattr(self, f"Kdiag{d}") for d in range(self.dim)],
            self.degree, self.grid_shape, self.free)
        self._kernel = banded_laplace

    def _init_merged(self, mapping_degree, geometry):
        mesh, p = self.dofs.mesh, self.degree
        self.mapping_degree = (min(p, 3) if mapping_degree is None
                               else mapping_degree)
        if geometry is None:
            geo = compute_geometry(mesh, p + 1, self.mapping_degree,
                                   self.device)
            coeff, self.jxw = geo.coeff, geo.jxw
        else:
            coeff, self.jxw = (torch.tensor(np.asarray(a, np.float64),
                                            device=self.device)
                               for a in geometry)
        # packed in float64, then cast, as the JAX package does
        self.register_buffer("coeff6", pack_merged_coeff(coeff, mesh.h).to(
            self.dtype).contiguous())
        del coeff
        s = shape_1d(p, p + 1)
        Ds = [s.D / mesh.h[d] for d in range(self.dim)]
        self.register_buffer("shape_tabs", self._tensor(np.stack([s.N, *Ds])))
        for d in range(self.dim):
            n, c = self.dofs.nodes_per_dim[d], mesh.n_cells[d]
            self.register_buffer(f"Ev{d}", self._tensor(
                interp_direction_transform(s.N, n, p, c, False)))
            self.register_buffer(f"Ed{d}", self._tensor(
                interp_direction_transform(Ds[d], n, p, c, False)))
        self.tables = MergedTables(
            self.coeff6, self.shape_tabs,
            [getattr(self, f"Ev{d}") for d in range(self.dim)],
            [getattr(self, f"Ed{d}") for d in range(self.dim)],
            p, tuple(reversed(mesh.n_cells)), self.free)
        self._kernel = merged_laplace

    def vmult(self, u: torch.Tensor) -> torch.Tensor:
        """A·u in the operator's dtype; another input dtype is cast in and
        out (the Lanczos estimate drives float32 levels with float64
        vectors, as the JAX package does)."""
        if u.dtype == self.dtype:
            return self._kernel(u, self.tables)
        return self._kernel(u.to(self.dtype), self.tables).to(u.dtype)

    def residual(self, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """b − A·x in one kernel call."""
        return self._kernel(x, self.tables, rhs=b)

    def forward(self, u):
        return self.vmult(u)

    def assemble_rhs(self, rhs: str = "constant") -> torch.Tensor:
        """b_i = ∫ f φ_i for f = 1, zero at constrained nodes
        (``laplace.py:808-835``).

        Cartesian: the outer product of the row sums of the global 1D mass
        matrices.  Deformed: w_q·det J times the basis values at the
        quadrature points, summed into the nodes (float64)."""
        if rhs != "constant":
            raise NotImplementedError(
                f"rhs {rhs!r}: the port assembles the constant rhs only "
                "(ROADMAP item 9)")
        if not self.deformed:
            rows = [torch.as_tensor(self.M1d_global[d].sum(axis=1)
                                    * self.dofs.free_1d(d), device=self.device)
                    for d in range(self.dim)]
            return outer_grid(rows).reshape(-1).to(self.dtype)
        s = shape_1d(self.degree, self.degree + 1)
        Nval = torch.as_tensor(tensor_values(s.N, self.dim), device=self.device)
        local = self.jxw @ Nval  # (C, L)
        b = cells_to_grid_sliced(local, self.dofs.mesh.n_cells, self.degree)
        b = torch.where(self.free, b, torch.zeros((), dtype=b.dtype,
                                                  device=b.device))
        return b.reshape(-1).to(self.dtype)
