"""Matrix-free Laplace operator on structured meshes (PyTorch).

Counterpart of ``dealii_asm_tpu/ops/laplace.py::LaplaceOperator`` on the
node lattice.  The geometry decides the form, as in the JAX package:
- Cartesian cells (``laplace.py:150-268``): the separable
  Σ_d M̂⊗…K̂_d…⊗M̂ with assembled banded 1D factors, applied by kernel A
  (``kernels/banded_laplace.py``) in 3D; 2D meshes reach no Pallas kernel in
  the JAX package and take the plain banded form on every device;
- a deformed mesh (``mesh.transform`` set; ``laplace.py:323-417``): the
  merged form, the symmetric w|J|J⁻¹J⁻ᵀ per quadrature point of an
  isoparametric Q_m mapping, applied by kernel E
  (``kernels/merged_laplace.py``);
- a deformed mesh with a compact ``mapping_type`` ("linear geometry",
  "quadratic geometry", "construct q"; ``laplace.py:122-133, 280-320,
  515-540``): per-cell mapping support points (or stored quadrature points)
  with the Jacobians rebuilt at every quadrature point in each apply.  The
  JAX package runs these in XLA, never in a Pallas kernel, so they are plain
  torch here, on every device.
Kernels A and E run in float32 or native float64.  Constrained (Dirichlet)
rows act as identity: ``vmult(u)`` is ``where(free, A·where(free, u, 0), u)``.

``assemble_rhs(f, dirichlet)`` solves deal.II's homogeneous system: the
lift −A·g of the Dirichlet data g goes into the free rows, the constrained
rows of b are 0, and the caller adds g to the solution.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..device import DEFAULT_DEVICE, resolve_device
from ..fem.functions import constant_rhs, dirichlet_values, make_rhs_and_dbc
from ..fem.lagrange import (gauss_lobatto_points, lagrange_derivatives,
                            lagrange_values, shape_1d, tensor_gradient,
                            tensor_values, tensor_weights)
from ..kernels.banded_laplace import (BandedTables, banded_laplace,
                                      banded_laplace_plain)
from ..kernels.lanes_laplace import sumfac_gradients, sumfac_integrate
from ..kernels.merged_laplace import MergedTables, merged_laplace
from .geometry import compute_geometry, inv_det_3x3, quadrature_points
from .lattice import cells_to_grid_sliced, grid_to_cells_sliced
from .tensorops import (banded_diagonals, cell_diagonal,
                        global_laplace_1d_factors, interp_direction_transform,
                        merged_coeff_qgrid, merged_laplace_apply, outer_grid,
                        pack_merged_coeff, separable_laplace_apply_banded)

# "operator mapping type" → the compact geometry form (``laplace.py:122-133``)
COMPACT_MAPPING_TYPES = {"linear geometry": "linear",
                         "quadratic geometry": "quadratic",
                         "construct q": "construct_q"}


def check_structured(dofs) -> None:
    """The port's structured operators cover 2D and 3D non-periodic meshes,
    deformed ones in 3D."""
    mesh = dofs.mesh
    if mesh.dim not in (2, 3):
        raise NotImplementedError(
            f"dim {mesh.dim}: the port runs 2D and 3D meshes (ROADMAP item 9)")
    if mesh.dim == 2 and mesh.transform is not None:
        raise NotImplementedError(
            "deformed 2D meshes are not ported yet (ROADMAP item 9)")
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
    of computing it; ``mapping_type`` (a key of ``COMPACT_MAPPING_TYPES``)
    selects a compact form, which maps with degree 1 (linear), 2
    (quadratic) or ``mapping_degree`` (construct q).
    ``interop.py`` passes the JAX package's tables through ``factors`` and
    ``geometry``.
    """

    def __init__(self, dofs, dtype=torch.float64, device=DEFAULT_DEVICE,
                 factors=None, mapping_degree=None, geometry=None,
                 mapping_type: str = ""):
        super().__init__()
        check_structured(dofs)
        self.dofs = dofs
        self.degree = dofs.degree
        self.dim = dofs.mesh.dim
        self.n_dofs = dofs.n_dofs
        self.dtype = dtype
        self.device = resolve_device(device)
        self.grid_shape = tuple(reversed(dofs.nodes_per_dim))  # ([Nz,] Ny, Nx)
        free = [torch.as_tensor(dofs.free_1d(d) > 0, device=self.device)
                for d in range(self.dim)]
        self.register_buffer("free", outer_grid(free))  # grid_shape bool
        self.deformed = dofs.mesh.transform is not None
        self.compact = (COMPACT_MAPPING_TYPES.get(mapping_type)
                        if self.deformed else None)
        if self.compact:
            self._init_compact(mapping_degree)
        elif self.deformed:
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
        # kernel A tiles 3D grids; a 2D grid takes the plain banded form
        self._kernel = (banded_laplace if self.dim == 3
                        else banded_laplace_plain)

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
        # the kernel's launch takes the 1D tables from this host copy
        shape_host = torch.tensor(np.stack([s.N, *Ds]), dtype=self.dtype)
        self.register_buffer("shape_tabs", shape_host.to(self.device))
        for d in range(self.dim):
            n, c = self.dofs.nodes_per_dim[d], mesh.n_cells[d]
            self.register_buffer(f"Ev{d}", self._tensor(
                interp_direction_transform(s.N, n, p, c, False)))
            self.register_buffer(f"Ed{d}", self._tensor(
                interp_direction_transform(Ds[d], n, p, c, False)))
        self.tables = MergedTables(
            self.coeff6, self.shape_tabs, shape_host,
            [getattr(self, f"Ev{d}") for d in range(self.dim)],
            [getattr(self, f"Ed{d}") for d in range(self.dim)],
            p, tuple(reversed(mesh.n_cells)), self.free)
        self._kernel = merged_laplace

    def _init_compact(self, mapping_degree):
        """Compact geometry (``laplace.py:280-320``): the linear and
        quadratic forms keep the (C, (m+1)³, 3) support points of a degree-1
        or degree-2 mapping and the basis gradients of that mapping at the
        quadrature points; construct q keeps the (C, Q, 3) quadrature points
        of the degree min(m, p) mapping and the collocation derivative on
        the 1D quadrature points."""
        mesh, p = self.dofs.mesh, self.degree
        mdeg = min(p, 3) if mapping_degree is None else mapping_degree
        self.mapping_degree = {"linear": 1, "quadratic": 2}.get(self.compact,
                                                                mdeg)
        s = shape_1d(p, p + 1)
        self.register_buffer("shape_tabs", self._tensor(
            np.stack([s.N, s.D, s.D, s.D])))
        self.register_buffer("quad_w", self._tensor(
            tensor_weights([s.w] * self.dim)))
        if self.compact == "construct_q":
            m = min(self.mapping_degree, p)
            gll = gauss_lobatto_points(m + 1)
            Nt = tensor_values(lagrange_values(gll, s.q), self.dim)  # (Q, Lm)
            qp = np.einsum("ql,cld->cqd", Nt, mesh.mapping_support_points(m))
            self.register_buffer("geo_qp", self._tensor(qp))
            self.register_buffer("Dcol", self._tensor(
                lagrange_derivatives(s.q, s.q)))
        else:
            m = self.mapping_degree
            gll = gauss_lobatto_points(m + 1)
            self.register_buffer("geo_sp", self._tensor(
                mesh.mapping_support_points(m)))
            self.register_buffer("gradN_geo", self._tensor(tensor_gradient(
                lagrange_values(gll, s.q), lagrange_derivatives(gll, s.q),
                self.dim)))
        self.tables = None
        self._kernel = self._compact_apply

    # -- the compact geometry's plain apply -----------------------------------

    def _compact_jacobians(self) -> torch.Tensor:
        """(C, Q, 3, 3) J[c, q, e, d] = ∂x_e/∂ξ_d, rebuilt in each apply."""
        if self.compact != "construct_q":
            return torch.einsum("qld,cle->cqed", self.gradN_geo, self.geo_sp)
        q = self.degree + 1
        qp = self.geo_qp.reshape(-1, q, q, q, 3)  # [c, z, y, x, e]
        cols = []
        for d in range(3):  # reference direction, x first
            axis = 3 - d
            t = torch.movedim(qp, axis, -1) @ self.Dcol.T
            cols.append(torch.movedim(t, -1, axis))
        return torch.stack(cols, dim=-1).reshape(qp.shape[0], -1, 3, 3)

    def _compact_cells(self, W: torch.Tensor) -> torch.Tensor:
        """Cell integrals of the cell values W (C, m³), (C, m³) out:
        t = w_q·|J|·J⁻¹J⁻ᵀ ∇̂u at each quadrature point (``laplace.py:515-
        540``), J from the compact tables."""
        m = self.degree + 1
        gx, gy, gz = sumfac_gradients(W.reshape(-1, m, m, m), self.shape_tabs)
        g = torch.stack([gx, gy, gz], dim=-1).reshape(W.shape[0], -1, 3)
        det, inv = inv_det_3x3(self._compact_jacobians())  # inv = J⁻¹
        sgrad = torch.einsum("cqfe,cqf->cqe", inv, g)  # physical gradient
        t = torch.einsum("cqde,cqe->cqd", inv, sgrad)
        t = t * (self.quad_w[None, :, None] * det[..., None])
        t = t.reshape(-1, m, m, m, 3)
        v = sumfac_integrate(t[..., 0], t[..., 1], t[..., 2], self.shape_tabs)
        return v.reshape(W.shape[0], -1)

    def _compact_unconstrained(self, grid: torch.Tensor) -> torch.Tensor:
        W = grid_to_cells_sliced(grid, self.degree)
        return cells_to_grid_sliced(self._compact_cells(W),
                                    self.dofs.mesh.n_cells, self.degree)

    def _compact_apply(self, u: torch.Tensor, tables=None,
                       rhs: torch.Tensor | None = None) -> torch.Tensor:
        g = u.reshape(self.grid_shape)
        zero = torch.zeros((), dtype=u.dtype, device=u.device)
        v = self._compact_unconstrained(torch.where(self.free, g, zero))
        v = torch.where(self.free, v, g).reshape(-1)
        return v if rhs is None else rhs - v

    # -- applies -------------------------------------------------------------

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

    def unconstrained_apply(self, grid: torch.Tensor) -> torch.Tensor:
        """The assembled operator without Dirichlet rows or columns on a
        node grid (plain torch, any device): the sum of the cell integrals,
        as the JAX package's ``apply_cells`` over ``cell_dofs``
        (``laplace.py:825-829``)."""
        if self.compact:
            return self._compact_unconstrained(grid)
        if self.deformed:
            c6 = merged_coeff_qgrid(self.coeff6, self.tables.cells,
                                    self.degree + 1)
            return merged_laplace_apply(grid, self.tables.Ev, self.tables.Ed,
                                        c6)
        return separable_laplace_apply_banded(grid, self.tables.Mdiags,
                                              self.tables.Kdiags)

    # -- setup: diagonal and right-hand side ---------------------------------

    def _merged_coeff6(self) -> torch.Tensor:
        """Packed (C, 6, Q) box-coordinate coefficients in the operator's
        dtype; the compact forms compute them at their mapping degree, as
        the JAX package's inverse diagonal reads ``geometry.coeff``."""
        if not self.compact:
            return self.coeff6
        geo = compute_geometry(self.dofs.mesh, self.degree + 1,
                               self.mapping_degree, self.device)
        return pack_merged_coeff(geo.coeff, self.dofs.mesh.h).to(self.dtype)

    def _jxw(self) -> torch.Tensor:
        """(C, Q) float64 w_q·det J of the deformed geometry."""
        if not self.compact:
            return self.jxw
        return compute_geometry(self.dofs.mesh, self.degree + 1,
                                self.mapping_degree, self.device).jxw

    def compute_inverse_diagonal(self) -> torch.Tensor:
        """1 / diag(A) in the operator's dtype, constrained rows 1
        (``laplace.py:771-806``).  Cartesian: diag(Σ_d ⊗ M̂…K̂_d…M̂) is the
        sum over d of outer products of the global 1D diagonals, z slowest,
        formed in the operator's dtype in the JAX package's order.
        Deformed: each cell's diagonal from the merged coefficients
        (``tensorops.cell_diagonal``, box-coordinate gradients), summed
        into the nodes by the lattice's overlap-add, a fixed order."""
        one = torch.ones((), dtype=self.dtype, device=self.device)
        if self.deformed:
            s = shape_1d(self.degree, self.degree + 1)
            h = self.dofs.mesh.h
            grad = np.stack([tensor_gradient(s.N, s.D, self.dim)[:, :, d]
                             / h[d] for d in range(self.dim)], axis=2)
            local = cell_diagonal(self._merged_coeff6(), grad)
            diag = cells_to_grid_sliced(local, self.dofs.mesh.n_cells,
                                        self.degree)
            return 1.0 / torch.where(self.free, diag, one).reshape(-1)
        dM = [self._tensor(np.diagonal(M)) for M in self.M1d_global]
        dK = [self._tensor(np.diagonal(K)) for K in self.K1d_global]
        diag = None
        for d in range(self.dim):
            vecs = [dK[e] if e == d else dM[e]
                    for e in reversed(range(self.dim))]
            term = vecs[0]
            for v in vecs[1:]:
                term = (term[:, None] * v[None, :]).reshape(-1)
            diag = term if diag is None else diag + term
        diag = torch.where(self.free.reshape(-1), diag, one)
        return 1.0 / diag

    def dirichlet_vector(self, dirichlet) -> torch.Tensor | None:
        """(n,) float64 g on the device: ``dirichlet`` at the constrained
        nodes, 0 elsewhere; None where g vanishes."""
        g = dirichlet_values(self.dofs, dirichlet)
        return None if g is None else torch.as_tensor(g, device=self.device)

    def assemble_rhs(self, f="constant", dirichlet=None) -> torch.Tensor:
        """b_i = ∫ f φ_i − (A g)_i on free nodes, 0 on constrained ones
        (``laplace.py:808-835``, on deal.II's homogeneous system).  ``f``
        is a function of (P, dim) points or a name of
        ``fem.functions.make_rhs_and_dbc``; ``dirichlet`` gives g.

        The constant f on a Cartesian mesh is the outer product of the
        row sums of the global 1D mass matrices.  Otherwise f at the
        quadrature points (``ops/geometry.py::quadrature_points``) times
        w_q·det J and the basis values, summed into the nodes (float64).
        The lift A g is the unconstrained operator on g
        (``unconstrained_apply``), not ``vmult``, which drops constrained
        inputs."""
        if isinstance(f, str):
            f = make_rhs_and_dbc(f, self.dim)[0]
        if f is constant_rhs and not self.deformed:
            rows = [torch.as_tensor(self.M1d_global[d].sum(axis=1),
                                    device=self.device)
                    for d in range(self.dim)]
            b = outer_grid(rows)
        else:
            mesh, p = self.dofs.mesh, self.degree
            s = shape_1d(p, p + 1)
            if self.deformed:
                jxw = self._jxw()
            else:
                jxw = torch.as_tensor(tensor_weights([s.w] * self.dim)
                                      * np.prod(mesh.h), device=self.device
                                      ).expand(mesh.n_cells_total, -1)
            if f is not constant_rhs:
                fq = f(quadrature_points(mesh, p + 1, 1).reshape(-1, self.dim))
                jxw = jxw * torch.as_tensor(
                    np.asarray(fq, np.float64), device=self.device).reshape(
                        jxw.shape)
            Nval = torch.as_tensor(tensor_values(s.N, self.dim),
                                   device=self.device)
            b = cells_to_grid_sliced(jxw @ Nval, mesh.n_cells, p)
        g = None if dirichlet is None else self.dirichlet_vector(dirichlet)
        if g is not None:
            b = b - self.unconstrained_apply(
                g.to(self.dtype).reshape(self.grid_shape)).to(b.dtype)
        zero = torch.zeros((), dtype=b.dtype, device=b.device)
        return torch.where(self.free, b, zero).reshape(-1).to(self.dtype)
