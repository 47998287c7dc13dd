"""Matrix-free Laplace operator on unstructured meshes (PyTorch).

Counterpart of ``dealii_asm_tpu/ops/laplace_general.py::
GeneralLaplaceOperator`` (the hyperball family): gather the cell DoFs
through the orientation-baked ``cell_dofs`` table, sum-factorised reference
gradients, the merged symmetric coefficient w_q·|J|·J⁻¹J⁻ᵀ per quadrature
point, transposed integration, scatter-add.  The apply is kernel F
(``kernels/lanes_laplace.py``) in float32 or native float64; the JAX
package's double-single outer matvec and its lane-major layouts are TPU
workarounds the port does not need.  Constrained (Dirichlet) rows act as
identity: ``vmult(u)`` is ``where(free, A·where(free, u, 0), u)``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..device import DEFAULT_DEVICE, resolve_device
from ..fem.functions import constant_rhs, dirichlet_values, make_rhs_and_dbc
from ..fem.lagrange import shape_1d, tensor_gradient, tensor_values
from ..kernels.lanes_laplace import (lanes_laplace, lanes_tables,
                                     sumfac_cell_apply)
from .geometry import compute_geometry, quadrature_points
from .fixed_sum import FixedOrderSum
from .tensorops import cell_diagonal, pack_merged_coeff


def default_mapping_degree(mesh) -> int:
    """2 on a curved mesh (``project`` set: the reference caps the ball's
    mapping at 2), else 1 (``laplace_general.py:74-78``)."""
    return 1 if mesh.project is None else 2


class GeneralLaplaceOperator(nn.Module):
    """Laplace operator on a ``fem.general_dofs.GeneralDofHandler``.

    ``geometry`` (optional): the NumPy pair (coeff6 (C, 6, Q) as [xx, yy,
    zz, xy, xz, yz], jxw (C, Q)) instead of computing it here; ``interop.py``
    passes the JAX package's tables through it.
    """

    def __init__(self, dofs, dtype=torch.float64, device=DEFAULT_DEVICE,
                 mapping_degree=None, geometry=None):
        super().__init__()
        mesh = dofs.mesh
        if mesh.dim != 3:
            raise NotImplementedError(
                f"dim {mesh.dim}: the port runs 3D meshes only (ROADMAP item 9)")
        self.dofs = dofs
        self.degree = p = dofs.degree
        self.dim = mesh.dim
        self.n_dofs = dofs.n_dofs
        self.dtype = dtype
        self.device = resolve_device(device)
        self.mapping_degree = (default_mapping_degree(mesh)
                               if mapping_degree is None else mapping_degree)
        if geometry is None:
            geo = compute_geometry(mesh, p + 1, self.mapping_degree,
                                   self.device)
            coeff6, self.jxw = pack_merged_coeff(geo.coeff, (1.0,) * 3), geo.jxw
            del geo
        else:
            coeff6, self.jxw = (torch.tensor(np.asarray(a, np.float64),
                                             device=self.device)
                                for a in geometry)
        # packed in float64, then cast, as the JAX package does
        self.register_buffer("coeff6", coeff6.to(dtype).contiguous())
        del coeff6
        s = shape_1d(p, p + 1)
        # the kernel's launch takes the 1D tables from this host copy
        shape_host = torch.tensor(np.stack([s.N, s.D, s.D, s.D]), dtype=dtype)
        self.register_buffer("shape_tabs", shape_host.to(self.device))
        self.tables = lanes_tables(dofs.cell_dofs, dofs.boundary_mask,
                                   self.coeff6, self.shape_tabs, shape_host, p)

    def vmult(self, u: torch.Tensor) -> torch.Tensor:
        """A·u in the operator's dtype; another input dtype is cast in and
        out (the Lanczos estimate drives float32 levels with float64
        vectors)."""
        if u.dtype == self.dtype:
            return lanes_laplace(u, self.tables)
        return lanes_laplace(u.to(self.dtype), self.tables).to(u.dtype)

    def residual(self, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """b − A·x in one kernel call."""
        return lanes_laplace(x, self.tables, rhs=b)

    def forward(self, u):
        return self.vmult(u)

    def compute_inverse_diagonal(self) -> torch.Tensor:
        """1 / diag(A) in the operator's dtype, constrained rows 1: each
        cell's diagonal in the six-pair form over ``coeff6``
        (``laplace_general.py:418-440``), summed into the DoFs in a fixed
        order (``FixedOrderSum``), so repeats are bit-identical."""
        s = shape_1d(self.degree, self.degree + 1)
        local = cell_diagonal(self.coeff6, tensor_gradient(s.N, s.D, self.dim))
        diag = FixedOrderSum(self.tables.cell_dofs, self.n_dofs)(local)
        one = torch.ones((), dtype=self.dtype, device=self.device)
        return 1.0 / torch.where(self.tables.free, diag, one)

    def dirichlet_vector(self, dirichlet) -> torch.Tensor | None:
        """(n,) float64 g on the device: ``dirichlet`` at the constrained
        DoFs' support points, 0 elsewhere; None where g vanishes."""
        g = dirichlet_values(self.dofs, dirichlet)
        return None if g is None else torch.as_tensor(g, device=self.device)

    def unconstrained_apply(self, u: torch.Tensor) -> torch.Tensor:
        """The assembled operator without Dirichlet rows or columns (plain
        torch): the cell integrals of u summed into the DoFs in a fixed
        order (``laplace_general.py:459-470``)."""
        m = self.degree + 1
        W = u[self.tables.cell_dofs].reshape(-1, m, m, m)
        local = sumfac_cell_apply(W, self.coeff6, self.shape_tabs)
        return FixedOrderSum(self.tables.cell_dofs, self.n_dofs)(
            local.reshape(W.shape[0], -1))

    def assemble_rhs(self, f="constant", dirichlet=None) -> torch.Tensor:
        """b_i = ∫ f φ_i − (A g)_i on free DoFs, 0 on constrained ones
        (``laplace_general.py:442-473``, on deal.II's homogeneous system;
        float64): f at the quadrature points of the operator's mapping
        times jxw and the basis values, summed into the DoFs in a fixed
        order; ``f`` is a function of (P, 3) points or a name of
        ``fem.functions.make_rhs_and_dbc``, ``dirichlet`` gives g."""
        if isinstance(f, str):
            f = make_rhs_and_dbc(f, self.dim)[0]
        s = shape_1d(self.degree, self.degree + 1)
        Nval = torch.as_tensor(tensor_values(s.N, self.dim),
                               device=self.device)
        jxw = self.jxw
        if f is not constant_rhs:
            qp = quadrature_points(self.dofs.mesh, self.degree + 1,
                                   self.mapping_degree)
            fq = f(qp.reshape(-1, self.dim))
            jxw = jxw * torch.as_tensor(np.asarray(fq, np.float64),
                                        device=self.device).reshape(jxw.shape)
        b = FixedOrderSum(self.tables.cell_dofs, self.n_dofs)(jxw @ Nval)
        g = None if dirichlet is None else self.dirichlet_vector(dirichlet)
        if g is not None:
            b = b - self.unconstrained_apply(g.to(self.dtype)).to(b.dtype)
        b = torch.where(self.tables.free, b, torch.zeros((), dtype=b.dtype,
                                                         device=b.device))
        return b.to(self.dtype)
