"""Subdomain additive Schwarz with direct subdomain solves (host).

Counterpart of ``dealii_asm_tpu/precond/domain.py::DomainPreconditioner``,
the reference program's rank-level Schwarz and its halo-layer study: the
cells split into slabs along the slowest axis, each slab widened by
``n_halo_layers`` cell layers, and each subdomain solves its restricted
sparse system (free DoFs only) with a SciPy sparse LU factorisation (or,
``inner_solver="amg-cg"``, diagonally preconditioned SciPy CG to
``inner_reduction``); the weighted solutions are summed.

In the JAX package this is a host-side oracle (``device_traceable =
False``, ``domain.py:23-26``): sparse LU has no device form there.  The
port keeps that design on purpose: ``vmult`` copies the vector to the host
explicitly, solves there in float64 and copies the result back to the
vector's device and dtype.  It is the one module of the port that computes
on the host in the solve; nothing else may route around the card so.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse.linalg as spla
import torch

from ..fem.assemble import assemble_laplace


class DomainPreconditioner:
    device_traceable = False

    def __init__(self, dofs, n_subdomains: int = 2, n_halo_layers: int = 1,
                 weighting_type: str = "symm", inner_solver: str = "direct",
                 inner_reduction: float = 1e-8):
        self.dofs = dofs
        self.weighting_type = weighting_type
        self.inner_solver = inner_solver
        self.inner_reduction = inner_reduction
        mesh = dofs.mesh
        A = assemble_laplace(dofs).tocsr()
        n = dofs.n_dofs
        axis = mesh.dim - 1
        n_cells_axis = mesh.n_cells[axis]
        n_subdomains = min(n_subdomains, n_cells_axis)
        bounds = np.linspace(0, n_cells_axis, n_subdomains + 1).astype(int)
        cd = np.asarray(dofs.cell_dofs)
        mi = mesh.cell_multi_index()
        self.blocks = []
        counts = np.zeros(n)
        for sdom in range(n_subdomains):
            lo = max(bounds[sdom] - n_halo_layers, 0)
            hi = min(bounds[sdom + 1] + n_halo_layers, n_cells_axis)
            cells = np.where((mi[:, axis] >= lo) & (mi[:, axis] < hi))[0]
            ids = np.unique(cd[cells].reshape(-1))
            ids = ids[~dofs.boundary_mask[ids]]
            # rows then columns: ``np.ix_`` would index through an
            # (n_ids, n_ids) grid
            Ab = A[ids][:, ids].tocsc()
            if inner_solver == "direct":
                solver = spla.splu(Ab).solve
            else:
                solver = self._cg_solver(Ab)
            self.blocks.append((ids, solver))
            counts[ids] += 1.0
        counts[counts == 0] = 1.0
        w = 1.0 / counts
        self.w = np.sqrt(w) if weighting_type == "symm" else w
        self.is_symmetric = weighting_type in ("none", "symm")

    def _cg_solver(self, Ab):
        """The inexact subdomain solve: diagonally preconditioned CG."""
        d = Ab.diagonal()
        M = spla.LinearOperator(Ab.shape, matvec=lambda v: v / d)

        def solve(rhs):
            x, _ = spla.cg(Ab, rhs, rtol=self.inner_reduction, maxiter=500,
                           M=M)
            return x
        return solve

    def vmult(self, src: torch.Tensor) -> torch.Tensor:
        x = src.detach().to("cpu", torch.float64).numpy()
        if self.weighting_type in ("pre", "symm"):
            x = x * self.w
        dst = np.zeros_like(x)
        for ids, solve in self.blocks:
            dst[ids] += solve(x[ids])
        if self.weighting_type in ("post", "symm"):
            dst = dst * self.w
        return torch.as_tensor(dst).to(device=src.device, dtype=src.dtype)

    def __call__(self, src):
        return self.vmult(src)
