"""Additive Schwarz preconditioner with FDM local solves (PyTorch).

Counterpart of ``dealii_asm_tpu/precond/asm.py::ASMPreconditioner`` for
element-centric overlap-1 patches on uniform Cartesian meshes, in its
``global_fdm`` form (``asm.py:287-313``, ``_vmult_global_fdm`` :527).  The
multiplicity weights (none/pre/post/symm) and the Dirichlet masks are
separable per axis, so they fold into per-axis vectors (``fin``/``fout``).

Setup is O(N_d) per axis: the tables come straight from the per-coordinate
1D eigenproblems (``precond/fdm.py::percoord_eigendecomposition``); no
per-patch collection, index table or dense inverse is built.  The apply is
kernel B (``kernels/fdm_patch.py``).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..kernels.fdm_patch import FDMTables, fdm_patch
from ..ops.laplace import check_structured_cartesian
from ..ops.tensorops import fdm_direction_transform
from .fdm import percoord_eigendecomposition

_FOLD_EXPONENTS = {"none": (0.0, 0.0), "pre": (1.0, 0.0),
                   "post": (0.0, 1.0), "symm": (0.5, 0.5)}


def axis_weight(n_nodes: int, n_cells: int, degree: int) -> np.ndarray:
    """1D multiplicity weight of element windows along one axis
    (``asm.py:382``); the node weights are the tensor product ⊗_d w_d."""
    counts = np.zeros(n_nodes)
    for c in range(n_cells):
        counts[c * degree: c * degree + degree + 1] += 1.0
    counts[counts == 0] = 1.0
    return 1.0 / counts


class ASMPreconditioner(nn.Module):
    """Element-centric overlap-1 additive Schwarz with FDM local solves.

    ``percoord`` (optional): per-direction (V (C_d, m, m), λ (C_d, m)) NumPy
    tables; by default they are built here (``interop.py`` passes the JAX
    ones).
    """

    is_symmetric = True

    def __init__(self, dofs, n_overlap: int = 1, weighting_type: str = "post",
                 dtype=torch.float64, device="cpu", percoord=None):
        super().__init__()
        if weighting_type not in _FOLD_EXPONENTS:
            raise NotImplementedError(
                f"weighting {weighting_type!r} is not ported yet "
                "(RAS: ROADMAP item 10)")
        if n_overlap != 1:
            raise NotImplementedError(
                f"n overlap {n_overlap}: the port has overlap 1 only "
                "(ROADMAP item 10)")
        check_structured_cartesian(dofs)
        self.dofs = dofs
        self.dim = dofs.mesh.dim
        self.degree = dofs.degree
        self.weighting_type = weighting_type
        self.is_symmetric = weighting_type in ("none", "symm")
        self.dtype = dtype
        self.device = resolve_device(device)
        mesh = dofs.mesh
        p = self.degree
        if percoord is None:
            percoord = percoord_eigendecomposition(mesh, p, n_overlap)
        self.percoord = [(np.asarray(V, np.float64), np.asarray(l, np.float64))
                         for V, l in percoord]
        a_in, a_out = _FOLD_EXPONENTS[weighting_type]
        names = ("V", "lam", "fin", "fout", "G", "Gt")
        lam_flat = []
        for d in range(self.dim):
            V, lam = self.percoord[d]
            N = dofs.nodes_per_dim[d]
            free = dofs.free_1d(d)
            w = axis_weight(N, mesh.n_cells[d], p)
            fin = free * w ** a_in
            fout = free * w ** a_out
            G = fdm_direction_transform(V, N, p, n_overlap, False)
            for name, arr in zip(names, (V, lam, fin, fout, G * fin[None, :],
                                         (G * fout[None, :]).T)):
                self.register_buffer(f"{name}{d}", self._tensor(arr))
            lam_flat.append(getattr(self, f"lam{d}").reshape(-1))
        lx, ly, lz = lam_flat
        denom = lx[None, None, :] + ly[None, :, None] + lz[:, None, None]
        self.register_buffer("inv_denom", 1.0 / denom)
        per = {name: [getattr(self, f"{name}{d}") for d in range(self.dim)]
               for name in names}
        self.tables = FDMTables(per["V"], per["lam"], per["fin"], per["fout"],
                                per["G"], per["Gt"], self.inv_denom,
                                tuple(reversed(mesh.n_cells)), p)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.tensor(np.ascontiguousarray(a), dtype=self.dtype,
                            device=self.device)

    @property
    def global_fdm(self):
        """(Gs, Gts, lams) as the JAX class exposes them (plain-path tables)."""
        return (self.tables.G, self.tables.Gt,
                [l.reshape(-1) for l in self.tables.lam])

    def vmult(self, src: torch.Tensor) -> torch.Tensor:
        if src.dtype == self.dtype:
            return fdm_patch(src, self.tables)
        return fdm_patch(src.to(self.dtype), self.tables).to(src.dtype)

    def forward(self, src):
        return self.vmult(src)
