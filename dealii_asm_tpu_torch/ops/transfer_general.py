"""Multigrid transfers on unstructured meshes (PyTorch).

Counterpart of ``dealii_asm_tpu/ops/transfer_general.py::
GeneralTwoLevelTransfer``, the hyperball's h- and p-transfers: cell-wise
tensor-product interpolation embedded as gather → ⊗T1 → scatter-add →
× inverse fine valence; restriction is the exact transpose.  The scatters
sum in a fixed order (``ops/fixed_sum.py``), so a repeated V-cycle on CUDA is
bit-identical.

h-transfer: the children of coarse cell c are the 2^dim consecutive fine
cells 2^dim·c + octant (``UnstructuredMesh.refine``) and share the parent's
local frame, so each coarse cell's (2p+1)^dim fine lattice is a plain
gather.  p-transfer: the same mesh, T1 interpolates GLL degree pc to pf.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..device import DEFAULT_DEVICE, resolve_device
from ..fem.lagrange import gauss_lobatto_points, lagrange_values
from ..mesh.unstructured import VERTEX_COORDS
from .fixed_sum import FixedOrderSum


def h_fine_lattice(coarse, fine) -> np.ndarray:
    """(Cc, (2p+1)^dim) fine global DoFs of each coarse cell's fine lattice
    (``transfer_general.py:75-104``)."""
    p = coarse.degree
    dim = coarse.mesh.dim
    n1, mf = p + 1, 2 * p + 1
    fcd = np.asarray(fine.cell_dofs, dtype=np.int64)
    parent, octant = fine.mesh.parent_cells, fine.mesh.child_index
    out = np.zeros((coarse.mesh.n_cells_total, mf ** dim), dtype=np.int64)
    lat = np.stack([np.arange(n1 ** dim) // n1 ** d % n1 for d in range(dim)],
                   axis=1)
    for o in range(2 ** dim):
        sel = np.where(octant == o)[0]
        pos = lat + VERTEX_COORDS[dim][o][None, :] * p
        flat = sum(pos[:, d] * mf ** d for d in range(dim))
        out[parent[sel][:, None], flat[None, :]] = fcd[sel]
    return out


class GeneralTwoLevelTransfer(nn.Module):
    """Transfer between a coarse and a fine ``GeneralDofHandler``.

    The two share a mesh (p-transfer) when their cell counts agree, else the
    fine mesh is the coarse one refined once (h-transfer).  ``T1``
    (optional): the (n_out, n_in) 1D interpolation matrix, by default built
    here (``interop.py`` passes the JAX one).
    """

    def __init__(self, coarse, fine, dtype=torch.float64,
                 device=DEFAULT_DEVICE, T1=None):
        super().__init__()
        if coarse.mesh.dim != 3:
            raise NotImplementedError(
                f"dim {coarse.mesh.dim}: the port runs 3D meshes only "
                "(ROADMAP item 9)")
        self.coarse, self.fine = coarse, fine
        self.dim = 3
        self.dtype = dtype
        self.device = resolve_device(device)
        pc, pf = coarse.degree, fine.degree
        if fine.mesh.n_cells_total == coarse.mesh.n_cells_total:
            if pf < pc:
                raise ValueError(f"p-transfer needs pf >= pc ({pf} < {pc})")
            nodes_in, x_out = (gauss_lobatto_points(pc + 1),
                               gauss_lobatto_points(pf + 1))
            fine_lat = np.asarray(fine.cell_dofs, dtype=np.int64)
        else:
            if (pf != pc or fine.mesh.parent_cells is None
                    or fine.mesh.n_cells_total
                    != 2 ** self.dim * coarse.mesh.n_cells_total):
                raise ValueError("h-transfer needs equal degrees and a fine "
                                 "mesh refined once from the coarse one")
            nodes_in = gauss_lobatto_points(pc + 1)
            x_out = np.concatenate([nodes_in * 0.5, 0.5 + nodes_in[1:] * 0.5])
            fine_lat = h_fine_lattice(coarse, fine)
        if T1 is None:
            T1 = lagrange_values(nodes_in, x_out)
        self.register_buffer("T1", torch.tensor(np.asarray(T1, np.float64),
                                                dtype=dtype, device=self.device))
        self.n_fine, self.n_coarse = fine.n_dofs, coarse.n_dofs
        counts = np.bincount(fine_lat.reshape(-1), minlength=self.n_fine)
        counts[counts == 0] = 1
        dev = self.device
        self.register_buffer("fine_lat", torch.as_tensor(fine_lat, device=dev))
        self.register_buffer("coarse_cd", torch.as_tensor(
            np.asarray(coarse.cell_dofs, np.int64), device=dev))
        self.register_buffer("fine_inv_valence", torch.as_tensor(
            1.0 / counts, dtype=dtype, device=dev))
        self.register_buffer("fine_free", torch.as_tensor(
            ~np.asarray(fine.boundary_mask), device=dev))
        self.register_buffer("coarse_free", torch.as_tensor(
            ~np.asarray(coarse.boundary_mask), device=dev))
        self._to_fine = FixedOrderSum(self.fine_lat, self.n_fine)
        self._to_coarse = FixedOrderSum(self.coarse_cd, self.n_coarse)

    def _tensor_apply(self, u: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
        """(C, n_in^3) → (C, n_out^3): T (n_out, n_in) along z, y, x."""
        n = T.shape[1]
        u = u.reshape(-1, n, n, n)
        u = torch.einsum("czyx,Zz->cZyx", u, T)
        u = torch.einsum("czyx,Yy->czYx", u, T)
        u = torch.einsum("czyx,Xx->czyX", u, T)
        return u.reshape(u.shape[0], -1)

    def prolongate(self, u_coarse: torch.Tensor) -> torch.Tensor:
        zero = torch.zeros((), dtype=u_coarse.dtype, device=u_coarse.device)
        u = torch.where(self.coarse_free, u_coarse, zero)
        vf = self._tensor_apply(u[self.coarse_cd], self.T1)
        out = self._to_fine(vf) * self.fine_inv_valence
        return torch.where(self.fine_free, out, zero)

    def restrict(self, r_fine: torch.Tensor) -> torch.Tensor:
        zero = torch.zeros((), dtype=r_fine.dtype, device=r_fine.device)
        r = torch.where(self.fine_free, r_fine, zero) * self.fine_inv_valence
        vc = self._tensor_apply(r[self.fine_lat], self.T1.T)
        return torch.where(self.coarse_free, self._to_coarse(vc), zero)
