"""Multigrid transfer operators between structured levels (PyTorch).

Counterpart of ``dealii_asm_tpu/ops/transfer.py`` (``TwoLevelTransfer``
:34-180, ``p_sequence`` :181).  Prolongation is the tensor product of global
1D interpolation matrices P̂_d (N_f × N_c), restriction its transpose; both
are plain torch axis products, as the JAX package computes them outside any
Pallas kernel.  Constrained rows and columns are zeroed in the device copies
of P̂_d, which equals masking the coarse input and the fine output.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..fem.lagrange import gauss_lobatto_points, lagrange_values
from .tensorops import axis_matmul


def _global_interp_1d(T1: np.ndarray, coarse, fine, d: int) -> np.ndarray:
    """Global 1D interpolation matrix along direction d (N_f × N_c); entries
    are set per coarse cell block (shared nodes get identical values)."""
    Nf = fine.nodes_per_dim[d]
    Nc = coarse.nodes_per_dim[d]
    pc = coarse.degree
    pf_nodes = T1.shape[0]
    P = np.zeros((Nf, Nc))
    for c in range(coarse.mesh.n_cells[d]):
        rows = (c * (pf_nodes - 1) + np.arange(pf_nodes)) % Nf
        cols = (c * pc + np.arange(pc + 1)) % Nc
        P[np.ix_(rows, cols)] = T1
    return P


class TwoLevelTransfer(nn.Module):
    """Transfer between a coarse and a fine DofHandler (p- or h-coarsening).

    ``P1d`` (optional): per-direction NumPy interpolation matrices, by
    default built here (``interop.py`` passes the JAX ones)."""

    def __init__(self, coarse, fine, dtype=torch.float64, device="cpu",
                 P1d=None):
        super().__init__()
        self.coarse = coarse
        self.fine = fine
        self.dim = coarse.mesh.dim
        self.dtype = dtype
        self.device = resolve_device(device)
        if P1d is None:
            pc, pf = coarse.degree, fine.degree
            if coarse.mesh.n_cells == fine.mesh.n_cells:  # p-transfer
                if pf < pc:
                    raise ValueError(f"p-transfer needs pf >= pc ({pf} < {pc})")
                T1 = lagrange_values(gauss_lobatto_points(pc + 1),
                                     gauss_lobatto_points(pf + 1))
            else:  # h-transfer: the fine mesh has 2x cells per direction
                if pf != pc or any(f != 2 * c for c, f in zip(
                        coarse.mesh.n_cells, fine.mesh.n_cells)):
                    raise ValueError("h-transfer needs equal degrees and "
                                     "2x refinement")
                nodes = gauss_lobatto_points(pc + 1)
                xf = np.concatenate([nodes * 0.5, 0.5 + nodes[1:] * 0.5])
                T1 = lagrange_values(nodes, xf)
            P1d = [_global_interp_1d(np.asarray(T1), coarse, fine, d)
                   for d in range(self.dim)]
        self.P1d = [np.asarray(P, np.float64) for P in P1d]
        for d, P in enumerate(self.P1d):
            Pm = fine.free_1d(d)[:, None] * P * coarse.free_1d(d)[None, :]
            self.register_buffer(f"P{d}", torch.as_tensor(
                Pm, dtype=dtype, device=self.device))
            self.register_buffer(f"PT{d}", torch.as_tensor(
                np.ascontiguousarray(Pm.T), dtype=dtype, device=self.device))
        self.coarse_grid_shape = tuple(reversed(coarse.nodes_per_dim))
        self.fine_grid_shape = tuple(reversed(fine.nodes_per_dim))

    def prolongate(self, u_coarse: torch.Tensor) -> torch.Tensor:
        t = u_coarse.reshape(self.coarse_grid_shape)
        for d in range(self.dim):
            t = axis_matmul(t, getattr(self, f"P{d}"), self.dim - 1 - d)
        return t.reshape(-1)

    def restrict(self, r_fine: torch.Tensor) -> torch.Tensor:
        t = r_fine.reshape(self.fine_grid_shape)
        for d in range(self.dim):
            t = axis_matmul(t, getattr(self, f"PT{d}"), self.dim - 1 - d)
        return t.reshape(-1)


def p_sequence(degree: int, kind: str) -> list[int]:
    """Degree sequences of the reference solver program (ascending)."""
    seq = [degree]
    if kind == "go to one":
        if degree > 1:
            seq.append(1)
    elif kind == "decrease by one":
        while seq[-1] > 1:
            seq.append(seq[-1] - 1)
    elif kind == "bisect":
        while seq[-1] > 1:
            seq.append(max(seq[-1] // 2, 1))
    else:
        raise ValueError(kind)
    return list(reversed(seq))
